"""Seeded weights of a configuration, made on the device in a few large
draws, as state dicts under the upstream key names: the one set of weights
both the program and the reference are given.

The parameter names and shapes come from the program's modules built on
the meta device (nothing is computed there); the values follow this file's
rules, not the program's init code: linear weights xavier-uniform, biases
zero, norms one; the DiT's timestep MLP, adaLN and final layer N(0, 0.02)
and its cross-attention gates 0.5 (so that no block is an identity);
convolutions U(+-1/sqrt(fan_in)), transposed convolutions with zero bias,
the vocoder's convolutions without bias and its conv_post at VOC_POST_GAIN
times that bound; the vocoder's snake parameters U(-0.3, 0.3) in log
scale; embeddings N(0, 0.02), T5's shared table N(0, 1) and its relative
bias N(0, 0.1)."""

from __future__ import annotations

import hashlib
from typing import Dict

import torch
from torch import nn


# The vocoder's convolutions carry no bias, so that its output follows the
# mel (with biases its random output is set by them, and the DiT and the VAE
# upstream barely move it); its signal shrinks through the stages, and
# conv_post's gain brings the wav back to a level where 16-bit PCM keeps it.
VOC_POST_GAIN = 200.0


def sub_seed(seed: int, tag: str, bits: int = 62) -> int:
    """A seed for one purpose, from the run's seed and a tag."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") % (1 << bits)


def _rule(mod_name: str, mod: nn.Module, pname: str, p_shape, part: str):
    """(kind, scale) of one parameter: kind in uniform, normal, const."""
    full = f"{mod_name}.{pname}" if mod_name else pname
    if isinstance(mod, nn.Embedding):
        std = 1.0 if mod_name.endswith("shared") else (
            0.1 if mod_name.endswith("relative_attention_bias") else 0.02)
        return "normal", std
    if isinstance(mod, (nn.Conv1d, nn.ConvTranspose1d)):
        bound = (mod.in_channels * mod.kernel_size[0]) ** -0.5
        if pname == "bias":
            zero = part == "vocoder" or isinstance(mod, nn.ConvTranspose1d)
            return ("const", 0.0) if zero else ("uniform", bound)
        post = part == "vocoder" and full == "conv_post.weight"
        return "uniform", bound * (VOC_POST_GAIN if post else 1.0)
    if isinstance(mod, nn.Linear):
        if pname == "bias":
            return "const", 0.0
        if part == "dit" and ("adaLN_modulation" in full or full.startswith("final_layer")
                              or full.startswith("t_embedder")):
            return "normal", 0.02
        fan_out, fan_in = p_shape
        return "uniform", (6.0 / (fan_in + fan_out)) ** 0.5
    if part == "vocoder" and pname in ("alpha", "beta"):
        return "uniform", 0.3
    if part == "dit" and pname == "gate":
        return "const", 0.5
    # LayerNorm / RMSNorm / GroupNorm
    return "const", 1.0 if pname == "weight" else 0.0


def _leaves(part: str, module: nn.Module):
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out.append((name, tuple(p.shape)) + _rule(mname, mod, pname, tuple(p.shape), part))
    return out


def make_state(modules: Dict[str, nn.Module], seed: int,
               device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{part: {name: tensor}} for each (meta-device) module, from `seed`:
    one uniform and one normal draw over every part, then views scaled
    leaf by leaf."""
    plan = {part: _leaves(part, m) for part, m in modules.items()}
    sizes = {"uniform": 0, "normal": 0}
    for leaves in plan.values():
        for _, shape, kind, _ in leaves:
            if kind in sizes:
                sizes[kind] += int(torch.Size(shape).numel())
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device).mul_(2).sub_(1),
            "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    at = {"uniform": 0, "normal": 0}
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for part, leaves in plan.items():
        sd = {}
        for name, shape, kind, scale in leaves:
            n = int(torch.Size(shape).numel())
            if kind == "const":
                sd[name] = torch.full(shape, float(scale), device=device)
            else:
                sd[name] = flat[kind][at[kind]:at[kind] + n].view(shape).mul_(scale)
                at[kind] += n
        out[part] = sd
    return out
