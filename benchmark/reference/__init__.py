"""The plain reference of Make-An-Audio 3 that decides `correct`.

Plain PyTorch and NumPy only: it imports neither JAX nor the program under
test. It is given what the benchmark made (the seeded weights, the
captions, the request seeds, the mel files and their manifest) and works
out again everything the program derived from them: tokens, per-request
noise, the data loader's batches and caption drops, the flow-matching
draws, the latent scale, the optimizer's state. Models run in fp32 without
TF32, in blocks of rows so that they fit beside nothing else on the card.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

import numpy as np
import torch

from . import dit as dit_ref
from . import text, vae, vocoder
from .core import exact_fp32
from .flow import clip_adamw, cfm_rows, posterior_sample


@torch.no_grad()
def serve(cfg: dict, sd: Dict[str, dict], requests: List[dict], device,
          block: int = 8) -> List[np.ndarray]:
    """The wav of each request {prompt, struct, seed, latent_len, steps,
    scale}: its captions encoded, its noise drawn from its seed with numpy
    (standard normal, (latent channels, latent_len), as the server draws it),
    the CFG ODE against the empty captions' context, the VAE decoder, the
    vocoder."""
    model = cfg["model"]
    out: List[Optional[np.ndarray]] = [None] * len(requests)
    with exact_fp32():
        uc = text.clap_flan(sd["cond"], cfg["conditioner"], [""], [""], device)
        order = sorted(range(len(requests)), key=lambda i: (
            requests[i]["latent_len"], requests[i]["steps"], requests[i]["scale"]))
        for lo in range(0, len(order), block):
            idx = order[lo:lo + block]
            rs = [requests[i] for i in idx]
            key = {(r["latent_len"], r["steps"], r["scale"]) for r in rs}
            if len(key) > 1:  # one block, one shape
                for i in idx:
                    out[i] = serve(cfg, sd, [requests[i]], device, block)[0]
                continue
            n, steps, scale = key.pop()
            ctx = text.clap_flan(sd["cond"], cfg["conditioner"], [r["prompt"] for r in rs],
                                 [r["struct"] for r in rs], device)
            x0 = torch.as_tensor(np.stack([
                np.random.default_rng(r["seed"]).standard_normal(
                    (model["latent_channels"], n)).astype(np.float32) for r in rs]),
                device=device)
            z = dit_ref.sample_cfg(sd["dit"], model["dit"], x0, ctx,
                                   uc.expand(len(rs), -1, -1), scale, steps)
            mel = vae.decode(sd["vae"], z / model["scale_factor"])
            wav = vocoder.vocode(sd["vocoder"], cfg["vocoder"], mel)
            for i, w in zip(idx, wav.cpu().numpy()):
                out[i] = w
    return out


def loader_batches(manifest: str, batch_size: int, seed: int, drop: float,
                   n_batches: int) -> List[dict]:
    """The first n_batches batches a seeded, shuffled, fixed-length
    text-to-spectrogram loader gives over a manifest (name, mel_path,
    ori_cap, caption), read by one worker in order: batches of consecutive
    rows, their order permuted by RandomState(seed + epoch); each row's
    captions dropped to "" where RandomState(seed).uniform() <= drop, drawn
    row by row in loading order; each mel cropped or tiled to the crop
    length by the caller (crop_len)."""
    with open(manifest, newline="", encoding="utf-8") as f:
        rows = list(csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE))
    caption_rng = np.random.RandomState(seed)
    out, epoch = [], 0
    while len(out) < n_batches:
        chunks = [list(range(i, min(i + batch_size, len(rows))))
                  for i in range(0, len(rows), batch_size)]
        perm = np.random.RandomState(seed + epoch).permutation(len(chunks))
        for c in perm:
            ori, struct, mels = [], [], []
            for i in chunks[c]:
                keep = caption_rng.uniform() > drop
                ori.append(rows[i]["ori_cap"] if keep else "")
                struct.append(rows[i]["caption"] if keep else "")
                mels.append(rows[i]["mel_path"])
            out.append({"ori": ori, "struct": struct, "mel_paths": mels})
            if len(out) == n_batches:
                break
        epoch += 1
    return out


def _crop_or_tile(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[1] < n:
        a = np.tile(a, -(-n // a.shape[1]))
    return a[:, :n]


def train(cfg: dict, sd: Dict[str, dict], batches: List[dict], crop_len: int,
          draw_seed: int, lr: float, device,
          rows_per_block: int = 2) -> dict:
    """The recipe's first len(batches) steps from the seeded weights: the VAE
    encode of each batch's mels and its posterior sample, the latent scale
    1 / std of the first batch's sample (scale_by_std), the trainable
    conditioner and the DiT under the flow-matching loss, the clip and
    AdamW. The draws come from a generator on `device` seeded with
    draw_seed * 2**32 + step: on the first step a posterior sample for the
    scale, then on every step the posterior noise, the integer timesteps
    and the flow noise.
    Returns {"loss": [...], "grad_norms": {leaf: norm of the clipped first
    gradient}, "change_norms": {leaf: norm of the change after the last
    step}}."""
    model = cfg["model"]
    dcfg, ccfg = model["dit"], cfg["conditioner"]
    names = [("dit", n) for n in sd["dit"]] + [("cond", n) for n in sd["cond"]]
    leaves = {k: {n: t.detach().clone().requires_grad_(True) for n, t in sd[k].items()}
              for k in ("dit", "cond")}
    params = [leaves[k][n] for k, n in names]
    opt_state: dict = {}
    out = {"loss": []}
    scale = None
    with exact_fp32():
        for step, b in enumerate(batches):
            mel = torch.as_tensor(np.stack([_crop_or_tile(np.load(p).astype(np.float32), crop_len)
                                            for p in b["mel_paths"]]), device=device)
            with torch.no_grad():
                moments = torch.cat([vae.encode_moments(sd["vae"], mel[i:i + rows_per_block])
                                     for i in range(0, len(mel), rows_per_block)])
            gen = torch.Generator(device=device).manual_seed(draw_seed * 2 ** 32 + step)
            half = moments.shape[1] // 2
            mshape = (moments.shape[0], half, moments.shape[2])
            if scale is None:
                zs = posterior_sample(moments, torch.randn(mshape, generator=gen, device=device))
                scale = 1.0 / float(zs.flatten().std(correction=0))
            z = posterior_sample(moments, torch.randn(mshape, generator=gen, device=device)) * scale
            t_int = torch.randint(0, model["timesteps"], (len(z),), generator=gen, device=device)
            x0 = torch.randn(z.shape, generator=gen, device=device)
            rows = len(z)
            for p in params:
                p.grad = None
            total = 0.0
            for lo in range(0, rows, rows_per_block):
                hi = min(rows, lo + rows_per_block)
                ctx = text.clap_flan(leaves["cond"], ccfg, b["ori"][lo:hi], b["struct"][lo:hi],
                                     device)

                def pred(xt, t):
                    return dit_ref.dit(leaves["dit"], dcfg, xt, t, ctx)

                part = cfm_rows(pred, z[lo:hi], t_int[lo:hi], x0[lo:hi],
                                model["timesteps"]).sum() / rows
                part.backward()
                total += float(part.detach())
            out["loss"].append(total)
            clip_adamw(params, opt_state, lr, cfg["train"]["grad_clip"], step)
            if step == 0:  # the clipped gradient, as the first update took it
                out["grad_norms"] = {f"{k}.{n}": float(torch.linalg.vector_norm(m)) / (1.0 - 0.9)
                                     for (k, n), m in zip(names, opt_state["mu"])}
        out["change_norms"] = {f"{k}.{n}": float(torch.linalg.vector_norm(
            leaves[k][n].detach() - sd[k][n])) for k, n in names}
    out["scale_factor"] = scale
    return out
