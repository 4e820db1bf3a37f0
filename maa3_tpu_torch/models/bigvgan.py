"""BigVGAN vocoder generator: (B, 80, T) log-mel -> (B, 256 T) wav
(counterpart of maa3_tpu/models/bigvgan.py).

conv_pre(7) -> per stage [ConvTranspose1d upsample (polyphase lowering);
AMPBlock1s or AMPBlock2s averaged] -> activation -> conv_post(7) -> tanh.
Weights are plain (weight norm folded, as the JAX package stores them).
The activation is the anti-aliased snake / snake-beta, or `lrelu`: a
leaky ReLU of slope 0.1 without anti-aliasing or parameters (HiFiGAN).

Kernel routing (maa3_tpu/models/bigvgan.py:459-503, applied at every batch
size): act->conv sites of stages with C <= 48, and activation_post ->
conv_post there, run K2 (ops/pallas_amp.py::conv_snake_fused); every other
anti-aliased activation runs K1 (ops/pallas_aa_snake.py::aa_snake_fused)
followed by a plain conv. AMPBlock1 has two sites per dilation
(convs1, convs2), AMPBlock2 one (convs). lrelu takes neither kernel. On CPU
tensors both wrappers run their plain versions, which compute the same
functions. The kernels have no backward: `bigvgan_apply(kernels=False)` is
the differentiable route (JAX's `pallas_aa=False`, which training takes),
the plain activation and an unfused conv at every site, under autograd.

int8 serving (`quantize_bigvgan`, the `int8:voc` mode): the resblock convs
of stages with at least 384 channels become int8 sites (QuantConv1d), which
always run w8a8 on their compute-dtype input: k shifted tap-GEMMs from 256
channels up, the unfold GEMM below (maa3_tpu/models/bigvgan.py:292-342).
Their activations still run K1; K2 fuses only stages of width <= 48.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.ops.conv import (QuantConv1d, conv1d, conv1d_tapgemm_w8a8,
                                     conv1d_unfold_w8a8, conv_transpose1d,
                                     conv_transpose1d_polyphase, quantize_conv_int8)
from maa3_tpu_torch.ops.pallas_aa_snake import aa_snake_fused, aa_snake_plain
from maa3_tpu_torch.ops.pallas_amp import conv_snake_fused
from maa3_tpu_torch.ops.resample import use_fast_sin2

FUSED_MAX_CH = 48  # stages at or below this width take the act->conv kernel


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)       # prod = 256 = hop
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    activation: str = "snakebeta"
    snake_logscale: bool = True
    resblock: str = "1"
    sampling_rate: int = 16000

    @classmethod
    def from_dict(cls, h: dict) -> "BigVGANConfig":
        """A vocoder directory's config.json (maa3_tpu/models/bigvgan.py:46)."""
        return cls(
            num_mels=h.get("num_mels", 80),
            upsample_rates=tuple(h["upsample_rates"]),
            upsample_kernel_sizes=tuple(h["upsample_kernel_sizes"]),
            upsample_initial_channel=h["upsample_initial_channel"],
            resblock=str(h.get("resblock", "1")),
            resblock_kernel_sizes=tuple(h["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(
                tuple(d) if isinstance(d, (list, tuple)) else d
                for d in h["resblock_dilation_sizes"]),
            activation=h.get("activation", "snakebeta"),
            snake_logscale=bool(h.get("snake_logscale", True)),
            sampling_rate=h.get("sampling_rate", 16000))


ACTIVATIONS = ("snake", "snakebeta", "lrelu")
LRELU_SLOPE = 0.1


class Snake(nn.Module):
    """Per-channel snake (alpha) or snake-beta (alpha, beta) parameters."""

    def __init__(self, ch: int, has_beta: bool):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(ch))
        if has_beta:
            self.beta = nn.Parameter(torch.zeros(ch))


class Activation1d(nn.Module):
    """Holds `.act` so the keys read `<...>.act.alpha` as in the reference;
    lrelu holds nothing."""

    def __init__(self, ch: int, activation: str):
        super().__init__()
        if activation != "lrelu":
            self.act = Snake(ch, activation == "snakebeta")


class AMPBlock1(nn.Module):
    def __init__(self, ch: int, k: int, dilations: Sequence[int], activation: str):
        super().__init__()
        self.k, self.dilations = k, tuple(dilations)
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, k, dilation=d)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, k) for _ in dilations)
        self.activations = nn.ModuleList(Activation1d(ch, activation)
                                         for _ in range(2 * len(dilations)))


class AMPBlock2(nn.Module):
    """One act -> dilated conv per dilation (models.py:99-128)."""

    def __init__(self, ch: int, k: int, dilations: Sequence[int], activation: str):
        super().__init__()
        self.k, self.dilations = k, tuple(dilations)
        self.convs = nn.ModuleList(nn.Conv1d(ch, ch, k, dilation=d)
                                   for d in dilations)
        self.activations = nn.ModuleList(Activation1d(ch, activation)
                                         for _ in dilations)


class BigVGAN(nn.Module):
    def __init__(self, cfg: BigVGANConfig):
        super().__init__()
        if cfg.activation not in ACTIVATIONS or cfg.resblock not in ("1", "2"):
            raise ValueError(f"unknown vocoder: activation {cfg.activation!r}, "
                             f"resblock {cfg.resblock!r}")
        self.cfg = cfg
        block = AMPBlock1 if cfg.resblock == "1" else AMPBlock2
        c0 = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, c0, 7)
        ups, res = [], []
        for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                       cfg.upsample_kernel_sizes)):
            cin, cout = c0 // (2 ** i), c0 // (2 ** (i + 1))
            ups.append(nn.ModuleList([nn.ConvTranspose1d(cin, cout, k, u,
                                                       padding=(k - u) // 2)]))
            for rk, rd in zip(cfg.resblock_kernel_sizes,
                              cfg.resblock_dilation_sizes):
                res.append(block(cout, rk, rd, cfg.activation))
        self.ups = nn.ModuleList(ups)
        self.resblocks = nn.ModuleList(res)
        ch = c0 // (2 ** len(cfg.upsample_rates))
        self.activation_post = Activation1d(ch, cfg.activation)
        self.conv_post = nn.Conv1d(ch, 1, 7)


@torch.no_grad()
def bigvgan_init_(voc: BigVGAN, generator: torch.Generator) -> BigVGAN:
    """As bigvgan_init: conv weights and biases U(+-1/sqrt(fan_in)),
    upsamplers U(+-1/sqrt(C_in k)) with zero bias, snake parameters 0 in log
    scale (1 otherwise)."""
    for m in voc.modules():
        if isinstance(m, nn.ConvTranspose1d):
            bound = (m.in_channels * m.kernel_size[0]) ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Conv1d):
            bound = (m.in_channels * m.kernel_size[0]) ** -0.5
            m.weight.uniform_(-bound, bound, generator=generator)
            m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Snake):
            for p in m.parameters():
                p.fill_(0.0 if voc.cfg.snake_logscale else 1.0)
    return voc


def _snake_args(act: Activation1d, cfg: BigVGANConfig, fast: bool) -> dict:
    return dict(beta=getattr(act.act, "beta", None), logscale=cfg.snake_logscale,
                has_beta=cfg.activation == "snakebeta", fast_sin2=fast)


def _act(act: Activation1d, x, cfg, fast, kernels: bool):
    """The activation of an unfused site: K1 (its plain version without
    kernels), or the leaky ReLU."""
    if cfg.activation == "lrelu":
        return F.leaky_relu(x, LRELU_SLOPE)
    snake = aa_snake_fused if kernels else aa_snake_plain
    return snake(x, act.act.alpha, **_snake_args(act, cfg, fast))


def _fused_site(act: Activation1d, conv: nn.Conv1d, x, k, d, cfg, fast):
    a = _snake_args(act, cfg, fast)
    return conv_snake_fused(x, act.act.alpha, a.pop("beta"), conv.weight,
                            conv.bias, k=k, dilation=d, **a)


@torch.no_grad()
def quantize_bigvgan(voc: BigVGAN, min_ch: Optional[int] = None) -> BigVGAN:
    """A copy of `voc` whose resblock convs in stages of at least min_ch
    channels (default 384, MAA3_VOC_QUANT_MIN_CH overrides) are int8
    (quantize_conv_int8, from the fp32 weights); conv_pre, the upsamplers,
    conv_post and the activations stay float (maa3_tpu/models/bigvgan.py:227)."""
    if min_ch is None:
        min_ch = int(os.environ.get("MAA3_VOC_QUANT_MIN_CH", "384"))
    q = copy.deepcopy(voc)
    cfg = q.cfg
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        if cfg.upsample_initial_channel // (2 ** (i + 1)) < min_ch:
            continue
        for rb in q.resblocks[i * nk:(i + 1) * nk]:
            for convs in (getattr(rb, n) for n in ("convs1", "convs2", "convs")
                          if hasattr(rb, n)):
                for j, c in enumerate(convs):
                    convs[j] = quantize_conv_int8(c.weight, c.bias)
    return q


def _conv_site(conv, x, k, d, compute_dtype):
    """One stride-1 conv; an int8 site runs w8a8 on its input cast to the
    compute dtype: tap-GEMMs from MAA3_VOC_QUANT_TAPGEMM_MIN_CH (256)
    channels up, else the unfold GEMM."""
    pad = (k * d - d) // 2
    if isinstance(conv, QuantConv1d):
        xq = x.to(compute_dtype) if compute_dtype is not None else x
        tap_min = int(os.environ.get("MAA3_VOC_QUANT_TAPGEMM_MIN_CH", "256"))
        fn = conv1d_tapgemm_w8a8 if x.shape[1] >= tap_min else conv1d_unfold_w8a8
        return fn(conv, xq, padding=pad, dilation=d)
    return conv1d(x, conv.weight, conv.bias, padding=pad, dilation=d,
                  compute_dtype=compute_dtype)


def _act_conv(act: Activation1d, conv: nn.Conv1d, x, k, d, cfg, compute_dtype,
              fused: bool, fast: bool, kernels: bool):
    """One act -> conv site: K2 when fused (not an int8 site), else the
    activation and a conv."""
    if fused and kernels and not isinstance(conv, QuantConv1d):
        return _fused_site(act, conv, x.to(compute_dtype), k, d, cfg, fast)
    return _conv_site(conv, _act(act, x, cfg, fast, kernels), k, d, compute_dtype)


def _residual_steps(rb):
    """Per dilation, the (activation, conv, dilation) sites of one residual
    step: AMPBlock1 two (convs1 at d, convs2 at 1), AMPBlock2 one."""
    if isinstance(rb, AMPBlock1):
        return [((rb.activations[2 * i], rb.convs1[i], d),
                 (rb.activations[2 * i + 1], rb.convs2[i], 1))
                for i, d in enumerate(rb.dilations)]
    return [((rb.activations[i], rb.convs[i], d),) for i, d in enumerate(rb.dilations)]


def _amp_apply(rb, x, cfg, compute_dtype, fused: bool, fast: bool, kernels: bool):
    """AMPBlock1 / AMPBlock2 (maa3_tpu/models/bigvgan.py:355-419)."""
    for sites in _residual_steps(rb):
        xt = x
        for act, conv, d in sites:
            xt = _act_conv(act, conv, xt, rb.k, d, cfg, compute_dtype, fused, fast,
                           kernels)
        x = xt + x
    return x


def bigvgan_apply(voc: BigVGAN, mel: torch.Tensor,
                  compute_dtype: torch.dtype = torch.float32,
                  kernels: bool = True) -> torch.Tensor:
    """mel (B, num_mels, T) -> wav (B, T * prod(upsample_rates)).

    kernels=True (serving, and the vocoder GAN's discriminator step) routes
    the activations through K1 / K2 and runs without autograd; kernels=False
    is the differentiable route: the plain activation and a conv at every
    site, with the graph kept for a backward."""
    if kernels:
        with torch.no_grad():
            return _forward(voc, mel, compute_dtype, True)
    return _forward(voc, mel, compute_dtype, False)


def _forward(voc: BigVGAN, mel, compute_dtype, kernels: bool):
    cfg = voc.cfg
    fast = use_fast_sin2(compute_dtype)
    nk = len(cfg.resblock_kernel_sizes)
    x = _conv_site(voc.conv_pre, mel, 7, 1, compute_dtype)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = voc.ups[i][0]
        pad = (k - u) // 2
        if k <= 3 * u and k - 2 * pad == u:
            x = conv_transpose1d_polyphase(x, up.weight, up.bias, u, pad,
                                           compute_dtype)
        else:
            x = conv_transpose1d(x, up.weight, up.bias, u, pad,
                                 compute_dtype=compute_dtype)
        fused = cfg.activation != "lrelu" and x.shape[1] <= FUSED_MAX_CH
        xs = None
        for j in range(nk):
            y = _amp_apply(voc.resblocks[i * nk + j], x, cfg, compute_dtype,
                           fused, fast, kernels)
            xs = y if xs is None else xs + y
        x = xs / nk
    x = _act_conv(voc.activation_post, voc.conv_post, x, 7, 1, cfg, compute_dtype,
                  cfg.activation != "lrelu" and x.shape[1] <= FUSED_MAX_CH, fast,
                  kernels)
    return torch.tanh(x)[:, 0, :]
