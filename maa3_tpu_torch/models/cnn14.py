"""Cnn14 (PANNs), the CLAP audio tower for the CLAP score (counterpart of
maa3_tpu/models/cnn14.py; wav_evaluation/models/audio.py:12-180).

wav (B, L) at 44.1 kHz -> power spectrogram (reflect pad 512, periodic
Hann 1024, hop 320) -> 64-bin slaney mel (50 Hz - 14 kHz) -> 10 log10
clipped at 1e-10 -> bn0 over the mel axis -> 6 conv blocks (3x3 conv, BN,
ReLU twice; 2x2 average pool, none after the last) -> mean over mel, max
plus mean over time -> fc1 + ReLU: the 2048-d embedding (fc_audioset: the
527 AudioSet logits). Inference only: BatchNorm from running statistics.
Keys are PANNs': bn0, conv_block{1..6}.{conv1,conv2,bn1,bn2}, fc1,
fc_audioset (the torchlibrosa frontend's spectrogram_extractor.* and
logmel_extractor.* are skipped at import: the port computes them). The
channel widths 64 .. 2048 are fixed.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maa3_tpu_torch.ops.basic import BatchNorm2d
from maa3_tpu_torch.ops.stft import _dft_basis, frame_signal, mel_filterbank, reflect_pad

CHANNELS = (1, 64, 128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class Cnn14Config:
    sample_rate: int = 44100
    window_size: int = 1024
    hop_size: int = 320
    mel_bins: int = 64
    fmin: float = 50.0
    fmax: float = 14000.0
    classes_num: int = 527
    out_emb: int = 2048


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.bn2 = BatchNorm2d(cout)


class Cnn14(nn.Module):
    def __init__(self, cfg: Cnn14Config = Cnn14Config()):
        super().__init__()
        self.cfg = cfg
        self.bn0 = BatchNorm2d(cfg.mel_bins)
        for i in range(6):
            setattr(self, f"conv_block{i + 1}", ConvBlock(CHANNELS[i], CHANNELS[i + 1]))
        self.fc1 = nn.Linear(2048, cfg.out_emb)
        self.fc_audioset = nn.Linear(cfg.out_emb, cfg.classes_num)


@torch.no_grad()
def cnn14_init_(m: Cnn14, generator: torch.Generator) -> Cnn14:
    """As cnn14_init: conv weights N(0, 2 / (C_in 9)), unit BN with zero
    mean and unit variance, xavier-uniform Linears with zero bias."""
    for mod in m.modules():
        if isinstance(mod, nn.Conv2d):
            std = float(np.sqrt(2.0 / (mod.in_channels * 9)))
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=generator) * std)
        elif isinstance(mod, nn.Linear):
            fan_out, fan_in = mod.weight.shape
            lim = (6.0 / (fan_in + fan_out)) ** 0.5
            mod.weight.uniform_(-lim, lim, generator=generator)
            mod.bias.zero_()
    return m


@lru_cache(maxsize=8)
def _cnn14_mel_basis(cfg: Cnn14Config, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.window_size, cfg.mel_bins,
                                           cfg.fmin, cfg.fmax)).to(device)


def cnn14_logmel(wav: torch.Tensor, cfg: Cnn14Config) -> torch.Tensor:
    """(B, L) -> (B, 1, T, mel): power spectrogram (center=True) -> 10 log10
    mel (maa3_tpu/models/cnn14.py:102)."""
    n_fft = cfg.window_size
    frames = frame_signal(reflect_pad(wav.float(), n_fft // 2), n_fft, cfg.hop_size)
    cos_b, sin_b = _dft_basis(n_fft, n_fft, "hann", wav.device)
    re, im = frames @ cos_b, frames @ sin_b
    mel = (re * re + im * im) @ _cnn14_mel_basis(cfg, wav.device).T
    return (10.0 * torch.log10(mel.clamp(min=1e-10)))[:, None]


def cnn14_apply_logmel(m: Cnn14, logmel: torch.Tensor) -> dict:
    """The conv backbone from a (B, 1, T, mel) log-mel
    (maa3_tpu/models/cnn14.py:121)."""
    x = m.bn0(logmel.transpose(1, 3)).transpose(1, 3)   # BN over the mel axis
    for i in range(1, 7):
        blk = getattr(m, f"conv_block{i}")
        x = F.relu(blk.bn1(blk.conv1(x)))
        x = F.relu(blk.bn2(blk.conv2(x)))
        if i < 6:
            x = F.avg_pool2d(x, 2)
    x = x.mean(dim=3)
    x = x.amax(dim=2) + x.mean(dim=2)
    x = F.relu(m.fc1(x))
    return {"embedding": x, "clipwise_output": torch.sigmoid(m.fc_audioset(x))}


def cnn14_apply(m: Cnn14, wav: torch.Tensor) -> dict:
    """wav (B, L) -> {"embedding": (B, out_emb), "clipwise_output": (B, classes)}."""
    return cnn14_apply_logmel(m, cnn14_logmel(wav, m.cfg))
