"""STFT magnitude and log10-mel frontend (counterpart of maa3_tpu/ops/stft.py).

MelNet's recipe (preprocess/NAT_mel.py:42-85): wav clamped to [-1, 1] ->
reflect pad (n_fft - hop) / 2 on both sides -> STFT (fft 1024, hop 256, win
1024, periodic Hann, center=False) -> |.| = sqrt(re^2 + im^2 + 1e-9) ->
slaney mel filterbank (fmin 0, fmax sr / 2) -> log10(clamp(x, 1e-5)).

Kept in the JAX package's form: the frames (an unfold) times a precomputed
windowed real-DFT basis, then the mel product. No hand-written kernel: the
JAX package computes this outside Pallas, as two GEMMs and elementwise ops.
The bases are built in float64 numpy and cast to fp32 once per device.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 1024
    win_size: int = 1024
    hop_size: int = 256
    num_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None  # defaults to sample_rate / 2

    def __post_init__(self):
        if self.fmax is None:
            object.__setattr__(self, "fmax", self.sample_rate / 2)


# slaney mel scale (librosa.filters.mel with htk=False, norm="slaney")
_F_SP = 200.0 / 3
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def _hz_to_mel(f) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(np.maximum(f, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                    f / _F_SP)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), m * _F_SP)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) slaney-normalised triangular filterbank."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def stft_constants(n_fft: int, win_size: int,
                   window: str = "hann") -> Tuple[np.ndarray, np.ndarray]:
    """Windowed real-DFT basis: (n_fft, n_fft // 2 + 1) cos and -sin.

    "hann" is torch.stft's periodic Hann (the mel frontend); "ones" is
    torch.stft without a window (rectangular, centred in n_fft when win_size
    < n_fft), which BigVGAN's MRD spectrogram uses (models.py:321-329)."""
    if window == "ones":
        win = np.ones(win_size)
    elif window == "hann":
        win = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win_size) / win_size)
    else:
        raise ValueError(f"unknown window {window!r}")
    if win_size < n_fft:
        pad = (n_fft - win_size) // 2
        win = np.pad(win, (pad, n_fft - win_size - pad))
    ang = 2 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_fft // 2 + 1)[None, :] / n_fft
    return ((np.cos(ang) * win[:, None]).astype(np.float32),
            (-np.sin(ang) * win[:, None]).astype(np.float32))


@lru_cache(maxsize=16)
def _dft_basis(n_fft: int, win_size: int, window: str, device: torch.device):
    cos_b, sin_b = stft_constants(n_fft, win_size, window)
    return torch.from_numpy(cos_b).to(device), torch.from_numpy(sin_b).to(device)


@lru_cache(maxsize=16)
def _mel_basis(cfg: MelConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.num_mels,
                                           cfg.fmin, cfg.fmax)).to(device)


def frame_signal(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, L) -> (B, 1 + (L - n_fft) // hop, n_fft) frames, center=False."""
    return y.unfold(-1, n_fft, hop)


def reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, L) reflect-padded by `pad` samples on both sides."""
    return F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0]


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int, win_size: int,
                   window: str = "hann") -> torch.Tensor:
    """(B, L) -> (B, n_fft // 2 + 1, frames) magnitude as torch.stft gives it
    (center=False), sqrt(re^2 + im^2 + 1e-9) as in NAT_mel.py:79."""
    frames = frame_signal(y.float(), n_fft, hop)
    cos_b, sin_b = _dft_basis(n_fft, win_size, window, y.device)
    re, im = frames @ cos_b, frames @ sin_b
    return torch.sqrt(re * re + im * im + 1e-9).transpose(1, 2)


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, L) wav -> (B, num_mels, L // hop) log10-mel (L a multiple of hop)."""
    y = reflect_pad(y.float().clamp(-1.0, 1.0), (cfg.n_fft - cfg.hop_size) // 2)
    mag = stft_magnitude(y, cfg.n_fft, cfg.hop_size, cfg.win_size)
    mel = torch.matmul(_mel_basis(cfg, y.device), mag)
    return torch.log10(mel.clamp(min=1e-5))
