"""SiT-style transport: interpolant paths and ODE / SDE samplers
(counterpart of maa3_tpu/diffusion/transport.py; the reference's
ldm/models/diffusion/transport/: transport.py:43, path.py:18-186,
integrators.py:8-112).

Interpolants x_t = alpha(t) x1 + sigma(t) x0 (x0 ~ N(0, I); t runs 0 -> 1,
noise -> data, as the CFM elsewhere in this package):
  linear: alpha = t,              sigma = 1 - t
  gvp:    alpha = sin(pi t / 2),  sigma = cos(pi t / 2)
  vp:     alpha / sigma from the VP log-SNR schedule

Every sampler is a Python loop over fp32 tensors; the time grids are built
as jnp.linspace builds them in fp32. dopri5 keeps t, dt and the error norm
as fp32 tensors, as JAX's `while_loop` carries them, and reads each step's
accept decision on the host (as torchdiffeq does), so both packages accept
and reject the same steps. Random draws come from `generator`, or are
given (`t=`, `x0=`, `draws=`) to replay another run's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num) in fp32: start (1 - s) + stop s with
    s = iota / (num - 1), the last point pinned to stop."""
    start32, stop32 = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start32], np.float32)
    s = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    grid = start32 * (np.float32(1) - s) + stop32 * s
    return np.append(grid, stop32).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Path:
    name: str

    def alpha_sigma(self, t: torch.Tensor):
        """(alpha, d_alpha, sigma, d_sigma) at t."""
        if self.name == "linear":
            return t, torch.ones_like(t), 1.0 - t, -torch.ones_like(t)
        if self.name == "gvp":
            a = torch.sin(math.pi / 2 * t)
            da = math.pi / 2 * torch.cos(math.pi / 2 * t)
            s = torch.cos(math.pi / 2 * t)
            ds = -math.pi / 2 * torch.sin(math.pi / 2 * t)
            return a, da, s, ds
        if self.name == "vp":
            # beta(u) = beta_min + u (beta_max - beta_min), u = 1 - t
            bmin, bmax = 0.1, 20.0
            u = 1.0 - t
            a = torch.exp(-0.25 * u ** 2 * (bmax - bmin) - 0.5 * u * bmin)
            da = 0.5 * (bmin + u * (bmax - bmin)) * a
            s = torch.sqrt(torch.clamp_min(1.0 - a ** 2, 1e-12))
            return a, da, s, -a * da / s
        raise ValueError(self.name)

    def interpolate(self, x1: torch.Tensor, x0: torch.Tensor, t: torch.Tensor):
        """(x_t, the target velocity dx_t/dt)."""
        shape = (-1,) + (1,) * (x1.dim() - 1)
        a, da, s, ds = (v.reshape(shape) for v in self.alpha_sigma(t))
        return a * x1 + s * x0, da * x1 + ds * x0


def training_losses(model_fn, path: Path, x1: torch.Tensor, context,
                    generator: Optional[torch.Generator] = None,
                    model_type: str = "velocity", t: Optional[torch.Tensor] = None,
                    x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transport.training_losses (transport.py:43): the MSE of the chosen
    parameterization; t ~ U(1e-5, 1 - 1e-5) and x0 ~ N(0, I) unless given."""
    b, dev = x1.shape[0], x1.device
    if t is None:
        t = 1e-5 + (1.0 - 2e-5) * torch.rand((b,), generator=generator, device=dev)
    if x0 is None:
        x0 = torch.randn(x1.shape, generator=generator, device=dev, dtype=x1.dtype)
    xt, vt = path.interpolate(x1, x0, t)
    pred = model_fn(xt, t, context)
    if model_type == "velocity":
        target = vt
    elif model_type == "noise":
        target = x0
    elif model_type == "score":
        s = path.alpha_sigma(t)[2].reshape((-1,) + (1,) * (x1.dim() - 1))
        target = -x0 / torch.clamp_min(s, 1e-5)
    else:
        raise ValueError(model_type)
    return (pred - target).square().mean()


def velocity_from(model_fn, path: Path, model_type: str):
    """A velocity field from a velocity, noise or score model."""
    if model_type == "velocity":
        return model_fn

    def vel(x, t, c):
        shape = (-1,) + (1,) * (x.dim() - 1)
        a, da, s, ds = (v.reshape(shape) for v in path.alpha_sigma(t))
        pred = model_fn(x, t, c)
        x0 = pred if model_type == "noise" else -pred * s  # score: x0 = -score sigma
        x1 = (x - s * x0) / torch.clamp_min(a, 1e-5)
        return da * x1 + ds * x0

    return vel


def shift_time_grid(t_grid, factor: float):
    """Lumina's time-shifted grid t / (t + s - s t) (integrators.py:96-98):
    steps concentrate near t = 0 (the noise end) for s > 1."""
    return t_grid / (t_grid + factor - factor * t_grid)


def _grid(start: float, stop: float, steps: int, device) -> torch.Tensor:
    return torch.from_numpy(linspace_f32(start, stop, steps)).to(device)


def ode_sample(velocity_fn, x0: torch.Tensor, context, steps: int = 25,
               method: str = "euler",
               time_shifting_factor: Optional[float] = None) -> torch.Tensor:
    """Deterministic ODE integration t: 0 -> 1 (integrators.py ode), Euler
    or Heun."""
    t_grid = _grid(0.0, 1.0, steps, x0.device)
    if time_shifting_factor:
        t_grid = shift_time_grid(t_grid, time_shifting_factor)
    b, x = x0.shape[0], x0
    for t, t_next in zip(t_grid[:-1], t_grid[1:]):
        dt = t_next - t
        v1 = velocity_fn(x, t.expand(b), context)
        if method == "euler":
            x = x + dt * v1
        else:
            v2 = velocity_fn(x + dt * v1, t_next.expand(b), context)
            x = x + dt * 0.5 * (v1 + v2)
    return x


# Dormand-Prince 5(4) tableau (the reference's default solver: torchdiffeq
# odeint(method="dopri5"), transport.py:357,404); the 4th-order embedded
# row gives the error estimate.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def dopri5_sample(velocity_fn, x0: torch.Tensor, context,
                  t0: float = 0.0, t1: float = 1.0,
                  rtol: float = 1e-4, atol: float = 1e-4,
                  max_steps: int = 1000) -> Tuple[torch.Tensor, dict]:
    """Adaptive Dormand-Prince RK45 (torchdiffeq's dopri5, the reference's
    default). Controller: accept when the scaled RMS error <= 1;
    dt *= clip(0.9 err^(-1/5), 0.2, 5). Returns (x(t1), {n_accepted,
    n_rejected, n_evals}).

    fp32 throughout, so the reachable tolerance floors near 1e-6 relative:
    below it every step rejects until max_steps, and x is the last
    accepted state (the stats show n_rejected saturated)."""
    b, dev = x0.shape[0], x0.device
    x = x0.float()

    def f(x, t):
        return velocity_fn(x, t.expand(b), context).float()

    def rk_step(x, t, dt):
        ks = []
        for i in range(7):
            xi = x
            for aij, kj in zip(_DP_A[i], ks):
                xi = xi + dt * aij * kj
            ks.append(f(xi, t + _DP_C[i] * dt))
        x5 = x4 = x
        for b5, b4, k in zip(_DP_B5, _DP_B4, ks):
            x5 = x5 + dt * b5 * k
            x4 = x4 + dt * b4 * k
        return x5, x5 - x4

    f32 = dict(dtype=torch.float32, device=dev)
    t = torch.tensor(t0, **f32)
    dt = torch.tensor((t1 - t0) / 25.0, **f32)
    t_end = torch.tensor(t1, **f32)
    n_acc = n_rej = it = 0
    while bool(t < t1 - 1e-9) and it < max_steps:
        dt = torch.minimum(dt, t_end - t)
        x_new, err = rk_step(x, t, dt)
        scale = atol + rtol * torch.maximum(x.abs(), x_new.abs())
        e = torch.sqrt((err / scale).square().mean())
        fac = torch.clamp(0.9 * torch.pow(torch.clamp_min(e, 1e-10), -0.2), 0.2, 5.0)
        dt_next = torch.clamp(dt * fac, 1e-6, t1 - t0)
        if bool(e <= 1.0):
            x, t = x_new, t + dt
            n_acc += 1
        else:
            n_rej += 1
        dt = dt_next
        it += 1
    return x, {"n_accepted": n_acc, "n_rejected": n_rej, "n_evals": 7 * it}


def sde_sample(velocity_fn, score_fn, x0: torch.Tensor, context,
               generator: Optional[torch.Generator] = None, steps: int = 25,
               diffusion: float = 1.0,
               draws: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Euler-Maruyama: dx = [v + 0.5 w(t) score] dt + sqrt(w(t)) dW
    (integrators.py sde), w(t) = diffusion (1 - t), annealed to zero at
    t = 1; one normal per step from `generator`, or `draws[i]`."""
    t_grid = _grid(1e-3, 1.0, steps, x0.device)
    b, x = x0.shape[0], x0
    for i, (t, t_next) in enumerate(zip(t_grid[:-1], t_grid[1:])):
        dt = t_next - t
        tb = t.expand(b)
        w = diffusion * (1.0 - t)
        drift = velocity_fn(x, tb, context) + 0.5 * w * score_fn(x, tb, context)
        noise = draws[i] if draws is not None else torch.randn(
            x.shape, generator=generator, device=x.device, dtype=x.dtype)
        x = x + drift * dt + torch.sqrt(torch.clamp_min(w * dt, 0.0)) * noise
    return x
