"""Port Next-DiT and CFM sampler against the JAX package: the same weights
(weights.params_from_jax after unfreeze_zero_init, so no block is an
identity) and the same numpy inputs. fp32: rtol 1e-3 / atol 1e-4. The bf16
serving form is held to atol = rtol = 5e-2 on O(1) velocities: both sides
round activations and weights to bf16 (8 significant bits) at every GEMM,
in slightly different places (the port rounds q.k before scaling)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.diffusion import cfm as jcfm
from maa3_tpu.models import dit as jdit
from maa3_tpu.utils.nprand import cast_matmul_weights, fuse_dit_gemms, unfreeze_zero_init
from maa3_tpu_torch.diffusion import cfm as tcfm
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.weights import dit_from_jax

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-4)
CFG = dict(in_channels=4, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32)


def _pair(**over):
    cfg = dict(CFG, **over)
    jcfg = jdit.DiTConfig(**cfg)
    p = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(0), jcfg),
                           jax.random.PRNGKey(1))
    if cfg.get("qk_norm"):
        att = dict(p["blocks"]["attention"])
        for nm in ("q_norm", "k_norm", "ky_norm"):
            att[nm] = {"weight": att[nm]["weight"] * 1.1,
                       "bias": att[nm]["bias"] + 0.05}
        p = dict(p, blocks=dict(p["blocks"], attention=att))
    m = tdit.DiT(tdit.DiTConfig(**cfg))
    m.load_state_dict(dit_from_jax(jax.tree.map(np.asarray, p)))
    return jcfg, p, m


def _inputs(b=2, t=16, ly=6, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, 4, t).astype(np.float32)
    ctx = rng.randn(b, ly, 32).astype(np.float32)
    mask = np.ones((b, ly), bool)
    mask[-1, ly // 2:] = False
    return x, ctx, mask


def _cmp(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


@pytest.mark.parametrize("over", [{}, {"qk_norm": True, "n_kv_heads": 2}])
def test_dit_apply_matches_jax(over):
    jcfg, p, m = _pair(**over)
    x, ctx, mask = _inputs()
    t = np.array([41, 977], np.int32)
    want = jdit.dit_apply(p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                          context_mask=jnp.asarray(mask), compute_dtype=jnp.float32)
    got = tdit.dit_apply(m, torch.tensor(x), torch.tensor(t), torch.tensor(ctx),
                         context_mask=torch.tensor(mask), compute_dtype=torch.float32)
    _cmp(got, want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2  # blocks contribute


def test_dit_planned_matches_jax():
    jcfg, p, m = _pair()
    x, ctx, mask = _inputs(b=4)
    t_ints = np.array([0, 333, 666], np.int32)
    jp = jdit.dit_sample_plan(p, jcfg, jnp.asarray(t_ints), jnp.asarray(ctx),
                              context_mask=jnp.asarray(mask), compute_dtype=jnp.float32)
    tp = tdit.dit_sample_plan(m, torch.tensor(t_ints), torch.tensor(ctx),
                              context_mask=torch.tensor(mask), compute_dtype=torch.float32)
    _cmp(tp["mods"], jp["mods"])
    _cmp(tp["final"], jp["final"])
    for d in range(2):  # the port's plan is head-major (B, H, Ly, D)
        _cmp(tp["yk"][d].transpose(1, 2).flatten(2), jp["yk"][d])
        _cmp(tp["yv"][d].transpose(1, 2).flatten(2), jp["yv"][d])
    want = jdit.dit_apply_planned(p, jcfg, jnp.asarray(x), jp["mods"][1], jp["final"][1],
                                  jp["yk"], jp["yv"], y_mask=jnp.asarray(mask),
                                  compute_dtype=jnp.float32)
    got = tdit.dit_apply_planned(m, torch.tensor(x), tp["mods"][1], tp["final"][1],
                                 tp["yk"], tp["yv"], y_mask=torch.tensor(mask),
                                 compute_dtype=torch.float32)
    _cmp(got, want)


def test_dit_bf16_serving_matches_jax():
    """Serving form: bf16-rounded matmul weights, fused q/k/v and w1/w3,
    fp32 residual (system.py:421-433)."""
    jcfg, p, m = _pair()
    jcfg = dataclasses.replace(jcfg, fp32_residual=True)
    ps = fuse_dit_gemms(cast_matmul_weights(p, jnp.bfloat16))
    s = tdit.serving_copy(m, torch.bfloat16)
    s.cfg = dataclasses.replace(s.cfg, fp32_residual=True)
    x, ctx, _ = _inputs()
    t_ints = np.array([0, 500], np.int32)
    jp = jdit.dit_sample_plan(ps, jcfg, jnp.asarray(t_ints), jnp.asarray(ctx))
    tp = tdit.dit_sample_plan(s, torch.tensor(t_ints), torch.tensor(ctx))
    want = jdit.dit_apply_planned(ps, jcfg, jnp.asarray(x), jp["mods"][1],
                                  jp["final"][1], jp["yk"], jp["yv"])
    got = tdit.dit_apply_planned(s, torch.tensor(x), tp["mods"][1], tp["final"][1],
                                 tp["yk"], tp["yv"])
    assert got.dtype == torch.float32
    _cmp(got, want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("steps,t_start", [(25, None), (10, 3), (2, None)])
def test_time_grid_matches_jax(steps, t_start):
    np.testing.assert_array_equal(tcfm.euler_t_grid(steps, t_start),
                                  np.asarray(jcfm.euler_t_grid(steps, t_start)))
    np.testing.assert_array_equal(tcfm.planned_t_ints(steps, t_start),
                                  np.asarray(jcfm.planned_t_ints(steps, t_start)))


def test_sample_cfg_plain_and_planned_match_jax():
    jcfg, p, m = _pair()
    x0, ctx, mask = _inputs(seed=1)
    unc = np.random.RandomState(2).randn(*ctx.shape).astype(np.float32)
    steps, scale = 4, 5.0

    def jvel(x, t, c):
        return jdit.dit_apply(p, jcfg, x, t, c, compute_dtype=jnp.float32)

    want = jcfm.sample_cfg(jvel, jnp.asarray(x0), jnp.asarray(ctx), jnp.asarray(unc),
                           scale, steps=steps)

    def tvel(x, t, c):
        return tdit.dit_apply(m, x, t, c, compute_dtype=torch.float32)

    with torch.no_grad():
        got = tcfm.sample_cfg(tvel, torch.tensor(x0), torch.tensor(ctx),
                              torch.tensor(unc), scale, steps=steps)
    _cmp(got, want)

    ctx_in = np.concatenate([unc, ctx])
    t_ints = jcfm.planned_t_ints(steps)
    jp = jdit.dit_sample_plan(p, jcfg, t_ints, jnp.asarray(ctx_in),
                              compute_dtype=jnp.float32)
    want_p = jcfm.sample_cfg_planned(
        lambda xi, xs: jdit.dit_apply_planned(p, jcfg, xi, xs[0], xs[1], jp["yk"],
                                              jp["yv"], compute_dtype=jnp.float32),
        jnp.asarray(x0), (jp["mods"], jp["final"]), scale, steps=steps)
    tp = tdit.dit_sample_plan(m, torch.tensor(np.asarray(t_ints)), torch.tensor(ctx_in),
                              compute_dtype=torch.float32)
    with torch.no_grad():
        got_p = tcfm.sample_cfg_planned(
            lambda xi, s: tdit.dit_apply_planned(m, xi, tp["mods"][s], tp["final"][s],
                                                 tp["yk"], tp["yv"],
                                                 compute_dtype=torch.float32),
            torch.tensor(x0), steps - 1, scale, steps=steps)
    _cmp(got_p, want_p)
    _cmp(got_p, want)
