"""Port ops (maa3_tpu_torch/ops) against the JAX ops on the same numpy
inputs, fp32 on the CPU: rtol 1e-3 / atol 1e-4 unless stated (as
tests/test_torch_import.py:191); the filter constants are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.ops import attention as jatt
from maa3_tpu.ops import basic as jb
from maa3_tpu.ops import conv as jconv
from maa3_tpu.ops import ffn as jffn
from maa3_tpu.ops import resample as jrs
from maa3_tpu.ops import rope as jrope
from maa3_tpu.utils.nprand import fuse_dit_gemms
from maa3_tpu_torch import weights
from maa3_tpu_torch.ops import attention as tatt
from maa3_tpu_torch.ops import basic as tb
from maa3_tpu_torch.ops import conv as tconv
from maa3_tpu_torch.ops import ffn as tffn
from maa3_tpu_torch.ops import resample as trs
from maa3_tpu_torch.ops import rope as trope

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-4)


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _cmp(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def test_dense_norms_modulate():
    x, w, b = _r(3, 5, 8), _r(8, 6, seed=1), _r(6, seed=2)
    jw = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    _cmp(tb.dense(torch.tensor(x), torch.tensor(w.T), torch.tensor(b)),
         jb.dense(jw, jnp.asarray(x)))
    # bf16 compute: both sides cast operands to bf16 and return bf16
    got = tb.dense(torch.tensor(x), torch.tensor(w.T), torch.tensor(b), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _cmp(got, jb.dense(jw, jnp.asarray(x), jnp.bfloat16), rtol=2e-2, atol=2e-2)
    g, beta = _r(8, seed=3), _r(8, seed=4)
    _cmp(tb.rms_norm(torch.tensor(g), torch.tensor(x)),
         jb.rms_norm({"weight": jnp.asarray(g)}, jnp.asarray(x)))
    _cmp(tb.layer_norm(torch.tensor(x), torch.tensor(g), torch.tensor(beta), 1e-5),
         jb.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta), 1e-5))
    xc, gc, bc = _r(2, 64, 10, seed=5), _r(64, seed=6), _r(64, seed=7)
    _cmp(tb.group_norm(torch.tensor(xc), torch.tensor(gc), torch.tensor(bc)),
         jb.group_norm(jnp.asarray(xc), jnp.asarray(gc), jnp.asarray(bc)))
    sh, sc = _r(3, 8, seed=8), _r(3, 8, seed=9)
    _cmp(tb.modulate(torch.tensor(x), torch.tensor(sh), torch.tensor(sc)),
         jb.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)))


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding(dim):
    """Arguments reach ~1000 rad, where one ulp of exp() in the frequencies
    moves cos/sin by ~3e-5: the standard fp32 tolerance."""
    t = np.array([0, 41, 500, 999], np.int32)
    _cmp(tb.timestep_embedding(torch.tensor(t), dim),
         jb.timestep_embedding(jnp.asarray(t), dim))


def test_rope():
    c_t, s_t = trope.precompute_rope(24, 50, rope_scaling_factor=2.0, ntk_factor=1.5)
    c_j, s_j = jrope.precompute_rope(24, 50, rope_scaling_factor=2.0, ntk_factor=1.5)
    _cmp(c_t, c_j, rtol=1e-5, atol=1e-5)
    _cmp(s_t, s_j, rtol=1e-5, atol=1e-5)
    q, k = _r(2, 7, 3, 24), _r(2, 7, 2, 24, seed=1)
    qt, kt = trope.apply_rope(torch.tensor(q), torch.tensor(k), c_t, s_t)
    qj, kj = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), c_j, s_j)
    _cmp(qt, qj)
    _cmp(kt, kj)


def test_swiglu_and_ffn():
    for args in [(64, 256, 32, None), (1152, 4608, 256, None), (768, 3072, 256, 1.3)]:
        assert tffn.swiglu_hidden_dim(*args) == jffn.swiglu_hidden_dim(*args)
    p = jffn.feed_forward_init(jax.random.PRNGKey(0), 32, 128, 16)
    ff = tffn.FeedForward(32, 128, 16)
    sd = {}
    for nm in ("w1", "w2", "w3"):
        weights._lin(sd, nm, jax.tree.map(np.asarray, p[nm]))
    ff.load_state_dict(sd)
    x = _r(2, 5, 32)
    want = jffn.feed_forward_apply(p, jnp.asarray(x))
    _cmp(tffn.feed_forward_apply(ff, torch.tensor(x)), want)
    ff.w13 = torch.cat([ff.w1.weight, ff.w3.weight]).detach()  # fused serving form
    _cmp(tffn.feed_forward_apply(ff, torch.tensor(x)), want)


def _attention_pair(n_heads, n_kv, qk_norm, seed=0):
    p = jatt.attention_init(jax.random.PRNGKey(seed), 32, n_heads, n_kv, qk_norm,
                            y_dim=24)
    p = dict(p, gate=jnp.linspace(-0.7, 0.9, n_heads))
    if qk_norm:
        for nm in ("q_norm", "k_norm", "ky_norm"):
            p[nm] = {"weight": 1.0 + 0.1 * jnp.arange(p[nm]["weight"].shape[0]),
                     "bias": 0.05 * jnp.ones_like(p[nm]["bias"])}
    m = tatt.Attention(32, n_heads, n_kv, qk_norm, 24)
    pn = jax.tree.map(np.asarray, p)
    sd = {"gate": torch.tensor(pn["gate"])}
    for nm in ("wq", "wk", "wv", "wo", "wk_y", "wv_y"):
        weights._lin(sd, nm, pn[nm])
    for nm in ("q_norm", "k_norm", "ky_norm"):
        if nm in pn:
            weights._vec(sd, nm, pn[nm])
    m.load_state_dict(sd)
    return p, m


@pytest.mark.parametrize("n_heads,n_kv,qk_norm", [(4, None, False), (4, 2, True)])
def test_attention_masks_gqa_qknorm(n_heads, n_kv, qk_norm):
    p, m = _attention_pair(n_heads, n_kv, qk_norm)
    x, y = _r(2, 9, 32, seed=1), _r(2, 5, 24, seed=2)
    xm = np.ones((2, 9), bool)
    xm[1, 6:] = False
    ym = np.ones((2, 5), bool)
    ym[0, 3:] = False
    cos, sin = jrope.precompute_rope(32 // n_heads, 9)
    want = jatt.attention_apply(p, jnp.asarray(x), cos, sin, y=jnp.asarray(y),
                                x_mask=jnp.asarray(xm), y_mask=jnp.asarray(ym),
                                n_heads=n_heads, n_kv_heads=n_kv)
    ct, st = trope.precompute_rope(32 // n_heads, 9)
    args = dict(x_mask=torch.tensor(xm), y_mask=torch.tensor(ym), n_heads=n_heads,
                n_kv_heads=n_kv)
    _cmp(tatt.attention_apply(m, torch.tensor(x), ct, st, y=torch.tensor(y), **args),
         want)
    # precomputed context K/V and the fused wqkv serving form
    ykv = tatt.context_kv(m, torch.tensor(y))
    m.wqkv = torch.cat([m.wq.weight, m.wk.weight, m.wv.weight]).detach()
    _cmp(tatt.attention_apply(m, torch.tensor(x), ct, st, y_kv=ykv, **args), want)


def test_attention_bf16_scores():
    """bf16 compute against JAX bf16 (bf16 logits storage, fp32 softmax):
    atol/rtol 3e-2, a few bf16 roundings of O(1) values."""
    p, m = _attention_pair(4, None, False, seed=3)
    pf = fuse_dit_gemms({"blocks": {"attention": p, "feed_forward": {}}})
    x, y = _r(2, 9, 32, seed=4), _r(2, 5, 24, seed=5)
    cos, sin = jrope.precompute_rope(8, 9)
    want = jatt.attention_apply(pf["blocks"]["attention"], jnp.asarray(x), cos, sin,
                                y=jnp.asarray(y), n_heads=4,
                                compute_dtype=jnp.bfloat16)
    ct, st = trope.precompute_rope(8, 9)
    got = tatt.attention_apply(m, torch.tensor(x), ct, st, y=torch.tensor(y),
                               n_heads=4, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _cmp(got, want, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 3, 1), (2, (0, 1), 1),
                                                     (1, 5, 5)])
def test_conv1d(stride, padding, dilation):
    x, w, b = _r(2, 6, 20), _r(4, 6, 3, seed=1), _r(4, seed=2)
    want = jconv.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                        stride=stride, padding=padding, dilation=dilation)
    _cmp(tconv.conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride,
                      padding, dilation), want)


@pytest.mark.parametrize("u,k", [(4, 8), (2, 4)])
def test_conv_transpose1d_and_polyphase(u, k):
    x, w, b = _r(2, 6, 11), _r(6, 4, k, seed=1), _r(4, seed=2)
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    pad = (k - u) // 2
    want = jconv.conv_transpose1d(p, jnp.asarray(x), u, pad)
    args = (torch.tensor(x), torch.tensor(w), torch.tensor(b), u, pad)
    _cmp(tconv.conv_transpose1d(*args), want)
    _cmp(tconv.conv_transpose1d_polyphase(*args), want)


def test_resample_filters_and_sin2():
    for args in [(0.25, 0.3, 12), (0.5, 0.6, 12), (0.25, 0.3, 7), (0.0, 0.3, 12)]:
        np.testing.assert_array_equal(trs.kaiser_sinc_filter1d(*args),
                                      jrs.kaiser_sinc_filter1d(*args))
    u = np.linspace(-40, 40, 4001).astype(np.float32)
    _cmp(trs.sin2_poly(torch.tensor(u)), jrs.sin2_poly(jnp.asarray(u)),
         rtol=0, atol=2e-6)
    np.testing.assert_allclose(trs.sin2_poly(torch.tensor(u)).numpy(),
                               np.sin(u.astype(np.float64)) ** 2, atol=1e-5)


@pytest.mark.parametrize("T", [1, 4, 37])
def test_fused_activation_matches_jax(T):
    """FusedActivation1d, the plain base of K1/K2, at edge-dominated lengths."""
    x = _r(2, 3, T, scale=2.0)
    a = _r(3, seed=1)
    want = jrs.FusedActivation1d(lambda v: v + jnp.sin(a[None, :, None] * v) ** 2)(
        jnp.asarray(x))
    got = trs.FusedActivation1d(
        lambda v: v + torch.sin(torch.tensor(a)[None, :, None] * v) ** 2)(torch.tensor(x))
    _cmp(got, want, rtol=1e-5, atol=2e-6)
