"""The port's flash attention (maa3_tpu_torch/ops/flash_attention.py, plain
PyTorch versions on the CPU) against the JAX package's Pallas flash
attention in interpret mode: the same numpy inputs, fp32, o, lse and the
gradients of q, k, v at rtol 1e-3 / atol 1e-4, on both routes (direct, and
online through block_k), masked and maskless. Also the two places where the
port departs from the JAX bodies on purpose: a query row whose keys are all
masked, and the maskless backward with very negative scores."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.models import dit as jdit
from maa3_tpu.ops import flash_attention as jfa
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-4)


def _inputs(b, h, l, d, masked, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, l, d).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = np.ones((b, l), bool)
        mask[-1, int(0.6 * l):] = False
    return q, k, v, do, mask


def _port(q, k, v, do, mask, block_k=None):
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    tm = None if mask is None else torch.tensor(mask)
    o = tfa.flash_attention(tq, tk, tv, tm, block_k=block_k)
    o.backward(torch.tensor(do))
    return o.detach(), tq.grad, tk.grad, tv.grad


def _jax(q, k, v, do, mask, block_k=None):
    jm = None if mask is None else jnp.asarray(mask)

    @jax.jit
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
            a, b, c, mask=jm, block_k=block_k, interpret=True), q, k, v)
        return (o, *vjp(do))

    return run(*(jnp.asarray(a) for a in (q, k, v, do)))


@pytest.mark.parametrize("d,l", [(24, 40), (72, 200)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("block_k", [None, 16], ids=["direct", "online"])
def test_flash_matches_jax(d, l, masked, block_k):
    q, k, v, do, mask = _inputs(2, 3, l, d, masked)
    scale = 1.0 / math.sqrt(d)
    route = tfa.route_for(l, block_k)
    assert route == ("direct" if block_k is None else "online")
    want = _jax(q, k, v, do, mask, block_k)
    got = _port(q, k, v, do, mask, block_k)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    jm = None if mask is None else jnp.asarray(mask, jnp.int32)
    _, jlse = jfa._flash_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm,
                                scale, None, block_k, True, with_lse=True)
    tm = None if mask is None else torch.tensor(mask, dtype=torch.int32)
    _, tlse = tfa.flash_fwd_plain(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  tm, scale, route)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse)[:, :l, 0], **TOL)


@pytest.mark.parametrize("block_k", [None, 16], ids=["direct", "online"])
def test_fully_masked_row_gives_zero_in_the_port(block_k):
    """Batch row 1 has no valid key. The JAX bodies return sum(v) / Lk_pad
    there (Lk_pad = 48 for Lk = 40: padding-dependent) and zero gradients;
    the port returns o = 0 and zero gradients. Row 0 agrees."""
    q, k, v, do, _ = _inputs(2, 1, 40, 24, False, seed=3)
    mask = np.ones((2, 40), bool)
    mask[1] = False
    jo, jdq, jdk, jdv = (np.asarray(a) for a in _jax(q, k, v, do, mask, block_k))
    o, dq, dk, dv = (a.numpy() for a in _port(q, k, v, do, mask, block_k))
    np.testing.assert_allclose(jo[1], np.broadcast_to(v[1].sum(1, keepdims=True) / 48,
                                                      jo[1].shape), **TOL)
    for a in (o, dq, dk, dv, jdq, jdk, jdv):
        assert not np.any(a[1])
    for a, b in zip((o, dq, dk, dv), (jo, jdq, jdk, jdv)):
        np.testing.assert_allclose(a[0], b[0], **TOL)


def _dense_grads(q, k, v, do, scale):
    tq, tk, tv = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
                  for a in (q, k, v))
    o = torch.softmax(tq @ tk.transpose(-1, -2) * scale, -1) @ tv
    o.backward(torch.tensor(do, dtype=torch.float64))
    return o.detach(), tq.grad, tk.grad, tv.grad


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -3)])
def test_maskless_dq_finite_when_every_score_is_very_negative(dtype, tol):
    """The case of the exp2 clamp at maa3_tpu/ops/flash_attention.py:278:
    every score of a row far below -88 nats (lse < -88). The port's maskless
    backward sees no pad keys (Lk = 40 is not a multiple of 16), so nothing
    overflows; dq, dk, dv stay finite and match the dense softmax gradient
    in fp64 of the same rounded inputs, q taken as the kernel's rounded
    q * scale * log2(e) divided back. bf16: 2^-3 of the largest value,
    because ds is rounded to bf16 before its product with k, whose entries
    sit at -10 +- 0.5: the rounding errors of a row of ds no longer sum to
    zero and are multiplied by |k| ~ 10 (measured: dq 6 %, dk 2 %, o and dv
    0.3 % of the largest value)."""
    rng = np.random.RandomState(5)
    d = 24
    q = (10.0 + 0.1 * rng.randn(1, 2, 40, d)).astype(np.float32)
    k = (-10.0 + 0.5 * rng.randn(1, 2, 40, d)).astype(np.float32)
    v, do = (rng.randn(1, 2, 40, d).astype(np.float32) for _ in range(2))
    q, k, v, do = (torch.tensor(a).to(dtype).float().numpy() for a in (q, k, v, do))
    tq, tk, tv = (torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv)
    o.backward(torch.tensor(do).to(dtype))
    c = tfa.LOG2E / math.sqrt(d)
    qs = (torch.tensor(q) * c).to(dtype).double().numpy() / c
    ref = _dense_grads(qs, k, v, do, 1.0 / math.sqrt(d))
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o.detach(), tq.grad, tk.grad, tv.grad),
                          ref):
        a = a.float().numpy()
        assert np.isfinite(a).all(), name
        b = b.numpy()
        assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max()), name


@pytest.mark.parametrize("lk,block_k", [(312, None), (1248, None), (1536, None),
                                        (1537, None), (2048, None), (200, 64)])
def test_route_follows_jax_rule(lk, block_k):
    direct = block_k is None and jfa._round_up(lk, 16) <= jfa._FAST_LK_CAP
    assert tfa.route_for(lk, block_k) == ("direct" if direct else "online")


@pytest.mark.parametrize("use_flash", [None, True, False])
@pytest.mark.parametrize("seq", [312, 1247, 1248, 4096, 4097])
def test_flash_for_len_matches_jax(use_flash, seq):
    jc, tc = jdit.DiTConfig(use_flash=use_flash), tdit.DiTConfig(use_flash=use_flash)
    for training in (False, True):
        assert tc.flash_for_len(seq, training) == jc.flash_for_len(seq, training)
        assert tc.resolve_flash(seq, training).use_flash == \
            jc.resolve_flash(seq, training).use_flash


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 1, 8, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_fwd(q, q, q, None, 0.3, "direct")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.flash_bwd(q, q, q, None, q[0, 0, :, 0], q, q[..., 0], 0.3)
