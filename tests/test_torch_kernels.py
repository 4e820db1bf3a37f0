"""The port's K1/K2 plain versions against the JAX Pallas kernels (run in
interpret mode, as tests/test_pallas_aa.py and tests/test_pallas_amp.py run
them), and the CUDA sources' filter constants against the Python filters.

Tolerances: fp32 atol 2e-5 / rtol 1e-4 for the activation (same math, only
the FIR summation order differs) and atol 1e-4 / rtol 1e-3 for act->conv
(conv sums of up to 11 * C_in terms). bf16 atol = rtol = 3e-2: bf16 keeps
8 significant bits (one rounding is up to 2^-8 relative), and the TPU
kernels round more intermediates to bf16 (the MXU variant stores the snake
phases in bf16, the conv kernel its activation and weights) than the plain
version, which rounds only its output.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.ops.pallas_aa_snake import _aa_snake_fused
from maa3_tpu.ops.pallas_amp import conv_snake_fused as jax_conv_snake
from maa3_tpu_torch.ops import pallas_aa_snake as k1
from maa3_tpu_torch.ops import pallas_amp as k2
from maa3_tpu_torch.ops.resample import COS_PI_COEF, F_DN, F_UP

torch.set_num_threads(2)

BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _inputs(shape, has_beta, seed=0):
    rng = np.random.RandomState(seed)
    B, C, T = shape
    x = (rng.randn(B, C, T) * 2.0).astype(np.float32)
    alpha = (rng.randn(C) * 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.5).astype(np.float32) if has_beta else None
    return x, alpha, beta


def _np(t):
    return np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("shape,tile,mxu", [
    ((2, 8, 300), 128, False),   # ragged last tile, shift-add body
    ((2, 8, 300), 128, True),    # ragged last tile, banded-FIR body
    ((1, 6, 100), 8192, True),   # T < tile
    ((1, 4, 261), 128, False),   # tail of 5 columns
    ((1, 4, 1), 128, False),     # one sample: every phase is an edge value
    ((2, 3, 5), 128, True),      # shorter than the 12-tap filters
    ((1, 4, 17), 128, False),    # odd, shorter than a kernel run and halo
    ((2, 4, 40), 128, True),     # one kernel run plus a partial one
])
@pytest.mark.parametrize("has_beta,logscale", [(True, True), (False, True),
                                               (False, False)])
def test_aa_snake_plain_matches_pallas_fp32(shape, tile, mxu, has_beta, logscale):
    x, a, b = _inputs(shape, has_beta)
    want = _aa_snake_fused(jnp.asarray(x), jnp.asarray(a),
                           None if b is None else jnp.asarray(b),
                           logscale=logscale, has_beta=has_beta, tile=tile,
                           interpret=True, fast_sin2=False, mxu_fir=mxu)
    got = k1.aa_snake_fused(torch.tensor(x), torch.tensor(a),
                            None if b is None else torch.tensor(b),
                            logscale=logscale, has_beta=has_beta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("mxu", [False, True])
def test_aa_snake_plain_matches_pallas_bf16_fast_sin2(mxu):
    x, a, b = _inputs((2, 16, 300), True, seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = _aa_snake_fused(xb, jnp.asarray(a), jnp.asarray(b), tile=128,
                           interpret=True, fast_sin2=True, mxu_fir=mxu)
    got = k1.aa_snake_fused(torch.tensor(x).bfloat16(), torch.tensor(a),
                            torch.tensor(b), fast_sin2=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16_TOL)


@pytest.mark.parametrize("k,d,c_out,shape,tile", [
    (3, 1, 8, (2, 8, 300), 128),     # ragged last tile
    (7, 3, 4, (1, 8, 300), 128),     # C_out != C_in
    (11, 5, 8, (1, 8, 100), None),   # T < tile, widest halo
    (7, 1, 1, (2, 6, 200), None),    # conv_post shape: C_out = 1
])
@pytest.mark.parametrize("has_beta", [True, False])
def test_conv_snake_plain_matches_pallas_fp32(k, d, c_out, shape, tile, has_beta):
    x, a, b = _inputs(shape, has_beta, seed=k + d)
    rng = np.random.RandomState(1)
    w = (rng.randn(c_out, shape[1], k) / np.sqrt(shape[1] * k)).astype(np.float32)
    bias = (rng.randn(c_out) * 0.1).astype(np.float32)
    want = jax_conv_snake(jnp.asarray(x), jnp.asarray(a),
                          None if b is None else jnp.asarray(b), jnp.asarray(w),
                          jnp.asarray(bias), k=k, dilation=d, has_beta=has_beta,
                          tile=tile, interpret=True, fast_sin2=False)
    got = k2.conv_snake_fused(torch.tensor(x), torch.tensor(a),
                              None if b is None else torch.tensor(b),
                              torch.tensor(w), torch.tensor(bias), k=k,
                              dilation=d, has_beta=has_beta)
    assert got.shape == (shape[0], c_out, shape[2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("k,d", [(3, 1), (11, 5)])
def test_conv_snake_plain_matches_pallas_bf16_fast_sin2(k, d):
    x, a, b = _inputs((2, 8, 300), True, seed=5)
    rng = np.random.RandomState(2)
    w = (rng.randn(8, 8, k) / np.sqrt(8 * k)).astype(np.float32)
    bias = (rng.randn(8) * 0.1).astype(np.float32)
    want = jax_conv_snake(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                          jnp.asarray(b), jnp.asarray(w), jnp.asarray(bias), k=k,
                          dilation=d, tile=128, interpret=True, fast_sin2=True)
    got = k2.conv_snake_fused(torch.tensor(x).bfloat16(), torch.tensor(a),
                              torch.tensor(b), torch.tensor(w), torch.tensor(bias),
                              k=k, dilation=d, fast_sin2=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **BF16_TOL)


def test_cpu_wrappers_do_not_count_launches():
    x, a, b = _inputs((1, 4, 64), True)
    n1, n2 = k1.launches, k2.launches
    k1.aa_snake_fused(torch.tensor(x), torch.tensor(a), torch.tensor(b))
    w = torch.zeros(4, 4, 3)
    k2.conv_snake_fused(torch.tensor(x), torch.tensor(a), torch.tensor(b), w,
                        torch.zeros(4), k=3)
    assert (k1.launches, k2.launches) == (n1, n2)


def test_cuda_filter_constants_match_python():
    src = (Path(k1.__file__).resolve().parent.parent / "csrc" / "snake.cuh").read_text()

    def table(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return np.array([float(v.strip().rstrip("f")) for v in body.split(",")],
                        np.float32)

    np.testing.assert_array_equal(table("kFUp"), F_UP)
    np.testing.assert_array_equal(table("kFDn"), F_DN)
    np.testing.assert_array_equal(table("kCosPi"),
                                  np.asarray(COS_PI_COEF, np.float32))
    inv_pi = float(re.search(r"kInvPi = ([0-9.e+-]+)f", src).group(1))
    assert np.float32(inv_pi) == np.float32(1.0 / np.pi)
