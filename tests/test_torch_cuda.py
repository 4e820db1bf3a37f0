"""Card-only tests of the port's CUDA kernels against their plain versions,
and of the port's CUDA path against its CPU path. They skip without an
NVIDIA GPU. This file imports torch only (no JAX), so it also runs on a
machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-4 * max(1, max|ref|) (summation order, sinf vs
torch.sin, expf); bf16 two bf16 ulps of the largest value,
2^-6 * max(1, max|ref|) (both sides compute in fp32 and round once; an fp32
difference of one ulp can flip that rounding). The flash backward's dq is a
sum of per-key-tile parts added with fp32 atomics in no fixed order, so its
last bits vary from run to run; the same tolerances cover that. The split
backward (K4b's dk and dv, K4c's dq) has no atomics and must be the same bits
on every run.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from maa3_tpu_torch.ops import flash_attention as fa
from maa3_tpu_torch.ops import pallas_aa_snake as k1
from maa3_tpu_torch.ops import pallas_amp as k2
from maa3_tpu_torch.pipeline import full_fp32

torch.set_num_threads(2)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _tol(ref: torch.Tensor) -> float:
    scale = max(1.0, ref.abs().max().item())
    return (1e-4 if ref.dtype == torch.float32 else 2.0 ** -6) * scale


def _inputs(shape, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    B, C, T = shape
    x = (torch.randn(B, C, T, generator=g) * 2.0).to(dtype)
    a = torch.randn(C, generator=g) * 0.5
    b = torch.randn(C, generator=g) * 0.5
    return x.to(dev), a.to(dev), b.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 8, 300), (1, 3, 5), (2, 16, 2500),
    # the kernel's routes (32-output runs, 8-sample halos, 16-byte pieces):
    # rows of one sample, shorter than a run, one run, odd (rows off
    # 16-byte boundaries), the vocoder's widest stage (interior runs and
    # the two edge runs per row), and more rows than a grid's y dimension
    (2, 4, 1), (2, 4, 16), (2, 4, 17), (2, 4, 40), (2, 4, 1001), (2, 8, 2496),
    (1, 70000, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_beta,logscale", [(True, True), (False, False)])
def test_aa_snake_kernel_matches_plain(cuda_dev, shape, dtype, has_beta, logscale):
    x, a, b = _inputs(shape, dtype, cuda_dev)
    n = k1.launches
    got = k1.aa_snake_fused(x, a, b, logscale=logscale, has_beta=has_beta)
    torch.cuda.synchronize()
    assert k1.launches == n + 1
    want = k1.aa_snake_plain(x, a, b, logscale=logscale, has_beta=has_beta)
    assert got.dtype == dtype and got.shape == x.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("shape,offset,fast", [
    ((2, 8, 2496), 0, False), ((2, 3, 17), 0, False), ((2, 8, 2496), 1, True)])
def test_aa_snake_bf16_generic_runs_match_plain(cuda_dev, shape, offset, fast):
    """bf16 inputs that send every run of the kernel to its compact generic
    run: libm's sin (fast_sin2=False), and data that starts one element past
    a 16-byte boundary."""
    x, a, b = _inputs(shape, torch.bfloat16, cuda_dev, seed=3)
    x = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(shape)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    got = k1.aa_snake_fused(x, a, b, fast_sin2=fast)
    want = k1.aa_snake_plain(x, a, b, fast_sin2=fast)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,c_in,c_out,T", [
    (3, 1, 8, 8, 300), (7, 3, 24, 24, 1000), (11, 5, 48, 48, 600),
    (7, 1, 24, 1, 513), (3, 5, 4, 12, 7),
    # the bf16 tensor-core tiling: 256-sample tiles (T not a multiple, one
    # past, shorter than the halo E = (k d - d) / 2 <= 25), C_in padded to
    # 16 / 32 / 48, C_out to 8 / 16 / 24 / 48 output channels
    (11, 5, 48, 24, 20), (7, 3, 4, 48, 257), (3, 3, 48, 1, 2000),
    (11, 1, 24, 12, 777), (7, 5, 48, 48, 4100), (3, 1, 24, 48, 5),
    (11, 3, 4, 1, 1025), (7, 1, 4, 24, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_snake_kernel_matches_plain(cuda_dev, k, d, c_in, c_out, T, dtype):
    x, a, b = _inputs((2, c_in, T), dtype, cuda_dev, seed=k * d)
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(c_out, c_in, k, generator=g) / (c_in * k) ** 0.5).to(cuda_dev)
    bias = (torch.randn(c_out, generator=g) * 0.1).to(cuda_dev)
    n = k2.launches
    got = k2.conv_snake_fused(x, a, b, w, bias, k=k, dilation=d)
    torch.cuda.synchronize()
    assert k2.launches == n + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = k2.conv_snake_plain(x, a, b, w, bias, k=k, dilation=d)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,c_in,c_out,T", [(7, 3, 24, 24, 1000), (3, 1, 48, 1, 300)])
def test_conv_snake_bf16_libm_sin_matches_plain(cuda_dev, k, d, c_in, c_out, T):
    """bf16 with fast_sin2=False (libm's sin, the kernel's compact run path
    for every run) against the plain version."""
    x, a, b = _inputs((2, c_in, T), torch.bfloat16, cuda_dev, seed=k)
    g = torch.Generator().manual_seed(2)
    w = (torch.randn(c_out, c_in, k, generator=g) / (c_in * k) ** 0.5).to(cuda_dev)
    bias = (torch.randn(c_out, generator=g) * 0.1).to(cuda_dev)
    got = k2.conv_snake_fused(x, a, b, w, bias, k=k, dilation=d, fast_sin2=False)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = k2.conv_snake_plain(x, a, b, w, bias, k=k, dilation=d, fast_sin2=False)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err


@pytest.mark.cuda
def test_conv_snake_bf16_refuses_wide_channels(cuda_dev):
    """The bf16 kernel takes C_in, C_out <= 64; wider shapes raise (no
    fallback to the plain version)."""
    x, a, b = _inputs((1, 72, 64), torch.bfloat16, cuda_dev)
    w = torch.zeros(8, 72, 3, device=cuda_dev)
    n = k2.launches
    with pytest.raises(ValueError, match="<= 64"):
        k2.conv_snake_fused(x, a, b, w, torch.zeros(8, device=cuda_dev), k=3)
    assert k2.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,grad", [("K1", "x"), ("K1", "alpha"), ("K1", "beta"),
                                         ("K2", "x"), ("K2", "alpha"), ("K2", "beta"),
                                         ("K2", "w"), ("K2", "b")])
def test_kernels_refuse_autograd(cuda_dev, kernel, grad):
    """K1 and K2 have no backward: under grad mode, with x or a parameter
    that requires grad, they raise and name the differentiable route
    (launching nothing) instead of returning a result cut off from the
    graph; under torch.no_grad() they launch."""
    x, a, b = _inputs((2, 8, 64), torch.float32, cuda_dev)
    w = torch.randn(8, 8, 3, device=cuda_dev) * 0.1
    bias = torch.zeros(8, device=cuda_dev)
    args = dict(x=x, alpha=a, beta=b, w=w, b=bias)
    args[grad] = args[grad].clone().requires_grad_(True)
    mod = k1 if kernel == "K1" else k2

    def run():
        if kernel == "K1":
            return k1.aa_snake_fused(args["x"], args["alpha"], args["beta"])
        return k2.conv_snake_fused(args["x"], args["alpha"], args["beta"], args["w"],
                                   args["b"], k=3)

    n = mod.launches
    with pytest.raises(RuntimeError, match="kernels=False"):
        run()
    assert mod.launches == n
    with torch.no_grad():
        run()
    assert mod.launches == n + 1


@pytest.mark.cuda
def test_cuda_pipeline_matches_cpu_path(cuda_dev):
    """A small system (K1 and K2 stages) through T2APipeline.generate on the
    card against the same weights on the CPU (plain versions), fp32."""
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.dit import DiTConfig, unfreeze_zero_init
    from maa3_tpu_torch.models.vae1d import VAEConfig
    from maa3_tpu_torch.pipeline import T2APipeline

    dcfg = DiTConfig(in_channels=4, context_dim=32, hidden_size=64, depth=2,
                     num_heads=4, multiple_of=32)
    vcfg = VAEConfig(out_ch=16, ch=32, ch_mult=(1, 2),
                     num_res_blocks=1, z_channels=4, embed_dim=4)
    ocfg = BigVGANConfig(num_mels=16, upsample_rates=(2, 2),
                         upsample_kernel_sizes=(4, 4), upsample_initial_channel=128)
    gen = torch.Generator().manual_seed(0)
    cpu = T2APipeline.random_init(gen, dcfg, vcfg, ocfg, device="cpu",
                                  compute_dtype=torch.float32)
    gpu = T2APipeline.random_init(torch.Generator(cuda_dev), dcfg, vcfg, ocfg,
                                  device=cuda_dev, compute_dtype=torch.float32)
    unfreeze_zero_init(cpu.dit, gen)
    for a, b in ((cpu.dit, gpu.dit), (cpu.vae, gpu.vae), (cpu.vocoder, gpu.vocoder)):
        b.load_state_dict(a.state_dict())
    ctx = torch.randn(2, 6, 32, generator=gen)
    unc = torch.randn(2, 6, 32, generator=gen)
    x0 = torch.randn(2, 4, 16, generator=gen)
    n1, n2 = k1.launches, k2.launches
    _, mel_c, wav_c = cpu.generate(ctx, unc, x0=x0, steps=4)
    _, mel_g, wav_g = gpu.generate(ctx.to(cuda_dev), unc.to(cuda_dev),
                                   x0=x0.to(cuda_dev), steps=4)
    torch.cuda.synchronize()
    # stage 0 (64 ch): 3 resblocks x 6 K1; stage 1 (32 ch): 18 K2 + post
    assert (k1.launches - n1, k2.launches - n2) == (18, 19)
    assert torch.isfinite(wav_g).all()
    np.testing.assert_allclose(mel_g.cpu().numpy(), mel_c.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(wav_g.cpu().numpy(), wav_c.numpy(), atol=1e-3, rtol=1e-3)


def _flash_inputs(b, h, lq, lk, d, dtype, dev, masked, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, h, lq, d, generator=g).to(dtype).to(dev) for _ in range(2))
    k, v = (torch.randn(b, h, lk, d, generator=g).to(dtype).to(dev) for _ in range(2))
    mask = None
    if masked:  # row 0 all valid, row 1 ragged, a last row (b >= 3) all masked
        mask = torch.ones(b, lk, dtype=torch.int32)
        mask[1, (2 * lk) // 3:] = 0
        if b >= 3:
            mask[-1] = 0
        mask = mask.to(dev)
    return q, k, v, do, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,masked,block_k", [
    (2, 3, 200, 200, 72, False, None),    # K3a
    (3, 2, 130, 77, 24, True, None),      # K3a, odd lengths, a fully masked row
    (1, 2, 1600, 1600, 72, False, None),  # K3b by length
    (3, 2, 100, 300, 48, True, 64),       # K3b by block_k, masked
    (2, 1, 65, 70, 50, False, None),      # a head dim padded to 72 in shared memory
    (2, 2, 33, 40, 16, False, 64),
    # edges of the bf16 tensor-core tiling: one query row and 5 keys (less
    # than one 16-key mma depth) at D = 8; 17 rows and 129 keys (one key
    # past two 64-key tiles, one past the backward's 128-key block) at D = 40
    # and 64; the ragged XL tail (1248 = 19.5 tiles of 64 rows, 9.75 blocks
    # of 128 keys); Lq != Lk across a 64-row and a 128-key edge at D = 72
    (1, 2, 1, 5, 8, False, None),
    (2, 2, 17, 129, 40, True, None),
    (1, 3, 17, 129, 64, False, 64),
    (2, 2, 1248, 1248, 72, False, None),
    (2, 3, 65, 257, 72, False, None),
    # the XXL training shape's head dim 48 (padded to the 72 template):
    # 1248 tokens, K3a, K4a, K4b
    (2, 4, 1248, 1248, 48, False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda_dev, b, h, lq, lk, d, masked, block_k, dtype):
    """The forward (K3a or K3b), K4a and K4b against their plain versions,
    with launch counts; K4b's dk and dv are the same bits over two launches."""
    q, k, v, do, mask = _flash_inputs(b, h, lq, lk, d, dtype, cuda_dev, masked)
    scale = d ** -0.5
    route = fa.route_for(lk, block_k)
    name = "K3a" if route == "direct" else "K3b"
    n = dict(fa.launches)
    o, lse = fa.flash_fwd(q, k, v, mask, scale, route)
    with full_fp32():
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, mask, scale, route)
    delta = (do.float() * o_ref.float()).sum(-1)
    grads = fa.flash_bwd(q, k, v, mask, lse_ref, do, delta, scale)
    dkv = fa.flash_bwd_dkv(q, k, v, mask, lse_ref, do, delta, scale)
    dkv_again = fa.flash_bwd_dkv(q, k, v, mask, lse_ref, do, delta, scale)
    with full_fp32():
        grads_ref = fa.flash_bwd_plain(q, k, v, mask, lse_ref, do, delta, scale)
    torch.cuda.synchronize()
    assert fa.launches[name] == n[name] + 1 and fa.launches["K4a"] == n["K4a"] + 1
    assert fa.launches["K4b"] == n["K4b"] + 2
    assert o.dtype == dtype and lse.shape == (b * h, lq)
    assert all(g.dtype == dtype for g in grads + dkv)
    assert torch.equal(dkv[0], dkv_again[0]) and torch.equal(dkv[1], dkv_again[1])
    live = lse_ref > -1e29  # rows with a valid key (lse of an empty row is ~-6.9e29)
    for got, want in ((o, o_ref), (lse[live], lse_ref[live]), *zip(grads, grads_ref),
                      *zip(dkv, grads_ref[1:])):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want), err
    if masked and b >= 3:  # a row with no valid key: o = 0, zero gradients
        assert not o[-1].any() and not any(g[-1].any() for g in grads + dkv)


def _fwd_matches_plain(q, k, v, mask, route):
    scale = q.shape[-1] ** -0.5
    o, lse = fa.flash_fwd(q, k, v, mask, scale, route)
    with full_fp32():
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, mask, scale, route)
    torch.cuda.synchronize()
    live = lse_ref > -1e29
    for got, want in ((o, o_ref), (lse[live], lse_ref[live])):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want), err


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["direct", "online"])
def test_flash_forward_large_scores_match_plain(cuda_dev, route):
    """q and k scaled up so that the scaled scores reach about +-80: the row
    max has to be subtracted before exp2, in bf16 on the tensor cores."""
    q, k, v, _, mask = _flash_inputs(2, 4, 200, 300, 72, torch.bfloat16, cuda_dev, True,
                                     seed=4)
    q, k = (q.float() * 3.5).to(torch.bfloat16), (k.float() * 3.5).to(torch.bfloat16)
    s = (q.float() @ k.float().transpose(-1, -2)) * 72 ** -0.5 * fa.LOG2E
    assert 50 < s.abs().max().item() < 150
    _fwd_matches_plain(q, k, v, mask, route)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_flash_forward_unaligned_rows_match_plain(cuda_dev, offset):
    """q, k and v as contiguous views that start `offset` bf16 values into a
    wider buffer: the copies fall back to 2-, 4- or 8-byte widths."""
    q, k, v, _, _ = _flash_inputs(2, 3, 150, 150, 72, torch.bfloat16, cuda_dev, False)

    def shifted(t):
        wide = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = wide[offset:].view(t.shape)
        view.copy_(t)
        return view

    q, k, v = shifted(q), shifted(k), shifted(v)
    assert q.is_contiguous() and q.data_ptr() % 16 == 2 * offset % 16
    for route in ("direct", "online"):
        _fwd_matches_plain(q, k, v, None, route)


def _bwd_matches_plain(q, k, v, do, mask):
    """K4a, K4b and K4c against the plain backward, from the plain forward's
    lse."""
    scale = q.shape[-1] ** -0.5
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v, mask, scale, fa.route_for(k.shape[2]))
        delta = (do.float() * o.float()).sum(-1)
        want = fa.flash_bwd_plain(q, k, v, mask, lse, do, delta, scale)
    got = (*fa.flash_bwd(q, k, v, mask, lse, do, delta, scale),
           *fa.flash_bwd_dkv(q, k, v, mask, lse, do, delta, scale),
           fa.flash_bwd_dq(q, k, v, mask, lse, do, delta, scale))
    torch.cuda.synchronize()
    for g, w in zip(got, want + want[1:] + want[:1]):
        assert torch.isfinite(g).all()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= _tol(w), err


@pytest.mark.cuda
def test_flash_backward_large_scores_match_plain(cuda_dev):
    """K4a, K4b and K4c in bf16 with q and k scaled up so that the scaled scores
    reach about +-80: p = exp2(S - lse) must take the saved lse as it is."""
    q, k, v, do, mask = _flash_inputs(2, 4, 200, 300, 72, torch.bfloat16, cuda_dev, True,
                                      seed=4)
    q, k = (q.float() * 3.5).to(torch.bfloat16), (k.float() * 3.5).to(torch.bfloat16)
    s = (q.float() @ k.float().transpose(-1, -2)) * 72 ** -0.5 * fa.LOG2E
    assert 50 < s.abs().max().item() < 150
    _bwd_matches_plain(q, k, v, do, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 4])
def test_flash_backward_unaligned_rows_match_plain(cuda_dev, offset):
    """K4a, K4b and K4c on q, k, v and do as contiguous views that start `offset`
    bf16 values into a wider buffer: the copies fall back to 2-, 4- or 8-byte
    widths (the scaled-q prologue too)."""
    q, k, v, do, _ = _flash_inputs(2, 3, 150, 150, 72, torch.bfloat16, cuda_dev, False)

    def shifted(t):
        wide = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = wide[offset:].view(t.shape)
        view.copy_(t)
        return view

    q, k, v, do = shifted(q), shifted(k), shifted(v), shifted(do)
    assert do.is_contiguous() and do.data_ptr() % 16 == 2 * offset % 16
    _bwd_matches_plain(q, k, v, do, None)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_flash_backward_dkv_is_deterministic(cuda_dev, masked):
    """Two bf16 launches of K4b give the same dk and dv bits."""
    q, k, v, do, mask = _flash_inputs(3, 4, 500, 700, 72, torch.bfloat16, cuda_dev, masked)
    scale = 72 ** -0.5
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v, mask, scale, "direct")
    delta = (do.float() * o.float()).sum(-1)
    a = fa.flash_bwd_dkv(q, k, v, mask, lse, do, delta, scale)
    b = fa.flash_bwd_dkv(q, k, v, mask, lse, do, delta, scale)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,lq,lk,d,masked", [
    (2, 3, 500, 700, 72, False),   # Lq != Lk both ways
    (2, 3, 700, 500, 72, True),    # masked, a ragged row
    (1, 2, 1, 5, 24, False),       # one query row, fewer keys than a 16-key depth
    (2, 2, 130, 77, 33, False),    # odd head dim, 2-byte copies
    (2, 2, 200, 150, 50, False),   # head dim padded to 72 (80 in the products)
    (3, 2, 300, 200, 24, True)])   # a fully masked batch row
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_dq_kernel_matches_plain(cuda_dev, b, h, lq, lk, d, masked, dtype):
    """K4c (the tensor-core kernel in bf16, the scalar one in fp32) against
    flash_bwd_dq_plain at ragged shapes, with the launch count; two launches
    give the same bits, and a row with no valid key gets dq = 0."""
    q, k, v, do, mask = _flash_inputs(b, h, lq, lk, d, dtype, cuda_dev, masked, seed=3)
    scale = d ** -0.5
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v, mask, scale, "direct")
        delta = (do.float() * o.float()).sum(-1)
        want = fa.flash_bwd_dq_plain(q, k, v, mask, lse, do, delta, scale)
    n = fa.launches["K4c"]
    got = fa.flash_bwd_dq(q, k, v, mask, lse, do, delta, scale)
    again = fa.flash_bwd_dq(q, k, v, mask, lse, do, delta, scale)
    torch.cuda.synchronize()
    assert fa.launches["K4c"] == n + 2
    assert got.dtype == dtype and got.shape == q.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _tol(want), err
    if masked and b >= 3:
        assert not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["direct", "online"])
def test_flash_forward_is_deterministic(cuda_dev, route):
    """Two bf16 launches of each forward route give the same bits."""
    q, k, v, _, mask = _flash_inputs(3, 4, 500, 700, 72, torch.bfloat16, cuda_dev, True)
    a = fa.flash_fwd(q, k, v, mask, 72 ** -0.5, route)
    b = fa.flash_fwd(q, k, v, mask, 72 ** -0.5, route)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_flash_kernels_refuse_wider_heads(cuda_dev):
    q = torch.zeros(1, 1, 8, fa.MAX_HEAD_DIM + 8, device=cuda_dev)
    with pytest.raises(ValueError, match=f"D <= {fa.MAX_HEAD_DIM}"):
        fa.flash_fwd(q, q, q, None, 1.0, "direct")


@pytest.mark.cuda
def test_flash_attention_autograd_matches_cpu(cuda_dev):
    """flash_attention forward and backward on the card (K3a, K4a) against
    the same inputs on the CPU (plain versions), fp32."""
    q, k, v, do, _ = _flash_inputs(2, 3, 150, 150, 72, torch.float32, "cpu", False)
    outs = []
    for dev in ("cpu", cuda_dev):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*leaves)
        o.backward(do.to(dev))
        outs.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for a, b in zip(*outs):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_dev):
    """Two fp32 training steps of a small DiT with flash attention forced on
    (remat on), on the card and on the CPU from the same weights and draws:
    loss, grad norm and every parameter."""
    import copy
    from maa3_tpu_torch.models.dit import DiT, DiTConfig, dit_init_, unfreeze_zero_init
    from maa3_tpu_torch.models.vae1d import AutoencoderKL, VAEConfig, vae_init_
    from maa3_tpu_torch.train.optim import make_optimizer
    from maa3_tpu_torch.train.step import create_train_state, make_train_step

    gen = torch.Generator().manual_seed(0)
    dit = DiT(DiTConfig(in_channels=4, context_dim=32, hidden_size=64, depth=2,
                        num_heads=4, multiple_of=32, use_flash=True, remat=True))
    unfreeze_zero_init(dit_init_(dit, gen), gen)
    vae = vae_init_(AutoencoderKL(VAEConfig(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2),
                                            num_res_blocks=1, z_channels=4,
                                            embed_dim=4)), gen)
    batches = [{"mel": torch.randn(2, 16, 40, generator=gen),
                "context": torch.randn(2, 6, 32, generator=gen)} for _ in range(2)]
    draws = [{"noise": torch.randn(2, 4, 20, generator=gen),
              "t_int": torch.randint(0, 1000, (2,), generator=gen),
              "x0": torch.randn(2, 4, 20, generator=gen)} for _ in range(2)]
    results = []
    n = fa.launches["K4a"]
    for dev in ("cpu", cuda_dev):
        d, a = copy.deepcopy(dit).to(dev), copy.deepcopy(vae).to(dev)
        opt = make_optimizer(d.parameters(), base_lr=1e-3, lr_multiplier=1.0, warm_up_steps=0)
        state = create_train_state(d, a, opt, scale_factor=0.8)
        step = make_train_step(compute_dtype=torch.float32)
        with full_fp32():
            ms = [step(state, {k: t.to(dev) for k, t in bt.items()},
                       draws={k: t.to(dev) for k, t in dr.items()})
                  for bt, dr in zip(batches, draws)]
        results.append((ms, [p.detach().cpu() for p in d.parameters()]))
    assert fa.launches["K4a"] == n + 4  # 2 blocks x 2 steps, on the card only
    for mc, mg in zip(results[0][0], results[1][0]):
        for key in ("loss", "grad_norm"):
            assert abs(mc[key].item() - mg[key].item()) <= 1e-4 * abs(mc[key].item())
    for a, b, p in zip(results[0][1], results[1][1], dit.parameters()):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())
    # the full-LR updates move parameters well past that tolerance
    assert max((a - p.detach()).abs().max().item()
               for a, p in zip(results[0][1], dit.parameters())) > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,d,masked,block_k", [
    (6, 16, 1248, 72, False, None),   # the XL training shape
    (2, 16, 2048, 72, False, None),   # the K3b route by length
    (4, 16, 312, 72, False, None),    # the serving length
    (3, 4, 1000, 24, True, None),     # masked, a fully masked batch row
    (4, 16, 312, 72, False, 64)])     # lse from the forced online route
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_backward_kernels_match_plain(cuda_dev, b, h, l, d, masked, block_k, dtype):
    """K4b (dk, dv) and K4c (dq) against their plain versions at the shapes of
    chip_smoke.py's phase 6, with launch counts; dq, dk and dv are the same
    bits over two launches, and dk / dv agree with K4a's."""
    q, k, v, do, mask = _flash_inputs(b, h, l, l, d, dtype, cuda_dev, masked)
    scale = d ** -0.5
    with full_fp32():
        o, lse = fa.flash_fwd_plain(q, k, v, mask, scale, fa.route_for(l, block_k))
    delta = (do.float() * o.float()).sum(-1)
    n = dict(fa.launches)
    dk, dv = fa.flash_bwd_dkv(q, k, v, mask, lse, do, delta, scale)
    dk2, dv2 = fa.flash_bwd_dkv(q, k, v, mask, lse, do, delta, scale)
    dq = fa.flash_bwd_dq(q, k, v, mask, lse, do, delta, scale)
    dq2 = fa.flash_bwd_dq(q, k, v, mask, lse, do, delta, scale)
    torch.cuda.synchronize()
    assert (fa.launches["K4b"] - n["K4b"], fa.launches["K4c"] - n["K4c"],
            fa.launches["K4a"] - n["K4a"]) == (2, 2, 0)
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
    with full_fp32():
        want_k, want_v = fa.flash_bwd_dkv_plain(q, k, v, mask, lse, do, delta, scale)
        want_q = fa.flash_bwd_dq_plain(q, k, v, mask, lse, do, delta, scale)
    for got, want in ((dq, want_q), (dk, want_k), (dv, want_v)):
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want), err
    _, fk, fv = fa.flash_bwd(q, k, v, mask, lse, do, delta, scale)
    for got, want in ((dk, fk), (dv, fv)):
        assert (got.float() - want.float()).abs().max().item() <= _tol(want)
    if masked:  # a row with no valid key: zero gradients
        assert not dq[-1].any() and not dk[-1].any() and not dv[-1].any()


def _small_trainer_pair(tmp_path, **trainer_kw):
    """The same small system (DiT with flash forced on, VAE, CLAP+FLAN) on the
    CPU and on the card, each in a Trainer that trains the conditioner
    (trainer_kw: more Trainer arguments)."""
    import copy
    import os
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train.loop import Trainer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=64", up + "depth=2", up + "num_heads=4",
            up + "context_dim=32", up + "multiple_of=32", up + "use_flash=true",
            dd + "ch=32", dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1",
            # the std rescale would draw its noise from each device's own generator
            "model.params.scale_by_std=false"]
    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=32, num_layers=1, num_heads=4,
                                          intermediate_size=64),
                          t5=T5Config(d_model=32, d_kv=8, d_ff=48, num_layers=1,
                                      num_heads=4), d_proj=32)
    voc = BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=64)
    cpu = MAA3System.from_config([os.path.join(root, "configs", "txt2audio-cfm-cfg-XL.yaml")],
                                 over, seed=3, compute_dtype=torch.float32, device="cpu",
                                 clap_cfg=clap, voc_cfg=voc, unfreeze=True)
    gpu = MAA3System(cpu.spec, *(copy.deepcopy(m).cuda() for m in
                                 (cpu.dit, cpu.vae, cpu.vocoder, cpu.cond)),
                     compute_dtype=torch.float32)
    out = []
    for i, s in enumerate((cpu, gpu)):
        out.append(Trainer(s, batch_size=2, lr_multiplier=1.0, warm_up_steps=0,
                           log_every=1, ckpt_every=0, ckpt_dir=str(tmp_path / str(i)),
                           **trainer_kw))
        # full LR from the first update, so parameters move past the tolerance
        out[-1].state.optimizer.schedule = lambda n: 1e-3
    return out


def _raw_batch(seed):
    g = np.random.RandomState(seed)
    caps = ["a dog barks", "rain on a tin roof"]
    return {"image": g.randn(2, 80, 96).astype(np.float32) - 4.0,
            "caption": {"ori_caption": caps, "struct_caption": [f"<{c}& all>" for c in caps]}}


@pytest.mark.cuda
def test_cuda_split_train_steps_with_conditioner_match_cpu(cuda_dev, tmp_path, monkeypatch):
    """Two fp32 Trainer steps with MAA3_FLASH_BWD=split (K3a, K4b, K4c on the
    card) that train the DiT and the conditioner, on the card and on the CPU
    from the same weights and draws: loss, grad norm and every parameter."""
    monkeypatch.setenv("MAA3_FLASH_BWD", "split")
    trainers = _small_trainer_pair(tmp_path)
    g = torch.Generator().manual_seed(1)
    draws = [{"noise": torch.randn(2, 20, 48, generator=g),
              "t_int": torch.randint(0, 1000, (2,), generator=g),
              "x0": torch.randn(2, 20, 48, generator=g)} for _ in range(2)]
    start = [p.detach().clone() for p in trainers[0].state.trainable_parameters()]
    n = dict(fa.launches)
    results = []
    for tr in trainers:
        ms = [tr.train_step(_raw_batch(i), draws={k: t.to(tr.device) for k, t in d.items()})
              for i, d in enumerate(draws)]
        results.append((ms, [p.detach().cpu() for p in tr.state.trainable_parameters()]))
    assert {k: fa.launches[k] - n[k] for k in ("K3a", "K4a", "K4b", "K4c")} == {
        "K3a": 4, "K4a": 0, "K4b": 4, "K4c": 4}  # 2 blocks x 2 steps, on the card only
    for mc, mg in zip(results[0][0], results[1][0]):
        for key in ("loss", "grad_norm"):
            assert abs(mc[key].item() - mg[key].item()) <= 1e-4 * abs(mc[key].item())
    for a, b in zip(results[0][1], results[1][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())
    n_cond = sum(1 for _ in trainers[0].state.cond.parameters())
    moved = [(a - s).abs().max().item() for a, s in zip(results[0][1], start)]
    assert max(moved[-n_cond:]) > 1e-3 and max(moved[:-n_cond]) > 1e-3


@pytest.mark.cuda
def test_train_latent_and_loss_match_cpu_without_outer_fp32(cuda_dev, tmp_path):
    """The training step's frozen VAE encode runs in fp32 on the card by
    itself: with cuDNN's TF32 allowed (its default) and no full_fp32() around
    the call, the latent and the step's loss match the CPU to 1e-4."""
    from maa3_tpu_torch.train.step import sample_latent
    trainers = _small_trainer_pair(tmp_path)
    g = torch.Generator().manual_seed(2)
    draws = {"noise": torch.randn(2, 20, 48, generator=g),
             "t_int": torch.randint(0, 1000, (2,), generator=g),
             "x0": torch.randn(2, 20, 48, generator=g)}
    zs, losses = [], []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        for tr in trainers:
            batch = tr.prepare_batch(_raw_batch(0))
            zs.append(sample_latent(tr.state.vae, batch, noise=draws["noise"].to(tr.device)).cpu())
            m = tr.train_step(_raw_batch(0), draws={k: t.to(tr.device) for k, t in draws.items()})
            losses.append(m["loss"].item())
    assert (zs[0] - zs[1]).abs().max().item() <= 1e-4 * max(1.0, zs[0].abs().max().item())
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[0])


@pytest.mark.cuda
@pytest.mark.parametrize("resblock,activation,want", [
    ("2", "snakebeta", (4, 5)), ("2", "snake", (4, 5)), ("1", "lrelu", (0, 0))])
def test_amp2_and_lrelu_vocoders_match_cpu(cuda_dev, resblock, activation, want):
    """AMPBlock2 and lrelu vocoders on the card against the CPU (plain
    versions), fp32, 1e-3 as for the pipeline; AMPBlock2 reaches K1 (the
    64-channel stage, one site per dilation) and K2 (the 32-channel stage
    and conv_post), lrelu neither kernel."""
    import copy
    from maa3_tpu_torch.models.bigvgan import (BigVGAN, BigVGANConfig, Snake,
                                               bigvgan_apply, bigvgan_init_)
    cfg = BigVGANConfig(num_mels=16, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=128, resblock=resblock,
                        activation=activation, snake_logscale=activation != "snake",
                        resblock_kernel_sizes=(3, 7),
                        resblock_dilation_sizes=((1, 3), (1, 3)) if resblock == "2"
                        else ((1, 3, 5), (1, 3, 5)))
    gen = torch.Generator().manual_seed(4)
    cpu = bigvgan_init_(BigVGAN(cfg), gen)
    with torch.no_grad():
        for m in cpu.modules():
            if isinstance(m, Snake):
                for p in m.parameters():
                    p.add_(torch.empty_like(p).uniform_(-0.3, 0.3, generator=gen))
    gpu = copy.deepcopy(cpu).to(cuda_dev)
    mel = torch.randn(2, 16, 40, generator=gen)
    n1, n2 = k1.launches, k2.launches
    with full_fp32():
        wav_g = bigvgan_apply(gpu, mel.to(cuda_dev))
        torch.cuda.synchronize()
        assert (k1.launches - n1, k2.launches - n2) == want
        wav_c = bigvgan_apply(cpu, mel)
    assert wav_g.shape == (2, 160) and torch.isfinite(wav_g).all()
    np.testing.assert_allclose(wav_g.cpu().numpy(), wav_c.numpy(), atol=1e-3, rtol=1e-3)


@pytest.mark.cuda
def test_served_batch_gives_the_same_bytes_in_any_arrival_order(cuda_dev):
    """The full-width text-to-music model served in bf16 (chip_smoke.py phase
    11's, random weights): the same 8 requests batched once in arrival
    order and once permuted give each request the same bytes. cuDNN's bf16
    convolutions at the vocoder's 768-channel stage round a row by its
    place in the batch, so the batcher runs the rows ordered by captions and
    seed, not by arrival."""
    import os
    from maa3_tpu_torch.serving import Batcher, ServeConfig, _Pending
    from maa3_tpu_torch.system import MAA3System
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    system = MAA3System.from_config([os.path.join(root, "configs", "txt2music-cfm-cfg.yaml")],
                                    seed=11, device="cuda", compute_dtype=torch.bfloat16,
                                    unfreeze=True)
    batcher = Batcher(system, ServeConfig(max_batch=8))
    prompts = [f"a piece for instrument number {i}" for i in range(8)]

    def served(order):
        reqs = [_Pending(prompt=prompts[i], struct=f"<{prompts[i]}& all>", steps=4,
                         scale=5.0, latent_len=system.spec.mel_length, seed=100 + i)
                for i in order]
        batcher._process(reqs)
        assert all(r.error is None for r in reqs), [r.error for r in reqs]
        return {r.prompt: r.wav for r in reqs}

    first, moved = served(range(8)), served([3, 0, 6, 1, 7, 2, 5, 4])
    assert all(np.array_equal(first[p], moved[p]) for p in prompts)


@pytest.mark.cuda
def test_audioldm_on_the_card_matches_cpu(cuda_dev):
    """A small AudioLDM pipeline (2-D UNet with FiLM, 2-D VAE, lrelu
    vocoder) on the card against the CPU, fp32 under full_fp32, DDIM and
    PLMS with CFG: latent, mel and wav at 1e-3 x max(1, |ref|); the lrelu
    vocoder launches neither K1 nor K2."""
    import copy
    from maa3_tpu_torch.diffusion.ddpm_loss import film_pool
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.unet2d import UNet2DConfig
    from maa3_tpu_torch.models.vae2d import VAE2DConfig
    from maa3_tpu_torch.pipeline_audioldm import AudioLDMPipeline
    gen = torch.Generator().manual_seed(6)
    cpu = AudioLDMPipeline.random_init(
        gen, UNet2DConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                          attention_levels=(1,), num_heads=2, film_dim=24),
        VAE2DConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        BigVGANConfig(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
                      upsample_initial_channel=64, resblock_kernel_sizes=(3,),
                      resblock_dilation_sizes=((1, 3, 5),), activation="lrelu"),
        device="cpu", latent_f=4, latent_t=16)
    with torch.no_grad():
        for p in cpu.unet.parameters():
            if not p.any():  # the zero-init leaves, so that every path contributes
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    gpu = AudioLDMPipeline(*(copy.deepcopy(m).to(cuda_dev) for m in
                             (cpu.unet, cpu.vae, cpu.vocoder)),
                           cpu.schedule, latent_f=4, latent_t=16)
    film = film_pool(torch.randn(2, 5, 24, generator=gen))
    x_T = torch.randn(2, 4, 4, 16, generator=gen)
    n1, n2 = k1.launches, k2.launches
    for plms in (False, True):
        outs = []
        for pipe, dev in ((gpu, cuda_dev), (cpu, torch.device("cpu"))):
            z = pipe.sample(x_T.to(dev), film.to(dev), torch.zeros_like(film).to(dev), 3.0,
                            ddim_steps=4, use_plms=plms)
            mel = pipe.decode(z)
            outs.append((z, mel, pipe.vocode(mel)))
        for g, c in zip(*outs):
            assert g.shape == c.shape and torch.isfinite(g).all()
            assert (g.cpu() - c).abs().max().item() <= 1e-3 * max(1.0, c.abs().max().item())
    assert (k1.launches, k2.launches) == (n1, n2)


@pytest.mark.cuda
def test_lightning_checkpoint_on_the_card_matches_cpu(cuda_dev, tmp_path):
    """A small Lightning checkpoint (EMA section, weight-normed vocoder in
    both namings) loaded with device="cuda" serves what the same files give
    on the CPU: conditioning, CFG ODE, decode and vocoder, fp32 at 1e-3."""
    import json
    import os
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    xl = os.path.join(root, "configs", "txt2audio-cfm-cfg-XL.yaml")
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=64", up + "depth=2", up + "num_heads=4",
            up + "context_dim=32", up + "multiple_of=32", dd + "ch=32",
            dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1"]
    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=32, num_layers=2, num_heads=4,
                                          intermediate_size=64),
                          t5=T5Config(d_model=32, d_kv=8, d_ff=48, num_layers=2,
                                      num_heads=4), d_proj=32)
    voc = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4],
               upsample_initial_channel=128, resblock_kernel_sizes=[3, 7],
               resblock_dilation_sizes=[[1, 3, 5]] * 2)
    src = MAA3System.from_config([xl], over, seed=5, device="cpu", clap_cfg=clap,
                                 voc_cfg=BigVGANConfig.from_dict(voc), unfreeze=True)
    g = torch.Generator().manual_seed(6)
    sd = {"scale_factor": torch.tensor(0.8)}
    for prefix, m in (("model.diffusion_model.", src.dit), ("first_stage_model.", src.vae),
                      ("cond_stage_model.", src.cond)):
        sd.update({prefix + k: v for k, v in m.state_dict().items()})
    for k, v in src.dit.state_dict().items():
        sd["model_ema." + ("diffusion_model." + k).replace(".", "")] = (
            v + 0.01 * torch.randn(v.shape, generator=g))
    torch.save({"state_dict": sd}, tmp_path / "m.ckpt")
    gen_sd, i = {}, 0
    for k, w in src.vocoder.state_dict().items():
        if w.dim() == 3:  # conv weights as weight norm's (g, v), namings alternating
            base, norm = k[:-len(".weight")], w.square().sum((1, 2), keepdim=True).sqrt()
            names = ("weight_g", "weight_v") if i % 2 else (
                "parametrizations.weight.original0", "parametrizations.weight.original1")
            gen_sd[f"{base}.{names[0]}"], gen_sd[f"{base}.{names[1]}"] = norm, 2.0 * w
            i += 1
        else:
            gen_sd[k] = w
    os.makedirs(tmp_path / "voc")
    (tmp_path / "voc" / "config.json").write_text(json.dumps(voc))
    torch.save({"generator": gen_sd}, tmp_path / "voc" / "generator.pt")
    prompts = {"ori_caption": ["a dog barks", "rain"], "struct_caption": ["<a& b>", "<r& c>"]}
    x0 = torch.randn(2, 20, 16, generator=g)
    outs = []
    n1, n2 = k1.launches, k2.launches
    for dev in ("cpu", cuda_dev):
        s = MAA3System.from_config([xl], over, device=dev, compute_dtype=torch.float32,
                                   clap_cfg=clap, ckpt_path=str(tmp_path / "m.ckpt"),
                                   vocoder_dir=str(tmp_path / "voc"))
        assert s.scale_factor == pytest.approx(0.8)
        c = s.get_learned_conditioning(prompts)
        uc = s.get_learned_conditioning({k: ["", ""] for k in prompts})
        z = s.sample_cfg(c, 5.0, uc, timesteps=4, x0=x0.to(dev))
        mel = s.decode_first_stage(z)
        outs.append([t.cpu() for t in (c, z, mel)] + [torch.from_numpy(s.vocode(mel))])
    torch.cuda.synchronize()
    assert k1.launches > n1 and k2.launches > n2
    for a, b in zip(*outs):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-3, rtol=1e-3)


POLICIES = ("nothing", "dots_no_batch", "save_gemms", "save_gemms_lite", "save_gemms_h1")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_on_the_card_matches_cpu(cuda_dev, policy):
    """Each remat policy, fp32, flash forced on (K3a and K4a on the card, the
    forward rerun inside the selective recompute): loss and every gradient
    on the card against the CPU at 1e-4, and the launches: each block's
    forward twice, its backward once."""
    import copy
    from maa3_tpu_torch.models.dit import (DiT, DiTConfig, dit_apply, dit_init_,
                                           unfreeze_zero_init)

    gen = torch.Generator().manual_seed(0)
    dit = DiT(DiTConfig(in_channels=4, context_dim=32, hidden_size=64, depth=2,
                        num_heads=4, multiple_of=32, use_flash=True, remat=True,
                        remat_policy=policy))
    unfreeze_zero_init(dit_init_(dit, gen), gen)
    x, ctx, tgt = (torch.randn(2, 4, 40, generator=gen), torch.randn(2, 6, 32, generator=gen),
                   torch.randn(2, 4, 40, generator=gen))
    t = torch.tensor([5, 700])
    out = []
    n = dict(fa.launches)
    for dev in ("cpu", cuda_dev):
        d = copy.deepcopy(dit).to(dev)
        with full_fp32():
            v = dit_apply(d, x.to(dev), t.to(dev), ctx.to(dev), compute_dtype=torch.float32,
                          training=True)
            loss = (v - tgt.to(dev)).pow(2).mean()
            loss.backward()
        out.append((loss.item(), [p.grad.cpu() for p in d.parameters()]))
    assert {k: fa.launches[k] - n[k] for k in ("K3a", "K4a")} == {"K3a": 4, "K4a": 2}
    assert abs(out[0][0] - out[1][0]) <= 1e-4 * abs(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())


@pytest.mark.cuda
def test_cuda_accumulation_bf16_mu_matches_cpu(cuda_dev, tmp_path):
    """accum_steps=2 with a bf16 first moment, 4 micro-steps (2 updates), fp32
    compute, on the card and on the CPU from the same weights and draws:
    every loss, and every parameter after each micro-step (unchanged by the
    first of each pair); the stored moment bf16 on both."""
    trainers = _small_trainer_pair(tmp_path, accum_steps=2, mu_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(5)
    draws = [{"noise": torch.randn(2, 20, 48, generator=g),
              "t_int": torch.randint(0, 1000, (2,), generator=g),
              "x0": torch.randn(2, 20, 48, generator=g)} for _ in range(4)]
    start = [p.detach().clone() for p in trainers[0].state.trainable_parameters()]
    results = []
    for tr in trainers:
        steps = []
        for i, d in enumerate(draws):
            m = tr.train_step(_raw_batch(i), draws={k: t.to(tr.device) for k, t in d.items()})
            steps.append((m["loss"].item(),  # copies, also of the CPU trainer's tensors
                          [p.detach().cpu().clone() for p in tr.state.trainable_parameters()]))
        assert all(m.dtype == torch.bfloat16 for m in tr.state.optimizer.mu)
        assert tr.state.optimizer.count == 2
        results.append(steps)
    for (lc, pc), (lg, pg) in zip(*results):
        assert abs(lc - lg) <= 1e-4 * abs(lc)
        for a, b in zip(pc, pg):
            assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item())
    for steps in results:
        assert all(torch.equal(a, b) for a, b in zip(steps[0][1], start))
        assert max((a - b).abs().max().item() for a, b in zip(steps[1][1], start)) > 5e-4


@pytest.mark.cuda
def test_cuda_fused_trainer_matches_unfused(cuda_dev, tmp_path):
    """A fuse_gemms Trainer on the card takes two fp32 steps as the unfused
    one does, from the same weights and draws: losses and every parameter
    in the canonical names at 1e-4."""
    from maa3_tpu_torch.models.dit import unfuse_dit_gemms

    unfused = _small_trainer_pair(tmp_path / "u")[1]
    fused = _small_trainer_pair(tmp_path / "f", fuse_gemms=True)[1]
    g = torch.Generator().manual_seed(6)
    draws = [{"noise": torch.randn(2, 20, 48, generator=g),
              "t_int": torch.randint(0, 1000, (2,), generator=g),
              "x0": torch.randn(2, 20, 48, generator=g)} for _ in range(2)]
    for i, d in enumerate(draws):
        dd = {k: t.to(cuda_dev) for k, t in d.items()}
        mu = unfused.train_step(_raw_batch(i), draws=dd)
        mf = fused.train_step(_raw_batch(i), draws=dd)
        assert abs(mu["loss"].item() - mf["loss"].item()) <= 1e-4 * abs(mu["loss"].item())
    canon = unfuse_dit_gemms(dict(fused.state.dit.named_parameters()),
                             fused.spec.dit.num_heads)
    for n, p in unfused.state.dit.named_parameters():
        a, b = p.detach().cpu(), canon[n].detach().cpu()
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, a.abs().max().item()), n


# -- int8 serving and the video MoE (card against CPU) ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("m,group", [(4, 0), (2496, 0), (3, 128), (624, 128)])
def test_dense_w8a8_on_the_card_matches_cpu(cuda_dev, m, group):
    """torch._int_mm on the card (rows <= 16 padded, the grouped loop): the
    same int8 codes, outputs within 1e-3 x max(1, |cpu|)."""
    from maa3_tpu_torch.ops import quant
    g = torch.Generator().manual_seed(m + group)
    w = torch.randn(384, 256, generator=g)
    x = torch.randn(m, 256, generator=g) * torch.rand(256, generator=g) * 4
    b = torch.randn(384, generator=g)
    qc = quant.quantize_weight_int8(w, group)
    qg = quant.quantize_weight_int8(w.to(cuda_dev), group)
    assert torch.equal(qc.w_q, qg.w_q.cpu())
    torch.testing.assert_close(qg.w_scale.cpu(), qc.w_scale, rtol=1e-6, atol=0)
    n = quant.int_mm_calls
    want = quant.dense_w8a8(x, qc, b)
    got = quant.dense_w8a8(x.to(cuda_dev), qg, b.to(cuda_dev), torch.bfloat16)
    assert quant.int_mm_calls - n == 2 * (256 // group if group else 1)
    assert got.dtype == torch.bfloat16
    err = (got.float().cpu() - want).abs().max().item()
    assert err <= 2.0 ** -6 * max(1.0, want.abs().max().item()), err
    got = quant.dense_w8a8(x.to(cuda_dev), qg, b.to(cuda_dev))
    assert (got.cpu() - want).abs().max().item() <= 1e-3 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("c,k,d", [(384, 3, 1), (384, 7, 5), (96, 11, 3)])
def test_w8a8_convs_on_the_card_match_cpu(cuda_dev, c, k, d):
    from maa3_tpu_torch.ops import conv
    g = torch.Generator().manual_seed(c + k + d)
    w = torch.randn(c, c, k, generator=g) / (c * k) ** 0.5
    b = torch.randn(c, generator=g)
    x = torch.randn(2, c, 300, generator=g)
    qc, qg = conv.quantize_conv_int8(w, b), conv.quantize_conv_int8(w.to(cuda_dev), b.to(cuda_dev))
    assert torch.equal(qc.w_q, qg.w_q.cpu())
    pad = (k * d - d) // 2
    for fn in (conv.conv1d_unfold_w8a8, conv.conv1d_tapgemm_w8a8):
        want = fn(qc, x, padding=pad, dilation=d)
        got = fn(qg, x.to(cuda_dev), padding=pad, dilation=d).cpu()
        assert (got - want).abs().max().item() <= 1e-3 * max(1.0, want.abs().max().item())


@pytest.mark.cuda
def test_moe_forced_flash_forward_and_backward_on_the_card(cuda_dev):
    """A small MoE DiT with use_flash=True on the card (K3a forward, K4a
    backward) against the same weights on the CPU (plain versions), fp32:
    output and every gradient within 1e-4 x max(1, |cpu|)."""
    import copy
    from maa3_tpu_torch.models import dit_moe
    from maa3_tpu_torch.models.dit import dit_init_, unfreeze_zero_init
    cfg = dit_moe.MoEDiTConfig(in_channels=20, context_dim=32, hidden_size=64, depth=2,
                               num_heads=4, multiple_of=32, use_flash=True)
    g = torch.Generator().manual_seed(0)
    cpu = unfreeze_zero_init(dit_init_(dit_moe.MoEDiT(cfg), g), g)
    card = copy.deepcopy(cpu).to(cuda_dev)
    x = torch.randn(2, 20, 40, generator=g)
    t = torch.tensor([10, 900])
    ctx = torch.randn(2, 6, 32, generator=g)
    outs = []
    n = dict(fa.launches)
    with full_fp32():
        for m, dev in ((cpu, "cpu"), (card, cuda_dev)):
            y = dit_moe.moe_dit_apply(m, x.to(dev), t.to(dev), ctx.to(dev),
                                      compute_dtype=torch.float32, training=True)
            y.square().mean().backward()
            outs.append((y.detach().cpu(), {k: p.grad.cpu() for k, p in m.named_parameters()}))
    assert fa.launches["K3a"] - n["K3a"] == 2 and fa.launches["K4a"] - n["K4a"] == 2
    (yc, gc), (yg, gg) = outs
    assert (yg - yc).abs().max().item() <= 1e-4 * max(1.0, yc.abs().max().item())
    for k in gc:
        assert (gg[k] - gc[k]).abs().max().item() <= 1e-4 * max(1.0, gc[k].abs().max().item()), k


def _eval_close(got, want, rel=1e-3):
    """The serving rule: fp32 on the card within 1e-3 x max(1, max|cpu|)."""
    err = (got.float().cpu() - want.float()).abs().max().item()
    assert err <= rel * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("running", [False, True])
def test_eval_towers_on_the_card_match_cpu(cuda_dev, running):
    """fp32 without TF32, the card against the CPU on the same weights: the
    VGGishish (--small's stack; batch and running statistics), the
    Melception (logits, features, aux), LPAPS and Cnn14 at full width, and
    the CLAP score with a small BERT."""
    from maa3_tpu_torch.eval import lpaps
    from maa3_tpu_torch.eval.clap_score import CLAPScorer
    from maa3_tpu_torch.models import cnn14, melception, melclf
    from maa3_tpu_torch.models.bert import BertConfig
    g = torch.Generator().manual_seed(0)
    mel = torch.randn(3, 80, 96, generator=g)
    clf = melclf.melclf_init_(melclf.MelClf(melclf.MelClfConfig(
        conv_layers=melclf.SMALL_CONV_LAYERS, num_classes=5), running_stats=running), g)
    mc = melception.melception_init_(melception.Melception(
        melception.MelceptionConfig(num_classes=5), running_stats=running), g)
    if running:
        for m in (clf, mc):
            for name, buf in m.named_buffers():
                buf.copy_(torch.rand(buf.shape, generator=g) * 0.2
                          + (0.9 if name.endswith("var") else -0.1))
    lp = lpaps.lpaps_init_(lpaps.LPAPS(), g)
    c14 = cnn14.cnn14_init_(cnn14.Cnn14(), g)
    wav = torch.randn(2, 11025, generator=g) * 0.3
    runs = [(clf, lambda m, x: melclf.melclf_apply(m, x, True), (mel,)),
            (mc, lambda m, x: melception.melception_apply(m, x, True, True), (mel,)),
            (lp, lpaps.lpaps_apply, (mel, mel.flip(0))),
            (c14, lambda m, w: tuple(cnn14.cnn14_apply(m, w).values()), (wav,))]
    with torch.no_grad(), full_fp32():
        for model, fn, args in runs:
            want = fn(model, *args)
            got = fn(model.to(cuda_dev), *(a.to(cuda_dev) for a in args))
            for gt, wt in zip(got if isinstance(got, tuple) else (got,),
                              want if isinstance(want, tuple) else (want,)):
                _eval_close(gt, wt)
    cfg = BertConfig(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    cpu = CLAPScorer.random_init(torch.Generator().manual_seed(1), bert_cfg=cfg, device="cpu")
    card = CLAPScorer.random_init(torch.Generator().manual_seed(1), bert_cfg=cfg,
                                  device=cuda_dev)
    cpu.duration = card.duration = 0.5
    wavs = [np.random.RandomState(i).randn(8000).astype(np.float32) * 0.3 for i in range(2)]
    caps = ["a dog barks", "rain falls on a roof"]
    for fn in (lambda s: s.audio_embeddings(wavs), lambda s: s.text_embeddings(caps),
               lambda s: torch.from_numpy(s.score(wavs, caps))):
        _eval_close(fn(card), fn(cpu))


@pytest.mark.cuda
def test_train_melclf_step_on_the_card_matches_cpu(cuda_dev, tmp_path):
    """train_melclf (--small, --cls_weights) for two steps on the card and on
    the CPU from the same weights and draws: the losses and every parameter
    within 1e-4 x max(1, max|cpu|) but for elements Adam moves by noise
    (conv biases cancelled by the batch-statistics BN; their gradient is
    rounding error), which stay within 2 lr x steps."""
    from maa3_tpu_torch import train_melclf
    rng = np.random.RandomState(0)
    lines = ["mel_path\tlabel"]
    for i in range(8):
        path = tmp_path / f"m{i}.npy"
        np.save(path, (rng.randn(80, 90) - 4.0 + 0.5 * (i % 3)).astype(np.float32))
        lines.append(f"{path}\t{['a', 'b', 'b'][i % 3]}")
    (tmp_path / "m.tsv").write_text("\n".join(lines) + "\n")
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = train_melclf.main([
            "--tsv", str(tmp_path / "m.tsv"), "--mel_len", "80", "--batch_size", "4",
            "--steps", "2", "--small", "--cls_weights", "--lr", "1e-3",
            "--ckpt_dir", str(tmp_path / dev), "--device", dev])
    np.testing.assert_allclose(out["cuda"]["losses"], out["cpu"]["losses"], rtol=1e-4)
    got = torch.load(out["cuda"]["ckpt"], weights_only=True)["model"]
    want = torch.load(out["cpu"]["ckpt"], weights_only=True)["model"]
    for k, w in want.items():
        diff = (got[k] - w).abs()
        assert diff.max().item() <= 2 * 1e-3 * 2, k
        if not (k.startswith("features.") and k.endswith(".bias")):
            off = diff > 1e-4 * max(1.0, w.abs().max().item())
            assert off.sum().item() <= max(1, 1e-5 * off.numel()), (k, int(off.sum()))


@pytest.mark.cuda
def test_xxl_width_forward_through_an_nccl_world_of_one(cuda_dev, tmp_path, monkeypatch):
    """A DiT of XXL width (1536, 32 heads of 48) at depth 2 in fp32, its
    training forward at 1248 tokens (K3a) and gradients, with its
    parameters placed by make_mesh / dit_param_specs / shard_params_ over an
    NCCL group of world size 1, against the same forward without the group:
    the same bits (the split backward, K4b / K4c: K4a's dq atomics vary in
    their last bits from run to run)."""
    monkeypatch.setenv("MAA3_FLASH_BWD", "split")
    import torch.distributed as dist
    from maa3_tpu_torch.models.dit import (DiT, DiTConfig, dit_apply, dit_init_,
                                           unfreeze_zero_init)
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.tp import TP
    cfg = DiTConfig(in_channels=20, context_dim=1024, hidden_size=1536, depth=2,
                    num_heads=32)
    with torch.device(cuda_dev):
        dit = DiT(cfg)
    g = torch.Generator(device=cuda_dev).manual_seed(0)
    unfreeze_zero_init(dit_init_(dit, g), g)
    x = torch.randn(2, 20, 1248, generator=g, device=cuda_dev)
    t = torch.tensor([100, 700], device=cuda_dev)
    c = torch.randn(2, 154, 1024, generator=g, device=cuda_dev)

    def run():
        dit.zero_grad()
        n = fa.launches["K3a"]
        with full_fp32():
            out = dit_apply(dit, x, t, c, compute_dtype=torch.float32, training=True)
            out.square().sum().backward()
        assert fa.launches["K3a"] == n + cfg.depth
        return out.detach(), [p.grad.clone() for p in dit.parameters()]

    want, want_g = run()
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        mesh = pmesh.make_mesh(n_model=1)
        assert mesh.shape == {"data": 1, "model": 1} and dist.get_backend() == "nccl"
        pmesh.shard_params_(dit, pmesh.dit_param_specs(dict(dit.named_parameters())), mesh)
        dit.tp = TP.of(mesh)
        got, got_g = run()
    finally:
        dist.destroy_process_group()
    assert dit.tp is None and torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))


def _card_rank(rank: int, world: int, init: str, task: str, d: str) -> None:
    """One of two spawned gloo ranks sharing the card (NCCL puts no two ranks
    on one device): CARD_TASKS[task]'s result written to d."""
    import os
    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world)
    try:
        torch.save(CARD_TASKS[task](), os.path.join(d, f"{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _two_card_ranks(d, task: str) -> list:
    """CARD_TASKS[task] on two spawned ranks; their results. A rank that
    raises, or a run past 240 s, fails the test. (The card machine may have
    another package named `tests`, so this file imports no other test
    module.)"""
    import os
    import time
    import torch.multiprocessing as mp
    d = str(d)
    ctx = mp.start_processes(_card_rank, args=(2, os.path.join(d, f"pg_{task}"), task, d),
                             nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, f"{task}: ranks still running after 240 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(os.path.join(d, f"{task}_{r}.pt"), weights_only=False)
            for r in range(2)]


def _pipe_case(mesh=None) -> dict:
    """A DiT of XL head dim (4 heads of 72) at depth 2, fp32, its training
    forward at 1248 tokens (K3a) and the gradients of sum(out^2): pipelined
    over mesh's two stages (n_micro 2), or dit_apply (mesh None); whole
    outputs and gradients and the K3a / K4b launches."""
    from maa3_tpu_torch.models.dit import (DiT, DiTConfig, dit_apply, dit_init_,
                                           unfreeze_zero_init)
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.pipeline import dit_apply_pipelined
    dev = torch.device("cuda")
    with torch.device(dev):
        dit = DiT(DiTConfig(in_channels=20, context_dim=64, hidden_size=288, depth=2,
                            num_heads=4))
    g = torch.Generator(device=dev).manual_seed(0)
    unfreeze_zero_init(dit_init_(dit, g), g)
    x = torch.randn(2, 20, 1248, generator=g, device=dev)
    t = torch.tensor([100, 700], device=dev)
    c = torch.randn(2, 16, 64, generator=g, device=dev)
    named = dict(dit.named_parameters())
    full = {n: tuple(p.shape) for n, p in named.items()}
    owners = {}
    if mesh is not None:
        owners = pmesh.add_pipe_specs(named, 2)
        pmesh.free_unowned_(dit, owners, mesh)
    n3, n4 = fa.launches["K3a"], fa.launches["K4b"]
    with full_fp32():
        out = (dit_apply(dit, x, t, c, compute_dtype=torch.float32, training=True)
               if mesh is None else
               dit_apply_pipelined(dit, x, t, c, mesh, 2, compute_dtype=torch.float32,
                                   training=True))
        out.square().sum().backward()
    torch.cuda.synchronize()
    grads = {n: pmesh.gather_tensor(torch.zeros_like(p) if p.grad is None else p.grad,
                                    (), mesh or pmesh.Mesh(), owner=owners.get(n),
                                    full_shape=full[n]).cpu()
             for n, p in dit.named_parameters()}
    return {"out": out.detach().cpu(), "grads": grads,
            "launches": (fa.launches["K3a"] - n3, fa.launches["K4b"] - n4)}


def _pipe_task() -> dict:
    from maa3_tpu_torch.parallel import mesh as pmesh
    return _pipe_case(pmesh.make_pipe_mesh(n_pipe=2))


def _moe_case(mesh=None) -> dict:
    """A video MoE (256 wide, 4 experts) at depth 2, fp32, its forward and
    the gradients of sum(out^2), expert-parallel over mesh (two experts a
    rank) or on one device."""
    from maa3_tpu_torch.models.dit import dit_init_, unfreeze_zero_init
    from maa3_tpu_torch.models.dit_moe import MoEDiT, MoEDiTConfig, moe_dit_apply
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.tp import EP
    dev = torch.device("cuda")
    with torch.device(dev):
        dit = MoEDiT(MoEDiTConfig(in_channels=20, context_dim=64, hidden_size=256, depth=2,
                                  num_heads=4, num_experts=4))
    g = torch.Generator(device=dev).manual_seed(0)
    unfreeze_zero_init(dit_init_(dit, g), g)
    x = torch.randn(4, 20, 312, generator=g, device=dev)
    t = torch.tensor([0, 260, 600, 999], device=dev)
    c = torch.randn(4, 40, 64, generator=g, device=dev)
    named = dict(dit.named_parameters())
    full = {n: tuple(p.shape) for n, p in named.items()}
    owners = {}
    if mesh is not None:
        owners = pmesh.add_ep_specs(named, 2)
        pmesh.free_unowned_(dit, owners, mesh)
        dit.ep = EP.of(mesh, 4)
    with full_fp32():
        out = moe_dit_apply(dit, x, t, c, compute_dtype=torch.float32, training=True)
        out.square().sum().backward()
    grads = {n: pmesh.gather_tensor(torch.zeros_like(p) if p.grad is None else p.grad,
                                    (), mesh or pmesh.Mesh(), owner=owners.get(n),
                                    full_shape=full[n]).cpu()
             for n, p in dit.named_parameters()}
    return {"out": out.detach().cpu(), "grads": grads}


def _moe_task() -> dict:
    from maa3_tpu_torch.parallel import mesh as pmesh
    return _moe_case(pmesh.make_moe_mesh(n_expert=2))


CARD_TASKS = {"pipe": _pipe_task, "moe": _moe_task}


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.cuda
def test_pipelined_apply_on_two_gloo_ranks_on_the_card(cuda_dev, tmp_path, monkeypatch):
    """GPipe over two stages (two gloo ranks on the card, n_micro 2) at 1248
    tokens, fp32: one device's forward and every gradient; each stage runs
    K3a and the split backward (K4b / K4c: K4a's dq atomics vary in their
    last bits from run to run) on its block for each of the 3 ticks."""
    monkeypatch.setenv("MAA3_FLASH_BWD", "split")   # the ranks inherit it
    one = _pipe_case()
    assert one["launches"] == (2, 2)
    for r in _two_card_ranks(tmp_path, "pipe"):
        assert r["launches"] == (3, 3)
        _close(r["out"], one["out"])
        for n, gr in r["grads"].items():
            _close(gr, one["grads"][n])


@pytest.mark.cuda
def test_expert_parallel_moe_on_two_gloo_ranks_on_the_card(cuda_dev, tmp_path):
    """The video MoE with two experts a rank (two gloo ranks on the card),
    fp32: one device's forward and every gradient."""
    one = _moe_case()
    for r in _two_card_ranks(tmp_path, "moe"):
        _close(r["out"], one["out"])
        for n, gr in r["grads"].items():
            _close(gr, one["grads"][n])


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_lies_within_it_on_the_profilers_clock(cuda_dev):
    """maa3_tpu_torch/trace.py's clock pair puts a span on torch.profiler's
    clock on the card: a GEMM launched and waited for inside the span starts
    and ends within the span mapped onto the clock of the profiler's CUDA
    events (5 ms of host sleep on either side: the mapping holds to better
    than 4 ms), and the span's device time covers the GEMM's."""
    from torch.profiler import ProfilerActivity, profile

    from maa3_tpu_torch import trace
    x = torch.randn(4096, 4096, device=cuda_dev)
    x @ x
    torch.cuda.synchronize()
    trace.enable(cuda_dev)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with trace.span("outer", device_time=True):
                time.sleep(0.005)
                x @ x
                torch.cuda.synchronize()
                time.sleep(0.005)
        d = trace.drain()
    finally:
        trace.disable()
    (s,) = d["spans"]
    c = d["clock"]
    lo, hi = (t - c["perf_ns"] + c["unix_ns"] for t in (s["start_ns"], s["end_ns"]))
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA" and not e.is_user_annotation()]
    gemm = max(kernels, key=lambda e: e.end_ns() - e.start_ns())
    assert lo + 4e6 < gemm.start_ns() < gemm.end_ns() < hi - 4e6
    assert s["device_ms"] >= (gemm.end_ns() - gemm.start_ns()) / 1e6


@pytest.mark.cuda
@pytest.mark.parametrize("lk", [312, 154])
@pytest.mark.parametrize("rows,heads,head_dim", [(32, 16, 72), (8, 32, 48)], ids=["xl", "xxl"])
def test_flash_forward_at_the_serving_shapes_matches_plain(cuda_dev, rows, heads, head_dim,
                                                           lk):
    """K3a at the serving attention of latent 312: XL's closed loop (32 dual
    rows x 16 heads of 72) and XXL's 4 prompts (8 dual rows x 32 heads of
    48), self-attention (Lk 312) and the cross-attention over the CLAP +
    FLAN-T5 context (Lk 154)."""
    q, k, v, _, _ = _flash_inputs(rows, heads, 312, lk, head_dim, torch.bfloat16, cuda_dev,
                                  False, seed=5)
    n = fa.launches["K3a"]
    _fwd_matches_plain(q, k, v, None, "direct")
    assert fa.launches["K3a"] == n + 1


@pytest.mark.cuda
def test_planned_step_on_flash_matches_the_dense_route(cuda_dev, monkeypatch):
    """A depth-2 DiT at XL width (1152, 16 heads of 72, a 154-token context
    of 1024) as the bf16 serving copy, one planned step at 16 rows: the card's
    route (K3a for self- and cross-attention, 4 launches) against the dense
    route forced on the same copy, both held to the copy's step in fp32
    (dense fp32 scores): the flash route's relative L2 gap may not exceed
    the dense route's by more than a quarter, and the two routes lie within
    1 % of each other."""
    from maa3_tpu_torch.models import dit as tdit
    cfg = tdit.DiTConfig(in_channels=20, context_dim=1024, hidden_size=1152, depth=2,
                         num_heads=16, fp32_residual=True)
    g = torch.Generator().manual_seed(8)
    dit = tdit.unfreeze_zero_init(tdit.dit_init_(tdit.DiT(cfg), g), g)
    card = tdit.serving_copy(dit.to(cuda_dev), torch.bfloat16)
    x = torch.randn(16, 20, 312, generator=g).to(cuda_dev)
    ctx = torch.randn(16, 154, 1024, generator=g).to(cuda_dev)
    t = torch.tensor([0, 400], device=cuda_dev)

    def step(dtype):
        plan = tdit.dit_sample_plan(card, t, ctx, compute_dtype=dtype)
        with torch.no_grad():
            return tdit.dit_apply_planned(card, x, plan["mods"][1], plan["final"][1],
                                          plan["yk"], plan["yv"], compute_dtype=dtype)

    n = fa.launches["K3a"]
    flash = step(torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches["K3a"] == n + 4
    with full_fp32():
        ref = step(torch.float32)
    monkeypatch.setattr(tdit, "dit_route", lambda *a, **k: tdit.Route())
    dense = step(torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches["K3a"] == n + 4

    def gap(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    g_flash, g_dense, g_routes = gap(flash, ref), gap(dense, ref), gap(flash, dense)
    print(f"planned step, 16 rows: flash vs fp32 {g_flash:.3e}, dense vs fp32 "
          f"{g_dense:.3e}, flash vs dense {g_routes:.3e}")
    assert torch.isfinite(flash).all() and ref.float().abs().max().item() > 0.1
    assert g_flash <= 1.25 * g_dense and g_routes <= 1e-2


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of a bf16 tensor (in fp32)."""
    e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))[1]
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1152, 1536, 64, 2056], ids=["xl", "xxl", "narrow", "row_loop"])
@pytest.mark.parametrize("branch", [True, False], ids=["residual", "entry"])
@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_residual_norm_modulate_kernel_matches_plain(cuda_dev, d, branch, out):
    """K5 at the closed loop's 32 dual rows x 312 tokens (XL 1152, XXL 1536;
    a narrow row and one past the register cache, 2056, which takes the row
    loop), with the MLP / attention branch and without (block 0's entry),
    the gate / shift / scale as strided chunks of a (B, 6D) modulation: h'
    within 1 fp32 ulp of the plain version (its products and sums round
    alone: the same bits), a bf16 x within 1 bf16 ulp on at most 0.1 % of
    its elements (the sum of squares is added in another order; where
    x = n (1 + scale) + shift cancels, the ulp is the larger of x's and 2^-20
    of |n (1 + scale)| + |shift|, the fp32 rounding of the terms), an fp32 x
    (an int8 GEMM's input) within 1e-6 of its largest value."""
    from maa3_tpu_torch.ops import dit_fused as fu
    g = torch.Generator(device=cuda_dev).manual_seed(11)
    b, l = 32, 312
    h = torch.randn(b, l, d, generator=g, device=cuda_dev) * 3.0
    br = torch.randn(b, l, d, generator=g, device=cuda_dev).to(torch.bfloat16)
    mods = torch.randn(b, 6 * d, generator=g, device=cuda_dev) * 0.5
    w = 1.0 + 0.1 * torch.randn(d, generator=g, device=cuda_dev)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    args = (br, gate) if branch else (None, None)
    want_h, want_x = fu.residual_norm_modulate_plain(h, *args, w, shift, scale, 1e-5, out)
    n = fu.launches["K5"]
    got_h, got_x = fu.residual_norm_modulate(h, *args, w, shift, scale, 1e-5, out)
    torch.cuda.synchronize()
    assert fu.launches["K5"] == n + 1 and got_h is h and got_x.dtype == out
    fp32_ulp = torch.finfo(torch.float32).eps * want_h.abs().clamp_min(2.0 ** -126)
    assert ((got_h - want_h).abs() <= fp32_ulp).all()
    diff = (got_x.float() - want_x.float()).abs()
    if out == torch.bfloat16:
        x32 = fu.residual_norm_modulate_plain(want_h, None, None, w, shift, scale, 1e-5,
                                              torch.float32)[1]
        terms = (x32 - shift[:, None, :]).abs() + shift[:, None, :].abs()
        ulp = torch.maximum(_bf16_ulp(want_x), 2.0 ** -20 * terms)
        off = (diff > 0).float().mean().item()
        worst = (diff / ulp).max().item()
        print(f"K5 D {d}: x differs from the plain version on {100 * off:.4f} % of elements, "
              f"by up to {worst:.3f} ulp")
        assert worst <= 1.0 and off <= 1e-3
    else:
        assert diff.max().item() <= 1e-6 * want_x.abs().max().item()


@pytest.mark.cuda
def test_residual_norm_modulate_refused_launch_raises(cuda_dev):
    """The C entry refuses a width that is no multiple of 8 (and returns its
    cudaError); the wrapper raises on what the kernel does not take."""
    from maa3_tpu_torch import cuda
    from maa3_tpu_torch.ops import dit_fused as fu
    h = torch.zeros(1, 4, 12, device=cuda_dev)
    mods = torch.zeros(1, 72, device=cuda_dev)
    lib = cuda.load()
    err = lib.maa3_residual_norm_modulate(h.data_ptr(), None, None, mods.data_ptr(),
                                          mods.data_ptr(), mods.data_ptr(), h.data_ptr(), 4, 4,
                                          12, 72, 1e-5, 0, cuda.stream_ptr(h))
    assert err != 0
    with pytest.raises(RuntimeError, match="cudaError"):
        cuda.check(err, "residual_norm_modulate")
    with pytest.raises(ValueError, match="D % 8"):
        fu.residual_norm_modulate(h, None, None, mods[0, :12], mods[:, :12], mods[:, 12:24],
                                  1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,heads,n_kv,head_dim", [
    (32, 16, 16, 72), (16, 32, 32, 48), (4, 8, 2, 64), (2, 4, 4, 6)],
    ids=["xl", "xxl", "gqa", "pair_path"])
def test_rope_qkv_heads_kernel_is_plain_bit_for_bit(cuda_dev, rows, heads, n_kv, head_dim):
    """K6 at the closed loop's XL shape (32 dual rows x 312, 16 heads of 72),
    XXL's (16 x 312, 32 heads of 48), a GQA projection and a head dim that
    is no multiple of 8 (one pair a thread): q, k and v the same bits as the
    plain version, contiguous and head-major."""
    from maa3_tpu_torch.ops import dit_fused as fu
    from maa3_tpu_torch.ops.rope import precompute_rope
    g = torch.Generator(device=cuda_dev).manual_seed(12)
    l = 312
    qkv = (torch.randn(rows, l, (heads + 2 * n_kv) * head_dim, generator=g, device=cuda_dev)
           * 2.0).to(torch.bfloat16)
    cos, sin = precompute_rope(head_dim, l, device=cuda_dev)
    want = fu.rope_qkv_heads_plain(qkv, cos, sin, heads, n_kv)
    n = fu.launches["K6"]
    got = fu.rope_qkv_heads(qkv, cos, sin, heads, n_kv)
    torch.cuda.synchronize()
    assert fu.launches["K6"] == n + 1
    for gt, wt in zip(got, want):
        assert gt.is_contiguous() and gt.shape == wt.shape and torch.equal(gt, wt)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,l,f", [(32, 312, 3072), (32, 312, 4096), (3, 157, 3072),
                                      (2, 9, 100)],
                         ids=["xl", "xxl", "odd_l", "column_path"])
def test_swiglu_kernel_matches_plain(cuda_dev, rows, l, f):
    """K7 at the closed loop's XL (32 dual rows x 312, F 3072) and XXL (F
    4096) shapes, an odd token count and a width that is no multiple of 8
    (one column a thread): the plain version's bits, or within one bf16 ulp
    on at most 0.1 % of the elements where the card's expf and PyTorch's
    sigmoid part (the share printed); contiguous (B, L, F)."""
    from maa3_tpu_torch.ops import dit_fused as fu
    g = torch.Generator(device=cuda_dev).manual_seed(14)
    x13 = (torch.randn(rows, l, 2 * f, generator=g, device=cuda_dev) * 3.0).to(torch.bfloat16)
    want = fu.swiglu_plain(x13)
    n = fu.launches["K7"]
    got = fu.swiglu(x13)
    torch.cuda.synchronize()
    assert fu.launches["K7"] == n + 1
    assert got.shape == want.shape and got.dtype == torch.bfloat16 and got.is_contiguous()
    diff = (got.float() - want.float()).abs()
    off = (diff > 0).float().mean().item()
    worst = (diff / _bf16_ulp(want)).max().item()
    print(f"K7 {(rows, l, f)}: differs from the plain version on {100 * off:.4f} % of "
          f"elements, by up to {worst:.3f} ulp")
    assert worst <= 1.0 and off <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,heads,l,hd", [(32, 16, 312, 72), (32, 32, 312, 48),
                                          (3, 8, 157, 24), (2, 4, 9, 6)],
                         ids=["xl", "xxl", "odd_l", "element_path"])
@pytest.mark.parametrize("gate_dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_gated_merge_heads_kernel_is_plain_bit_for_bit(cuda_dev, b, heads, l, hd, gate_dtype):
    """K8 at the closed loop's XL (32 dual rows x 16 heads of 72 x 312) and
    XXL (32 heads of 48) shapes, the music server's heads of 24 at an odd
    token count, and a head dim that is no multiple of 8 (one element a
    thread), with an fp32 and a bf16 gate: the plain version's bits, a
    contiguous token-major (B, L, H * hd)."""
    from maa3_tpu_torch.ops import dit_fused as fu
    g = torch.Generator(device=cuda_dev).manual_seed(15)
    out, out_y = ((torch.randn(b, heads, l, hd, generator=g, device=cuda_dev) * 2.0)
                  .to(torch.bfloat16) for _ in range(2))
    gate = torch.randn(heads, generator=g, device=cuda_dev).to(gate_dtype)
    want = fu.gated_merge_heads_plain(out, out_y, gate)
    n = fu.launches["K8"]
    got = fu.gated_merge_heads(out, out_y, gate)
    torch.cuda.synchronize()
    assert fu.launches["K8"] == n + 1
    assert got.is_contiguous() and got.shape == (b, l, heads * hd) and torch.equal(got, want)


@pytest.mark.cuda
def test_swiglu_and_merge_refuse_what_they_do_not_take(cuda_dev):
    """The C entries refuse a non-positive width or head dim (and return
    their cudaError); the wrappers raise on a dtype, a layout or a gate the
    kernels do not take."""
    from maa3_tpu_torch import cuda
    from maa3_tpu_torch.ops import dit_fused as fu
    x = torch.zeros(2, 4, 16, dtype=torch.bfloat16, device=cuda_dev)
    lib = cuda.load()
    assert lib.maa3_swiglu(x.data_ptr(), x.data_ptr(), 8, 0, cuda.stream_ptr(x)) != 0
    assert lib.maa3_gated_merge_heads(x.data_ptr(), x.data_ptr(), x.data_ptr(), x.data_ptr(),
                                      1, 4, 2, 0, 0, cuda.stream_ptr(x)) != 0
    with pytest.raises(ValueError, match="bf16"):
        fu.swiglu(x.float())
    with pytest.raises(ValueError, match="contiguous"):
        fu.swiglu(x.transpose(1, 2))
    o = x.reshape(1, 2, 4, 16)
    with pytest.raises(ValueError, match="one shape"):
        fu.gated_merge_heads(o, o.transpose(2, 3), torch.zeros(2, device=cuda_dev))
    with pytest.raises(ValueError, match="gate"):
        fu.gated_merge_heads(o, o, torch.zeros(3, device=cuda_dev))


@pytest.mark.cuda
@pytest.mark.parametrize("width,heads,depth", [(1152, 16, 28), (1536, 32, 32)],
                         ids=["xl", "xxl"])
def test_planned_step_on_the_fused_blocks_matches_the_unfused_route(cuda_dev, monkeypatch,
                                                                    width, heads, depth):
    """XL (28 blocks of 1152, 16 heads of 72) and XXL (32 of 1536, 32 heads
    of 48) as bf16 serving copies with the fp32 residual stream, one planned
    step at 16 rows: the fused blocks (K5 twice and K6, K7, K8 once a block,
    every launch's return code checked by its wrapper) against the same copy on
    `_block_apply`, both held to the copy's step in fp32, with the planned
    route test's tolerance: the fused gap may not exceed the unfused one by
    more than a quarter, and the two lie within 1 % of each other."""
    from maa3_tpu_torch import trace
    from maa3_tpu_torch.models import dit as tdit
    from maa3_tpu_torch.ops import dit_fused as fu
    cfg = tdit.DiTConfig(in_channels=20, context_dim=1024, hidden_size=width, depth=depth,
                         num_heads=heads, fp32_residual=True)
    g = torch.Generator(device=cuda_dev).manual_seed(8)
    with torch.device(cuda_dev):
        dit = tdit.unfreeze_zero_init(tdit.dit_init_(tdit.DiT(cfg), g), g)
    card = tdit.serving_copy(dit, torch.bfloat16)
    del dit
    x = torch.randn(16, 20, 312, generator=g, device=cuda_dev)
    ctx = torch.randn(16, 154, 1024, generator=g, device=cuda_dev)
    t = torch.tensor([0, 400], device=cuda_dev)

    def step(dtype):
        plan = tdit.dit_sample_plan(card, t, ctx, compute_dtype=dtype)
        with torch.no_grad():
            return tdit.dit_apply_planned(card, x, plan["mods"][1], plan["final"][1],
                                          plan["yk"], plan["yv"], compute_dtype=dtype)

    since, n = dict(trace.counts), dict(fu.launches)
    fused = step(torch.bfloat16)
    torch.cuda.synchronize()
    assert trace.counts_since(since) == {"attn_flash": 2 * depth, "attn_dense": 0,
                                         "dit_fused": depth, "dit_plain": 0}
    assert fu.launches == {"K5": n["K5"] + 2 * depth, "K6": n["K6"] + depth,
                           "K7": n["K7"] + depth, "K8": n["K8"] + depth}
    with full_fp32():
        ref = step(torch.float32)
    route = tdit.dit_route
    monkeypatch.setattr(tdit, "dit_route", lambda *a, **k: dataclasses.replace(
        route(*a, **k), fused=False))
    since = dict(trace.counts)
    unfused = step(torch.bfloat16)
    torch.cuda.synchronize()
    assert trace.counts_since(since) == {"attn_flash": 2 * depth, "attn_dense": 0,
                                         "dit_fused": 0, "dit_plain": depth}

    def gap(a, b):
        return ((a.float() - b.float()).norm() / b.float().norm()).item()

    g_fused, g_unfused, g_routes = gap(fused, ref), gap(unfused, ref), gap(fused, unfused)
    print(f"planned step, {depth} blocks of {width}, 16 rows: fused vs fp32 {g_fused:.3e}, "
          f"unfused vs fp32 {g_unfused:.3e}, fused vs unfused {g_routes:.3e}")
    assert torch.isfinite(fused).all() and ref.float().abs().max().item() > 0.1
    assert g_fused <= 1.25 * g_unfused and g_routes <= 1e-2
