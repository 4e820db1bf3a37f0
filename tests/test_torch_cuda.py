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
last bits vary from run to run; the same tolerances cover that.
"""

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
@pytest.mark.parametrize("shape", [(2, 8, 300), (1, 3, 5), (2, 16, 2500)])
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
@pytest.mark.parametrize("k,d,c_in,c_out,T", [
    (3, 1, 8, 8, 300), (7, 3, 24, 24, 1000), (11, 5, 48, 48, 600),
    (7, 1, 24, 1, 513), (3, 5, 4, 12, 7)])
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
    (2, 2, 33, 40, 16, False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain(cuda_dev, b, h, lq, lk, d, masked, block_k, dtype):
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
    with full_fp32():
        grads_ref = fa.flash_bwd_plain(q, k, v, mask, lse_ref, do, delta, scale)
    torch.cuda.synchronize()
    assert fa.launches[name] == n[name] + 1 and fa.launches["K4a"] == n["K4a"] + 1
    assert o.dtype == dtype and lse.shape == (b * h, lq)
    live = lse_ref > -1e29  # rows with a valid key (lse of an empty row is ~-6.9e29)
    for got, want in ((o, o_ref), (lse[live], lse_ref[live]), *zip(grads, grads_ref)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= _tol(want), err
    if masked and b >= 3:  # a row with no valid key: o = 0, zero gradients
        assert not o[-1].any() and not any(g[-1].any() for g in grads)


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
