"""The planned serving step's fused block (models/dit.py `_fused_block`;
ops/dit_fused.py K5 - K8) on the CPU: each plain version against the
unfused chain it replaces, bit for bit; the fused block loop with its
carried residual, through the plain versions, against the `_block_apply`
loop on small DiTs, bit for bit; the block-step counts. Which applies take
it: tests/test_torch_attention_route.py `test_dit_route`."""

import dataclasses

import pytest
import torch

from maa3_tpu_torch import trace
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.ops import dit_fused as fu
from maa3_tpu_torch.ops.basic import modulate, rms_norm, silu
from maa3_tpu_torch.ops.ffn import FeedForward, feed_forward_apply
from maa3_tpu_torch.ops.rope import apply_rope, precompute_rope

torch.set_num_threads(2)

BF16 = torch.bfloat16
def _stream(b, l, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(b, l, d, generator=g) * 3.0
    branch = torch.randn(b, l, d, generator=g).to(BF16)
    mods = torch.randn(b, 6 * d, generator=g) * 0.5
    w = 1.0 + 0.1 * torch.randn(d, generator=g)
    return h, branch, mods, w


@pytest.mark.parametrize("b,l,d", [(3, 17, 64), (2, 40, 1152), (1, 9, 1536)])
@pytest.mark.parametrize("with_branch", [True, False])
@pytest.mark.parametrize("out", [BF16, torch.float32])
def test_residual_norm_modulate_plain_is_the_unfused_chain(b, l, d, with_branch, out):
    """K5's plain version on strided chunks of a (B, 6D) modulation gives the
    bits of `_block_apply`'s gated residual, rms_norm, modulate and the GEMM
    input's cast (bf16; none for an int8 GEMM); without a branch h comes back
    as it is."""
    h, branch, mods, w = _stream(b, l, d)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    n = dict(fu.launches)
    got_h, got_x = fu.residual_norm_modulate(h, branch if with_branch else None,
                                             gate if with_branch else None, w, shift, scale,
                                             1e-5, out)
    want_h = h + gate[:, None, :].to(h.dtype) * branch if with_branch else h
    want_x = modulate(rms_norm(w, want_h, 1e-5), shift, scale).to(out)
    assert got_h.dtype == torch.float32 and got_x.dtype == out
    assert torch.equal(got_h, want_h) and torch.equal(got_x, want_x)
    assert with_branch or got_h is h
    assert fu.launches == n  # the CPU never launches a kernel


@pytest.mark.parametrize("b,l,heads,n_kv,hd", [(2, 31, 4, 4, 72), (3, 12, 8, 8, 48),
                                               (2, 9, 4, 2, 16), (1, 5, 2, 1, 6)])
def test_rope_qkv_heads_plain_is_the_unfused_chain(b, l, heads, n_kv, hd):
    """K6's plain version gives the bits of ops/rope.py's apply_rope on the
    split wqkv product, moved to contiguous (B, heads, L, hd) as the flash
    route copies it; v is moved unrotated (GQA: n_kv of the heads)."""
    g = torch.Generator().manual_seed(1)
    qkv = (torch.randn(b, l, (heads + 2 * n_kv) * hd, generator=g) * 2.0).to(BF16)
    cos, sin = precompute_rope(hd, l + 3)
    n = dict(fu.launches)
    got = fu.rope_qkv_heads(qkv, cos, sin, heads, n_kv)
    xq, xk, xv = qkv.split([heads * hd, n_kv * hd, n_kv * hd], dim=-1)
    xq, xk = apply_rope(xq.reshape(b, l, heads, hd), xk.reshape(b, l, n_kv, hd), cos, sin)
    want = [t.transpose(1, 2).contiguous() for t in (xq, xk, xv.reshape(b, l, n_kv, hd))]
    for gt, wt, nh in zip(got, want, (heads, n_kv, n_kv)):
        assert gt.shape == (b, nh, l, hd) and gt.dtype == BF16 and gt.is_contiguous()
        assert torch.equal(gt, wt)
    assert fu.launches == n


# (batch, tokens, heads, head dim): XL's heads of 72, XXL's of 48, the music
# server's of 24, odd token counts
MERGE_SHAPES = [(2, 31, 4, 72), (3, 12, 8, 48), (2, 9, 6, 24), (1, 5, 2, 6)]


@pytest.mark.parametrize("b,l,heads,hd", MERGE_SHAPES)
@pytest.mark.parametrize("gate_dtype", [torch.float32, BF16])
def test_gated_merge_heads_plain_is_the_unfused_chain(b, l, heads, hd, gate_dtype):
    """K8's plain version gives the bits of ops/attention.py `_attend`'s
    gated merge (the gate's tanh in fp32 cast to bf16, the broadcast product,
    the sum) and its `transpose(1, 2).reshape` to wo's (B, L, H * hd) input;
    the gate an fp32 leaf (serving copies) or bf16. Through the entry point
    on the CPU: no launch."""
    g = torch.Generator().manual_seed(2)
    out, out_y = ((torch.randn(b, heads, l, hd, generator=g) * 2.0).to(BF16) for _ in range(2))
    gate = torch.randn(heads, generator=g).to(gate_dtype)
    n = dict(fu.launches)
    got = fu.gated_merge_heads(out, out_y, gate)
    tg = torch.tanh(gate.float()).to(out_y.dtype)
    want = (out + out_y * tg[None, :, None, None]).transpose(1, 2).reshape(b, l, heads * hd)
    assert got.shape == (b, l, heads * hd) and got.dtype == BF16 and got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(fu.gated_merge_heads_plain(out, out_y, gate),
                                                  want)
    assert fu.launches == n


# (batch, tokens, width, multiple_of): XL's FFN (1152 -> 3072) and XXL's
# (1536 -> 4096) at few tokens, an odd count, a narrow FFN (64 -> 176)
SWIGLU_SHAPES = [(2, 5, 1152, 256), (1, 3, 1536, 256), (3, 7, 64, 16)]


@pytest.mark.parametrize("b,l,d,multiple_of", SWIGLU_SHAPES)
def test_swiglu_plain_is_the_unfused_chain(b, l, d, multiple_of):
    """K7's plain version on a bf16 serving copy's fused w13 product gives
    the bits of ops/ffn.py's `silu(x1) * x3` on its `chunk` halves, and w2
    on it the bits of feed_forward_apply. Through the entry point on the
    CPU: no launch."""
    g = torch.Generator().manual_seed(4)
    ff = FeedForward(d, 4 * d, multiple_of)
    f = ff.w2.weight.shape[1]
    for lin in (ff.w1, ff.w2, ff.w3):
        lin.weight.data = (torch.randn(lin.weight.shape, generator=g)
                           * lin.weight.shape[1] ** -0.5).to(BF16)
    ff.w13 = torch.cat([ff.w1.weight, ff.w3.weight])
    x = (torch.randn(b, l, d, generator=g) * 2.0).to(BF16)
    x13 = x @ ff.w13.t()
    n = dict(fu.launches)
    got = fu.swiglu(x13)
    x1, x3 = x13.chunk(2, dim=-1)
    assert got.shape == (b, l, f) and got.dtype == BF16 and got.is_contiguous()
    assert torch.equal(got, silu(x1) * x3) and torch.equal(fu.swiglu_plain(x13), got)
    assert torch.equal(got @ ff.w2.weight.t(), feed_forward_apply(ff, x, BF16))
    assert fu.launches == n


def test_kernel_entries_raise_off_the_cpu_and_the_card():
    h, branch, mods, w = _stream(1, 4, 16)
    shift, scale, gate = mods.chunk(6, dim=-1)[:3]
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fu.residual_norm_modulate(h.to(meta), None, None, w, shift, scale, 1e-5)
    cos, sin = precompute_rope(8, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.rope_qkv_heads(torch.empty(1, 4, 24, dtype=BF16, device=meta), cos, sin, 1, 1)
    o = torch.empty(1, 2, 4, 8, dtype=BF16, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fu.gated_merge_heads(o, o, torch.zeros(2, device=meta))
    with pytest.raises(ValueError, match="unsupported device"):
        fu.swiglu(torch.empty(1, 4, 32, dtype=BF16, device=meta))


def _dit(seed=3, **over):
    cfg = tdit.DiTConfig(**dict(dict(in_channels=4, context_dim=16, hidden_size=64, depth=3,
                                     num_heads=4, multiple_of=16, fp32_residual=True),
                                **over))
    gen = torch.Generator().manual_seed(seed)
    dit = tdit.unfreeze_zero_init(tdit.dit_init_(tdit.DiT(cfg), gen), gen)
    return dit, gen


def _planned(dit, gen, b=3, t=24, ly=7, y_mask=None):
    x = torch.randn(b, 4, t, generator=gen)
    ctx = torch.randn(b, ly, 16, generator=gen)
    plan = tdit.dit_sample_plan(dit, torch.tensor([0, 500]), ctx, context_mask=y_mask,
                                compute_dtype=BF16)

    def step():
        with torch.no_grad():
            return tdit.dit_apply_planned(dit, x, plan["mods"][1], plan["final"][1],
                                          plan["yk"], plan["yv"], y_mask=y_mask,
                                          compute_dtype=BF16)
    return step


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("over", [{}, {"n_kv_heads": 2}, {"hidden_size": 96, "num_heads": 2}])
def test_fused_block_loop_is_the_block_apply_loop_on_the_cpu(monkeypatch, attn, over):
    """A bf16 serving copy with the fp32 residual stream, one planned step:
    the fused loop forced onto the CPU (K5 - K8 through their plain
    versions, each block's MLP residual carried into the next block's entry)
    gives the bits of the `_block_apply` loop, on the dense attention route
    and on the flash route (its plain versions); GQA and heads of 48
    included. The block-step counts follow the route."""
    dit, gen = _dit(**over)
    step = _planned(tdit.serving_copy(dit, BF16), gen)
    flash = attn == "flash"
    route = tdit.dit_route
    monkeypatch.setattr(tdit, "dit_route", lambda *a, **k: dataclasses.replace(
        route(*a, **k), self_flash=flash, cross_flash=flash))
    since = dict(trace.counts)
    want = step()
    assert trace.counts_since(since) == {"attn_flash": 6 * flash, "attn_dense": 6 * (not flash),
                                         "dit_fused": 0, "dit_plain": 3}
    monkeypatch.setattr(tdit, "dit_route", lambda *a, **k: tdit.Route(flash, flash, True))
    since = dict(trace.counts)
    got = step()
    assert trace.counts_since(since) == {"attn_flash": 6 * flash, "attn_dense": 6 * (not flash),
                                         "dit_fused": 3, "dit_plain": 0}
    assert got.dtype == torch.float32 and got.abs().max().item() > 0.01
    assert torch.equal(got, want)


def test_fused_block_loop_with_a_context_mask_and_int8_weights(monkeypatch):
    """A ragged context mask (cross-attention dense on the card's route) and
    int8 serving copies (w8a8 GEMMs, per channel and without w2's) run the
    fused loop too, with the same bits: K5 gives an int8 GEMM its input in
    fp32, which dense_w8a8 quantizes, as the unfused chain does."""
    dit, gen = _dit(seed=5)
    mask = torch.arange(7)[None, :] < torch.tensor([[7], [3], [1]])
    steps = [_planned(tdit.serving_copy(dit, BF16), gen, y_mask=mask),
             _planned(tdit.quant_serving_copy(dit), gen),
             _planned(tdit.quant_serving_copy(dit, skip_w2=True), gen)]
    want = [s() for s in steps]
    route = tdit.dit_route
    monkeypatch.setattr(tdit, "dit_route", lambda *a, **k: dataclasses.replace(
        route(*a, **k), fused=True))
    since = dict(trace.counts)
    for s, w in zip(steps, want):
        assert torch.equal(s(), w)
    assert trace.counts_since(since) == {"attn_flash": 0, "attn_dense": 18, "dit_fused": 9,
                                         "dit_plain": 0}


def test_training_fp32_and_calibration_keep_block_apply():
    """The CPU's unpatched route: dit_apply (training's forward, autograd
    on), fp32 serving and the SmoothQuant statistics run `_block_apply`
    only; the planned step on the CPU counts its block-steps as plain."""
    dit, gen = _dit()
    since, n = dict(trace.counts), dict(fu.launches)
    x = torch.randn(2, 4, 24, generator=gen)
    ctx = torch.randn(2, 7, 16, generator=gen)
    tdit.dit_apply(dit, x, torch.tensor([3, 700]), ctx, compute_dtype=BF16,
                   training=True).sum().backward()
    plan = tdit.dit_sample_plan(dit, torch.tensor([0, 500]), ctx, compute_dtype=None)
    with torch.no_grad():
        tdit.dit_apply_planned(dit, x, plan["mods"][0], plan["final"][0], plan["yk"],
                               plan["yv"], compute_dtype=None, return_stats=True)
    assert trace.counts_since(since) == {"attn_flash": 0, "attn_dense": 12, "dit_fused": 0,
                                         "dit_plain": 3}
    assert fu.launches == n
