"""The route of each DiT apply (models/dit.py `dit_route`) on the CPU: the
Route each caller, device, dtype, grad mode, head dim, width, context mask,
residual dtype, tp, SmoothQuant statistics, qk_norm, weight layout, length
and use_flash takes, and what `check_limits` refuses; self- and gated
cross-attention through the flash route (its plain versions here) against
the dense route; the plan's contiguous head-major context K/V against views
of the (B, Ly, kv) layout."""

import copy
import dataclasses
import types

import pytest
import torch

from maa3_tpu_torch import trace
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.models.dit_moe import MoEDiTConfig
from maa3_tpu_torch.ops import attention as tatt
from maa3_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from maa3_tpu_torch.ops.rope import precompute_rope
from maa3_tpu_torch.system import check_limits

torch.set_num_threads(2)

BF16 = torch.bfloat16
R = tatt.Route
XL = tdit.DiTConfig(hidden_size=1152, depth=28, num_heads=16, fp32_residual=True)  # heads of 72
XXL = {"hidden_size": 1536, "num_heads": 32}                # heads of 48
WIDE = {"hidden_size": (MAX_HEAD_DIM + 8) * 16}             # heads past the kernels' limit
# the planned bf16 serving step on the card with a serving copy's fused wqkv
CARD = {"device_type": "cuda", "dtype": BF16, "grad_enabled": False, "fused_wqkv": True}
APART = dict(CARD, fused_wqkv=False)  # wq / wk / wv apart: the attention's route alone


def _planned(**over):
    return dict(CARD, **over)


@pytest.mark.parametrize("over,seq,kw,want", [
    # the planned step's attention: K3a at every length on the card
    pytest.param({}, 39, APART, R(True, True), id="card-39"),
    pytest.param(XXL, 624, APART, R(True, True), id="card-hd48-624"),
    pytest.param({}, 312, dict(APART, y_masked=True), R(True, False), id="card-masked"),
    # off the card's route the planned step follows JAX's inference rule
    pytest.param({}, 4096, dict(APART, device_type="cpu"), R(), id="cpu-4096"),
    pytest.param({}, 4097, dict(APART, dtype=torch.float32), R(True), id="fp32-4097"),
    pytest.param({}, 5000, dict(APART, grad_enabled=True), R(True), id="grad-5000"),
    pytest.param(WIDE, 312, APART, R(), id="hd80"),
    # the planned step's blocks: `_fused_block` or `_block_apply`
    pytest.param({}, 312, CARD, R(True, True, True), id="fused-xl"),
    pytest.param(XXL, 312, CARD, R(True, True, True), id="fused-xxl"),
    pytest.param({}, 312, _planned(device_type="cpu"), R(), id="fused-cpu"),
    pytest.param({}, 312, _planned(dtype=torch.float32), R(), id="fused-fp32"),
    pytest.param({}, 312, _planned(grad_enabled=True), R(), id="fused-grad"),
    pytest.param({"fp32_residual": False}, 312, CARD, R(True, True), id="bf16-residual"),
    pytest.param({}, 312, _planned(tp=object()), R(True, True), id="tp"),
    pytest.param({}, 312, _planned(return_stats=True), R(True, True), id="smoothquant-stats"),
    pytest.param({"qk_norm": True}, 312, CARD, R(True, True), id="qk-norm"),
    pytest.param({}, 312, APART, R(True, True), id="wqkv-apart"),
    pytest.param(WIDE, 312, CARD, R(), id="fused-hd80"),
    pytest.param({"hidden_size": 7 * 16}, 312, CARD, R(True, True), id="odd-head-dim"),
    pytest.param({"hidden_size": 10 * 6, "num_heads": 6}, 312, CARD, R(True, True),
                 id="width-60"),
    pytest.param({"hidden_size": 12 * 6, "num_heads": 6}, 312, CARD, R(True, True, True),
                 id="width-72"),
    # use_flash decides self-attention on the planned step, and only it
    pytest.param({"use_flash": False}, 312, CARD, R(False, True, True), id="planned-flash-off"),
    pytest.param({"use_flash": True}, 312, CARD, R(True, True, True), id="planned-flash-on"),
    pytest.param({"use_flash": True}, 312, _planned(device_type="cpu"), R(True),
                 id="planned-flash-on-cpu"),
    # dit_apply and the pipeline stage: JAX's rule, dense cross-attention
    pytest.param({}, 1247, {"training": True}, R(), id="train-1247"),
    pytest.param({}, 1248, {"training": True}, R(True), id="train-1248"),
    pytest.param({"use_flash": False}, 1248, {"training": True}, R(), id="train-flash-off"),
    pytest.param({}, 4097, {}, R(True), id="infer-4097"),
])
def test_dit_route(over, seq, kw, want):
    """Head dim 7 (odd), 80 (past the kernels' 72) and a width of 60 (not a
    multiple of 8) keep `_block_apply`; a width of 72 (heads of 12) takes the
    fused block."""
    assert tdit.dit_route(dataclasses.replace(XL, **over), seq, **kw) == want


@pytest.mark.parametrize("seq,training,want", [(1248, True, R(True)), (1247, True, R()),
                                               (4096, False, R()), (4097, False, R(True))])
def test_moe_route_is_the_text_dits_rule(seq, training, want):
    """The video MoE's apply (training) and planned step (inference)."""
    cfg = MoEDiTConfig(hidden_size=64, depth=2, num_heads=4)
    assert tdit.dit_route(cfg, seq, training) == want


@pytest.mark.parametrize("over,device,latent_len,refuse", [
    (WIDE, "cuda", 5000, True),                       # the inference rule sends it to flash
    (dict(WIDE, use_flash=True), "cuda", 312, True),
    (WIDE, "cuda", 312, False),                       # dense below 4097 tokens
    (WIDE, "cpu", 5000, False),                       # the CPU runs the plain versions
    ({}, "cuda", 5000, False),                        # heads of 72: the kernels take them
])
def test_check_limits(over, device, latent_len, refuse):
    spec = types.SimpleNamespace(dit=dataclasses.replace(XL, **over), mel_length=312)
    if refuse:
        with pytest.raises(ValueError, match="exceeds the flash kernels"):
            check_limits(spec, device, latent_len)
    else:
        check_limits(spec, device, latent_len)


def _attention(hd=72, heads=2, ctx=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    d = hd * heads
    att = tatt.Attention(d, heads, y_dim=ctx)
    with torch.no_grad():
        for p in att.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (0.5 if p.dim() == 1 else d ** -0.5))
    return att, g


def test_flash_route_matches_dense_for_self_and_gated_cross_attention():
    """bf16, 2 heads of 72, L = 40, Ly = 20, the context K/V in the plan's
    head-major layout; tolerance: two bf16 ulps of the largest output."""
    att, g = _attention()
    b, l, ly, d = 3, 40, 20, 144
    x = torch.randn(b, l, d, generator=g).to(BF16)
    y = torch.randn(b, ly, 24, generator=g).to(BF16)
    cos, sin = precompute_rope(72, l)
    yk, yv = tatt.context_kv(att, y, BF16)
    y_kv = (yk.contiguous(), yv.contiguous())
    kw = dict(n_heads=2, compute_dtype=BF16, y_kv=y_kv)
    since = dict(trace.counts)
    dense = tatt.attention_apply(att, x, cos, sin, **kw)
    assert trace.counts_since(since) == {"attn_flash": 0, "attn_dense": 2, "dit_fused": 0,
                                         "dit_plain": 0}
    since = dict(trace.counts)
    flash = tatt.attention_apply(att, x, cos, sin, route=R(True, True), **kw)
    assert trace.counts_since(since) == {"attn_flash": 2, "attn_dense": 0, "dit_fused": 0,
                                         "dit_plain": 0}
    assert flash.dtype == dense.dtype == BF16 and flash.shape == (b, l, d)
    scale = dense.float().abs().max().item()
    assert scale > 0.1
    assert (flash.float() - dense.float()).abs().max().item() <= 2.0 ** -6 * scale
    # each route alone, and the context K/V as context_kv's views
    for route in (R(True, False), R(False, True)):
        mixed = tatt.attention_apply(att, x, cos, sin, route=route, **dict(kw, y_kv=(yk, yv)))
        assert (mixed.float() - dense.float()).abs().max().item() <= 2.0 ** -6 * scale
    # a ragged context mask (every row keeps a key): the same on both routes
    y_mask = torch.arange(ly)[None, :] < torch.tensor([[ly], [ly // 2], [1]])
    masked = [tatt.attention_apply(att, x, cos, sin, route=R(f, f), y_mask=y_mask, **kw)
              for f in (False, True)]
    assert (masked[1].float() - masked[0].float()).abs().max().item() <= 2.0 ** -6 * scale
    assert (masked[0].float() - dense.float()).abs().max().item() > 2.0 ** -4 * scale


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_head_major_plan_gives_the_planned_step_of_the_old_layout(dtype):
    """dit_sample_plan's contiguous head-major context K/V against the same
    K/V held in the (B, Ly, kv) layout the plan held before (head-major
    views of it), on the dense route (CPU)."""
    cfg = tdit.DiTConfig(in_channels=4, context_dim=16, hidden_size=64, depth=2, num_heads=4,
                         multiple_of=16)
    gen = torch.Generator().manual_seed(3)
    dit = tdit.unfreeze_zero_init(tdit.dit_init_(tdit.DiT(cfg), gen), gen)
    if dtype == BF16:
        dit = tdit.serving_copy(dit, BF16)
    x = torch.randn(4, 4, 24, generator=gen)
    ctx = torch.randn(4, 7, 16, generator=gen)
    plan = tdit.dit_sample_plan(dit, torch.tensor([0, 500]), ctx, compute_dtype=dtype)
    assert all(t.shape == (4, 4, 7, 16) and t.is_contiguous()
               for t in plan["yk"] + plan["yv"])
    old = {k: [t.transpose(1, 2).flatten(2).unflatten(2, (4, 16)).transpose(1, 2)
               for t in plan[k]] for k in ("yk", "yv")}
    assert not any(t.is_contiguous() for t in old["yk"] + old["yv"])
    since = dict(trace.counts)
    with torch.no_grad():
        got = tdit.dit_apply_planned(dit, x, plan["mods"][1], plan["final"][1], plan["yk"],
                                     plan["yv"], compute_dtype=dtype)
        want = tdit.dit_apply_planned(copy.deepcopy(dit), x, plan["mods"][1],
                                      plan["final"][1], old["yk"], old["yv"],
                                      compute_dtype=dtype)
    assert trace.counts_since(since) == {"attn_flash": 0, "attn_dense": 8, "dit_fused": 0,
                                         "dit_plain": 4}
    assert torch.equal(got, want)
