"""The planned serving step's attention route (models/dit.py
card_attention_route) on the CPU: the route each device, dtype, grad mode,
head dim and context mask takes; self- and gated cross-attention through
the flash route (its plain versions here) against the dense route; the
plan's contiguous head-major context K/V against views of the (B, Ly, kv)
layout."""

import copy

import pytest
import torch

from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.ops import attention as tatt
from maa3_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from maa3_tpu_torch.ops.rope import precompute_rope

torch.set_num_threads(2)

BF16 = torch.bfloat16


@pytest.mark.parametrize("device,dtype,grad,head_dim,y_masked,want", [
    ("cuda", BF16, False, 72, False, (True, True)),
    ("cuda", BF16, False, 48, False, (True, True)),
    ("cuda", BF16, False, 72, True, (True, False)),     # a context mask: cross stays dense
    ("cpu", BF16, False, 72, False, (False, False)),
    ("cuda", torch.float32, False, 72, False, (False, False)),
    ("cuda", BF16, True, 72, False, (False, False)),    # autograd: training's route
    ("cuda", BF16, False, MAX_HEAD_DIM + 8, False, (False, False)),
])
def test_card_attention_route(device, dtype, grad, head_dim, y_masked, want):
    assert tdit.card_attention_route(device, dtype, grad, head_dim, y_masked) == want


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
    calls = dict(tatt.calls)
    dense = tatt.attention_apply(att, x, cos, sin, **kw)
    assert tatt.route_counts(calls) == {"attn_flash": 0, "attn_dense": 2}
    calls = dict(tatt.calls)
    flash = tatt.attention_apply(att, x, cos, sin, use_flash=True, cross_flash=True, **kw)
    assert tatt.route_counts(calls) == {"attn_flash": 2, "attn_dense": 0}
    assert flash.dtype == dense.dtype == BF16 and flash.shape == (b, l, d)
    scale = dense.float().abs().max().item()
    assert scale > 0.1
    assert (flash.float() - dense.float()).abs().max().item() <= 2.0 ** -6 * scale
    # each route alone, and the context K/V as context_kv's views
    for use_flash, cross_flash in ((True, False), (False, True)):
        mixed = tatt.attention_apply(att, x, cos, sin, use_flash=use_flash,
                                     cross_flash=cross_flash, **dict(kw, y_kv=(yk, yv)))
        assert (mixed.float() - dense.float()).abs().max().item() <= 2.0 ** -6 * scale
    # a ragged context mask (every row keeps a key): the same on both routes
    y_mask = torch.arange(ly)[None, :] < torch.tensor([[ly], [ly // 2], [1]])
    masked = [tatt.attention_apply(att, x, cos, sin, use_flash=f, cross_flash=f,
                                   y_mask=y_mask, **kw) for f in (False, True)]
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
    calls = dict(tatt.calls)
    with torch.no_grad():
        got = tdit.dit_apply_planned(dit, x, plan["mods"][1], plan["final"][1], plan["yk"],
                                     plan["yv"], compute_dtype=dtype)
        want = tdit.dit_apply_planned(copy.deepcopy(dit), x, plan["mods"][1],
                                      plan["final"][1], old["yk"], old["yv"],
                                      compute_dtype=dtype)
    assert tatt.route_counts(calls) == {"attn_flash": 0, "attn_dense": 8}
    assert torch.equal(got, want)
