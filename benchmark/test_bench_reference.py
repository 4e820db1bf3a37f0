"""The plain reference against the program at tiny sizes in fp32 on the CPU,
and the yardstick's counts against hand counts and PyTorch's FLOP counter."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, yardstick
from benchmark.reference import dit as rdit
from benchmark.reference import text, vae, vocoder
from benchmark.reference.tokenizer import hash_tokens

SEED = 2900000001


@pytest.fixture(scope="module")
def tiny():
    from benchmark.conftest import TINY
    from maa3_tpu_torch.system import MAA3System
    cfg = TINY
    state = harness.seeded_state(cfg, SEED, "cpu", 8)
    voc, clap = harness.part_configs(cfg)
    system = MAA3System.from_state_dicts(harness.model_spec(cfg, 8), state, voc, clap,
                                         device="cpu", compute_dtype=torch.float32)
    return cfg, state, system


def close(a, b, tol):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12)) <= tol


def test_hash_tokens_are_the_programs():
    from maa3_tpu_torch.data.tokenizers import HashTokenizer
    texts = ["A dog barks", "", "rain on a tin roof " * 30]
    ids, mask = hash_tokens(texts)
    pids, pmask = HashTokenizer()(texts)
    assert np.array_equal(ids, pids) and np.array_equal(mask, pmask)


def test_conditioner(tiny):
    cfg, state, system = tiny
    ori = ["a dog barks in the distance", ""]
    struct = ["<a dog barks in the distance& all>", ""]
    got = system.get_learned_conditioning(system.captions(ori, struct))
    want = text.clap_flan(state["cond"], cfg["conditioner"], ori, struct, "cpu")
    assert got.shape == want.shape and close(got, want, 1e-5)


def test_dit_and_the_cfg_ode(tiny):
    from maa3_tpu_torch.models.dit import dit_apply
    cfg, state, system = tiny
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 4, 8, generator=g)
    ctx = torch.randn(3, 154, 32, generator=g)
    t = torch.tensor([0, 417, 999])
    got = dit_apply(system.dit, x, t, ctx, compute_dtype=None)
    assert close(got, rdit.dit(state["dit"], cfg["model"]["dit"], x, t, ctx), 1e-5)
    uc = torch.randn(3, 154, 32, generator=g)
    z = system.sample_cfg(ctx, 5.0, uc, x0=x, timesteps=6)
    assert close(z, rdit.sample_cfg(state["dit"], cfg["model"]["dit"], x, ctx, uc, 5.0, 6), 1e-5)


def test_vae_and_vocoder(tiny):
    from maa3_tpu_torch.models.bigvgan import bigvgan_apply
    from maa3_tpu_torch.models.vae1d import vae_encode_moments
    cfg, state, system = tiny
    g = torch.Generator().manual_seed(2)
    z = torch.randn(2, 4, 8, generator=g)
    mel = system.decode_first_stage(z)
    assert close(mel, vae.decode(state["vae"], z), 1e-5)
    m = torch.randn(2, 80, 16, generator=g) * 2 - 4
    assert close(vae_encode_moments(system.vae, m), vae.encode_moments(state["vae"], m), 1e-5)
    got = bigvgan_apply(system.vocoder, mel, torch.float32, kernels=False)
    assert close(got, vocoder.vocode(state["vocoder"], cfg["vocoder"], mel), 1e-5)


def _matmul_flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_model_flops_are_what_the_program_multiplies(tiny):
    from maa3_tpu_torch.models.clap import clap_flan_encode_batch
    from maa3_tpu_torch.models.dit import dit_apply
    from maa3_tpu_torch.models.vae1d import vae_decode, vae_encode_moments
    cfg, state, system = tiny
    m = cfg["model"]
    x, ctx = torch.randn(3, 4, 8), torch.randn(3, 154, 32)
    got = _matmul_flops(lambda: dit_apply(system.dit, x, torch.tensor([1, 2, 3]), ctx,
                                          compute_dtype=None))
    assert got == yardstick.dit_forward_flops(m["dit"], 3, 8)
    toks = system.tokenize(system.captions(["a b"] * 2, ["c"] * 2))
    assert _matmul_flops(lambda: clap_flan_encode_batch(system.cond, toks)) == \
        yardstick.conditioner_flops(cfg["conditioner"], 2)
    assert _matmul_flops(lambda: vae_decode(system.vae, torch.randn(2, 4, 8))) == \
        yardstick.vae_flops(m["vae"], 16, 2, decode=True)
    assert _matmul_flops(lambda: vae_encode_moments(system.vae, torch.randn(2, 80, 16))) == \
        yardstick.vae_flops(m["vae"], 16, 2, decode=False)


def test_vocoder_flops_by_hand(tiny):
    """Every non-depthwise convolution of the vocoder at its output length."""
    cfg, state, _ = tiny
    voc, mel = cfg["vocoder"], 6
    t, want = mel, 2 * mel * 80 * 64 * 7                       # conv_pre
    c = 64
    for i, (u, k) in enumerate(zip(voc["upsample_rates"], voc["upsample_kernel_sizes"])):
        want += 2 * t * c * (c // 2) * k                         # the transposed conv, per input
        t, c = t * u, c // 2
        for rk in voc["resblock_kernel_sizes"]:
            want += 2 * 2 * 2 * t * c * c * rk                    # 2 dilations x (convs1, convs2)
    want += 2 * t * c * 1 * 7                                    # conv_post
    assert yardstick.vocoder_flops(voc, mel, 1) == want


def test_kernel_bounds_by_hand():
    # K1 over (2, 64, 100) bf16: 12,800 samples read and written, 96 fp32
    # operations each
    assert yardstick.k1_bound_s(2, 64, 100, 2) == max(
        (2 * 12800 * 2 + 8 * 64) / 3.35e12, 12800 * 96 / 67e12)
    # K2 from 24 to 1 channel, 7 taps, over (2, 24, 1000) bf16
    n = 2000
    assert yardstick.k2_bound_s(2, 24, 1000, 1, 7, 2) == max(
        (n * 25 * 2 + 4 * (168 + 1 + 48)) / 3.35e12, n * 24 * 96 / 67e12 + 2 * n * 168 / 989e12)
    # K3a / K4a over (2, 4, 64, 16) bf16: 32,768 (query, key) pairs
    b = yardstick.flash_bounds_s(2, 4, 64, 16)
    assert b["k3a"] == max((4 * 8192 * 2 + 4 * 512) / 3.35e12, 4 * 32768 * 16 / 989e12)
    assert b["k4a"] == max((7 * 8192 * 2 + 8 * 512) / 3.35e12, 10 * 32768 * 16 / 989e12)
    # one XL vocode of 4 rows: the bounds of chip_smoke.py's kernel table
    voc = harness.Bench().config("xl-t2a")["vocoder"]
    got = yardstick.vocode_bounds(4, 624, voc, 2)
    assert abs(got["k1"] * 1e3 - 1.384) < 1e-3 and abs(got["k2"] * 1e3 - 1.095) < 1e-3
    assert yardstick.vocode_launches(voc) == {"k1": 72, "k2": 37}
