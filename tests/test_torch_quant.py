"""int8 serving of the port against the JAX package on the CPU, the same
numpy inputs from a seed through both:

- quantize_weight_int8 (per channel, grouped, a stacked depth axis) and
  quantize_conv_int8: the int8 codes equal exactly, the scales to rtol 1e-6
  (the port's (out, in) layout against JAX's (in, out), transposed);
- dense_w8a8 and both w8a8 convs (k 3 / 5 / 7, dilations 1 / 3 / 5):
  rtol 1e-3 / atol 1e-4 after dequantization (tests/test_torch_import.py's
  tolerance), with at most 0.1 % of the elements allowed one int8 step of a
  rounding tie (an activation code off by one moves an output by at most
  127 x its two scales);
- smooth_migrate_dit (fused and unfused layouts): the migrated fp32 DiT
  equals the unmigrated one to 1e-5 and JAX's migrated weights to 1e-6;
  calibrate_dit_smooth's stats equal JAX's to 1e-4;
- a small system in each int8 mode (int8, int8:g32, int8:now2, int8:smooth,
  int8:voc) from the same weights and noise, 4 ODE steps, fp32 compute: the
  serving copy's int8 codes equal JAX's exactly, the latent within a
  relative L2 of 1e-3 (both packages cast every unquantized matmul weight of
  the quantized copy to bf16, maa3_tpu/system.py:300, and round the same
  activations), the wav at rtol 1e-3 / atol 1e-4;
- _parse_quant_mode raises JAX's errors; the CLIs take --quant."""

import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu import config as jconfig
from maa3_tpu.models import bert as jbert
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import t5 as jt5
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.ops import conv as jconv
from maa3_tpu.ops import quant as jquant
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.system import _parse_quant_mode as j_parse
from maa3_tpu.utils.nprand import fuse_dit_gemms, unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.models import bert as tbert
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import t5 as tt5
from maa3_tpu_torch.models.dit import DiT, dit_apply, quant_serving_copy
from maa3_tpu_torch.ops import conv as tconv
from maa3_tpu_torch.ops import quant as tquant
from maa3_tpu_torch.system import MAA3System, _parse_quant_mode
from maa3_tpu_torch.weights import dit_from_jax, params_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
UP, DD = "model.params.unet_config.params.", "model.params.first_stage_config.params.ddconfig."
SMALL = [UP + "hidden_size=64", UP + "depth=2", UP + "num_heads=4",
         UP + "context_dim=32", UP + "multiple_of=32", DD + "ch=32",
         DD + "ch_mult=[1, 2]", DD + "num_res_blocks=1"]
BERT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
T5 = dict(d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
VOC = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=128)
TOL = dict(rtol=1e-3, atol=1e-4)
TIE_SHARE = 1e-3   # elements allowed one int8 step of a rounding tie
PROMPTS = {"ori_caption": ["a dog barks", "rain on a tin roof"],
           "struct_caption": ["<dog barks& all>", "<rain& all>"]}
EMPTY = {"ori_caption": ["", ""], "struct_caption": ["", ""]}
MODES = ("int8", "int8:g32", "int8:now2", "int8:smooth", "int8:voc")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close_but_ties(got, want, step):
    """got within TOL of want, except at most TIE_SHARE of the elements, which
    may differ by one activation step (`step`, broadcast to the output)."""
    got, want = _np(got), np.asarray(want, np.float32)
    bad = ~np.isclose(got, want, **TOL)
    assert bad.mean() <= TIE_SHARE, f"{bad.mean():.2e} of the elements differ"
    lim = np.broadcast_to(step, got.shape)[bad] + TOL["atol"]
    assert (np.abs(got - want)[bad] <= lim).all()


# -- weights and products -------------------------------------------------------

@pytest.mark.parametrize("shape,group", [((40, 24), 0), ((64, 40), 16),
                                         ((3, 48, 32), 0), ((3, 48, 32), 8)])
def test_quantize_weight_codes_equal_jax(shape, group):
    """(in, out) JAX weights, a leading depth axis in two cases."""
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jq = jquant.quantize_weight_int8(jnp.asarray(w), group_size=group)
    tq = tquant.quantize_weight_int8(torch.tensor(np.swapaxes(w, -1, -2)), group)
    np.testing.assert_array_equal(tq.w_q.numpy(), np.swapaxes(np.asarray(jq["w_q"]), -1, -2))
    np.testing.assert_allclose(tq.w_scale.numpy(), np.asarray(jq["w_scale"]), rtol=1e-6)


@pytest.mark.parametrize("m,group", [(2, 0), (40, 0), (3, 16), (40, 8)])
def test_dense_w8a8_matches_jax(m, group):
    """Per-token and per-(token, group) scales; m <= 16 rows pads for _int_mm."""
    rng = np.random.RandomState(1)
    w = rng.randn(32, 24).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    x = (rng.randn(m, 32) * rng.exponential(1.0, 32)).astype(np.float32)
    jq = jquant.quantize_weight_int8(jnp.asarray(w), group_size=group)
    want = jquant.dense_w8a8({**jq, "b": jnp.asarray(b)}, jnp.asarray(x))
    tq = tquant.quantize_weight_int8(torch.tensor(w.T), group)
    n0 = tquant.int_mm_calls
    got = tquant.dense_w8a8(torch.tensor(x), tq, torch.tensor(b))
    assert tquant.int_mm_calls - n0 == (32 // group if group else 1)
    ws = tq.w_scale.numpy()
    _close_but_ties(got, want, np.abs(x).max(-1, keepdims=True) * (ws.max(0) if group else ws))


@pytest.mark.parametrize("k,d", [(3, 1), (5, 3), (7, 5)])
def test_w8a8_convs_match_jax(k, d):
    rng = np.random.RandomState(k * 10 + d)
    c = 16
    w = (rng.randn(c, c, k) / np.sqrt(c * k)).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    x = rng.randn(2, c, 40).astype(np.float32)
    pad = (k * d - d) // 2
    jq = jconv.quantize_conv_int8({"w": jnp.asarray(w), "b": jnp.asarray(b)})
    tq = tconv.quantize_conv_int8(torch.tensor(w), torch.tensor(b))
    np.testing.assert_array_equal(tq.w_q.numpy(), np.asarray(jq["w_q"]))
    np.testing.assert_allclose(tq.w_scale.numpy(), np.asarray(jq["w_scale"]), rtol=1e-6)
    step = np.abs(x).max() * tq.w_scale.numpy()[None, :, None]
    for jf, tf in ((jconv.conv1d_unfold_w8a8, tconv.conv1d_unfold_w8a8),
                   (jconv.conv1d_tapgemm_w8a8, tconv.conv1d_tapgemm_w8a8)):
        want = jf(jq, jnp.asarray(x), padding=pad, dilation=d)
        got = tf(tq, torch.tensor(x), padding=pad, dilation=d)
        assert got.shape == (2, c, 40)
        _close_but_ties(got, want, step)
        ref = torch.nn.functional.conv1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                                         padding=pad, dilation=d)
        assert float((got - ref).norm() / ref.norm()) < 2e-2  # int8 is near the float conv


def test_parse_quant_mode_matches_jax():
    for mode in ("int8", "int8:g128", "int8:now2", "int8:g128,now2", "int8:voc",
                 "int8:novoc", "int8:smooth", "int8:g64,voc,smooth"):
        assert _parse_quant_mode(mode) == j_parse(mode)
    for bad in ("fp8", "int4:g128", "int8:g", "int8:gx", "int8:w2", "int8:smooth,foo", ""):
        with pytest.raises(ValueError) as te:
            _parse_quant_mode(bad)
        with pytest.raises(ValueError) as je:
            j_parse(bad)
        assert str(te.value) == str(je.value)


# -- SmoothQuant on a small DiT ---------------------------------------------------

@pytest.fixture(scope="module")
def small_dit():
    spec = jconfig.parse_model_config(jconfig.load_config([XL], SMALL))
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    p = jax.tree.map(np.asarray, unfreeze_zero_init(jdit.dit_init(ks[0], spec.dit), ks[1]))
    tspec = tconfig.parse_model_config(tconfig.load_config([XL], SMALL))
    dit = DiT(tspec.dit)
    dit.load_state_dict(dit_from_jax(p))
    dit.requires_grad_(False)
    rng = np.random.RandomState(5)
    inputs = dict(x=rng.randn(2, 20, 12).astype(np.float32),
                  t=np.array([5, 700], np.int32),
                  ctx=rng.randn(2, 6, 32).astype(np.float32),
                  unc=rng.randn(2, 6, 32).astype(np.float32))
    return spec, p, dit, inputs


def _stats(n_blocks, h, hp, seed):
    rng = np.random.RandomState(seed)
    return {"attn_in": rng.exponential(2.0, (n_blocks, h)).astype(np.float32),
            "ffn_in": rng.exponential(2.0, (n_blocks, h)).astype(np.float32),
            "ffn_prod": rng.exponential(4.0, (n_blocks, hp)).astype(np.float32)}


@pytest.mark.parametrize("fused", [False, True])
def test_smooth_migration_is_exact_and_matches_jax(small_dit, fused):
    import copy
    spec, p, dit, inp = small_dit
    hp = dit.blocks[0].feed_forward.w2.weight.shape[1]
    st = _stats(2, 64, hp, 7)
    st["attn_in"][0, :3] = 0.0  # dead channels keep s = 1
    args = [torch.tensor(inp["x"]), torch.tensor(inp["t"]), torch.tensor(inp["ctx"])]
    ref = dit_apply(dit, *args, compute_dtype=torch.float32)
    mig = copy.deepcopy(dit)
    if fused:
        from maa3_tpu_torch.models.dit import _fuse_serving
        _fuse_serving(mig)
    tquant.smooth_migrate_dit(mig, {k: torch.tensor(v) for k, v in st.items()})
    got = dit_apply(mig, *args, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    jp = jax.tree.map(jnp.asarray, fuse_dit_gemms(p) if fused else p)
    jp = jquant.smooth_migrate_dit(jp, st)
    jb = jax.tree.map(np.asarray, jp["blocks"])
    for i, blk in enumerate(mig.blocks):
        pairs = [(blk.attention_norm.weight, jb["attention_norm"]["weight"][i]),
                 (blk.ffn_norm.weight, jb["ffn_norm"]["weight"][i]),
                 (blk.adaLN_modulation[1].weight, jb["adaLN"]["w"][i].T),
                 (blk.adaLN_modulation[1].bias, jb["adaLN"]["b"][i]),
                 (blk.feed_forward.w2.weight, jb["feed_forward"]["w2"]["w"][i].T)]
        if fused:
            pairs += [(blk.attention.wqkv, jb["attention"]["wqkv"]["w"][i].T),
                      (blk.feed_forward.w13, jb["feed_forward"]["w13"]["w"][i].T)]
        else:
            pairs += [(getattr(blk.attention, n).weight, jb["attention"][n]["w"][i].T)
                      for n in ("wq", "wk", "wv")]
            pairs += [(getattr(blk.feed_forward, n).weight, jb["feed_forward"][n]["w"][i].T)
                      for n in ("w1", "w3")]
        for a, b in pairs:
            np.testing.assert_allclose(_np(a), b, rtol=1e-6, atol=1e-7)


def test_calibrate_stats_match_jax(small_dit):
    spec, p, dit, inp = small_dit
    args = [torch.tensor(inp[k]) for k in ("x", "ctx", "unc")]
    got = tquant.calibrate_dit_smooth(dit, *args, guidance_scale=5.0, steps=4,
                                      compute_dtype=torch.float32)
    want = jquant.calibrate_dit_smooth(p, spec.dit, *(jnp.asarray(inp[k]) for k in
                                                     ("x", "ctx", "unc")),
                                       guidance_scale=5.0, steps=4,
                                       compute_dtype=jnp.float32)
    assert set(got) == set(want) == {"attn_in", "ffn_in", "ffn_prod"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kw", [dict(group_size=16), dict(skip_w2=True),
                                dict(classes=("w2",)), dict(group_for={"w2": 16})])
def test_quantize_dit_serving_variants_match_jax(small_dit, kw):
    """Unfused layout: every quantized projection's codes and scales."""
    import copy
    _, p, dit, _ = small_dit
    tq = tquant.quantize_dit_serving(copy.deepcopy(dit), **kw)
    jq = jax.tree.map(np.asarray, jquant.quantize_dit_serving(p, **kw)["blocks"])
    names = {"attention": ("wq", "wk", "wv"), "feed_forward": ("w1", "w3", "w2")}
    n_q = 0
    for part, ns in names.items():
        for n in ns:
            jw = jq[part][n]
            for i, blk in enumerate(tq.blocks):
                mod = getattr(getattr(blk, part), n)
                if "w_q" not in jw:
                    assert isinstance(mod, torch.nn.Linear)
                    continue
                n_q += 1
                np.testing.assert_array_equal(mod.weight.w_q.numpy(),
                                              np.swapaxes(jw["w_q"][i], -1, -2))
                np.testing.assert_allclose(mod.weight.w_scale.numpy(), jw["w_scale"][i],
                                           rtol=1e-6)
    assert n_q > 0


# -- the system in each mode --------------------------------------------------------

@pytest.fixture(scope="module")
def systems():
    spec = jconfig.parse_model_config(jconfig.load_config([XL], SMALL))
    jclap_cfg = jclap.CLAPFLANConfig(bert=jbert.BertConfig(**BERT),
                                     t5=jt5.T5Config(**T5), d_proj=32)
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    params = {"dit": unfreeze_zero_init(jdit.dit_init(ks[0], spec.dit), ks[1]),
              "vae": jvae.vae_init(ks[2], spec.vae),
              "vocoder": jvoc.bigvgan_init(ks[3], jvoc.BigVGANConfig(**VOC)),
              "cond": jclap.clap_flan_init(ks[4], jclap_cfg)}
    js = JSystem(spec, params, jvoc.BigVGANConfig(**VOC), scale_factor=0.8,
                 compute_dtype=jnp.float32, clap_cfg=jclap_cfg)
    tspec = tconfig.parse_model_config(tconfig.load_config([XL], SMALL))
    ts = MAA3System.from_state_dicts(
        tspec, params_from_jax(jax.tree.map(np.asarray, params)),
        tvoc.BigVGANConfig(**VOC),
        tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT), t5=tt5.T5Config(**T5),
                             d_proj=32),
        scale_factor=0.8, device="cpu", compute_dtype=torch.float32)
    return js, ts


def _codes_equal(ts, js):
    """The serving copies' int8 codes: the port's (out, in) against JAX's
    stacked (depth, in, out)."""
    jb = jax.tree.map(np.asarray, js.serving_dit()["blocks"])
    got = tquant.quant_weights(ts.serving_dit())
    assert got
    for name, qw in got.items():
        _, i, part, n = name.removesuffix(".weight").split(".")
        jw = jb[part][n]
        np.testing.assert_array_equal(qw.w_q.numpy(), np.swapaxes(jw["w_q"][int(i)], -1, -2))
        np.testing.assert_allclose(qw.w_scale.numpy(), jw["w_scale"][int(i)], rtol=1e-6)
    return got


@pytest.mark.parametrize("mode", MODES)
def test_int8_system_matches_jax(systems, mode, monkeypatch):
    """MAA3_VOC_QUANT_MIN_CH 32 / TAPGEMM_MIN_CH 64 make the small vocoder's
    two stages (64 and 32 channels) int8 under :voc, one by tap-GEMMs, one
    by the unfold GEMM."""
    monkeypatch.setenv("MAA3_VOC_QUANT_MIN_CH", "32")
    monkeypatch.setenv("MAA3_VOC_QUANT_TAPGEMM_MIN_CH", "64")
    js, ts = systems
    x0 = np.random.RandomState(0).randn(2, 20, 12).astype(np.float32)
    c_j, uc_j = js.get_learned_conditioning(PROMPTS), js.get_learned_conditioning(EMPTY)
    c_t, uc_t = ts.get_learned_conditioning(PROMPTS), ts.get_learned_conditioning(EMPTY)
    js.set_serving_quant(mode)
    ts.set_serving_quant(mode)
    try:
        if mode == "int8:smooth":
            ts.calibrate_smooth(c_t, uc_t, timesteps=4, x0=torch.tensor(x0))
            want = jquant.calibrate_dit_smooth(
                js.params["dit"], js._serving_dit_cfg(), jnp.asarray(x0), c_j, uc_j,
                steps=4, compute_dtype=jnp.float32)
            for k in want:
                np.testing.assert_allclose(ts._smooth_stats[k].numpy(), want[k],
                                           rtol=1e-4, atol=1e-4)
            # both migrate by the same stats, so the codes can be held exactly
            js._smooth_stats = {k: v.numpy() for k, v in ts._smooth_stats.items()}
            js._serving_dit = None
        codes = _codes_equal(ts, js)
        assert any(".w2" in name for name in codes) == (mode != "int8:now2")
        z_j = js.sample_cfg(c_j, 5.0, uc_j, None, timesteps=4, x0=jnp.asarray(x0))
        z_t = ts.sample_cfg(c_t, 5.0, uc_t, timesteps=4, x0=torch.tensor(x0))
        z_j = np.asarray(z_j)
        rel = float(np.linalg.norm(z_t.numpy() - z_j) / np.linalg.norm(z_j))
        assert rel <= 1e-3, rel
        assert float(np.abs(z_j - x0).max()) > 1e-2
        mel = js.decode_first_stage(jnp.asarray(z_j))
        wav_t = ts.vocode(torch.tensor(np.asarray(mel)))
        np.testing.assert_allclose(wav_t, np.asarray(js.vocode(mel)), **TOL)
        if mode == "int8:voc":
            q = ts.serving_vocoder()
            assert sum(isinstance(m, tconv.QuantConv1d) for m in q.modules()) == 36
            assert ts.serving_vocoder() is q  # cached
    finally:
        js.set_serving_quant(None)
        ts.set_serving_quant(None)
        ts._smooth_stats = js._smooth_stats = None


def test_serving_copies_follow_mode_and_params(systems):
    """Both caches drop when the mode changes or a parameter is replaced."""
    _, ts = systems
    ts.set_serving_quant("int8:voc")
    try:
        d, v = ts.serving_dit(), ts.serving_vocoder()
        assert ts.serving_dit() is d and ts.serving_vocoder() is v
        with torch.no_grad():
            ts.dit.proj_in.bias.add_(0.0)
            ts.vocoder.conv_post.bias.add_(0.0)
        assert ts.serving_dit() is not d and ts.serving_vocoder() is not v
        ts.set_serving_quant("int8")
        assert ts.serving_vocoder() is ts.vocoder
        ts.set_serving_quant("int8:smooth")
        with pytest.raises(RuntimeError, match="calibrate_smooth"):
            ts.serving_dit()
    finally:
        ts.set_serving_quant(None)
    with pytest.raises(ValueError, match="unknown serving quant mode"):
        ts.set_serving_quant("int4")


def test_quant_serving_copy_casts_the_rest_to_bf16(small_dit):
    _, _, dit, _ = small_dit
    q = quant_serving_copy(dit)
    blk = q.blocks[0]
    assert isinstance(blk.attention.wqkv, tquant.QuantWeight)
    assert isinstance(blk.feed_forward.w13, tquant.QuantWeight)
    assert isinstance(blk.feed_forward.w2.weight, tquant.QuantWeight)
    for lin in (blk.attention.wo, blk.attention.wk_y, q.proj_in, q.final_layer.linear,
                blk.adaLN_modulation[1]):
        assert lin.weight.dtype == torch.bfloat16
    assert blk.attention_norm.weight.dtype == torch.float32
    assert blk.attention.gate.dtype == torch.float32


# -- the CLIs -------------------------------------------------------------------------

def _small_from_config(monkeypatch):
    real = MAA3System.from_config.__func__

    def small(cls, paths, *a, **kw):
        kw.update(clap_cfg=tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT),
                                                t5=tt5.T5Config(**T5), d_proj=32),
                  voc_cfg=tvoc.BigVGANConfig(**VOC))
        return real(cls, paths, SMALL, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))


@pytest.mark.parametrize("mode", ["int8:smooth", "int8:g32,voc"])
def test_txt2audio_cli_quant(tmp_path, monkeypatch, mode):
    from maa3_tpu_torch import txt2audio
    _small_from_config(monkeypatch)
    seen = []
    real = MAA3System.calibrate_smooth

    def spy(self, *a, **kw):
        seen.append(kw.get("timesteps"))
        return real(self, *a, **kw)

    monkeypatch.setattr(MAA3System, "calibrate_smooth", spy)
    txt2audio.main(["--prompt", "a dog barks", "--outdir", str(tmp_path), "-b", XL,
                    "--steps", "3", "-W", "8", "--device", "cpu", "--quant", mode])
    with wave.open(str(tmp_path / "prompt_0.wav")) as w:
        assert (w.getframerate(), w.getnframes()) == (16000, 64)
    assert seen == ([3] if "smooth" in mode else [])


def test_serve_cli_quant_needs_bf16(monkeypatch):
    from maa3_tpu_torch import serve
    with pytest.raises(SystemExit, match="composes with --precision bf16 only"):
        serve.main(["-b", XL, "--quant", "int8", "--precision", "fp32", "--device", "cpu"])
    _small_from_config(monkeypatch)
    built = []

    class Server:
        def __init__(self, system, cfg, host, port):
            built.append(system)
            self.port = port
            self.batcher = None

        def serve_forever(self):
            pass

    monkeypatch.setattr("maa3_tpu_torch.serving.AudioServer", Server)
    serve.main(["-b", XL, "--quant", "int8:now2", "--device", "cpu", "--warmup", ""])
    assert built[0].serve_quant == "int8:now2"
