"""The whole slice of the port against the JAX package at small widths:
MAA3System (conditioning -> planned CFG ODE -> VAE decode -> vocoder) and
T2APipeline.generate with a shared initial noise x0, the same weights
(weights.params_from_jax) and the same prompts (both sides fall back to the
same hash tokenizer). fp32: rtol 1e-3 / atol 1e-4. Also the port's own
tokenizers and config parsing against the JAX package's, and the CLI."""

import dataclasses
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu import config as jconfig
from maa3_tpu.data import tokenizers as jtok
from maa3_tpu.models import bert as jbert
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import t5 as jt5
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.pipeline import T2APipeline as JPipeline
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.data import tokenizers as ttok
from maa3_tpu_torch.models import bert as tbert
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import t5 as tt5
from maa3_tpu_torch.pipeline import T2APipeline
from maa3_tpu_torch.system import MAA3System
from maa3_tpu_torch.weights import params_from_jax

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
PROMPTS = {"ori_caption": ["a dog barks", "rain on a tin roof"],
           "struct_caption": ["<dog barks& all>", "<rain& all>"]}
EMPTY = {"ori_caption": ["", ""], "struct_caption": ["", ""]}


def _small_clap_t():
    return tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT), t5=tt5.T5Config(**T5),
                                d_proj=32)


@pytest.fixture(scope="module")
def systems():
    spec = jconfig.parse_model_config(jconfig.load_config([XL], SMALL))
    jclap_cfg = jclap.CLAPFLANConfig(bert=jbert.BertConfig(**BERT),
                                     t5=jt5.T5Config(**T5), d_proj=32)
    jvoc_cfg = jvoc.BigVGANConfig(**VOC)
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    params = {
        "dit": unfreeze_zero_init(jdit.dit_init(ks[0], spec.dit), ks[1]),
        "vae": jvae.vae_init(ks[2], spec.vae),
        "vocoder": jvoc.bigvgan_init(ks[3], jvoc_cfg),
        "cond": jclap.clap_flan_init(ks[4], jclap_cfg)}
    js = JSystem(spec, params, jvoc_cfg, scale_factor=0.8,
                 compute_dtype=jnp.float32, clap_cfg=jclap_cfg)
    tspec = tconfig.parse_model_config(tconfig.load_config([XL], SMALL))
    state = params_from_jax(jax.tree.map(np.asarray, params))
    ts = MAA3System.from_state_dicts(tspec, state, tvoc.BigVGANConfig(**VOC),
                                     _small_clap_t(), scale_factor=0.8, device="cpu",
                                     compute_dtype=torch.float32)
    return js, ts, params, spec


def _cmp(got, want, **tol):
    got = got if isinstance(got, np.ndarray) else got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or TOL))


def test_system_slice_matches_jax(systems):
    js, ts, _, _ = systems
    x0 = np.random.RandomState(0).randn(2, 20, 12).astype(np.float32)
    c_j, uc_j = js.get_learned_conditioning(PROMPTS), js.get_learned_conditioning(EMPTY)
    c_t, uc_t = ts.get_learned_conditioning(PROMPTS), ts.get_learned_conditioning(EMPTY)
    assert c_t.shape == (2, 154, 32)
    _cmp(c_t, c_j)
    _cmp(uc_t, uc_j)
    z_j = js.sample_cfg(c_j, 5.0, uc_j, None, timesteps=4, x0=jnp.asarray(x0))
    z_t = ts.sample_cfg(c_t, 5.0, uc_t, timesteps=4, x0=torch.tensor(x0))
    _cmp(z_t, z_j)
    assert float(np.abs(np.asarray(z_j) - x0).max()) > 1e-2  # the ODE moved
    mel_j, mel_t = js.decode_first_stage(z_j), ts.decode_first_stage(z_t)
    assert mel_t.shape == (2, 80, 24)
    _cmp(mel_t, mel_j)
    wav_t = ts.vocode(mel_t)
    assert wav_t.shape == (2, 96) and np.isfinite(wav_t).all()
    _cmp(wav_t, js.vocode(mel_j))


def test_pipeline_generate_matches_jax(systems):
    """T2APipeline.generate: JAX draws x0 from its key; the port gets the
    same x0 explicitly."""
    js, ts, params, spec = systems
    jp = JPipeline(spec.dit, spec.vae, jvoc.BigVGANConfig(**VOC), params,
                   scale_factor=0.8, compute_dtype=jnp.float32)
    rng = np.random.RandomState(1)
    ctx = rng.randn(2, 6, 32).astype(np.float32)
    unc = rng.randn(2, 6, 32).astype(np.float32)
    key = jax.random.PRNGKey(7)
    z_j, mel_j, wav_j = jp.generate(jnp.asarray(ctx), jnp.asarray(unc), key,
                                    latent_len=10, steps=3)
    x0 = np.asarray(jax.random.normal(key, (2, 20, 10), jnp.float32))
    tp = T2APipeline(ts.dit, ts.vae, ts.vocoder, scale_factor=0.8,
                     compute_dtype=torch.float32)
    z_t, mel_t, wav_t = tp.generate(torch.tensor(ctx), torch.tensor(unc),
                                    x0=torch.tensor(x0), steps=3)
    _cmp(z_t, z_j)
    _cmp(mel_t, mel_j)
    _cmp(wav_t, wav_j)


def test_system_bf16_serving_ode_matches_jax(systems):
    """bf16 serving ODE (bf16 weights, fused GEMMs, fp32 residual): atol =
    rtol = 5e-2 after 4 Euler steps of bf16 velocities."""
    js, ts, params, spec = systems
    js_b = JSystem(spec, params, js.voc_cfg, 0.8, compute_dtype=jnp.bfloat16,
                   clap_cfg=js.clap_cfg)
    ts_b = MAA3System(ts.spec, ts.dit, ts.vae, ts.vocoder, ts.cond, 0.8,
                      compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(2)
    x0 = rng.randn(2, 20, 12).astype(np.float32)
    c, uc = rng.randn(2, 6, 32).astype(np.float32), rng.randn(2, 6, 32).astype(np.float32)
    z_j = js_b.sample_cfg(jnp.asarray(c), 5.0, jnp.asarray(uc), None, timesteps=4,
                          x0=jnp.asarray(x0))
    z_t = ts_b.sample_cfg(torch.tensor(c), 5.0, torch.tensor(uc), timesteps=4,
                          x0=torch.tensor(x0))
    assert ts_b.serving_dit().cfg.fp32_residual
    _cmp(z_t, z_j, rtol=5e-2, atol=5e-2)


def test_from_config_random_init_runs(systems):
    """from_config builds on the CPU from a seed; unfreeze makes the zero-init
    leaves nonzero; the serving copy follows in-place weight changes."""
    s = MAA3System.from_config([XL], SMALL, seed=3, device="cpu",
                               clap_cfg=_small_clap_t(),
                               voc_cfg=tvoc.BigVGANConfig(**VOC), unfreeze=True)
    assert s.spec.dit.hidden_size == 64 and s.spec.mel_length == 256
    assert s.dit.blocks[0].attention.gate[0].item() == 0.5
    first = s.serving_dit()
    assert s.serving_dit() is first
    with torch.no_grad():
        s.dit.blocks[0].attention.gate.fill_(0.25)
    assert s.serving_dit() is not first
    assert first.blocks[0].attention.wqkv.dtype == torch.bfloat16
    z = s.sample_cfg(s.get_learned_conditioning(PROMPTS), 3.0,
                     s.get_learned_conditioning(EMPTY),
                     torch.Generator().manual_seed(0), shape=(2, 20, 8), timesteps=3)
    assert z.shape == (2, 20, 8) and torch.isfinite(z).all()


def test_config_parse_matches_jax():
    for name in ("txt2audio-cfm-cfg-XL.yaml", "txt2audio-cfm-cfg.yaml",
                 "txt2audio-cfm-cfg-XXL.yaml"):
        path = os.path.join(ROOT, "configs", name)
        j = jconfig.parse_model_config(jconfig.load_config([path], ["model.params.x=1e-3"]))
        t = tconfig.parse_model_config(tconfig.load_config([path], ["model.params.x=1e-3"]))
        jd = {f.name: getattr(j.dit, f.name) for f in dataclasses.fields(t.dit)
              if f.name != "fp32_residual"}
        assert jd == {k: v for k, v in dataclasses.asdict(t.dit).items() if k in jd}
        assert {k: getattr(j.vae, k) for k in dataclasses.asdict(t.vae)} == \
            dataclasses.asdict(t.vae)
        assert (j.mel_dim, j.mel_length, j.timesteps) == (t.mel_dim, t.mel_length,
                                                          t.timesteps)


def test_tokenizers_match_jax(tmp_path):
    texts = ["A dog barks, twice!", "unaffable café", "", "x" * 120]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "dog", "bar", "##ks", ",",
             "twice", "!", "un", "##aff", "##able", "cafe"]
    (tmp_path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    want = jtok.WordPieceTokenizer(str(tmp_path / "vocab.txt"))(texts)
    for got in (ttok.load_tokenizer(str(tmp_path))(texts),
                ttok.WordPieceTokenizer.from_vocab(
                    {v: i for i, v in enumerate(vocab)})(texts)):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    uni = {"model": {"type": "Unigram", "unk_id": 2, "vocab": [
        ["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0], ["▁a", -1.0], ["▁dog", -2.0],
        ["▁", -3.0], ["d", -4.0], ["o", -4.0], ["g", -4.0], ["s", -4.5]]},
        "added_tokens": [{"id": 0, "special": True}, {"id": 1, "special": True}]}
    (tmp_path / "t5").mkdir()
    (tmp_path / "t5" / "tokenizer.json").write_text(json.dumps(uni))
    want = jtok.UnigramTokenizer.from_tokenizer_json(str(tmp_path / "t5" / "tokenizer.json"))(texts)
    got = ttok.load_tokenizer(str(tmp_path / "t5"))(texts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(ttok.load_tokenizer(None)(texts), jtok.HashTokenizer()(texts)):
        np.testing.assert_array_equal(a, b)


def test_cli_writes_wavs(tmp_path, monkeypatch):
    from maa3_tpu_torch import txt2audio

    real = MAA3System.from_config.__func__

    def small(cls, paths, *a, **kw):
        kw.update(clap_cfg=_small_clap_t(), voc_cfg=tvoc.BigVGANConfig(**VOC))
        return real(cls, paths, SMALL, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))
    txt2audio.main(["--prompt", "a dog barks", "--outdir", str(tmp_path), "-b", XL,
                    "--steps", "3", "-W", "8", "--n_samples", "2",
                    "--device", "cpu", "--save_mel"])
    with wave.open(str(tmp_path / "prompt_1.wav")) as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnframes()) == (16000, 2, 64)
    assert (tmp_path / "prompt_0_mel.npy").exists()
    assert (tmp_path / "result.csv").read_text().count("a dog barks") == 2


def test_port_state_dicts_load_through_reference_importer(systems):
    """The port's state-dict keys are the reference checkpoints' keys: the JAX
    package's own importers (torch_import.*_from_torch) read the port's
    state_dict() and give the same model."""
    from maa3_tpu import torch_import
    js, ts, params, spec = systems

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    p_dit = torch_import.dit_from_torch(sd(ts.dit), depth=spec.dit.depth)
    x = np.random.RandomState(3).randn(2, 20, 8).astype(np.float32)
    ctx = np.random.RandomState(4).randn(2, 6, 32).astype(np.float32)
    t = np.array([5, 700], np.int32)
    want = jdit.dit_apply(p_dit, spec.dit, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(ctx), compute_dtype=jnp.float32)
    from maa3_tpu_torch.models.dit import dit_apply
    with torch.no_grad():
        got = dit_apply(ts.dit, torch.tensor(x), torch.tensor(t), torch.tensor(ctx),
                        compute_dtype=torch.float32)
    _cmp(got, want)
    p_voc = torch_import.bigvgan_from_torch(sd(ts.vocoder), jvoc.BigVGANConfig(**VOC))
    for a, b in zip(jax.tree.leaves(p_voc), jax.tree.leaves(params["vocoder"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    clap_cfg = js.clap_cfg
    p_cond = torch_import.clap_flan_from_torch(sd(ts.cond), clap_cfg.bert, clap_cfg.t5)
    for a, b in zip(jax.tree.leaves(p_cond), jax.tree.leaves(params["cond"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
