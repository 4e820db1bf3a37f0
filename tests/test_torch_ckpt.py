"""Serving from checkpoint files, the port against the JAX package on the
CPU (fp32, rtol 1e-3 / atol 1e-4 unless a test says otherwise), with the
same seeded weights on both sides:

- a Lightning `.ckpt` in the reference's key layout (DiT, a full `model_ema.`
  section, VAE, CLAP+FLAN conditioner with HF's extra keys, scale_factor) and
  a vocoder directory (config.json, generator.pt with weight norm in both
  namings) loaded by both packages' MAA3System.from_config: conditioning,
  CFG ODE, VAE decode and vocoder agree;
- the import's edge cases: a partial EMA is ignored, a missing DiT key
  raises, extra keys are skipped and logged, a random conditioner stands in
  when the file has none, and a head dim the card's flash kernels cannot
  run is refused at load;
- a checkpoint of the port's Trainer served through from_config, and the
  training CLI's --torch_ckpt warm start;
- the FLAN and CLAP conditioners, the text-to-music (FLAN) and a CLAP-only
  system (conditioning, `sample` without guidance, `sample_cfg`), the
  AMPBlock2 and lrelu vocoders and BigVGANConfig.from_dict, `_sdpa` with
  fp32_scores in bf16, and the ODE's sub-batching (MAA3_ODE_CHUNK)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu import config as jconfig
from maa3_tpu import torch_import as jimport
from maa3_tpu.diffusion import cfm as jcfm
from maa3_tpu.models import bert as jbert
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import t5 as jt5
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.ops import attention as jattn
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch import pipeline as tpipeline
from maa3_tpu_torch import torch_import
from maa3_tpu_torch.models import bert as tbert
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import t5 as tt5
from maa3_tpu_torch.ops import attention as tattn
from maa3_tpu_torch.system import MAA3System
from maa3_tpu_torch.weights import bigvgan_from_jax, params_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
MUSIC = os.path.join(ROOT, "configs", "txt2music-cfm-cfg.yaml")
UP, DD = "model.params.unet_config.params.", "model.params.first_stage_config.params.ddconfig."
SMALL = [UP + "hidden_size=64", UP + "depth=2", UP + "num_heads=4",
         UP + "context_dim=32", UP + "multiple_of=32", DD + "ch=32",
         DD + "ch_mult=[1, 2]", DD + "num_res_blocks=1"]
CLAP_ONLY = ["model.params.cond_stage_config.target="
             "ldm.modules.encoders.modules.FrozenCLAPEmbedder"]
BERT = dict(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64)
T5 = dict(d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)
VOC = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=128)
TOL = dict(rtol=1e-3, atol=1e-4)
PROMPTS = {"ori_caption": ["a dog barks", "rain on a tin roof"],
           "struct_caption": ["<dog barks& all>", "<rain& all>"]}
EMPTY = {"ori_caption": ["", ""], "struct_caption": ["", ""]}


def small_clap():
    return tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT), t5=tt5.T5Config(**T5),
                                d_proj=32)


def _jclap_cfg():
    return jclap.CLAPFLANConfig(bert=jbert.BertConfig(**BERT), t5=jt5.T5Config(**T5),
                                d_proj=32)


def _cmp(got, want, **tol):
    got = got if isinstance(got, np.ndarray) else got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or TOL))


def _jax_params(config, overrides, voc_cfg, seed=0):
    spec = jconfig.parse_model_config(jconfig.load_config([config], overrides))
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    params = {"dit": unfreeze_zero_init(jdit.dit_init(ks[0], spec.dit), ks[1]),
              "vae": jvae.vae_init(ks[2], spec.vae),
              "vocoder": jvoc.bigvgan_init(ks[3], voc_cfg),
              "cond": jclap.clap_flan_init(ks[4], _jclap_cfg())}
    return spec, jax.tree.map(np.asarray, params)


# -- writing the reference's files ---------------------------------------------

def ema_name(key: str) -> str:
    """LitEma's shadow name of a DiT parameter (dots removed)."""
    return ("diffusion_model." + key).replace(".", "")


def lightning_dict(states: dict, ema: str = "full", scale_factor: float = 0.7,
                   seed: int = 11) -> dict:
    """A Lightning checkpoint of {dit, vae, cond?} state dicts in the
    reference's layout. ema: "full" (a shadow of every DiT key, each the live
    value plus seeded noise, and LitEma's decay / num_updates), "partial"
    (one DiT key without its shadow) or "none". The conditioner carries
    HF's keys no importer reads; so does the first stage (a loss)."""
    sd = {"model.diffusion_model." + k: v for k, v in states["dit"].items()}
    sd.update({"first_stage_model." + k: v for k, v in states["vae"].items()})
    sd["first_stage_model.loss.logvar"] = torch.zeros(())
    if "cond" in states:
        cond = dict(states["cond"])
        t5 = "t5_transformer." if "t5_transformer.shared.weight" in cond else "transformer."
        if t5 + "shared.weight" in cond:
            cond[t5 + "encoder.embed_tokens.weight"] = cond[t5 + "shared.weight"].clone()
        if "caption_encoder.base.embeddings.word_embeddings.weight" in cond:
            cond["caption_encoder.base.embeddings.position_ids"] = torch.arange(77)[None]
            cond["caption_encoder.base.pooler.dense.weight"] = torch.zeros(4, 4)
        sd.update({"cond_stage_model." + k: v for k, v in cond.items()})
    if ema != "none":
        g = torch.Generator().manual_seed(seed)
        keys = list(states["dit"])[(1 if ema == "partial" else 0):]
        for k in keys:
            v = states["dit"][k]
            sd["model_ema." + ema_name(k)] = v + 0.01 * torch.randn(v.shape, generator=g)
        sd["model_ema.decay"] = torch.tensor(0.9999)
        sd["model_ema.num_updates"] = torch.tensor(1000, dtype=torch.int32)
    sd["scale_factor"] = torch.tensor(scale_factor)
    return {"state_dict": sd, "global_step": 1000, "epoch": 3}


def weight_normed(state: dict, seed: int = 5) -> dict:
    """A vocoder state dict with every conv weight split into weight norm's
    (g, v), the two namings alternating, and the anti-aliasing filters the
    reference's Activation1d registers (no importer reads them)."""
    g = torch.Generator().manual_seed(seed)
    out, i = {}, 0
    for k, w in state.items():
        if k.endswith(".weight") and w.dim() == 3:
            name = k[:-len(".weight")]
            norm = w.double().square().sum(dim=(1, 2), keepdim=True).sqrt().float()
            v = w * (0.5 + torch.rand(w.shape[0], 1, 1, generator=g))
            if i % 2:
                out[name + ".weight_g"], out[name + ".weight_v"] = norm, v
            else:
                out[name + ".parametrizations.weight.original0"] = norm
                out[name + ".parametrizations.weight.original1"] = v
            i += 1
        else:
            out[k] = w
    out["resblocks.0.activations.0.upsample.filter"] = torch.ones(1, 1, 12)
    out["resblocks.0.activations.0.downsample.lowpass.filter"] = torch.ones(1, 1, 12)
    return out


def write_vocoder_dir(path, cfg: dict, state: dict, name: str = "generator.pt") -> str:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(cfg, segment_size=8192, num_gpus=1), f)
    torch.save({"generator": weight_normed(state)}, os.path.join(path, name))
    return str(path)


def voc_json(**kw) -> dict:
    return {"num_mels": 80, "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5]] * 3, "activation": "snakebeta",
            "snake_logscale": True, "sampling_rate": 16000,
            **{k: list(v) for k, v in VOC.items() if k != "upsample_initial_channel"},
            "upsample_initial_channel": VOC["upsample_initial_channel"], **kw}


# -- the Lightning checkpoint in both packages --------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The seeded weights, the Lightning file (and a copy without the
    conditioner for JAX, whose loader reads full-size towers) and the
    vocoder directory."""
    tmp = tmp_path_factory.mktemp("ckpt")
    spec, params = _jax_params(XL, SMALL, jvoc.BigVGANConfig(**VOC))
    states = params_from_jax(params)
    ckpt = lightning_dict(states)
    torch.save(ckpt, tmp / "model.ckpt")
    no_cond = {k: v for k, v in ckpt["state_dict"].items()
               if not k.startswith("cond_stage_model.")}
    torch.save({"state_dict": no_cond}, tmp / "no_cond.ckpt")
    vdir = write_vocoder_dir(tmp / "vocoder", voc_json(), states["vocoder"])
    return tmp, states, ckpt["state_dict"], vdir


def test_lightning_checkpoint_serves_like_jax(files, capsys):
    tmp, states, sd, vdir = files
    ts = MAA3System.from_config([XL], SMALL, device="cpu", compute_dtype=torch.float32,
                                clap_cfg=small_clap(), ckpt_path=str(tmp / "model.ckpt"),
                                vocoder_dir=vdir)
    out = capsys.readouterr().out
    assert "using EMA weights" in out and "skipped 2 EMA keys" in out
    lines = out.splitlines()
    for what, n in (("cond of", 3), ("vae of", 1), ("vocoder", 2)):  # HF's, a loss, filters
        assert any(x.startswith(what) and f"skipped {n} checkpoint keys" in x
                   for x in lines), (what, out)
    js = JSystem.from_config([XL], SMALL, ckpt_path=str(tmp / "no_cond.ckpt"),
                             vocoder_dir=vdir, compute_dtype=jnp.float32, init_cond=False)
    assert "cond" not in js.params
    cond_np = {k[len("cond_stage_model."):]: v.numpy() for k, v in sd.items()
               if k.startswith("cond_stage_model.")}
    js.clap_cfg = _jclap_cfg()
    js.params["cond"] = jimport.clap_flan_from_torch(cond_np, js.clap_cfg.bert,
                                                     js.clap_cfg.t5)
    assert ts.scale_factor == pytest.approx(0.7) and js.scale_factor == pytest.approx(0.7)
    # the EMA shadows were taken, each tensor as written
    for k, v in ts.dit.state_dict().items():
        assert torch.equal(v, sd["model_ema." + ema_name(k)]), k
    # the vocoder's folded weights equal the weights the norm was made from
    for k, v in ts.vocoder.state_dict().items():
        ref = states["vocoder"][k]
        assert (v - ref).abs().max() <= 1e-6 * max(1.0, ref.abs().max().item()), k

    c_t, uc_t = ts.get_learned_conditioning(PROMPTS), ts.get_learned_conditioning(EMPTY)
    c_j, uc_j = js.get_learned_conditioning(PROMPTS), js.get_learned_conditioning(EMPTY)
    _cmp(c_t, c_j)
    _cmp(uc_t, uc_j)
    x0 = np.random.RandomState(0).randn(2, 20, 12).astype(np.float32)
    z_t = ts.sample_cfg(c_t, 5.0, uc_t, timesteps=4, x0=torch.tensor(x0))
    z_j = js.sample_cfg(c_j, 5.0, uc_j, None, timesteps=4, x0=jnp.asarray(x0))
    _cmp(z_t, z_j)
    mel_t, mel_j = ts.decode_first_stage(z_t), js.decode_first_stage(z_j)
    _cmp(mel_t, mel_j)
    wav_t, wav_j = ts.vocode(mel_t), js.vocode(mel_j)
    assert wav_t.shape == (2, 96) and np.isfinite(wav_t).all()
    _cmp(wav_t, wav_j)
    before = ts.vocoder
    ts._load_vocoder(vdir)  # system.py:236: the same directory again
    assert ts.vocoder is not before and not ts.vocoder.conv_pre.weight.requires_grad
    _cmp(ts.vocode(mel_t), wav_j)


@pytest.mark.parametrize("case", ["partial_ema", "no_ema", "missing_dit_key",
                                  "no_cond", "no_cond_init_cond_false", "bad_vocoder"])
def test_lightning_import_edge_cases(files, tmp_path, case, capsys):
    _, states, _, _ = files
    kw = dict(device="cpu", compute_dtype=torch.float32, clap_cfg=small_clap(),
              voc_cfg=tvoc.BigVGANConfig(**VOC))
    ckpt = lightning_dict(states, ema={"partial_ema": "partial",
                                       "no_ema": "none"}.get(case, "full"))
    sd = ckpt["state_dict"]
    if case == "missing_dit_key":
        del sd["model.diffusion_model.blocks.1.attention.wk_y.weight"]
    if case.startswith("no_cond"):
        for k in [k for k in sd if k.startswith("cond_stage_model.")]:
            del sd[k]
    path = str(tmp_path / "m.ckpt")
    torch.save(ckpt, path)
    if case == "missing_dit_key":
        with pytest.raises(KeyError, match="blocks.1.attention.wk_y.weight"):
            MAA3System.from_config([XL], SMALL, ckpt_path=path, **kw)
        return
    if case == "bad_vocoder":  # a generator missing a key the vocoder needs
        voc = {k: v for k, v in states["vocoder"].items() if k != "conv_post.bias"}
        vdir = write_vocoder_dir(tmp_path / "voc", voc_json(), voc)
        with pytest.raises(KeyError, match="conv_post.bias"):
            MAA3System.from_config([XL], SMALL, ckpt_path=path, vocoder_dir=vdir, **kw)
        return
    s = MAA3System.from_config([XL], SMALL, ckpt_path=path,
                               init_cond=case != "no_cond_init_cond_false", **kw)
    out = capsys.readouterr().out
    if case in ("partial_ema", "no_ema"):  # the live weights, not a half EMA
        assert ("EMA covers" in out) == (case == "partial_ema")
        assert "using EMA" not in out
        for k, v in s.dit.state_dict().items():
            assert torch.equal(v, states["dit"][k]), k
    elif case == "no_cond":  # a random conditioner stands in
        assert isinstance(s.cond, tclap.CLAPFLAN)
        assert s.get_learned_conditioning(PROMPTS).shape == (2, 154, 32)
    else:
        assert s.cond is None
        with pytest.raises(ValueError, match="no conditioner"):
            s.get_learned_conditioning(PROMPTS)


def test_head_dim_beyond_the_flash_kernels_is_refused_at_load(monkeypatch):
    """A DiT whose head dim exceeds MAX_HEAD_DIM, where its serving length
    runs self-attention on the flash kernels, is refused before any module
    is built on the card; on the CPU the plain path runs it."""
    over = [UP + "hidden_size=160", UP + "num_heads=2", UP + "depth=1",
            UP + "use_flash=true"]
    spec = tconfig.parse_model_config(tconfig.load_config([XL], over))
    from maa3_tpu_torch import system as tsystem
    with pytest.raises(ValueError, match="head dim 80 .* exceeds the flash kernels' 72"):
        tsystem.check_limits(spec, "cuda")
    tsystem.check_limits(spec, "cpu")
    tsystem.check_limits(tconfig.parse_model_config(tconfig.load_config(
        [XL], [UP + "hidden_size=160", UP + "num_heads=2"])), "cuda")  # dense at 312


def test_trainer_checkpoint_serves_its_ema(tmp_path):
    """A Trainer's checkpoint through from_config: the DiT and the trained
    conditioner from the EMA shadows, the frozen VAE and the scale factor."""
    from maa3_tpu_torch.train.loop import Trainer
    kw = dict(device="cpu", compute_dtype=torch.float32, clap_cfg=small_clap(),
              voc_cfg=tvoc.BigVGANConfig(**VOC))
    src = MAA3System.from_config([XL], SMALL, seed=3, unfreeze=True, **kw)
    tr = Trainer(src, batch_size=2, use_ema=True, ckpt_every=0,
                 ckpt_dir=str(tmp_path / "run"))
    assert tr.state.cond is src.cond
    with torch.no_grad():
        for i, e in enumerate(tr.state.ema):
            e.add_(0.01 * (i + 1))
        for p in src.vae.parameters():
            p.mul_(1.5)
    tr.state.scale_factor = 0.55
    path = tr.save_checkpoint(tag="last")
    s = MAA3System.from_config([XL], SMALL, seed=9, ckpt_path=path, **kw)
    names = [("dit", n) for n, _ in src.dit.named_parameters()] + [
        ("cond", n) for n, _ in src.cond.named_parameters()]
    for (mod, n), e in zip(names, tr.state.ema):
        assert torch.equal(getattr(s, mod).state_dict()[n], e), n
    for k, v in src.vae.state_dict().items():
        assert torch.equal(s.vae.state_dict()[k], v), k
    assert s.scale_factor == 0.55


def test_train_cli_warm_starts_from_a_lightning_file(tmp_path, monkeypatch):
    """--torch_ckpt: the training CLI starts from the file's weights (its
    EMA DiT, conditioner and VAE); with no step taken, `last` holds them.
    (The Trainer starts from the config's scale factor and rescales by std,
    as the JAX Trainer does.)"""
    from maa3_tpu_torch.train import __main__ as cli
    from tests.test_torch_train import _small_synth_setup
    over = _small_synth_setup(tmp_path, monkeypatch)
    src = MAA3System.from_config([XL], over, seed=4, device="cpu", unfreeze=True)
    states = {"dit": src.dit.state_dict(), "vae": src.vae.state_dict(),
              "cond": src.cond.state_dict()}
    ckpt = lightning_dict(states, scale_factor=0.6)
    torch.save(ckpt, tmp_path / "warm.ckpt")
    cli.main(["-b", XL, "--torch_ckpt", str(tmp_path / "warm.ckpt"), "--max_steps", "0",
              "--device", "cpu", "--fp32", "--ckpt_dir", str(tmp_path / "run"), *over])
    saved = torch.load(tmp_path / "run" / "last.pt", weights_only=True)
    sd = ckpt["state_dict"]
    for k, v in saved["params"]["dit"].items():
        assert torch.equal(v, sd["model_ema." + ema_name(k)]), k
    for k, v in saved["params"]["cond"].items():
        assert torch.equal(v, states["cond"][k]), k
    for k, v in saved["frozen"]["vae"].items():
        assert torch.equal(v, states["vae"][k]), k


# -- conditioners, systems, vocoders and sampling against JAX ----------------

@pytest.mark.parametrize("kind", ["flan", "clap"])
def test_conditioner_matches_jax(kind):
    jcfg = _jclap_cfg()
    params = jax.tree.map(np.asarray, jclap.clap_flan_init(jax.random.PRNGKey(1), jcfg))
    m = tclap.COND_MODULES[kind](small_clap())
    m.load_state_dict(params_from_jax({"cond": params}, kind)["cond"])
    ids = np.random.RandomState(2).randint(0, 300, (3, 77))
    mask = (np.arange(77)[None] < np.array([[77], [20], [5]])).astype(np.int64)
    fn = jclap.flan_encode if kind == "flan" else jclap.clap_encode
    want = fn(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    enc = tclap.flan_encode if kind == "flan" else tclap.clap_encode
    with torch.no_grad():
        got = enc(m, torch.tensor(ids), torch.tensor(mask))
    assert got.shape == (3, 77, 32)
    _cmp(got, want)


@pytest.mark.parametrize("kind", ["flan", "clap"])
def test_flan_and_clap_systems_match_jax(kind):
    """The text-to-music config (FLAN) and a CLAP-only config: conditioning
    from a list of captions, sample (no guidance) and sample_cfg; a dict
    raises TypeError instead of encoding its keys as JAX's list(c) does."""
    over = SMALL + (CLAP_ONLY if kind == "clap" else [])
    spec, params = _jax_params(MUSIC, over, jvoc.BigVGANConfig(**VOC), seed=2)
    assert spec.cond_kind == kind
    js = JSystem(spec, jax.tree.map(jnp.asarray, params), jvoc.BigVGANConfig(**VOC),
                 scale_factor=0.9, compute_dtype=jnp.float32, clap_cfg=_jclap_cfg())
    tspec = tconfig.parse_model_config(tconfig.load_config([MUSIC], over))
    assert tspec.cond_kind == kind and tspec.mel_length == 256
    ts = MAA3System.from_state_dicts(tspec, params_from_jax(params, kind),
                                     tvoc.BigVGANConfig(**VOC), small_clap(),
                                     scale_factor=0.9, device="cpu",
                                     compute_dtype=torch.float32)
    caps = ["a calm piano melody", "an upbeat drum loop"]
    c_t, uc_t = ts.get_learned_conditioning(caps), ts.get_learned_conditioning(["", ""])
    c_j, uc_j = js.get_learned_conditioning(caps), js.get_learned_conditioning(["", ""])
    assert c_t.shape == (2, 77, 32)
    _cmp(c_t, c_j)
    with pytest.raises(TypeError, match="list of captions"):
        ts.get_learned_conditioning(PROMPTS)
    assert ts.captions(["o"], ["s"]) == (["s"] if kind == "flan" else ["o"])
    key = jax.random.PRNGKey(3)
    z_j = js.sample(c_j, key, shape=(2, 20, 10), timesteps=4)
    x0 = np.asarray(jax.random.normal(key, (2, 20, 10), jnp.float32))
    z_t = ts.sample(c_t, x0=torch.tensor(x0), timesteps=4)
    _cmp(z_t, z_j)
    assert float(np.abs(np.asarray(z_j) - x0).max()) > 1e-2  # the ODE moved
    z_j = js.sample_cfg(c_j, 4.0, uc_j, None, timesteps=3, x0=jnp.asarray(x0))
    z_t = ts.sample_cfg(c_t, 4.0, uc_t, timesteps=3, x0=torch.tensor(x0))
    _cmp(z_t, z_j)


VOCODERS = {
    "amp2_snakebeta": dict(resblock="2", resblock_kernel_sizes=(3, 7),
                           resblock_dilation_sizes=((1, 3), (1, 3))),
    "amp2_snake": dict(resblock="2", activation="snake", snake_logscale=False,
                       resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
    "amp1_lrelu": dict(activation="lrelu", resblock_kernel_sizes=(3, 7),
                       resblock_dilation_sizes=((1, 3, 5), (1, 3, 5))),
    "amp2_lrelu": dict(resblock="2", activation="lrelu", resblock_kernel_sizes=(3,),
                       resblock_dilation_sizes=((1, 3),))}


@pytest.mark.parametrize("name", sorted(VOCODERS))
def test_vocoders_match_jax(name):
    """AMPBlock2 and lrelu vocoders (a wide stage through K1's plain version,
    a narrow one through K2's, lrelu through neither) against bigvgan_apply,
    with snake parameters made nonzero."""
    jcfg = jvoc.BigVGANConfig(**VOC, **VOCODERS[name])
    params = jvoc.bigvgan_init(jax.random.PRNGKey(4), jcfg)
    rng = np.random.RandomState(5)
    params = jax.tree.map(lambda a: np.asarray(a), params)
    for rb in params["resblocks"] + [{"acts": [params["activation_post"]]}]:
        for act in rb["acts"]:
            for k in act:
                act[k] = (act[k] + rng.uniform(-0.3, 0.3, act[k].shape)
                          ).astype(np.float32)
    voc = tvoc.BigVGAN(tvoc.BigVGANConfig(**VOC, **VOCODERS[name]))
    voc.load_state_dict(bigvgan_from_jax(params))
    assert any(".act." in k for k in voc.state_dict()) == ("lrelu" not in name)
    mel = rng.randn(2, 80, 9).astype(np.float32)
    want = jvoc.bigvgan_apply(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(mel))
    got = tvoc.bigvgan_apply(voc, torch.tensor(mel))
    assert got.shape == (2, 36)
    _cmp(got, want)


def test_vocoder_config_from_dict_matches_jax():
    for h in (voc_json(), voc_json(resblock=2, activation="lrelu",
                                   resblock_dilation_sizes=[[1, 3]] * 3)):
        t, j = tvoc.BigVGANConfig.from_dict(h), jvoc.BigVGANConfig.from_dict(h)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    d = dict(voc_json())
    del d["sampling_rate"], d["resblock"]
    assert tvoc.BigVGANConfig.from_dict(d) == tvoc.BigVGANConfig(**VOC)


@pytest.mark.parametrize("fp32_scores", [False, True])
def test_sdpa_bf16_scores_match_jax(fp32_scores):
    """_sdpa in bf16 (head-major here, (B, L, H, D) in JAX), the logits
    stored in bf16 or (fp32_scores) in fp32, with a key mask: bf16
    outputs, so rtol = atol = 2^-7 (one bf16 step of a value near 1)."""
    rng = np.random.RandomState(6)
    q, k, v = (rng.randn(2, 24, 4, 16).astype(np.float32) * 2 for _ in range(3))
    mask = np.arange(24)[None] < np.array([[24], [13]])
    want = jattn._sdpa(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 0.25,
                       jnp.asarray(mask), fp32_scores=fp32_scores)
    got = tattn._sdpa(*(torch.tensor(a).bfloat16().transpose(1, 2) for a in (q, k, v)),
                      0.25, torch.tensor(mask), fp32_scores=fp32_scores).transpose(1, 2)
    assert got.dtype == torch.bfloat16
    _cmp(got, np.asarray(want, np.float32), rtol=2 ** -7, atol=2 ** -7)


def test_ode_sub_batches_equal_the_whole_batch(monkeypatch, files):
    """MAA3_ODE_CHUNK=2 at B=4 runs the ODE as two sub-batches of 2, and
    gives the same latents as one batch of 4 (rows are independent; on the
    CPU the sub-batch GEMMs may round differently in the last bit, so
    rtol 1e-6 / atol 1e-6)."""
    tmp, _, _, _ = files
    s = MAA3System.from_config([XL], SMALL, device="cpu", compute_dtype=torch.float32,
                               clap_cfg=small_clap(), voc_cfg=tvoc.BigVGANConfig(**VOC),
                               ckpt_path=str(tmp / "model.ckpt"))
    caps = {"ori_caption": ["a", "b", "c", "d"], "struct_caption": ["<a>", "<b>", "<c>", "<d>"]}
    c = s.get_learned_conditioning(caps)
    uc = s.get_learned_conditioning({k: [""] * 4 for k in caps})
    x0 = torch.randn(4, 20, 10, generator=torch.Generator().manual_seed(7))
    plans = []
    real = tpipeline.dit_sample_plan
    monkeypatch.setattr(tpipeline, "dit_sample_plan",
                        lambda dit, t, ctx, **kw: plans.append(ctx.shape[0]) or real(
                            dit, t, ctx, **kw))
    monkeypatch.delenv("MAA3_ODE_CHUNK", raising=False)
    assert tpipeline.ode_chunk() == 0
    whole = s.sample_cfg(c, 5.0, uc, timesteps=3, x0=x0)
    monkeypatch.setenv("MAA3_ODE_CHUNK", "2")
    parts = s.sample_cfg(c, 5.0, uc, timesteps=3, x0=x0)
    monkeypatch.setenv("MAA3_ODE_CHUNK", "3")  # does not divide 4: one batch
    odd = s.sample_cfg(c, 5.0, uc, timesteps=3, x0=x0)
    assert plans == [8, 4, 4, 8]  # dual batches [uc; c]
    _cmp(parts, whole.numpy(), rtol=1e-6, atol=1e-6)
    assert torch.equal(odd, whole)
