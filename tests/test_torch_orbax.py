"""JAX Trainer checkpoints through orbax_to_torch.py on the CPU: JAX's
Trainer saves its Orbax directory into tmp_path, the converter writes the
port's Trainer file, and the port's readers must give what JAX's readers
give. Resumption (plain, accum_steps=2 saved mid-accumulation, a bf16
first moment, fuse_gemms): the port's Trainer restored from the converted
file and JAX's Trainer restored from the directory each take one more
step with JAX's draws replayed, and every parameter, moment, EMA shadow,
count and step agree (rtol 1e-3 / atol 1e-4; a bf16 moment within one
bf16 rounding). Inference: from_config(ckpt_path=) of the converted file
and JAX's _from_orbax give the same planned ODE latent in fp32 (the text
DiT, the video MoE, and a directory without `frozen`). Refusals: a
directory that is no checkpoint of the JAX package, configs or flags that
do not fit, and a directory handed to the port's readers."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import orbax_to_torch
from maa3_tpu import config as jconfig
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import dit_moe as jmoe
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.train.loop import Trainer as JTrainer
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch.models.bigvgan import BigVGANConfig
from maa3_tpu_torch.system import MAA3System
from maa3_tpu_torch.train.loop import Trainer
from maa3_tpu_torch.weights import dit_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
VIDEO = os.path.join(ROOT, "configs", "video2audio-cfm-cfg-moe.yaml")
TOL = dict(rtol=1e-3, atol=1e-4)
UP = "model.params.unet_config.params."
DD = "model.params.first_stage_config.params.ddconfig."
# the XL YAML cut to a DiT of width 64, depth 2 and a VAE of width 32 over 16
# mel bins, the conditioner frozen (the batches carry their context)
TEXT = [UP + "hidden_size=64", UP + "depth=2", UP + "num_heads=4", UP + "context_dim=32",
        UP + "multiple_of=32", UP + "in_channels=4", DD + "ch=32", DD + "ch_mult=[1, 2]",
        DD + "num_res_blocks=1", DD + "attn_layers=[]", DD + "in_channels=16",
        DD + "out_ch=16", DD + "z_channels=4", "model.params.first_stage_config.params.embed_dim=4",
        "model.params.cond_stage_trainable=false", "model.params.scale_by_std=false",
        "model.params.scale_factor=0.7", "model.base_learning_rate=1.0e-4"]
# the video MoE YAML at width 64, depth 2, its feature encoder trained
MOE = [UP + "hidden_size=64", UP + "depth=2", UP + "num_heads=4", UP + "context_dim=32",
       UP + "multiple_of=32", DD + "ch=32", DD + "ch_mult=[1, 2]", DD + "num_res_blocks=1",
       "model.params.scale_by_std=false", "model.params.scale_factor=0.7"]
SMALL_VOC = BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                          upsample_initial_channel=32)
TINY_CLAP = jclap.CLAPFLANConfig(
    bert=jclap.BertConfig(vocab_size=100, hidden_size=16, num_layers=1, num_heads=2,
                          intermediate_size=32),
    t5=jclap.T5Config(vocab_size=120, d_model=16, d_kv=8, d_ff=32, num_layers=1,
                      num_heads=2), d_proj=16)
KW = dict(batch_size=8, use_ema=True, ema_decay=0.99, warm_up_steps=2, log_every=100,
          ckpt_every=0)
VARIANTS = {"plain": dict(steps=2),
            "accum_mid": dict(steps=3, accum_steps=2),
            "bf16_mu": dict(steps=2, mu_dtype="bfloat16"),
            "fused": dict(steps=2, fuse_gemms=True)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_system(config, over, moe=False, seed=0):
    spec = jconfig.parse_model_config(jconfig.load_config([config], over))
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = {"dit": unfreeze_zero_init((jmoe.moe_dit_init if moe else jdit.dit_init)(
                  k[0], spec.dit), k[1]),
              "vae": jvae.vae_init(k[2], spec.vae)}
    if moe:
        params["cond"] = jclap.video_feat_encoder_init(k[3], 512, spec.dit.context_dim)
    return JSystem(spec, params, scale_factor=spec.scale_factor, compute_dtype=jnp.float32,
                   clap_cfg=TINY_CLAP)


def _port_system(config, over, **kw):
    return MAA3System.from_config([config], over, seed=5, device="cpu", voc_cfg=SMALL_VOC,
                                  compute_dtype=torch.float32, **kw)


def _raws(n):
    rng = np.random.RandomState(7)
    return [{"image": rng.randn(8, 16, 40).astype(np.float32),
             "context": rng.randn(8, 6, 32).astype(np.float32)} for _ in range(n)]


def _draws(seed, zshape=(8, 4, 20)):
    """The draws of JAX's Trainer.fit(seed=seed)'s first step
    (maa3_tpu/train/step.py: the posterior noise, then the CFM draws)."""
    kvae, kcfm = jax.random.split(jax.random.split(jax.random.PRNGKey(seed))[1])
    kt, kn = jax.random.split(kcfm)
    return {"noise": torch.tensor(np.asarray(jax.random.normal(kvae, zshape))),
            "t_int": torch.tensor(np.asarray(jax.random.randint(kt, (zshape[0],), 0, 1000))),
            "x0": torch.tensor(np.asarray(jax.random.normal(kn, zshape)))}


def _flags(v):
    return {k: v[k] for k in ("accum_steps", "mu_dtype", "fuse_gemms") if k in v}


def _jax_trainer(tmp_path, name, v):
    f = _flags(v)
    jt = JTrainer(_jax_system(XL, TEXT), ckpt_dir=str(tmp_path / name),
                  accum_steps=f.get("accum_steps", 1),
                  mu_dtype=jnp.dtype(f.get("mu_dtype", "float32")),
                  fuse_gemms=f.get("fuse_gemms", False), **KW)
    jt._tb_failed = True  # no TensorBoard (its TensorFlow import is slow)
    return jt


def _save(jt) -> str:
    """jt.save_checkpoint() of its state moved to one device (Orbax saves
    arrays of the 8-device mesh through a compile per array)."""
    jt.state = jax.device_put(jt.state, jax.devices()[0])
    return jt.save_checkpoint()


def _saved_state(st) -> dict:
    """What JAX's Trainer.save_checkpoint writes of a state."""
    return {"params": st.params, "opt_state": st.opt_state, "step": st.step,
            "scale_factor": st.scale_factor, "frozen": st.frozen,
            "ema_params": st.ema_params}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per variant: JAX's Trainer after its steps (saved and converted), then
    restored from its directory and one step further (that state through
    the converter's mapping)."""
    out = {}
    for name, v in VARIANTS.items():
        tmp = tmp_path_factory.mktemp(name)
        jt = _jax_trainer(tmp, "j", v)
        # the state replicated over the mesh, as a step leaves it: one compile
        jt.state = jax.device_put(jt.state, NamedSharding(jt.mesh, PartitionSpec()))
        raws = _raws(v["steps"] + 1)
        for i, raw in enumerate(raws[:-1]):
            jt.fit(iter([raw]), max_steps=1, seed=100 + i)
        saved = _save(jt)
        jt.restore_checkpoint(saved)
        jt.state = jax.device_put(jt.state, NamedSharding(jt.mesh, PartitionSpec()))
        jt.fit(iter([raws[-1]]), max_steps=1, seed=200)
        path = str(tmp / "saved.pt")
        assert orbax_to_torch.convert(saved, path, [XL], TEXT, **_flags(v)) == "trainer"
        out[name] = dict(v, dir=saved, file=path, raw=raws[-1], tmp=tmp,
                         after=orbax_to_torch.trainer_payload(_saved_state(jt.state), [XL],
                                                              TEXT, **_flags(v)))
    return out


def _cmp(got, want, what, bf16=False):
    tol = dict(rtol=2.0 ** -8, atol=1e-4) if bf16 else TOL
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), err_msg=what, **tol)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_resumed_step_matches_jax(runs, variant):
    """The port resumes the converted file to JAX's next step: every
    parameter, EMA shadow, AdamW moment (and accumulated gradient), the
    counts and the step; the converted file is what the port's writer
    writes, key for key."""
    r = runs[variant]
    f = _flags(r)
    t = Trainer(_port_system(XL, TEXT, init_cond=False), ckpt_dir=str(r["tmp"] / "t"),
                accum_steps=f.get("accum_steps", 1),
                mu_dtype=getattr(torch, f.get("mu_dtype", "float32")),
                fuse_gemms=f.get("fuse_gemms", False), **KW)
    t.restore_checkpoint(r["file"])
    assert t.state.step == r["steps"]
    assert t.state.optimizer.mini_step == (r["steps"] % 2 if "accum_steps" in f else 0)
    t.train_step(r["raw"], draws=_draws(200))
    got = torch.load(t.save_checkpoint(tag="after"), weights_only=True)
    want = r["after"]
    assert sorted(got) == sorted(want)
    assert sorted(got["opt_state"]) == sorted(want["opt_state"])
    for k in ("step", "scale_factor", "fuse_gemms"):
        assert got[k] == want[k], k
    for k in ("count", "mini_step", "kind", "mu_dtype", "accum_steps", "n_params"):
        assert got["opt_state"][k] == want["opt_state"][k], k
    for part in ("params", "frozen"):
        for m, sd in want[part].items():
            assert sorted(got[part][m]) == sorted(sd)
            for n, x in sd.items():
                _cmp(got[part][m][n], x, f"{part}.{m}.{n}")
    for key in ("mu", "nu", "acc"):
        if key in want["opt_state"]:
            for i, (a, b) in enumerate(zip(got["opt_state"][key], want["opt_state"][key],
                                           strict=True)):
                assert a.dtype == b.dtype and a.shape == b.shape, (key, i)
                _cmp(a, b, f"{key}[{i}]", bf16=b.dtype == torch.bfloat16)
    for i, (a, b) in enumerate(zip(got["ema_params"], want["ema_params"], strict=True)):
        _cmp(a, b, f"ema[{i}]")


def _same(a, b, where="payload"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def test_command_line_with_overrides(runs, tmp_path):
    """The documented command line, its key=value overrides right after
    -b's config and before a flag, writes what convert() writes."""
    r = runs["accum_mid"]
    out = str(tmp_path / "cli.pt")
    assert orbax_to_torch.main([r["dir"], out, "-b", XL, *TEXT, "--accum_steps", "2"]) == 0
    _same(torch.load(out, weights_only=True), torch.load(r["file"], weights_only=True))


@pytest.fixture
def no_jax_vocoder(monkeypatch):
    """JAX's _from_orbax without its random full-width BigVGAN (112 M
    parameters drawn on the host), which the latents do not use."""
    import maa3_tpu.system
    monkeypatch.setattr(maa3_tpu.system, "bigvgan_init", lambda key, cfg: {})


def _latents(js, ts, seed=3, ctx_dim=32, lc=6):
    rng = np.random.RandomState(seed)
    c, uc = (rng.randn(2, lc, ctx_dim).astype(np.float32) for _ in range(2))
    x0 = rng.randn(2, ts.spec.dit.in_channels, 12).astype(np.float32)
    want = js.sample_cfg(jnp.asarray(c), 3.0, jnp.asarray(uc), jax.random.PRNGKey(0),
                         timesteps=4, x0=jnp.asarray(x0))
    got = ts.sample_cfg(torch.tensor(c), 3.0, torch.tensor(uc), timesteps=4,
                        x0=torch.tensor(x0))
    assert float(np.abs(np.asarray(want) - x0).max()) > 1e-3  # the DiT moved it
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_served_from_converted_file_matches_from_orbax(runs, no_jax_vocoder):
    """from_config(ckpt_path=) of the converted file against JAX's
    _from_orbax of the directory (EMA preferred by both): the same ODE
    latent; the fused checkpoint too."""
    for variant in ("plain", "fused"):
        r = runs[variant]
        spec = jconfig.parse_model_config(jconfig.load_config([XL], TEXT))
        js = JSystem._from_orbax(spec, r["dir"], 0, jnp.float32, clap_cfg=TINY_CLAP)
        ts = _port_system(XL, TEXT, init_cond=False, ckpt_path=r["file"])
        payload = torch.load(r["file"], weights_only=True)
        want_vae = payload["frozen"]["vae"]
        for n, p in ts.vae.state_dict().items():
            assert torch.equal(p, want_vae[n]), n
        if variant == "plain":
            _latents(js, ts)


def _without_frozen(src, dst):
    """An Orbax directory of the round before the frozen VAE: src's
    entries but `frozen`, written with Orbax."""
    import orbax.checkpoint as ocp
    with ocp.PyTreeCheckpointer() as c:
        tree = c.restore(src)
    tree.pop("frozen")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(dst, tree)
    ckptr.wait_until_finished()
    return dst


def test_checkpoint_without_frozen(runs, no_jax_vocoder):
    """A directory without `frozen` converts to a file without it, which
    the port's Trainer restores (keeping its VAE) and from_config serves."""
    r = runs["plain"]
    d = _without_frozen(r["dir"], str(r["tmp"] / "old"))
    path = str(r["tmp"] / "old.pt")
    orbax_to_torch.convert(d, path, [XL], TEXT)
    assert "frozen" not in torch.load(path, weights_only=True)
    spec = jconfig.parse_model_config(jconfig.load_config([XL], TEXT))
    js = JSystem._from_orbax(spec, d, 0, jnp.float32, clap_cfg=TINY_CLAP)
    _latents(js, _port_system(XL, TEXT, init_cond=False, ckpt_path=path))
    t = Trainer(_port_system(XL, TEXT, init_cond=False), ckpt_dir=str(r["tmp"] / "t2"), **KW)
    vae = {n: p.clone() for n, p in t.state.vae.state_dict().items()}
    t.restore_checkpoint(path)
    assert all(torch.equal(p, vae[n]) for n, p in t.state.vae.state_dict().items())


def test_video_moe_checkpoint(tmp_path, no_jax_vocoder):
    """A video MoE Trainer checkpoint (the feature encoder trained, EMA on):
    the port serves the converted file as JAX's _from_orbax serves the
    directory, and its Trainer restores it."""
    js = _jax_system(VIDEO, MOE, moe=True, seed=1)
    jt = JTrainer(js, ckpt_dir=str(tmp_path / "j"), **KW)
    jt._tb_failed = True
    rng = np.random.default_rng(4)
    ema = jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
                       jt.state.params)
    jt.state = jt.state._replace(ema_params=ema)
    d = _save(jt)
    path = str(tmp_path / "moe.pt")
    assert orbax_to_torch.convert(d, path, [VIDEO], MOE) == "trainer"
    saved = torch.load(path, weights_only=True)
    assert sorted(saved["params"]) == ["cond", "dit"]
    ts = _port_system(VIDEO, MOE, ckpt_path=path)
    want = dit_from_jax(_np(ema["dit"]))
    for n, p in ts.dit.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), want[n].numpy(), err_msg=n)
    _latents(JSystem._from_orbax(js.spec, d, 0, jnp.float32), ts, lc=8)
    Trainer(_port_system(VIDEO, MOE), ckpt_dir=str(tmp_path / "t"), **KW).restore_checkpoint(path)


def test_refusals(runs, tmp_path):
    """An Orbax directory of none of the four kinds; a Trainer directory
    without -b, with configs of another width, with the wrong
    --accum_steps, --mu_dtype or --fuse_gemms; a directory handed to
    from_config, to the Trainer and to --vae_ckpt: each raises, the port's
    naming orbax_to_torch.py."""
    import orbax.checkpoint as ocp
    from maa3_tpu_torch.train.__main__ import load_vae_ckpt
    odd = str(tmp_path / "odd")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(odd, {"weights": jnp.ones(3)})
    ckptr.wait_until_finished()
    with pytest.raises(ValueError, match="none of the JAX package's checkpoints"):
        orbax_to_torch.convert(odd, str(tmp_path / "x.pt"))
    d, out = runs["plain"]["dir"], str(tmp_path / "y.pt")
    with pytest.raises(ValueError, match="-b configs"):
        orbax_to_torch.convert(d, out)
    for over, flags, what in ((TEXT + [UP + "hidden_size=96"], {}, r"\(2, 96, 576\) float32 from"),
                              (TEXT, {"accum_steps": 2}, "acc_grads/dit/.*: missing"),
                              (TEXT, {"mu_dtype": "bfloat16"}, "bfloat16 from the configs"),
                              (TEXT, {"fuse_gemms": True}, "wqkv")):
        with pytest.raises(ValueError, match=what):
            orbax_to_torch.convert(d, out, [XL], over, **flags)
    assert not os.path.exists(out)
    with pytest.raises(ValueError, match="orbax_to_torch.py"):
        _port_system(XL, TEXT, init_cond=False, ckpt_path=d)
    t = Trainer(_port_system(XL, TEXT, init_cond=False), ckpt_dir=str(tmp_path / "t"), **KW)
    with pytest.raises(ValueError, match="orbax_to_torch.py"):
        t.restore_checkpoint(d)
    with pytest.raises(ValueError, match="orbax_to_torch.py"):
        load_vae_ckpt(t.state.vae, d)
