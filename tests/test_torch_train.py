"""The port's training path against the JAX package on the CPU, fp32 at
rtol 1e-3 / atol 1e-4: the VAE encoder and posterior sample, the CFM loss
with JAX's random draws replayed, the optimizer (clip + AdamW + LambdaLinear
schedule) against optax, EMA, and two make_train_step steps of a small
config with flash attention forced on, remat off and on (loss, gradients,
grad norm and every parameter), and two steps that also train a small
CLAP+FLAN conditioner with the split flash backward. Then Trainer.fit and the
training CLI on clips of data/synth (the CLI with the YAML's trainable
conditioner, periodic checkpoints and -r), checkpoints saved and restored
(the next step equal to the uninterrupted run's, rotation, tags, refusals),
and the data helpers against the JAX ones."""

import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maa3_tpu.data import datasets as jdata
from maa3_tpu.diffusion import cfm as jcfm
from maa3_tpu.models import bert as jbert
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import t5 as jt5
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.train import optim as joptim
from maa3_tpu.train import step as jstep
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.data import datasets as tdata
from maa3_tpu_torch.diffusion import cfm as tcfm
from maa3_tpu_torch.models import bert as tbert
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.models import t5 as tt5
from maa3_tpu_torch.models import vae1d as tvae
from maa3_tpu_torch.ops import flash_attention as tfa
from maa3_tpu_torch.train import optim as toptim
from maa3_tpu_torch.train import step as tstep
from maa3_tpu_torch.weights import clap_flan_from_jax, dit_from_jax, vae_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
TOL = dict(rtol=1e-3, atol=1e-4)
VAE = dict(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(), z_channels=4, embed_dim=4)
DIT = dict(in_channels=4, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32)
BERT = dict(vocab_size=100, hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64)
T5 = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=48, num_layers=1, num_heads=4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cmp(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _vae_pair():
    p = jvae.vae_init(jax.random.PRNGKey(0), jvae.VAEConfig(**VAE))
    m = tvae.AutoencoderKL(tvae.VAEConfig(**VAE))
    m.load_state_dict(vae_from_jax(_np(p)))
    return p, m


def test_vae_encoder_and_sample_match_jax():
    p, m = _vae_pair()
    mel = np.random.RandomState(0).randn(2, 16, 40).astype(np.float32)
    want = jax.jit(lambda p, x: jvae.vae_encode_moments(p, jvae.VAEConfig(**VAE), x))(
        p, jnp.asarray(mel))
    with torch.no_grad():
        got = tvae.vae_encode_moments(m, torch.tensor(mel))
    assert got.shape == (2, 8, 20)
    _cmp(got, want)
    key = jax.random.PRNGKey(7)
    noise = jax.random.normal(key, (2, 4, 20), jnp.float32)
    _cmp(tvae.gaussian_sample(got, noise=torch.tensor(np.asarray(noise))),
         jvae.gaussian_sample(want, key))
    g = torch.Generator().manual_seed(0)
    assert tvae.gaussian_sample(got, g).shape == (2, 4, 20)


def _cfm_draws(key, b, shape):
    """The draws jcfm.cfm_loss makes from `key`."""
    kt, kn = jax.random.split(key)
    return (np.asarray(jax.random.randint(kt, (b,), 0, 1000)),
            np.asarray(jax.random.normal(kn, shape, jnp.float32)))


def test_cfm_loss_matches_jax_with_replayed_draws():
    rng = np.random.RandomState(1)
    x1 = rng.randn(3, 4, 10).astype(np.float32)
    ctx = rng.randn(3, 5, 6).astype(np.float32)
    w = rng.randn(4, 4).astype(np.float32)

    def jvel(x, t, c):
        return (jnp.einsum("oc,bct->bot", w, x) * (t[:, None, None] / 1000.0)
                + c.mean(axis=(1, 2))[:, None, None])

    def tvel(x, t, c):
        return (torch.einsum("oc,bct->bot", torch.tensor(w), x)
                * (t[:, None, None] / 1000.0) + c.mean(dim=(1, 2))[:, None, None])

    key = jax.random.PRNGKey(3)
    want, _ = jax.jit(lambda x, c, k: jcfm.cfm_loss(jvel, x, c, k))(
        jnp.asarray(x1), jnp.asarray(ctx), key)
    t_int, x0 = _cfm_draws(key, 3, x1.shape)
    got, aux = tcfm.cfm_loss(tvel, torch.tensor(x1), torch.tensor(ctx),
                             t_int=torch.tensor(t_int), x0=torch.tensor(x0))
    _cmp(got, want)
    assert aux["loss_simple"] is got


def test_optimizer_and_ema_match_optax():
    rng = np.random.RandomState(2)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[(3.0 * rng.randn(*s)).astype(np.float32) for s in shapes]
             for _ in range(3)]
    kw = dict(base_lr=1e-2, lr_multiplier=1.0, warm_up_steps=2)
    opt = joptim.make_optimizer(**kw)
    update = jax.jit(opt.update)
    jp = [jnp.asarray(a) for a in p0]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    topt = toptim.make_optimizer(tp, **kw)
    jema, tema = list(jp), [t.detach().clone() for t in tp]
    for n, g in enumerate(grads):
        upd, st = update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        jema = joptim.ema_update(jema, jp, 0.999, n)
        for t, a in zip(tp, g):
            t.grad = torch.tensor(a)
        norm = topt.step()
        toptim.ema_update(tema, tp, 0.999, n)
        _cmp(norm, optax.global_norm([jnp.asarray(a) for a in g]))
        for a, b in zip(tp, jp):
            _cmp(a, b)
        for a, b in zip(tema, jema):
            _cmp(a, b)
    assert np.abs(np.asarray(jp[0]) - p0[0]).max() > 1e-3  # the updates moved it
    sched, tsched = joptim.lambda_linear_schedule(0.5, 10), toptim.lambda_linear_schedule(0.5, 10)
    for s in (0, 1, 5, 10, 11, 10 ** 6):
        assert tsched(s) == pytest.approx(float(sched(s)), rel=1e-6)


def _train_pair(remat):
    jcfg = jdit.DiTConfig(**DIT, use_flash=True, remat=remat)
    pd = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(0), jcfg),
                            jax.random.PRNGKey(1))
    pv, vae = _vae_pair()
    dit = tdit.DiT(tdit.DiTConfig(**DIT, use_flash=True, remat=remat))
    dit.load_state_dict(dit_from_jax(_np(pd)))
    return jcfg, pd, pv, dit, vae


@pytest.mark.parametrize("remat", [False, True])
def test_train_steps_match_jax(remat):
    jcfg, pd, pv, dit, vae = _train_pair(remat)
    # full LR from the first update: two updates move parameters ~2e-3, past atol
    kw = dict(base_lr=1e-3, lr_multiplier=1.0, warm_up_steps=0)
    jopt = joptim.make_optimizer(**kw)
    jst = jstep.create_train_state({"dit": pd}, {"vae": pv}, jopt, scale_factor=0.7)
    jtrain = jax.jit(jstep.make_train_step(jcfg, jvae.VAEConfig(**VAE), jopt,
                                           compute_dtype=jnp.float32))
    tst = tstep.create_train_state(dit, vae, toptim.make_optimizer(dit.parameters(), **kw),
                                   scale_factor=0.7)
    ttrain = tstep.make_train_step(compute_dtype=torch.float32)
    rng = np.random.RandomState(4)
    names = [n for n, _ in dit.named_parameters()]
    start = [p.detach().clone() for p in dit.parameters()]
    n0 = tfa.launches.copy()
    for i in range(2):
        mel = rng.randn(2, 16, 40).astype(np.float32)
        ctx = rng.randn(2, 6, 32).astype(np.float32)
        key = jax.random.PRNGKey(10 + i)
        kvae, kcfm = jax.random.split(key)
        noise = np.asarray(jax.random.normal(kvae, (2, 4, 20), jnp.float32))
        t_int, x0 = _cfm_draws(kcfm, 2, (2, 4, 20))
        if i == 0:  # gradients of the first step, from the JAX loss itself
            def jloss(params):
                m = jvae.vae_encode_moments(pv, jvae.VAEConfig(**VAE), jnp.asarray(mel))
                z = jvae.gaussian_sample(m, kvae) * 0.7
                return jcfm.cfm_loss(lambda x, t, c: jdit.dit_apply(
                    params, jcfg, x, t, c, compute_dtype=jnp.float32, training=True),
                    z, jnp.asarray(ctx), kcfm)[0]
            jgrads = dit_from_jax(_np(jax.jit(jax.grad(jloss))(pd)))
        jst, jm = jtrain(jst, {"mel": jnp.asarray(mel), "context": jnp.asarray(ctx)}, key)
        tm = ttrain(tst, {"mel": torch.tensor(mel), "context": torch.tensor(ctx)},
                    draws={"noise": torch.tensor(noise), "t_int": torch.tensor(t_int),
                           "x0": torch.tensor(x0)})
        _cmp(tm["loss"], jm["loss"])
        _cmp(tm["grad_norm"], jm["grad_norm"])
        clip = min(1.0, 1.0 / float(jm["grad_norm"]))
        if i == 0:
            for n, p in dit.named_parameters():  # .grad holds the clipped gradient
                _cmp(p.grad, jgrads[n].numpy() * clip)
        jp = dit_from_jax(_np(jst.params["dit"]))
        for n, p in dit.named_parameters():
            _cmp(p, jp[n])
    assert tst.step == 2 and len(names) == len(jp)
    assert max((p.detach() - s).abs().max().item()
               for p, s in zip(dit.parameters(), start)) > 1e-3
    assert tfa.launches == n0  # the CPU path runs the plain versions


def test_train_steps_with_conditioner_match_jax(monkeypatch):
    """Two steps that train the DiT and a small CLAP+FLAN conditioner together
    (maa3_tpu/train/step.py with its `conditioner`), with MAA3_FLASH_BWD=split
    in both packages: loss, grad norm (over both modules) and every parameter
    of both after each step."""
    monkeypatch.setenv("MAA3_FLASH_BWD", "split")
    jcfg, pd, pv, dit, vae = _train_pair(False)
    ccfg = jclap.CLAPFLANConfig(bert=jbert.BertConfig(**BERT), t5=jt5.T5Config(**T5),
                                d_proj=32)
    pc = jclap.clap_flan_init(jax.random.PRNGKey(5), ccfg)
    cond = tclap.CLAPFLAN(tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT),
                                               t5=tt5.T5Config(**T5), d_proj=32))
    cond.load_state_dict(clap_flan_from_jax(_np(pc)))
    kw = dict(base_lr=1e-3, lr_multiplier=1.0, warm_up_steps=0)
    jopt = joptim.make_optimizer(**kw)
    jst = jstep.create_train_state({"dit": pd, "cond": pc}, {"vae": pv}, jopt,
                                   use_ema=True, scale_factor=0.7)

    def jcond(params, batch):
        return jclap.clap_flan_encode(params["cond"], ccfg, batch["ori_ids"],
                                      batch["struct_ids"], batch["ori_mask"],
                                      batch["struct_mask"])

    jtrain = jax.jit(jstep.make_train_step(jcfg, jvae.VAEConfig(**VAE), jopt,
                                           compute_dtype=jnp.float32, conditioner=jcond))
    params = list(dit.parameters()) + list(cond.parameters())
    tst = tstep.create_train_state(dit, vae, toptim.make_optimizer(params, **kw),
                                   use_ema=True, scale_factor=0.7, cond=cond)
    ttrain = tstep.make_train_step(compute_dtype=torch.float32,
                                   conditioner=tclap.clap_flan_encode_batch)
    start = [p.detach().clone() for p in cond.parameters()]
    rng = np.random.RandomState(6)
    n0 = tfa.launches.copy()
    for i in range(2):
        mel = rng.randn(2, 16, 40).astype(np.float32)
        tokens = {"ori_ids": rng.randint(0, 100, (2, 12)), "struct_ids": rng.randint(0, 120, (2, 12)),
                  "ori_mask": np.ones((2, 12), np.int32), "struct_mask": np.ones((2, 12), np.int32)}
        tokens["ori_mask"][1, 7:] = 0
        tokens["struct_mask"][0, 9:] = 0
        key = jax.random.PRNGKey(20 + i)
        kvae, kcfm = jax.random.split(key)
        noise = np.asarray(jax.random.normal(kvae, (2, 4, 20), jnp.float32))
        t_int, x0 = _cfm_draws(kcfm, 2, (2, 4, 20))
        jst, jm = jtrain(jst, {"mel": jnp.asarray(mel),
                               **{k: jnp.asarray(v, jnp.int32) for k, v in tokens.items()}}, key)
        tm = ttrain(tst, {"mel": torch.tensor(mel),
                          **{k: torch.tensor(v, dtype=torch.int64) for k, v in tokens.items()}},
                    draws={"noise": torch.tensor(noise), "t_int": torch.tensor(t_int),
                           "x0": torch.tensor(x0)})
        _cmp(tm["loss"], jm["loss"])
        _cmp(tm["grad_norm"], jm["grad_norm"])
        for mod, conv, jp in ((dit, dit_from_jax, jst.params["dit"]),
                              (cond, clap_flan_from_jax, jst.params["cond"])):
            want = conv(_np(jp))
            for n, p in mod.named_parameters():
                _cmp(p, want[n])
        jema = dit_from_jax(_np(jst.ema_params["dit"])) | clap_flan_from_jax(
            _np(jst.ema_params["cond"]))
        names = [n for n, _ in dit.named_parameters()] + [n for n, _ in cond.named_parameters()]
        for n, e in zip(names, tst.ema):
            _cmp(e, jema[n])
    assert max((p.detach() - s).abs().max().item()
               for p, s in zip(cond.parameters(), start)) > 1e-3
    assert tfa.launches == n0  # the CPU path runs the plain versions


def _small_synth_setup(tmp_path, monkeypatch):
    """Four clips of data/synth in a manifest, tiny-model overrides of the XL
    config, and MAA3System.from_config patched to a tiny conditioner and
    vocoder. Returns the overrides."""
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System

    rows = jdata.read_tsv(os.path.join(ROOT, "data", "synth", "manifest_mel.tsv"))[:4]
    tsv = tmp_path / "four.tsv"
    with open(tsv, "w") as f:
        f.write("\t".join(rows[0]) + "\n")
        for r in rows:
            r = dict(r, mel_path=os.path.join(ROOT, r["mel_path"]))
            f.write("\t".join(r.values()) + "\n")
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=32", up + "depth=2", up + "num_heads=2", up + "context_dim=16",
            up + "multiple_of=16", up + "use_flash=true", dd + "ch=32", dd + "ch_mult=[1, 2]",
            dd + "num_res_blocks=1",
            f"data.params.train.params.dataset_cfg.dataset_name={tsv}",
            "data.params.train.params.dataset_cfg.spec_crop_len=64"]
    real = MAA3System.from_config.__func__

    def small(cls, paths, overrides=(), *a, **kw):
        kw.update(clap_cfg=CLAPFLANConfig(
            bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32),
            t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2), d_proj=16),
            voc_cfg=BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                  upsample_initial_channel=128))
        return real(cls, paths, overrides, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))
    return over


def test_trainer_fit_and_cli_on_synth_clips(tmp_path, monkeypatch):
    """Trainer.fit with the frozen conditioner (cond_stage_trainable=false),
    then the CLI on the YAML as written (trainable conditioner) with a
    checkpoint every step, and the CLI again resumed from its `last`."""
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train import __main__ as cli
    from maa3_tpu_torch.train.loop import Trainer

    over = _small_synth_setup(tmp_path, monkeypatch)
    frozen = over + ["model.params.cond_stage_trainable=false"]
    system = MAA3System.from_config([XL], frozen, device="cpu", compute_dtype=torch.float32)
    data = tconfig.parse_data_config(tconfig.load_config([XL], frozen))
    trainer = Trainer(system, batch_size=2, log_every=1, ckpt_dir=str(tmp_path / "fit"))
    assert trainer.state.cond is None
    before = [p.detach().clone() for p in system.dit.parameters()]
    m = trainer.fit(cli.build_loader(data, 2, 0, 8), max_steps=2)
    assert m["step"] == 2 and np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert trainer.state.scale_factor != 1.0  # the XL config rescales by std
    assert any((a != b.detach()).any() for a, b in zip(before, system.dit.parameters()))
    lines = (tmp_path / "fit" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    val = trainer.evaluate(cli.build_loader(data, 2, 1, 8), max_batches=1)
    assert np.isfinite(val["val/loss_simple"])

    ckpt = tmp_path / "cli"
    m = cli.main(["-b", XL, "--max_steps", "2", "--batch_size", "2", "--device", "cpu",
                  "--fp32", "--remat", "--log_every", "1", "--ckpt_every", "1",
                  "--ckpt_dir", str(ckpt), *over])
    assert m["step"] == 2 and np.isfinite(m["loss"])
    assert sorted(os.listdir(ckpt)) == ["last.pt", "metrics.jsonl", "step_00000001.pt",
                                        "step_00000002.pt", "tb"]
    saved = torch.load(ckpt / "last.pt", weights_only=True)
    assert sorted(saved["params"]) == ["cond", "dit"] and saved["step"] == 2
    m = cli.main(["-b", XL, "-r", str(ckpt / "last.pt"), "--max_steps", "1",
                  "--batch_size", "2", "--device", "cpu", "--fp32", "--log_every", "1",
                  "--ckpt_every", "0", "--ckpt_dir", str(tmp_path / "resumed"), *over])
    assert m["step"] == 3 and np.isfinite(m["loss"])
    resumed = torch.load(tmp_path / "resumed" / "last.pt", weights_only=True)
    assert resumed["step"] == 3 and resumed["scale_factor"] == saved["scale_factor"]


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch, capsys):
    """A Trainer of the YAML as written (DiT + conditioner) saves after step
    1; a fresh Trainer restored from it takes step 2 exactly as the
    uninterrupted one does. Then rotation (keep_last_k), the tags, the crash
    save, a file without the frozen VAE, and the two refusals of a file
    whose trainable set differs from the trainer's."""
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train import __main__ as cli
    from maa3_tpu_torch.train.loop import Trainer

    over = _small_synth_setup(tmp_path, monkeypatch)
    data = tconfig.parse_data_config(tconfig.load_config([XL], over))
    raws = list(itertools.islice(cli.build_loader(data, 2, 0, 8), 2))

    def make(ckpt_dir, train_cond=None):
        s = MAA3System.from_config([XL], over, device="cpu", compute_dtype=torch.float32,
                                   unfreeze=True)
        return Trainer(s, batch_size=2, log_every=1, ckpt_every=0, ckpt_dir=str(ckpt_dir),
                       train_cond=train_cond)

    a = make(tmp_path / "a")
    assert a.state.cond is a.system.cond
    a.train_step(raws[0])
    path = a.save_checkpoint()
    assert os.path.basename(path) == "step_00000001.pt"
    ma = a.train_step(raws[1])
    b = make(tmp_path / "b")
    b.restore_checkpoint(path)
    assert b.state.step == 1 and b.state.scale_factor == a.state.scale_factor
    mb = b.train_step(raws[1])
    for k in ("loss", "grad_norm"):
        assert torch.equal(ma[k], mb[k]), k
    for pa, pb in zip(a.state.trainable_parameters(), b.state.trainable_parameters()):
        assert torch.equal(pa, pb)
    b.sync_system_params()
    assert b.system.cond is b.state.cond and b.system.scale_factor == b.state.scale_factor
    payload = torch.load(path, weights_only=True)
    del payload["frozen"]
    torch.save(payload, tmp_path / "no_frozen.pt")

    for _ in range(3):  # steps 3, 4, 5: periodic saves rotate, tagged ones stay
        a.train_step(raws[0])
        a.save_checkpoint(keep_last_k=2)
    a.save_checkpoint(tag="last")
    a.save_checkpoint(tag="usr1")

    def boom(*_):
        raise RuntimeError("boom")

    a._train_step = boom
    with pytest.raises(RuntimeError, match="boom"):
        a.train_step(raws[0])
    assert sorted(os.listdir(tmp_path / "a")) == [
        "crash.pt", "last.pt", "step_00000004.pt", "step_00000005.pt", "usr1.pt"]

    vae_before = [t.clone() for t in b.state.vae.state_dict().values()]
    b.restore_checkpoint(str(tmp_path / "no_frozen.pt"))
    assert "keeping the current one" in capsys.readouterr().out
    assert all(torch.equal(x, y) for x, y in zip(vae_before, b.state.vae.state_dict().values()))

    frozen = make(tmp_path / "frozen", train_cond=False)
    with pytest.raises(ValueError, match="cond_stage_trainable"):
        frozen.restore_checkpoint(str(tmp_path / "a" / "last.pt"))
    with pytest.raises(ValueError, match="cond_stage_trainable"):
        b.restore_checkpoint(frozen.save_checkpoint(tag="last"))


def test_config_reads_training_settings():
    spec = tconfig.parse_model_config(tconfig.load_config([XL]))
    assert (spec.scale_by_std, spec.cond_stage_trainable, spec.base_learning_rate) == (
        True, True, 3e-6)
    assert spec.dit.use_flash is None and not spec.dit.remat
    up = "model.params.unet_config.params."
    spec = tconfig.parse_model_config(tconfig.load_config(
        [XL], [up + "use_flash=false", up + "remat=true"]))
    assert spec.dit.use_flash is False and spec.dit.remat
    with pytest.raises(ValueError, match="unknown remat_policy: 'save_all'"):
        tconfig.parse_model_config(tconfig.load_config([XL], [up + "remat_policy=save_all"]))
    for policy in ("nothing", "dots_no_batch", "save_gemms", "save_gemms_lite",
                   "save_gemms_h1"):
        spec = tconfig.parse_model_config(tconfig.load_config(
            [XL], [up + "remat=true", up + f"remat_policy={policy}"]))
        assert spec.dit.remat and spec.dit.remat_policy == policy
    data = tconfig.parse_data_config(tconfig.load_config([XL]))
    assert dataclasses.astuple(data) == ("audiocaps_train_16000_struct2.tsv", 624, 0.2, 16,
                                         "train", False)


def test_data_helpers_match_jax(tmp_path):
    for kw in (dict(), dict(shuffle=False)):
        a = tdata.BucketBatchSampler(range(11), 3, seed=5, **kw)
        b = jdata.BucketBatchSampler(range(11), 3, seed=5, **kw)
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)
    tsv = os.path.join(ROOT, "data", "synth", "manifest_mel.tsv")
    monkey_rows = jdata.read_tsv(tsv)[:3]
    path = tmp_path / "m.tsv"
    with open(path, "w") as f:
        f.write("\t".join(monkey_rows[0]) + "\n")
        for r in monkey_rows:
            r = dict(r, mel_path=os.path.join(ROOT, r["mel_path"]))
            f.write("\t".join(r.values()) + "\n")
        f.write("\t".join(dict(monkey_rows[0], mel_path="missing.npy").values()) + "\n")
    a = tdata.TextSpecDataset("train", str(path), 100, drop=0.5, seed=3)
    b = jdata.TextSpecDataset("train", str(path), 100, drop=0.5, seed=3)
    ta, tb = a.collater([a[i] for i in range(4)]), b.collater([b[i] for i in range(4)])
    np.testing.assert_array_equal(ta["image"], tb["image"])
    assert ta["caption"] == tb["caption"]
