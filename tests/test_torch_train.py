"""The port's training path against the JAX package on the CPU, fp32 at
rtol 1e-3 / atol 1e-4: the VAE encoder and posterior sample, the CFM loss
with JAX's random draws replayed, the optimizer (clip + AdamW + LambdaLinear
schedule) against optax, EMA, and two make_train_step steps of a small
config with flash attention forced on, remat off and on (loss, gradients,
grad norm and every parameter). Then Trainer.fit and the training CLI for two
steps on clips of data/synth, and the data helpers against the JAX ones."""

import dataclasses
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
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.train import optim as joptim
from maa3_tpu.train import step as jstep
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.data import datasets as tdata
from maa3_tpu_torch.diffusion import cfm as tcfm
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.models import vae1d as tvae
from maa3_tpu_torch.ops import flash_attention as tfa
from maa3_tpu_torch.train import optim as toptim
from maa3_tpu_torch.train import step as tstep
from maa3_tpu_torch.weights import dit_from_jax, vae_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
TOL = dict(rtol=1e-3, atol=1e-4)
VAE = dict(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(), z_channels=4, embed_dim=4)
DIT = dict(in_channels=4, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32)


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
        norm = topt.step(n)
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


def test_trainer_fit_and_cli_on_synth_clips(tmp_path, monkeypatch):
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train import __main__ as cli
    from maa3_tpu_torch.train.loop import Trainer

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
            dd + "num_res_blocks=1", "model.params.cond_stage_trainable=false",
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
    system = MAA3System.from_config([XL], over, device="cpu", compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="conditioner"):
        Trainer(system, train_cond=True, ckpt_dir=str(tmp_path / "no"))
    data = tconfig.parse_data_config(tconfig.load_config([XL], over))
    trainer = Trainer(system, batch_size=2, log_every=1, ckpt_dir=str(tmp_path / "fit"))
    before = [p.detach().clone() for p in system.dit.parameters()]
    m = trainer.fit(cli.build_loader(data, 2, 0, 8), max_steps=2)
    assert m["step"] == 2 and np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert trainer.state.scale_factor != 1.0  # the XL config rescales by std
    assert any((a != b.detach()).any() for a, b in zip(before, system.dit.parameters()))
    lines = (tmp_path / "fit" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    val = trainer.evaluate(cli.build_loader(data, 2, 1, 8), max_batches=1)
    assert np.isfinite(val["val/loss_simple"])

    m = cli.main(["-b", XL, "--max_steps", "2", "--batch_size", "2", "--device", "cpu",
                  "--fp32", "--remat", "--log_every", "1", "--ckpt_dir",
                  str(tmp_path / "cli"), *over])
    assert m["step"] == 2 and np.isfinite(m["loss"])


def test_config_reads_training_settings():
    spec = tconfig.parse_model_config(tconfig.load_config([XL]))
    assert (spec.scale_by_std, spec.cond_stage_trainable, spec.base_learning_rate) == (
        True, True, 3e-6)
    assert spec.dit.use_flash is None and not spec.dit.remat
    up = "model.params.unet_config.params."
    spec = tconfig.parse_model_config(tconfig.load_config(
        [XL], [up + "use_flash=false", up + "remat=true"]))
    assert spec.dit.use_flash is False and spec.dit.remat
    with pytest.raises(ValueError, match="remat_policy"):
        tconfig.parse_model_config(tconfig.load_config([XL], [up + "remat_policy=save_gemms"]))
    data = tconfig.parse_data_config(tconfig.load_config([XL]))
    assert dataclasses.astuple(data) == ("audiocaps_train_16000_struct2.tsv", 624, 0.2, 16)


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
