"""Video-to-audio with the MoE DiT, the port against the JAX package on the
CPU (fp32, rtol 1e-3 / atol 1e-4 unless a test says otherwise), the same
numpy inputs from a seed and the same weights (weights.params_from_jax):

- the MoE feed-forward (moe_apply, moe_apply_shared_t), moe_dit_apply in
  inference and with training=True (and forced flash attention), the
  planned sampler, and the gradients of one fp32 loss against jax.grad;
- the video feature encoder and the CLAP fusion layer;
- cfm.sample_cfg_inpaint, which keeps the known region on the OT path to
  1e-5;
- VideoSpecDataset and VideoSpecInpaintDataset: JAX's items, exactly, from
  the same seed and files;
- the video config parses to JAX's spec, and a random MoE Lightning file
  loads in both packages and gives the same sample;
- one Trainer step of a small video system against JAX's train step with
  the same draws (loss, grad norm, every parameter);
- the video2audio CLI end to end: one wav per clip (empty_vid skipped) of
  the windowed length, plain, --inpaint, --renorm and --clap_text; one
  window's latent against JAX's sample_cfg / sample_cfg_inpaint in-process;
  the --clap_text embedding's stable seed."""

import dataclasses
import os
import wave
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu import config as jconfig
from maa3_tpu import torch_import as jimport
from maa3_tpu.data import video_dataset as jvd
from maa3_tpu.diffusion import cfm as jcfm
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import dit_moe as jmoe
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.train import optim as joptim
from maa3_tpu.train import step as jstep
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch import video2audio
from maa3_tpu_torch.data import video_dataset as tvd
from maa3_tpu_torch.diffusion import cfm as tcfm
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import dit_moe as tmoe
from maa3_tpu_torch.models.bigvgan import BigVGANConfig
from maa3_tpu_torch.ops import flash_attention as tfa
from maa3_tpu_torch.pipeline import sample_planned
from maa3_tpu_torch.system import MAA3System
from maa3_tpu_torch.train.loop import Trainer
from maa3_tpu_torch.weights import dit_from_jax, params_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO = os.path.join(ROOT, "configs", "video2audio-cfm-cfg-moe.yaml")
UP, DD = "model.params.unet_config.params.", "model.params.first_stage_config.params.ddconfig."
SMALL = [UP + "hidden_size=64", UP + "depth=2", UP + "num_heads=4",
         UP + "context_dim=32", UP + "multiple_of=32", DD + "ch=32",
         DD + "ch_mult=[1, 2]", DD + "num_res_blocks=1"]
MOE = dict(in_channels=20, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32, num_experts=4)
VOC = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
           upsample_initial_channel=64)
TOL = dict(rtol=1e-3, atol=1e-4)


def _cmp(got, want, **tol):
    got = got if isinstance(got, np.ndarray) else got.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(tol or TOL))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def moe_pair():
    jcfg = jmoe.MoEDiTConfig(**MOE)
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    p = _np(unfreeze_zero_init(jmoe.moe_dit_init(ks[0], jcfg), ks[1]))
    dit = tmoe.MoEDiT(tmoe.MoEDiTConfig(**MOE))
    dit.load_state_dict(dit_from_jax(p))
    rng = np.random.RandomState(1)
    inp = dict(x=rng.randn(2, 20, 12).astype(np.float32),
               t=np.array([100, 800], np.int32),
               ctx=rng.randn(2, 5, 32).astype(np.float32),
               unc=rng.randn(2, 5, 32).astype(np.float32))
    return jcfg, p, dit, inp


def _j(inp, *keys):
    return [jnp.asarray(inp[k]) for k in keys]


def _t(inp, *keys):
    return [torch.tensor(inp[k]) for k in keys]


def test_moe_ffn_matches_jax(moe_pair):
    jcfg, p, dit, inp = moe_pair
    moe_p = jax.tree.map(lambda a: jnp.asarray(a[0]), p["blocks"]["feed_forward"])
    x = np.random.RandomState(2).randn(2, 7, 64).astype(np.float32)
    t = np.array([30, 999], np.int32)  # experts 0 and 3
    want = jmoe.moe_apply(moe_p, jnp.asarray(x), jnp.asarray(t), jcfg)
    with torch.no_grad():
        got = tmoe.moe_apply(dit.blocks[0].feed_forward, torch.tensor(x), torch.tensor(t),
                             dit.cfg)
        _cmp(got, want)
        for t_idx in range(4):
            want = jmoe.moe_apply_shared_t(moe_p, jnp.asarray(x), t_idx, jcfg)
            got = tmoe.moe_apply_shared_t(dit.blocks[0].feed_forward, torch.tensor(x),
                                          t_idx, dit.cfg)
            _cmp(got, want)


@pytest.mark.parametrize("training,flash", [(False, None), (True, None), (True, True)])
def test_moe_dit_apply_matches_jax(moe_pair, training, flash):
    jcfg, p, dit, inp = moe_pair
    jc = dataclasses.replace(jcfg, use_flash=flash)
    d = tmoe.MoEDiT(dataclasses.replace(dit.cfg, use_flash=flash))
    d.load_state_dict(dit.state_dict())
    want = jmoe.moe_dit_apply(p, jc, *_j(inp, "x", "t", "ctx"), compute_dtype=jnp.float32,
                              training=training)
    n0 = dict(tfa.launches)
    with torch.no_grad():
        got = tmoe.moe_dit_apply(d, *_t(inp, "x", "t", "ctx"), compute_dtype=torch.float32,
                                 training=training)
    _cmp(got, want)
    assert tfa.launches == n0  # the CPU path runs the plain flash versions


def test_moe_gradients_match_jax(moe_pair):
    jcfg, p, dit, inp = moe_pair

    def jloss(params):
        y = jmoe.moe_dit_apply(params, jcfg, *_j(inp, "x", "t", "ctx"),
                               compute_dtype=jnp.float32, training=True)
        return jnp.mean(jnp.square(y))

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, p))
    jg = dit_from_jax(_np(jg))
    dit.zero_grad()
    loss = tmoe.moe_dit_apply(dit, *_t(inp, "x", "t", "ctx"), compute_dtype=torch.float32,
                              training=True).square().mean()
    loss.backward()
    _cmp(loss, jl)
    scale = max(float(v.abs().max()) for v in jg.values())
    for n, prm in dit.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), jg[n].numpy(), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=n)
    dit.zero_grad(set_to_none=True)


def test_moe_planned_sampler_matches_jax(moe_pair):
    jcfg, p, dit, inp = moe_pair
    ctx_in = np.concatenate([inp["unc"], inp["ctx"]])
    t_ints = jcfm.planned_t_ints(5)
    plan = jmoe.moe_dit_sample_plan(p, jcfg, t_ints, jnp.asarray(ctx_in),
                                    compute_dtype=jnp.float32)

    def step_vel(x_in, xs):
        mods, final_mod, tidx = xs
        return jmoe.moe_dit_apply_planned(p, jcfg, x_in, mods, final_mod, tidx, plan["yk"],
                                          plan["yv"], plan["freq_sliced"],
                                          compute_dtype=jnp.float32)

    want = jcfm.sample_cfg_planned(step_vel, jnp.asarray(inp["x"]),
                                   (plan["mods"], plan["final"], plan["tidx"]), 4.5, steps=5)
    got = sample_planned(dit, *_t(inp, "x", "ctx", "unc"), 4.5, 5,
                         compute_dtype=torch.float32)
    _cmp(got, want)
    unplanned = jcfm.sample_cfg(lambda x, t, c: jmoe.moe_dit_apply(
        p, jcfg, x, t, c, compute_dtype=jnp.float32), *_j(inp, "x", "ctx", "unc"), 4.5,
        steps=5)
    _cmp(got, unplanned)
    with pytest.raises(ValueError, match="context masks"):
        sample_planned(dit, *_t(inp, "x", "ctx", "unc"), 4.5, 5,
                       context_mask=torch.ones(2, 5, dtype=torch.bool))


def test_video_encoder_and_fusion_match_jax():
    ks = jax.random.split(jax.random.PRNGKey(3), 2)
    pe = _np(jclap.video_feat_encoder_init(ks[0], 512, 32))
    pf = _np(jclap.clap_fusion_init(ks[1]))
    enc, fus = tclap.VideoFeatEncoder(512, 32), tclap.ClapFusion()
    state = params_from_jax({"cond": pe, "clap_fusion": pf}, "video_feat")
    enc.load_state_dict(state["cond"])
    fus.load_state_dict(state["clap_fusion"])
    rng = np.random.RandomState(4)
    feat = rng.randn(2, 6, 512).astype(np.float32)
    text = rng.randn(2, 1024).astype(np.float32)
    with torch.no_grad():
        _cmp(tclap.video_feat_encoder_apply(enc, torch.tensor(feat)),
             jclap.video_feat_encoder_apply(pe, jnp.asarray(feat)))
        _cmp(tclap.clap_fusion_apply(fus, torch.tensor(feat), torch.tensor(text)),
             jclap.clap_fusion_apply(pf, jnp.asarray(feat), jnp.asarray(text)))


def test_sample_cfg_inpaint_matches_jax_and_keeps_the_known_region():
    rng = np.random.RandomState(5)
    x0 = rng.randn(2, 4, 16).astype(np.float32)
    known = rng.randn(2, 4, 16).astype(np.float32)
    ctx, unc = rng.randn(2, 3, 6).astype(np.float32), rng.randn(2, 3, 6).astype(np.float32)
    keep = np.ones((1, 1, 16), np.float32)
    keep[..., 4:12] = 0.0
    w = rng.randn(4, 4).astype(np.float32)

    def jvel(x, t, c):
        return jnp.einsum("oc,bct->bot", w, x) * (1 + t[:, None, None] / 1000) + c.mean((1, 2))[:, None, None]

    def tvel(x, t, c):
        return (torch.einsum("oc,bct->bot", torch.tensor(w), x)
                * (1 + t[:, None, None] / 1000) + c.mean((1, 2))[:, None, None])

    want = jcfm.sample_cfg_inpaint(jvel, jnp.asarray(x0), jnp.asarray(ctx), jnp.asarray(unc),
                                   3.0, jnp.asarray(known), jnp.asarray(keep), steps=6)
    got = tcfm.sample_cfg_inpaint(tvel, torch.tensor(x0), torch.tensor(ctx),
                                  torch.tensor(unc), 3.0, torch.tensor(known),
                                  torch.tensor(keep), steps=6)
    _cmp(got, want)
    end = known + (1.0 - (1.0 - tcfm.SIGMA_MIN)) * x0  # the OT path at t = 1
    np.testing.assert_allclose(got.numpy()[..., :4], end[..., :4], atol=1e-5)
    np.testing.assert_allclose(got.numpy()[..., 12:], end[..., 12:], atol=1e-5)
    assert np.abs(got.numpy()[..., 4:12] - end[..., 4:12]).max() > 1e-2


# -- data -------------------------------------------------------------------------------

def _write_video_data(root, names, seed=0, lengths=(700, 300, 625, 80)):
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "mel_maa2", "npy"))
    os.makedirs(os.path.join(root, "cavp"))
    for i, n in enumerate(names):
        t = lengths[i % len(lengths)]
        np.save(os.path.join(root, "mel_maa2", "npy", n + "_mel.npy"),
                rng.randn(80, t).astype(np.float32))
        if i != 2:  # clip 2 has no features: the empty one stands in
            np.savez(os.path.join(root, "cavp", n + ".npz"),
                     feat=rng.randn(30 + 5 * i, 512).astype(np.float32))
    np.savez(os.path.join(root, "cavp", "empty_vid.npz"),
             feat=np.zeros((40, 512), np.float32))
    for split in ("Train", "Test"):
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root


@pytest.mark.parametrize("cls", ["VideoSpecDataset", "VideoSpecInpaintDataset"])
def test_video_datasets_match_jax(tmp_path, cls):
    root = _write_video_data(str(tmp_path), [f"clip{i}" for i in range(5)])
    kw = dict(split="train", data_dir=root, split_txt_path=root, drop=0.3, seed=4)
    jd, td = getattr(jvd, cls)(**kw), getattr(tvd, cls)(**kw)
    assert len(jd) == len(td) == 5
    items = []
    for _ in range(2):
        for i in range(5):
            a, b = jd[i], td[i]
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            items.append(b)
    jb, tb = jd.collater(items[:4]), td.collater(items[:4])
    for k in jb:
        np.testing.assert_array_equal(jb[k], tb[k])
    assert tb["image"].shape == (4, 80, 512) and tb["video_feat"].shape == (4, 32, 512)


def test_video_config_parses_to_jax_spec():
    j = jconfig.parse_model_config(jconfig.load_config([VIDEO]))
    t = tconfig.parse_model_config(tconfig.load_config([VIDEO]))
    assert dataclasses.asdict(j.dit) == dataclasses.asdict(t.dit)
    assert {k: getattr(j.vae, k) for k in dataclasses.asdict(t.vae)} == \
        dataclasses.asdict(t.vae)
    for f in ("kind", "backbone_kind", "cond_kind", "mel_dim", "mel_length", "scale_factor",
              "timesteps", "scale_by_std", "cond_stage_trainable", "base_learning_rate"):
        assert getattr(j, f) == getattr(t, f), f
    assert (t.kind, t.backbone_kind, t.cond_kind) == ("cfm", "video_moe_dit", "video_feat")
    over = ["model.target=ldm.models.diffusion.cfm1_audio.CFM_inpaint",
            "model.params.cond_stage_config.target="
            "ldm.modules.encoders.modules.Video_Feat_Encoder_NoPosembed_inpaint"]
    j = jconfig.parse_model_config(jconfig.load_config([VIDEO], over))
    t = tconfig.parse_model_config(tconfig.load_config([VIDEO], over))
    assert (t.kind, t.cond_kind) == (j.kind, j.cond_kind) == ("cfm_inpaint", "video_feat_inpaint")


# -- systems ------------------------------------------------------------------------------

def _lightning(tmp_path):
    """A random small video system's Lightning file, written from the port."""
    s = MAA3System.from_config([VIDEO], SMALL, seed=3, device="cpu", unfreeze=True,
                               compute_dtype=torch.float32, voc_cfg=BigVGANConfig(**VOC))
    sd = {"model.diffusion_model." + k: v for k, v in s.dit.state_dict().items()}
    sd.update({"first_stage_model." + k: v for k, v in s.vae.state_dict().items()})
    sd.update({"cond_stage_model." + k: v for k, v in s.cond.state_dict().items()})
    sd["scale_factor"] = torch.tensor(0.6)
    path = str(tmp_path / "video.ckpt")
    torch.save({"state_dict": sd}, path)
    return path, s


def test_moe_lightning_file_loads_in_both_packages(tmp_path):
    path, src = _lightning(tmp_path)
    ts = MAA3System.from_config([VIDEO], SMALL, device="cpu", ckpt_path=path,
                                compute_dtype=torch.float32, voc_cfg=BigVGANConfig(**VOC))
    for a, b in zip(ts.dit.state_dict().values(), src.dit.state_dict().values()):
        assert torch.equal(a, b)
    assert ts.scale_factor == pytest.approx(0.6)
    js = JSystem.from_config([VIDEO], SMALL, ckpt_path=path, compute_dtype=jnp.float32)
    rng = np.random.RandomState(6)
    feat = rng.randn(2, 8, 512).astype(np.float32)
    x0 = rng.randn(2, 20, 12).astype(np.float32)
    c_j, uc_j = js.get_learned_conditioning(feat), js.get_learned_conditioning(0 * feat)
    c_t, uc_t = ts.get_learned_conditioning(feat), ts.get_learned_conditioning(0 * feat)
    _cmp(c_t, c_j)
    z_j = js.sample_cfg(c_j, 4.5, uc_j, None, timesteps=4, x0=jnp.asarray(x0))
    z_t = ts.sample_cfg(c_t, 4.5, uc_t, timesteps=4, x0=torch.tensor(x0))
    _cmp(z_t, z_j)
    assert float(np.abs(np.asarray(z_j) - x0).max()) > 1e-2
    # int8 on the MoE quantizes attention only, in both packages
    js.set_serving_quant("int8")
    ts.set_serving_quant("int8")
    jq = _np(js.serving_dit()["blocks"])
    assert "w_q" in jq["attention"]["wqkv"] and "w_q" not in str(jq["feed_forward"].keys())
    from maa3_tpu_torch.ops.quant import quant_weights
    q = quant_weights(ts.serving_dit())
    assert sorted(q) == ["blocks.0.attention.wqkv", "blocks.1.attention.wqkv"]
    for i in range(2):
        np.testing.assert_array_equal(q[f"blocks.{i}.attention.wqkv"].w_q.numpy(),
                                      jq["attention"]["wqkv"]["w_q"][i].T)
    z_j = js.sample_cfg(c_j, 4.5, uc_j, None, timesteps=4, x0=jnp.asarray(x0))
    z_t = ts.sample_cfg(c_t, 4.5, uc_t, timesteps=4, x0=torch.tensor(x0))
    z_j = np.asarray(z_j)
    assert np.linalg.norm(z_t.numpy() - z_j) / np.linalg.norm(z_j) <= 1e-3
    with pytest.raises(NotImplementedError, match="text DiT"):
        ts.calibrate_smooth(c_t, uc_t, x0=torch.tensor(x0))


def test_video_trainer_step_matches_jax(tmp_path):
    """One step of the port's Trainer (video features through the trainable
    encoder, moe_dit_apply(training=True)) against JAX's train step as JAX's
    Trainer builds it for the video model, with JAX's draws replayed."""
    over = SMALL + ["model.params.scale_by_std=false", "model.params.scale_factor=0.7",
                    "model.base_learning_rate=1.0e-3"]
    ts = MAA3System.from_config([VIDEO], over, seed=2, device="cpu", unfreeze=True,
                                compute_dtype=torch.float32, voc_cfg=BigVGANConfig(**VOC))
    spec = jconfig.parse_model_config(jconfig.load_config([VIDEO], over))
    # copies: jnp.asarray of a numpy view of a torch parameter aliases it,
    # and the port's step updates its parameters in place
    pd = jimport.dit_from_torch({k: v.numpy().copy() for k, v in ts.dit.state_dict().items()},
                                depth=2, moe=True, num_experts=4)
    pv = jimport.vae_from_torch({k: v.numpy().copy() for k, v in ts.vae.state_dict().items()},
                                spec.vae)
    pc = {"embedder": {"w": jnp.asarray(ts.cond.embedder[0].weight.detach().numpy().T.copy()),
                       "b": jnp.asarray(ts.cond.embedder[0].bias.detach().numpy().copy())}}
    jopt = joptim.make_optimizer(base_lr=1e-3, lr_multiplier=1.0, warm_up_steps=0)
    jst = jstep.create_train_state({"dit": pd, "cond": pc}, {"vae": pv}, jopt,
                                   scale_factor=0.7)
    jtrain = jax.jit(jstep.make_train_step(
        spec.dit, spec.vae, jopt, compute_dtype=jnp.float32,
        conditioner=lambda prm, b: jclap.video_feat_encoder_apply(prm["cond"], b["video_feat"]),
        apply_fn=lambda prm, x, t, c: jmoe.moe_dit_apply(prm, spec.dit, x, t, c,
                                                         compute_dtype=jnp.float32,
                                                         training=True)))
    tr = Trainer(ts, batch_size=2, lr_multiplier=1.0, warm_up_steps=0, log_every=1,
                 ckpt_dir=str(tmp_path), ckpt_every=0)
    rng = np.random.RandomState(7)
    raw = {"image": rng.randn(2, 80, 24).astype(np.float32),
           "video_feat": rng.randn(2, 6, 512).astype(np.float32)}
    key = jax.random.PRNGKey(9)
    kvae, kcfm = jax.random.split(key)
    kt, kn = jax.random.split(kcfm)
    draws = {"noise": torch.tensor(np.asarray(jax.random.normal(kvae, (2, 20, 12)))),
             "t_int": torch.tensor(np.asarray(jax.random.randint(kt, (2,), 0, 1000))),
             "x0": torch.tensor(np.asarray(jax.random.normal(kn, (2, 20, 12))))}
    jst, jm = jtrain(jst, {"mel": jnp.asarray(raw["image"]),
                           "video_feat": jnp.asarray(raw["video_feat"])}, key)
    start = [p.detach().clone() for p in tr.state.trainable_parameters()]
    tm = tr.train_step(raw, draws=draws)
    _cmp(tm["loss"], jm["loss"])
    _cmp(tm["grad_norm"], jm["grad_norm"])

    def jloss(prm):
        m = jvae.vae_encode_moments(pv, spec.vae, jnp.asarray(raw["image"]))
        z = jvae.gaussian_sample(m, kvae) * 0.7
        ctx = jclap.video_feat_encoder_apply(prm["cond"], jnp.asarray(raw["video_feat"]))
        return jcfm.cfm_loss(lambda x, t, c: jmoe.moe_dit_apply(
            prm["dit"], spec.dit, x, t, c, compute_dtype=jnp.float32, training=True),
            z, ctx, kcfm)[0]

    jg = jax.grad(jloss)({"dit": pd, "cond": pc})
    clip = min(1.0, 1.0 / float(jm["grad_norm"]))
    want = dit_from_jax(_np(jst.params["dit"]))
    grads = dit_from_jax(_np(jg["dit"]))
    n_free = n_all = 0
    for n, p in tr.state.dit.named_parameters():
        g, gj = p.grad.numpy(), grads[n].numpy() * clip
        np.testing.assert_allclose(g, gj, rtol=1e-3, atol=1e-4 * float(np.abs(gj).max()) + 1e-9)
        # phase 7's rule: an element whose gradient is at rounding noise (the
        # two differ by over a quarter) has a noise direction in Adam's first
        # step and may differ by 2 lr; every other one at TOL
        free = np.abs(g - gj) > 0.25 * np.abs(gj)
        n_free, n_all = n_free + free.sum(), n_all + free.size
        w = want[n].numpy()
        tol = TOL["atol"] + TOL["rtol"] * np.abs(w) + free * 2 * 1e-3
        assert (np.abs(p.detach().numpy() - w) <= tol).all(), n
    assert n_free <= 1e-2 * n_all
    _cmp(tr.state.cond.embedder[0].weight, np.asarray(jst.params["cond"]["embedder"]["w"]).T)
    # validation's step (Trainer.evaluate without its TensorBoard log line)
    val = tr._eval_step(tr.state, tr.prepare_batch(raw), draws=draws)
    assert np.isfinite(float(val)) and abs(float(val) - float(tm["loss"])) > 0
    assert max((p.detach() - s).abs().max().item()
               for p, s in zip(tr.state.trainable_parameters(), start)) > 1e-4
    with pytest.raises(ValueError, match="n_expert=2: .* no process group"):
        Trainer(ts, n_expert=2, ckpt_dir=str(tmp_path))


# -- the video2audio CLI ---------------------------------------------------------------------

SMALL_YAML = """model:
  params:
    unet_config:
      params:
        hidden_size: 64
        depth: 2
        num_heads: 4
        context_dim: 32
        multiple_of: 32
    first_stage_config:
      params:
        ddconfig:
          ch: 32
          ch_mult: [1, 2]
          num_res_blocks: 1
"""


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("v2a")
    (d / "small.yaml").write_text(SMALL_YAML)
    (d / "voc").mkdir()
    (d / "voc" / "config.json").write_text(
        '{"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4], '
        '"upsample_initial_channel": 64, "resblock_kernel_sizes": [3, 7, 11], '
        '"resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]]}')
    (d / "feats").mkdir()
    (d / "mels").mkdir()
    rng = np.random.RandomState(8)
    for name, frames in (("a", 10), ("b", 3)):
        np.savez(d / "feats" / f"{name}.npz", feat=rng.randn(frames, 512).astype(np.float32))
        np.save(d / "mels" / f"{name}_mel.npy", rng.randn(80, 150).astype(np.float32))
    np.savez(d / "feats" / "empty_vid.npz", feat=np.zeros((4, 512), np.float32))
    return d


def _argv(d, out, *extra):
    return ["--feat_dir", str(d / "feats"), "--outdir", str(out), "-b",
            f"{VIDEO},{d / 'small.yaml'}", "--vocoder-ckpt", str(d / "voc"),
            "--duration", "1.0", "--ddim_steps", "3", "--device", "cpu", "--fp32", *extra]


@pytest.mark.parametrize("extra", [(), ("--inpaint", "--mask_ratio", "0.5"),
                                   ("--renorm",), ("--clap_text", "a dog barks")])
def test_video2audio_cli_writes_wavs(cli_files, tmp_path, extra, capsys):
    d = cli_files
    gt = ("--mel_gt_dir", str(d / "mels")) if extra[:1] in (("--inpaint",), ("--renorm",)) else ()
    video2audio.main(_argv(d, tmp_path, *extra, *gt))
    assert sorted(os.listdir(tmp_path)) == ["a.wav", "b.wav"]
    # 1 s windows of 4 frames: a has 3, b 1; each decodes to 62 mel frames x 4
    for name, n_win in (("a", 3), ("b", 1)):
        with wave.open(str(tmp_path / f"{name}.wav")) as w:
            assert (w.getframerate(), w.getsampwidth(), w.getnframes()) == (16000, 2, n_win * 62 * 4)
    if "--clap_text" in extra:
        assert "clap fusion" in capsys.readouterr().out


def test_video2audio_window_latents_match_jax(cli_files):
    """One window through the CLI's WindowSampler, plain and --inpaint, against
    JAX's sample_cfg / sample_cfg_inpaint on the same weights (JAX's
    importers read the port's state dicts) and the same draws."""
    d = cli_files
    opt = video2audio.parse_args(_argv(d, d / "out", "--inpaint", "--mel_gt_dir",
                                       str(d / "mels")))
    ts = MAA3System.from_config(opt.base.split(","), seed=0, device="cpu",
                                compute_dtype=torch.float32,
                                vocoder_dir=opt.vocoder_ckpt)
    sampler = video2audio.WindowSampler(ts, opt)
    spec = jconfig.parse_model_config(jconfig.load_config(opt.base.split(",")))
    sd = {k: v.numpy() for k, v in ts.dit.state_dict().items()}
    pd = jimport.dit_from_torch(sd, depth=2, moe=True, num_experts=4)
    pc = {"embedder": {"w": jnp.asarray(ts.cond.embedder[0].weight.numpy().T),
                       "b": jnp.asarray(ts.cond.embedder[0].bias.numpy())}}
    js = JSystem(spec, {"dit": pd, "cond": pc, "vae": {}, "vocoder": {}},
                 compute_dtype=jnp.float32, scale_factor=ts.scale_factor)
    feat = np.load(d / "feats" / "a.npz")["feat"]
    gt = np.load(d / "mels" / "a_mel.npy")
    seg = next(video2audio.windows(feat, sampler.truncate_frame))
    c = js.get_learned_conditioning(jnp.asarray(seg[None]))
    uc = js.get_learned_conditioning(jnp.zeros((1, 4, 512)))
    _cmp(sampler.conditioning(seg), c)
    # the draws the sampler makes: the GT latent's posterior sample, then x0
    gen = torch.Generator().manual_seed(opt.seed)
    known = ts.encode_first_stage(torch.tensor(gt[None, :, :62]), gen)
    x0 = torch.randn((1, 20, 31), generator=gen)
    keep = video2audio.keep_mask(31, 0.5)
    got = sampler.latent(seg, 0, gt)
    want = jcfm.sample_cfg_inpaint(js._velocity_fn(pd), jnp.asarray(x0.numpy()), c, uc, 4.5,
                                   jnp.asarray(known.numpy()), jnp.asarray(keep), steps=3)
    _cmp(got, want)
    end = known + tcfm.SIGMA_MIN * x0
    kept = torch.tensor(keep).bool().expand_as(got)
    np.testing.assert_allclose(got[kept].numpy(), end[kept].numpy(), atol=1e-5)
    # plain: the next window's noise is the generator's next draw
    sampler.opt.inpaint = False
    x0 = torch.randn((1, 20, 31), generator=gen)
    got = sampler.latent(seg, 0, gt)
    want = js.sample_cfg(c, 4.5, uc, None, timesteps=3, x0=jnp.asarray(x0.numpy()))
    _cmp(got, want)


def test_clap_text_embedding_seed_is_stable():
    """The port seeds the text stand-in with crc32 (JAX's CLI uses hash(),
    which PYTHONHASHSEED changes between processes)."""
    e = video2audio.text_embedding("a dog barks")
    assert e.shape == (1, 1024) and e.dtype == np.float32
    seed = zlib.crc32(b"a dog barks") % (2 ** 31)
    np.testing.assert_array_equal(e, np.random.RandomState(seed).randn(1, 1024)
                                  .astype(np.float32))
    assert not np.array_equal(e, video2audio.text_embedding("a cat meows"))
