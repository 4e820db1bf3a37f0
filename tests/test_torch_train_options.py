"""The port's trainer options against the JAX package on the CPU, fp32 at
rtol 1e-3 / atol 1e-4 unless a test states another tolerance: the five remat
policies (loss and gradients against the port without remat and against JAX
with the same policy; what each policy saves, read from the backward's
matmuls and the saved bytes), the optimizer's bf16 first moment and
adafactor against optax, gradient accumulation in a Trainer against JAX's
Trainer under optax.MultiSteps (with a checkpoint taken mid-accumulation),
fused-GEMM training, cached latents (encode_latents against JAX's encode,
training from moments against training from the mel), the audio logger
against sample_cfg, and the training CLI with every new flag."""

import dataclasses
import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from maa3_tpu.config import ModelSpec as JSpec
from maa3_tpu.models import dit as jdit
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.system import MAA3System as JSystem
from maa3_tpu.train import optim as joptim
from maa3_tpu.train.loop import Trainer as JTrainer
from maa3_tpu.utils.nprand import unfreeze_zero_init
from maa3_tpu_torch import config as tconfig
from maa3_tpu_torch.models import dit as tdit
from maa3_tpu_torch.models import vae1d as tvae
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from maa3_tpu_torch.system import MAA3System
from maa3_tpu_torch.train import optim as toptim
from maa3_tpu_torch.train.audio_logger import AudioLogger
from maa3_tpu_torch.train.loop import Trainer
from maa3_tpu_torch.weights import dit_from_jax, vae_from_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
MUSIC = os.path.join(ROOT, "configs", "txt2music-cfm-cfg.yaml")
TOL = dict(rtol=1e-3, atol=1e-4)
POLICIES = ("nothing", "dots_no_batch", "save_gemms", "save_gemms_lite", "save_gemms_h1")
VAE = dict(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(), z_channels=4, embed_dim=4)
DIT = dict(in_channels=4, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32)
UP = "model.params.unet_config.params."
DD = "model.params.first_stage_config.params.ddconfig."
SMALL = [UP + "hidden_size=32", UP + "depth=2", UP + "num_heads=2", UP + "context_dim=16",
         UP + "multiple_of=16", DD + "ch=32", DD + "ch_mult=[1, 2]",
         DD + "num_res_blocks=1", DD + "attn_layers=[]"]
# the YAML cut to the DIT / VAE sizes above
AS_DIT_VAE = SMALL + [UP + "hidden_size=64", UP + "num_heads=4", UP + "context_dim=32",
                      UP + "multiple_of=32", UP + "in_channels=4", DD + "in_channels=16",
                      DD + "out_ch=16", DD + "z_channels=4",
                      "model.params.first_stage_config.params.embed_dim=4"]
SMALL_VOC = BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                          upsample_initial_channel=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cmp(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _cfm_draws(key, b, shape):
    """The draws maa3_tpu/diffusion/cfm.py cfm_loss makes from `key`."""
    kt, kn = jax.random.split(key)
    return (np.asarray(jax.random.randint(kt, (b,), 0, 1000)),
            np.asarray(jax.random.normal(kn, shape, jnp.float32)))


def _step_draws(key, zshape):
    """The draws of one JAX train step from `key` (maa3_tpu/train/step.py:
    the posterior noise from the first half, the CFM draws from the second)."""
    kvae, kcfm = jax.random.split(key)
    t_int, x0 = _cfm_draws(kcfm, zshape[0], zshape)
    return {"noise": torch.tensor(np.asarray(jax.random.normal(kvae, zshape, jnp.float32))),
            "t_int": torch.tensor(t_int), "x0": torch.tensor(x0)}


# -- remat policies ---------------------------------------------------------

class _MatmulCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm"):
            self.n["bmm" if name == "bmm" else "mm"] += 1
        return func(*args, **(kwargs or {}))


def _jax_dit(use_flash):
    jcfg = jdit.DiTConfig(**DIT, use_flash=use_flash)
    return jcfg, unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(0), jcfg),
                                    jax.random.PRNGKey(1))


def _inputs():
    rng = np.random.RandomState(3)
    return (rng.randn(2, 4, 24).astype(np.float32), rng.randn(2, 5, 32).astype(np.float32),
            np.array([17, 640]), rng.randn(2, 4, 24).astype(np.float32))


def _port_loss_and_grads(dit, policy, fused=False, capture=None):
    """(loss, {canonical name: grad}, backward matmul counts) of the port's
    DiT with remat under `policy` (None: no remat)."""
    x, ctx, t, tgt = _inputs()
    d = tdit.fuse_dit_gemms(dit) if fused else dit
    d.cfg = dataclasses.replace(dit.cfg, remat=policy is not None,
                                remat_policy=policy or "nothing")
    d.requires_grad_(True).zero_grad()
    out = tdit.dit_apply(d, torch.tensor(x), torch.tensor(t), torch.tensor(ctx),
                         compute_dtype=torch.float32, training=True)
    loss = (out - torch.tensor(tgt)).pow(2).mean()
    if capture is not None:
        capture.append(sum(_saved_bytes(mode) for mode in _SAC_MODES))
        _SAC_MODES.clear()
    count = _MatmulCount()
    with count:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in d.named_parameters()}
    return loss.detach(), tdit.unfuse_dit_gemms(grads, dit.cfg.num_heads), count.n


_SAC_MODES = []


def _saved_bytes(mode) -> int:
    """The bytes of the op outputs a selective-checkpoint forward cached."""
    vals = [getattr(w, "val", None) for outs in mode.storage.values()
            for out in outs.values() for w in tree_leaves(out)]
    return sum(v.nbytes for v in vals if isinstance(v, torch.Tensor))


def _recording_contexts(policy_fn, **kw):
    """create_selective_checkpoint_contexts, keeping the forward's caching
    mode so that a test can read what the policy saved."""
    fwd, rec = torch.utils.checkpoint.create_selective_checkpoint_contexts(policy_fn, **kw)
    _SAC_MODES.append(fwd)
    return fwd, rec


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_matches_no_remat_and_jax(policy):
    """Each policy gives the port's no-remat loss and gradients (rtol 1e-5 /
    atol 1e-6, as tests/test_train.py::test_remat_matches_plain_gradients)
    and JAX's with the same policy, flash attention on (the plain version of
    the kernels on the CPU)."""
    jcfg, pj = _jax_dit(True)
    dit = tdit.DiT(tdit.DiTConfig(**DIT, use_flash=True))
    dit.load_state_dict(dit_from_jax(_np(pj)))
    l0, g0, _ = _port_loss_and_grads(dit, None)
    l1, g1, _ = _port_loss_and_grads(dit, policy)
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=1e-6)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-5, atol=1e-6)
    x, ctx, t, tgt = _inputs()
    jcfg = dataclasses.replace(jcfg, remat=True, remat_policy=policy)

    def jloss(p):
        out = jdit.dit_apply(p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                             compute_dtype=jnp.float32, training=True)
        return jnp.mean((out - tgt) ** 2)

    lj, gj = jax.jit(jax.value_and_grad(jloss))(pj)
    _cmp(l1, lj)
    gj = dit_from_jax(_np(gj))
    for n in g1:
        _cmp(g1[n], gj[n].numpy())


@pytest.mark.parametrize("fused", [False, True])
def test_remat_policies_save_what_they_name(monkeypatch, fused):
    """What each policy keeps, read from the backward: the matmuls it runs
    (each recomputed projection is one more) are strictly ordered nothing >
    save_gemms_lite > save_gemms_h1 > save_gemms (unfused; fused, h1 keeps
    the w13 matmul only with both halves, so it recomputes it as lite
    does), dots_no_batch recomputes no 2-D matmul but every batched one;
    the bytes the policy saved are ordered the other way."""
    monkeypatch.setattr(tdit, "create_selective_checkpoint_contexts", _recording_contexts)
    jcfg, pj = _jax_dit(False)
    dit = tdit.DiT(tdit.DiTConfig(**DIT, use_flash=False))
    dit.load_state_dict(dit_from_jax(_np(pj)))
    counts, saved = {}, {}
    for policy in (None,) + POLICIES:
        cap = [] if policy else None
        _, _, counts[policy] = _port_loss_and_grads(dit, policy, fused, capture=cap)
        saved[policy] = cap[0] if cap else None
    mm = {k: v["mm"] for k, v in counts.items()}
    depth = DIT["depth"]
    # per block: q, k, v, o, w1, w3, w2 (7 unfused, 4 fused), the adaLN and the
    # context's k and v
    per_block = (4 if fused else 7) + 3
    assert mm["nothing"] - mm[None] == depth * per_block
    assert mm["dots_no_batch"] == mm[None]
    assert counts["dots_no_batch"]["bmm"] == counts["nothing"]["bmm"] > counts[None]["bmm"]
    assert mm["save_gemms"] - mm[None] == depth * 3
    assert mm["save_gemms_lite"] - mm[None] == depth * (4 if fused else 5)
    assert mm["save_gemms_h1"] - mm[None] == depth * 4
    if fused:
        assert mm["nothing"] > mm["save_gemms_lite"] == mm["save_gemms_h1"] > mm["save_gemms"]
        assert saved["nothing"] == 0 < saved["save_gemms_lite"] == saved["save_gemms_h1"] < saved["save_gemms"]
    else:
        assert mm["nothing"] > mm["save_gemms_lite"] > mm["save_gemms_h1"] > mm["save_gemms"]
        assert saved["nothing"] == 0 < saved["save_gemms_lite"] < saved["save_gemms_h1"] \
            < saved["save_gemms"] < saved["dots_no_batch"]


# -- optimizer ----------------------------------------------------------------

SHAPES = [(5, 3), (7,), (130, 129), (128, 40), (40, 200), (2, 130, 140)]


@pytest.mark.parametrize("kind", ["bf16_mu", "factored", "factored_bf16_mu"])
def test_optimizer_options_match_optax(kind):
    """AdamW with a bf16 first moment, and adafactor (with an fp32 and a bf16
    momentum), against optax over 3 updates, on shapes below and above 128
    in both dims (factored only where the two largest reach 128). Parameters
    at 1e-3 / 1e-4; the stored moment in its dtype and within one bf16 step
    (2^-7 relative, and of the tensor's largest moment) of optax's: both
    round fp32 values that may differ in their last bits, and a rounding
    that goes the other way carries into the next update's moment."""
    factored = kind.startswith("factored")
    mu_dtype = kind.endswith("bf16_mu")
    rng = np.random.RandomState(2)
    p0 = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[(0.2 * rng.randn(*s)).astype(np.float32) for s in SHAPES] for _ in range(3)]
    kw = dict(base_lr=1e-2, lr_multiplier=1.0, warm_up_steps=2)
    opt = joptim.make_optimizer(**kw, mu_dtype=jnp.bfloat16 if mu_dtype else None,
                                factored=factored)
    update = jax.jit(opt.update)
    jp = [jnp.asarray(a) for a in p0]
    st = opt.init(jp)
    tp = [torch.nn.Parameter(torch.tensor(a)) for a in p0]
    topt = toptim.make_optimizer(tp, **kw, mu_dtype=torch.bfloat16 if mu_dtype
                                 else torch.float32, factored=factored)
    for g in grads:
        upd, st = update([jnp.asarray(a) for a in g], st, jp)
        jp = optax.apply_updates(jp, upd)
        for t, a in zip(tp, g):
            t.grad = torch.tensor(a)
        topt.step()
        for a, b in zip(tp, jp):
            _cmp(a, b)
    mu_j = next(x.ema if factored else x.mu for x in st[1]
                if hasattr(x, "ema" if factored else "mu"))
    for m, mj in zip(topt.mu, mu_j):
        assert m.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        assert str(mj.dtype) == ("bfloat16" if mu_dtype else "float32")
        mj = np.asarray(mj, np.float32)
        _cmp(m, mj, rtol=2 ** -7, atol=2 ** -7 * np.abs(mj).max())
    if factored:  # the second moment is factored exactly where optax factors it
        for shape, vr, vj in zip(SHAPES, topt.v_row, st[1][0].v_row):
            assert tuple(vr.shape) == tuple(vj.shape), shape
            _cmp(vr, vj)
        assert [d is not None for d in topt.dims] == [False, False, True, False, False, True]
    assert np.abs(np.asarray(jp[2]) - p0[2]).max() > 1e-3  # the updates moved it
    assert topt.count == 3 and topt.last_lr == pytest.approx(1e-2)


# -- accumulation in a Trainer against JAX's ------------------------------------

def _systems(tmp_path):
    """A tiny JAX system and the port's with the same DiT and VAE weights; the
    conditioner frozen, the batches carry their context."""
    dcfg = jdit.DiTConfig(**DIT, max_len=128)
    vcfg = jvae.VAEConfig(**VAE)
    key = jax.random.PRNGKey(0)
    pd = unfreeze_zero_init(jdit.dit_init(key, dcfg), jax.random.PRNGKey(1))
    pv = jvae.vae_init(jax.random.PRNGKey(2), vcfg)
    jspec = JSpec(kind="cfm", backbone_kind="text_dit", dit=dcfg, vae=vcfg,
                  cond_kind="clap_flan", cond_params_cfg={}, mel_dim=4, mel_length=20,
                  scale_by_std=False, scale_factor=0.7, cond_stage_trainable=False,
                  base_learning_rate=1e-4)
    js = JSystem(jspec, {"dit": pd, "vae": pv}, scale_factor=0.7, compute_dtype=jnp.float32)
    tspec = tconfig.ModelSpec(dit=tdit.DiTConfig(**DIT), vae=tvae.VAEConfig(**VAE),
                              mel_dim=4, mel_length=20, scale_factor=0.7,
                              base_learning_rate=1e-4)
    dit, vae = tdit.DiT(tspec.dit), tvae.AutoencoderKL(tspec.vae)
    dit.load_state_dict(dit_from_jax(_np(pd)))
    vae.load_state_dict(vae_from_jax(_np(pv)))
    ts = MAA3System(tspec, dit, vae, BigVGAN(SMALL_VOC), None, 0.7,
                    compute_dtype=torch.float32)
    return js, ts


def _raws(n, b=8):
    rng = np.random.RandomState(7)
    return [{"image": rng.randn(b, 16, 40).astype(np.float32),
             "context": rng.randn(b, 6, 32).astype(np.float32)} for _ in range(n)]


def test_accumulation_matches_jax_trainer(tmp_path):
    """accum_steps=2, bf16 first moment, EMA: the port's Trainer against JAX's
    (optax.MultiSteps) over 4 micro-steps with JAX's draws replayed:
    parameters unchanged after micro-steps 1 and 3, and after each
    micro-step the parameters and EMA shadows equal JAX's, the stored first
    moment bf16, and the LR of each update JAX's schedule at the update
    count (warm-up over 2 updates). A checkpoint taken after micro-step 1
    and restored into a fresh Trainer gives the uninterrupted run's
    micro-steps 2-4 exactly."""
    js, ts = _systems(tmp_path)
    kw = dict(batch_size=8, use_ema=True, ema_decay=0.99, warm_up_steps=2,
              accum_steps=2, log_every=100, ckpt_every=0)
    jt = JTrainer(js, ckpt_dir=str(tmp_path / "j"), mu_dtype=jnp.bfloat16, **kw)
    tt = Trainer(ts, ckpt_dir=str(tmp_path / "t"), mu_dtype=torch.bfloat16, **kw)
    sched = joptim.lambda_linear_schedule(1e-4 * 2 * 8, 2)
    raws = _raws(4)
    draws = [_step_draws(jax.random.split(jax.random.PRNGKey(100 + i))[1], (8, 4, 20))
             for i in range(4)]
    names = [n for n, _ in ts.dit.named_parameters()]
    prev = [p.detach().clone() for p in ts.dit.parameters()]
    for i, (raw, dr) in enumerate(zip(raws, draws)):
        jm = jt.fit(iter([raw]), max_steps=1, seed=100 + i)
        tm = tt.train_step(raw, draws=dr)
        _cmp(tm["loss"], jm["loss"])
        _cmp(tm["grad_norm"], jm["grad_norm"])  # the micro-batch's
        want = dit_from_jax(_np(jt.state.params["dit"]))
        for n, p in ts.dit.named_parameters():
            _cmp(p, want[n])
        jema = dit_from_jax(_np(jt.state.ema_params["dit"]))
        for n, e in zip(names, tt.state.ema):
            _cmp(e, jema[n])
        moved = max((p.detach() - q).abs().max().item()
                    for p, q in zip(ts.dit.parameters(), prev))
        assert (moved > 0) == (i % 2 == 1), (i, moved)
        prev = [p.detach().clone() for p in ts.dit.parameters()]
        opt = tt.state.optimizer
        assert opt.count == (i + 1) // 2 == int(jt.state.opt_state.gradient_step)
        if i % 2:
            assert opt.last_lr == pytest.approx(float(sched(opt.count - 1)), rel=1e-6)
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)
        if i == 0:
            ckpt = tt.save_checkpoint()
    assert tt.state.step == 4
    after = [p.detach().clone() for p in ts.dit.parameters()]

    _, ts2 = _systems(tmp_path)
    t2 = Trainer(ts2, ckpt_dir=str(tmp_path / "t2"), mu_dtype=torch.bfloat16, **kw)
    t2.restore_checkpoint(ckpt)
    assert t2.state.optimizer.mini_step == 1 and t2.state.step == 1
    for raw, dr in zip(raws[1:], draws[1:]):
        t2.train_step(raw, draws=dr)
    for a, b in zip(after, ts2.dit.parameters()):
        assert torch.equal(a, b.detach())
    for a, b in zip(tt.state.ema, t2.state.ema):
        assert torch.equal(a, b)
    f32 = Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "f"), **kw)
    with pytest.raises(ValueError, match="optimizer state"):
        f32.restore_checkpoint(ckpt)  # fp32 moments cannot take a bf16 file


def test_factored_trainer_checkpoint(tmp_path):
    """A factored (adafactor) Trainer's checkpoint carries its factors: a
    fresh factored Trainer restored from it takes the next step exactly as
    the uninterrupted one; an AdamW Trainer refuses the file."""
    raws = _raws(2)
    kw = dict(batch_size=8, warm_up_steps=0, log_every=100, ckpt_every=0)
    a = Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "a"), factored=True, **kw)
    a.train_step(raws[0])
    path = a.save_checkpoint()
    a.train_step(raws[1])
    b = Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "b"), factored=True, **kw)
    b.restore_checkpoint(path)
    b.train_step(raws[1])
    for x, y in zip(a.state.trainable_parameters(), b.state.trainable_parameters()):
        assert torch.equal(x, y)
    adamw = Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "c"), **kw)
    with pytest.raises(ValueError, match="adafactor"):
        adamw.restore_checkpoint(path)


# -- fused GEMMs ------------------------------------------------------------------

def test_fused_trainer_equals_unfused(tmp_path):
    """fuse_gemms: two steps (EMA on) equal the unfused trainer's (the same
    elements, the same per-element AdamW, the clip over the same values; the
    fused GEMMs sum in another order, and AdamW's normalised update of a
    near-zero gradient shows that in the fifth digit); the fused .pt holds the canonical names, loads in from_config
    and into a fused trainer (resuming exactly), and an unfused trainer
    refuses it; sync_system_params hands the system canonical weights."""
    raws = _raws(3)
    kw = dict(batch_size=8, warm_up_steps=0, use_ema=True, log_every=100, ckpt_every=0)
    _, su = _systems(tmp_path)
    _, sf = _systems(tmp_path)
    u = Trainer(su, ckpt_dir=str(tmp_path / "u"), **kw)
    f = Trainer(sf, ckpt_dir=str(tmp_path / "f"), fuse_gemms=True, **kw)
    assert f.state.dit is not sf.dit and f.state.dit.blocks[0].attention.wqkv is not None
    for raw in raws[:2]:
        mu, mf = u.train_step(raw, draws=None), f.train_step(raw, draws=None)
        _cmp(mf["loss"], mu["loss"].numpy())
    canon = tdit.unfuse_dit_gemms(dict(f.state.dit.named_parameters()), DIT["num_heads"])
    for n, p in su.dit.named_parameters():
        _cmp(canon[n], p.detach().numpy())
    f.sync_system_params()
    for n, p in sf.dit.named_parameters():
        assert torch.equal(p, canon[n])
    path = f.save_checkpoint()
    saved = torch.load(path, weights_only=True)
    assert set(saved["params"]["dit"]) == set(su.dit.state_dict())
    loaded = MAA3System.from_config([XL], AS_DIT_VAE, device="cpu", ckpt_path=path,
                                    init_cond=False, voc_cfg=SMALL_VOC)
    ema = dict(zip([n for n, _ in su.dit.named_parameters()], saved["ema_params"]))
    for n, p in loaded.dit.named_parameters():
        assert torch.equal(p, ema[n])  # the file's EMA shadows, canonical names
    f.train_step(raws[2])
    f2 = Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "f2"), fuse_gemms=True, **kw)
    f2.restore_checkpoint(path)
    f2.train_step(raws[2])
    for a, b in zip(f.state.trainable_parameters(), f2.state.trainable_parameters()):
        assert torch.equal(a, b)
    for a, b in zip(f.state.ema, f2.state.ema):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fuse_gemms"):
        Trainer(_systems(tmp_path)[1], ckpt_dir=str(tmp_path / "u2"), **kw).restore_checkpoint(path)


# -- cached latents ----------------------------------------------------------------

def _mel_manifest(tmp_path, n=5, t=40, rows=16):
    rng = np.random.RandomState(5)
    d = tmp_path / "mels"
    d.mkdir()
    lines = ["name\tmel_path\tori_cap\tcaption"]
    for i in range(n):
        p = d / f"clip{i}.npy"
        np.save(p, rng.randn(rows, t - 4 * (i == 4)).astype(np.float32))
        lines.append(f"clip{i}\t{p}\tsound {i}\t<sound {i}& all>")
    tsv = tmp_path / "m.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    return str(tsv)


def test_cached_latents_match_jax_and_the_mel_path(tmp_path):
    """encode_latents' moments equal JAX's vae_encode_moments of the same
    tiled mels (batch 2: the ragged tail padded; the short clip's moments cut
    to its length); the CLI writes the same files from a system of the same
    seed; training from the cached moments equals training from the mel with
    the same draws; MAA3System.encode_first_stage equals JAX's (the scaled
    posterior mean), and with a generator draws a sample of that shape."""
    from maa3_tpu_torch import encode_latents
    from maa3_tpu_torch.data.datasets import TextSpecDataset, read_tsv

    js, ts = _systems(tmp_path)
    tsv = _mel_manifest(tmp_path)
    out_tsv = encode_latents.encode_manifest(ts, tsv, str(tmp_path / "lat"), batch=2,
                                             crop_len=40)
    rows = read_tsv(out_tsv)
    assert [r["name"] for r in rows] == [f"clip{i}" for i in range(5)]
    enc = jax.jit(lambda p, x: jvae.vae_encode_moments(p, jvae.VAEConfig(**VAE), x))
    for r in rows:
        mel = np.load(r["mel_path"])
        tiled = np.tile(mel, 2)[:, :40]
        want = np.asarray(enc(js.params["vae"], jnp.asarray(tiled[None])))[0]
        got = np.load(r["moments_path"])
        assert got.shape == (8, mel.shape[1] // 2)
        _cmp(got, want[:, : got.shape[1]])
    mels = np.stack([np.load(r["mel_path"]) for r in rows[:2]])
    z = ts.encode_first_stage(torch.tensor(mels))
    _cmp(z, js.encode_first_stage(jnp.asarray(mels)))
    assert ts.encode_first_stage(torch.tensor(mels), torch.Generator().manual_seed(0)
                                 ).shape == z.shape == (2, 4, 20)

    # the CLI on a system built from the config and a seed
    os.rename(out_tsv, out_tsv + ".first")
    cli_tsv = encode_latents.main(["--tsv_path", tsv, "--save_path", str(tmp_path / "lat2"),
                                   "-b", XL, "--batch", "4", "--crop_len", "40",
                                   "--device", "cpu", *AS_DIT_VAE],
                                  voc_cfg=SMALL_VOC)
    s0 = MAA3System.from_config([XL], AS_DIT_VAE, device="cpu", init_cond=False,
                                voc_cfg=SMALL_VOC)
    want = encode_latents.encode_manifest(s0, tsv, str(tmp_path / "lat3"), batch=4,
                                          crop_len=40)
    for a, b in zip(read_tsv(cli_tsv), read_tsv(want)):
        np.testing.assert_array_equal(np.load(a["moments_path"]), np.load(b["moments_path"]))

    # training from the moments equals training from the mel
    ds_mel = TextSpecDataset("train", tsv, 40)
    ds_mom = TextSpecDataset("train", out_tsv + ".first", 40, moments_dim=8)
    batch_mel = ds_mel.collater([ds_mel[i] for i in range(4)])
    batch_mom = ds_mom.collater([ds_mom[i] for i in range(4)])
    assert batch_mom["moments"].shape == (4, 8, 20)
    ctx = np.random.RandomState(1).randn(4, 6, 32).astype(np.float32)
    dr = _step_draws(jax.random.PRNGKey(9), (4, 4, 20))
    losses = []
    for batch in (batch_mel, batch_mom):
        _, s = _systems(tmp_path)
        tr = Trainer(s, batch_size=4, warm_up_steps=0, log_every=100, ckpt_every=0,
                     ckpt_dir=str(tmp_path / "tr"))
        losses.append(tr.train_step(dict(batch, context=ctx), draws=dr)["loss"])
    _cmp(losses[1], losses[0].numpy(), rtol=1e-4, atol=0)


# -- audio logger ------------------------------------------------------------------

@pytest.mark.parametrize("config,kind", [(MUSIC, "flan"), (XL, "clap_flan")],
                         ids=["music", "xl"])
def test_audio_logger_equals_sample_cfg(tmp_path, config, kind):
    """log_samples writes, per caption, the mel of sample_cfg -> decode with
    the same generator (conditioning built by MAA3System.captions), a 16 kHz
    int16 wav of the vocoded mel, the caption, and a png."""
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from scipy.io import wavfile

    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2,
                                          intermediate_size=32),
                          t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1,
                                      num_heads=2), d_proj=16)
    s = MAA3System.from_config([config], SMALL + [UP + "use_flash=false"], device="cpu",
                               compute_dtype=torch.float32, clap_cfg=clap,
                               voc_cfg=SMALL_VOC, unfreeze=True)
    assert s.spec.cond_kind == kind
    caps = [{"ori_caption": "a dog barks", "struct_caption": "<dog barks& all>"},
            {"ori_caption": "rain on a roof", "struct_caption": "<rain& all>"}]
    logger = AudioLogger(str(tmp_path), every_n_steps=3, steps=3)
    assert [logger.should_log(n) for n in (0, 1, 3, 6)] == [False, False, True, True]
    out = logger.log_samples(s, 3, caps, torch.Generator().manual_seed(4))
    c = s.get_learned_conditioning(s.captions([x["ori_caption"] for x in caps],
                                              [x["struct_caption"] for x in caps]))
    uc = s.get_learned_conditioning(s.captions(["", ""], ["", ""]))
    mel = s.decode_first_stage(s.sample_cfg(c, 5.0, uc, torch.Generator().manual_seed(4),
                                            timesteps=3))
    wav = s.vocode(mel)
    assert sorted(os.listdir(out)) == ["00.wav", "00_caption.txt", "00_mel.npy", "00_mel.png",
                                       "01.wav", "01_caption.txt", "01_mel.npy", "01_mel.png"]
    for i in range(2):
        np.testing.assert_array_equal(np.load(os.path.join(out, f"{i:02d}_mel.npy")),
                                      mel[i].numpy())
        rate, pcm = wavfile.read(os.path.join(out, f"{i:02d}.wav"))
        assert rate == 16000 and pcm.dtype == np.int16
        np.testing.assert_array_equal(
            pcm, (np.clip(wav[i].reshape(-1), -1, 1) * 32767).astype(np.int16))
        assert open(os.path.join(out, f"{i:02d}_caption.txt")).read() == \
            caps[i]["ori_caption"] + "\n"


# -- the CLI -------------------------------------------------------------------------

def test_cli_with_the_new_flags(tmp_path, monkeypatch):
    """python -m maa3_tpu_torch.train with --accum_steps 2 --mu_dtype bfloat16
    --fuse_gemms --val_every 1 --val_batches 1 --audio_log_every 1 and a
    remat policy, on a manifest of 5 clips: a val/loss_simple line after
    every step, the logger's wavs every step, a `last` checkpoint of the
    fused bf16 run, and no loader thread left."""
    import threading

    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.train import __main__ as cli

    real = MAA3System.from_config.__func__

    def small(cls, paths, overrides=(), *a, **kw):
        kw.update(clap_cfg=CLAPFLANConfig(
            bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32),
            t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2), d_proj=16),
            voc_cfg=SMALL_VOC)
        return real(cls, paths, overrides, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))
    tsv = _mel_manifest(tmp_path, n=4, t=64, rows=80)
    before = set(threading.enumerate())
    ckpt = tmp_path / "run"
    m = cli.main(["-b", XL, "--max_steps", "2", "--batch_size", "2", "--device", "cpu",
                  "--fp32", "--accum_steps", "2", "--mu_dtype", "bfloat16", "--fuse_gemms",
                  "--val_every", "1", "--val_batches", "1", "--audio_log_every", "1",
                  "--log_every", "1", "--ckpt_every", "0", "--ckpt_dir", str(ckpt),
                  *SMALL, UP + "remat=true", UP + "remat_policy=save_gemms_lite",
                  f"data.params.train.params.dataset_cfg.dataset_name={tsv}",
                  "data.params.train.params.dataset_cfg.spec_crop_len=64"])
    assert m["step"] == 2 and np.isfinite(m["loss"])
    lines = [json.loads(x) for x in (ckpt / "metrics.jsonl").read_text().splitlines()]
    val = [x for x in lines if "val/loss_simple" in x]
    assert [x["step"] for x in val] == [1, 2] and all(np.isfinite(x["val/loss_simple"])
                                                      for x in val)
    for step in (1, 2):
        d = ckpt / "audio" / f"step_{step:08d}"
        wavs = sorted(f for f in os.listdir(d) if f.endswith(".wav"))
        assert wavs == ["00.wav", "01.wav"]
        with wave.open(str(d / "00.wav")) as w:
            assert w.getframerate() == 16000 and w.getsampwidth() == 2
    saved = torch.load(ckpt / "last.pt", weights_only=True)
    assert saved["fuse_gemms"] and saved["opt_state"]["mu_dtype"] == "bfloat16"
    assert saved["opt_state"]["accum_steps"] == 2 and saved["opt_state"]["count"] == 1
    assert "blocks.0.attention.wq.weight" in saved["params"]["dit"]
    assert not [t for t in set(threading.enumerate()) - before
                if t.name.startswith("PrefetchLoader")]
