"""Tensor and expert parallelism of the video MoE, FSDP of the MoE, and
adafactor over sharded parameters (maa3_tpu_torch/models/dit_moe.py,
parallel/, train/optim.py) on gloo process groups, against the JAX package
on its 8-device virtual CPU mesh (tests/conftest.py) and against the port on
one rank.

As tests/test_torch_parallel.py: the parent computes JAX's results (the MoE
forward and gradients on data 2 x model 4, expert-parallel serving on 1 x 2
x 2, its Trainer(n_model=2, n_expert=2, fsdp=True), optax's adafactor),
writes them with the numpy-seeded inputs and the weights to tmp_path, and
spawns 2 or 4 gloo ranks (no JAX in a rank, every wait bounded).

Tolerances: the port against JAX at the port's rule (rtol 1e-3 / atol
1e-4, fp32); several ranks against one rank at the JAX tests' own
(forward 1e-5, gradients 1e-4, serving 2e-4 / 2e-5, parameters after a step
5e-5 / 5e-6)."""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (SEEDS, SERVE, STEP, TRAIN, VAE, _cmp, _np, _spawn,
                                       _step_draws)

torch.set_num_threads(2)

# the JAX MoE tests' DiT (tests/test_parallel.py), latents of 20 frames
MOE = dict(in_channels=4, context_dim=16, hidden_size=32, depth=2, num_heads=4,
           multiple_of=16, num_experts=4)
B, ZSHAPE = 8, (8, 4, 20)
FWD, GRAD = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-5)
# adafactor's leaves: (shape, the dim "model" shards, the dim "data" shards);
# "a"'s model shard is 96 wide, under the 128 that factoring needs, and its
# whole dim 192 is not; "c" is square; "d" too small to factor; "e" a vector
ADA = {"a": ((256, 192), 1, 0), "b": ((192, 320), 0, 1), "c": ((160, 160), 0, 1),
       "d": ((64, 64), 1, None), "e": ((300,), None, None)}
ADA_STEPS = 3


# -- the port's side (parent and ranks) -------------------------------------------------

def _port_video_system(st: dict):
    """The tiny port video system of st's weights (the trainable video
    feature encoder as the conditioner)."""
    from maa3_tpu_torch import config as tconfig
    from maa3_tpu_torch.models import vae1d as tvae
    from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from maa3_tpu_torch.models.clap import VideoFeatEncoder
    from maa3_tpu_torch.models.dit_moe import MoEDiT, MoEDiTConfig
    from maa3_tpu_torch.system import MAA3System
    cfg = MoEDiTConfig(**MOE)
    spec = tconfig.ModelSpec(dit=cfg, vae=tvae.VAEConfig(**VAE), mel_dim=4, mel_length=20,
                             scale_factor=0.7, base_learning_rate=1e-4,
                             cond_stage_trainable=True, cond_kind="video_feat",
                             backbone_kind="video_moe_dit")
    dit, vae, cond = MoEDiT(cfg), tvae.AutoencoderKL(spec.vae), VideoFeatEncoder(12, 16)
    dit.load_state_dict(st["moe"])
    vae.load_state_dict(st["vae"])
    cond.load_state_dict(st["cond"])
    voc = BigVGAN(BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                upsample_initial_channel=32))
    return MAA3System(spec, dit, vae, voc, cond, 0.7, compute_dtype=torch.float32)


def _moe_forward(st: dict, mesh) -> dict:
    """moe_dit_apply's forward and the gradients of sum(out * cot), the MoE
    sharded over mesh's model and expert groups (one rank: mesh None)."""
    from maa3_tpu_torch.models.dit_moe import moe_dit_apply
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.tp import EP, TP
    d = _port_video_system(st).dit.requires_grad_(True)
    named = dict(d.named_parameters())
    full = {n: tuple(p.shape) for n, p in named.items()}
    specs, owners = pmesh.dit_param_specs(named), {}
    if mesh is not None:
        if mesh.n_expert > 1:
            owners = pmesh.add_ep_specs(named, mesh.n_expert)
        pmesh.free_unowned_(d, owners, mesh)
        pmesh.shard_params_(d, specs, mesh, ("model",))
        d.tp, d.ep = TP.of(mesh), EP.of(mesh, MOE["num_experts"])
    x, t, c, cot = st["fwd"]
    out = moe_dit_apply(d, x, t, c, compute_dtype=torch.float32, training=True)
    (out * cot).sum().backward()
    grads = {}
    for n, p in d.named_parameters():   # another coordinate's experts: no gradient
        g = torch.zeros_like(p) if p.grad is None else p.grad
        grads[n] = (g if mesh is None else pmesh.gather_tensor(
            g, specs[n], mesh, owner=owners.get(n), full_shape=full[n]))
    return {"out": out.detach(), "grads": grads,
            "shapes": {n: tuple(p.shape) for n, p in d.named_parameters()}}


def _serve(st: dict, mesh) -> dict:
    """sample_cfg of the tiny video system (4 steps, guidance 3, fp32), on one
    device or through shard_serving over mesh; the serving copy's local
    expert shapes."""
    s = _port_video_system(st)
    s.dit.requires_grad_(False)
    if mesh is not None:
        s.shard_serving(mesh)
    ctx, uc, x0 = st["serve"]
    z = s.sample_cfg(ctx, 3.0, uc, x0=x0, timesteps=4)
    ff = s.serving_dit().blocks[0].feed_forward
    return {"z": z, "w1": [tuple(e.w1.weight.shape) for e in ff.time_experts]}


def _train(st: dict, ckpt_dir: str, **kw):
    """Two Trainer steps of the tiny video system on st's batches with JAX's
    draws; the whole parameters, EMA shadows and the local shapes."""
    from maa3_tpu_torch.train.loop import Trainer
    tr = Trainer(_port_video_system(st), ckpt_dir=ckpt_dir, **TRAIN, **kw)
    metrics = [{k: float(v) for k, v in tr.train_step(raw, draws=st["draws"][i]).items()}
               for i, raw in enumerate(st["raws"])]
    full = tr._full_params()
    return tr, {"params": {f"{k}.{n}": t.detach().clone() for k, sd in full.items()
                           for n, t in sd.items()},
                "ema": [e.clone() for e in tr._gather_list(tr.state.ema)],
                "shapes": {n: tuple(p.shape) for n, p in tr.state.dit.named_parameters()},
                "metrics": metrics, "mesh": tr.mesh.shape}


def _adafactor(st: dict, mesh) -> dict:
    """ADA_STEPS adafactor updates (train/optim.py, lr 1e-3, clip 1.0) of
    ADA's leaves from st's grads, each leaf this rank's shard over the
    mesh's model and data groups (one rank: mesh None); the whole leaves."""
    import functools
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.train.loop import sharded_norm
    from maa3_tpu_torch.train.optim import make_optimizer
    specs = {}
    for k, (shape, dm, dd) in ADA.items():
        specs[k] = tuple("model" if i == dm else "data" if i == dd else None
                         for i in range(len(shape)))
    mesh = mesh or pmesh.Mesh()
    params = [torch.nn.Parameter(pmesh.shard_tensor(st["ada"][k].clone(), specs[k], mesh))
              for k in ADA]
    groups = [{pmesh.spec_dim(specs[k], a): (mesh.group(a), mesh.size(a))
               for a in ("model", "data")
               if pmesh.spec_dim(specs[k], a) is not None and mesh.size(a) > 1} for k in ADA]
    opt = make_optimizer(params, 1e-3, 1.0, 0, factored=True,
                         full_shapes=[ADA[k][0] for k in ADA], dim_groups=groups)
    if pmesh.world_size() > 1:
        held = [mesh.size("model") ** ("model" not in specs[k])
                * mesh.size("data") ** ("data" not in specs[k]) for k in ADA]
        opt.norm_fn = functools.partial(sharded_norm, weights=[1.0 / h for h in held])
    for grads in st["ada_grads"]:
        for p, k in zip(params, ADA):
            p.grad = pmesh.shard_tensor(grads[k], specs[k], mesh)
        opt.step()
    return {"params": {k: pmesh.gather_tensor(p.detach(), specs[k], mesh)
                       for p, k in zip(params, ADA)},
            "local": {k: tuple(p.shape) for p, k in zip(params, ADA)},
            "factored": opt.dims}


def _task_e2(rank: int, d: str) -> dict:
    """Two ranks: the MoE forward and gradients over model 2 and over expert
    2, adafactor over model 2, Trainer(n_expert=2) and its checkpoint."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    out = {"tp_fwd": _moe_forward(st, pmesh.make_mesh(n_model=2)),
           "ep_fwd": _moe_forward(st, pmesh.make_moe_mesh(n_expert=2)),
           "ada": _adafactor(st, pmesh.make_mesh(n_model=2))}
    tr, out["ep_train"] = _train(st, os.path.join(d, "ep"), n_expert=2)
    out["ckpt"] = tr.save_checkpoint()
    return out


def _task_e4(rank: int, d: str) -> dict:
    """Four ranks: the forward and gradients on model 2 x expert 2, serving
    on 1 x 2 x 2 and 2 x 1 x 2, Trainer steps on 1 x 2 x 2, on 2 x 1 x 2
    with FSDP and on data 2 x model 2 with FSDP, adafactor over data 2 x
    model 2."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    tp_ep = pmesh.make_moe_mesh(n_model=2, n_expert=2)
    out = {"tp_ep_fwd": _moe_forward(st, tp_ep),
           "serve_122": _serve(st, tp_ep),
           "serve_212": _serve(st, pmesh.make_moe_mesh(n_model=1, n_expert=2)),
           "ada": _adafactor(st, pmesh.make_mesh(n_model=2))}
    _, out["train_122"] = _train(st, os.path.join(d, "t122"), n_model=2, n_expert=2)
    _, out["train_212"] = _train(st, os.path.join(d, "t212"), n_expert=2, fsdp=True,
                                 fsdp_min_size=1024)
    _, out["train_tp_fsdp"] = _train(st, os.path.join(d, "ttf"), n_model=2, fsdp=True,
                                     fsdp_min_size=1024)
    return out


TASKS = {"e2": _task_e2, "e4": _task_e4}


def _rank_main(rank: int, world: int, init: str, task: str, d: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world)
    try:
        torch.save(TASKS[task](rank, d), os.path.join(d, f"{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


# -- the parent: JAX's results and the port on one rank ----------------------------------

def _jax_video_system(pm, pv, pc):
    import jax.numpy as jnp
    from maa3_tpu.config import ModelSpec as JSpec
    from maa3_tpu.models.dit_moe import MoEDiTConfig
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.system import MAA3System as JSystem
    spec = JSpec(kind="cfm", backbone_kind="video_moe_dit",
                 dit=MoEDiTConfig(**MOE, max_len=64), vae=jvae.VAEConfig(**VAE),
                 cond_kind="video_feat", cond_params_cfg={}, mel_dim=4, mel_length=20,
                 scale_by_std=False, scale_factor=0.7, cond_stage_trainable=True,
                 base_learning_rate=1e-4)
    return JSystem(spec, {"dit": pm, "vae": pv, "cond": pc}, scale_factor=0.7,
                   compute_dtype=jnp.float32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from maa3_tpu.models import clap as jclap
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.models.dit_moe import MoEDiTConfig, moe_dit_apply, moe_dit_init
    from maa3_tpu.parallel.mesh import (batch_sharding, dit_param_specs, make_mesh,
                                        make_moe_mesh)
    from maa3_tpu.train.loop import Trainer as JTrainer
    from maa3_tpu.train.optim import make_optimizer as jmake_optimizer
    from maa3_tpu.utils.nprand import unfreeze_zero_init
    from maa3_tpu_torch.weights import dit_from_jax, vae_from_jax, video_feat_from_jax

    d = str(tmp_path_factory.mktemp("expert"))
    cfg = MoEDiTConfig(**MOE, max_len=64)
    pm = unfreeze_zero_init(moe_dit_init(jax.random.PRNGKey(0), cfg), jax.random.PRNGKey(3))
    pv = jvae.vae_init(jax.random.PRNGKey(2), jvae.VAEConfig(**VAE))
    pc = jclap.video_feat_encoder_init(jax.random.PRNGKey(4), 12, 16)
    rng = np.random.RandomState(7)
    raws = [{"image": rng.randn(B, 16, 40).astype(np.float32),
             "video_feat": rng.randn(B, 5, 12).astype(np.float32)} for _ in SEEDS]
    x = rng.randn(4, 4, 16).astype(np.float32)
    t = np.array([0, 260, 600, 999])
    c = rng.randn(4, 5, 16).astype(np.float32)
    cot = rng.randn(4, 4, 16).astype(np.float32)
    ctx = rng.randn(2, 5, 16).astype(np.float32)
    x0 = rng.randn(2, 4, 20).astype(np.float32)
    ada = {k: rng.randn(*s).astype(np.float32) for k, (s, _, _) in ADA.items()}
    ada_grads = [{k: rng.randn(*s).astype(np.float32) * 0.1 for k, (s, _, _) in ADA.items()}
                 for _ in range(ADA_STEPS)]
    t_ = torch.tensor
    st = {"moe": dit_from_jax(_np(pm)), "vae": vae_from_jax(_np(pv)),
          "cond": video_feat_from_jax(_np(pc)), "raws": raws,
          "draws": [_step_draws(jax.random.split(jax.random.PRNGKey(s))[1], ZSHAPE)
                    for s in SEEDS],
          "fwd": (t_(x), t_(t), t_(c), t_(cot)),
          "serve": (t_(ctx), torch.zeros(2, 5, 16), t_(x0)),
          "ada": {k: t_(v) for k, v in ada.items()},
          "ada_grads": [{k: t_(v) for k, v in g.items()} for g in ada_grads]}
    torch.save(st, os.path.join(d, "payload.pt"))
    out = {"d": d, "st": st}

    # the MoE forward and gradients on data 2 x model 4 (JAX's
    # test_moe_tp_sharded_forward_matches_single_device)
    mesh = make_mesh(2, 4)
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), pm,
                           dit_param_specs(pm))
    xs = [jax.device_put(jnp.asarray(a), batch_sharding(mesh, a.ndim)) for a in (x, t, c, cot)]

    def f(p):
        return moe_dit_apply(p, cfg, *xs[:3], compute_dtype=jnp.float32, training=True)

    with jax.set_mesh(mesh):
        out["jax_fwd"] = {"out": np.asarray(jax.jit(f)(sharded)), "grads": dit_from_jax(
            _np(jax.jit(jax.grad(lambda p: jnp.sum(f(p) * xs[3])))(sharded)))}
    # expert-parallel serving on 1 x 2 x 2 (test_ep_serving_matches_single_device)
    js = _jax_video_system(pm, pv, pc)
    js.shard_serving(make_moe_mesh(1, 2, 2, devices=jax.devices()[:4]))
    out["jax_serve"] = np.asarray(js.sample_cfg(
        jnp.asarray(ctx), 3.0, jnp.zeros((2, 5, 16)), jax.random.PRNGKey(0), timesteps=4,
        x0=jnp.asarray(x0)))
    # JAX's Trainer with TP, EP and FSDP on data 2 x model 2 x expert 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_log", lambda self, m: None)   # no TensorBoard
        jt = JTrainer(_jax_video_system(pm, pv, pc), ckpt_dir=os.path.join(d, "j"),
                      n_model=2, n_expert=2, fsdp=True, fsdp_min_size=1024, **TRAIN)
        metrics = [jt.fit(iter([raw]), max_steps=1, seed=s) for raw, s in zip(raws, SEEDS)]
    assert dict(jt.mesh.shape) == {"data": 2, "model": 2, "expert": 2}
    params = {f"dit.{n}": v for n, v in dit_from_jax(_np(jt.state.params["dit"])).items()}
    params |= {f"cond.{n}": v for n, v in video_feat_from_jax(
        _np(jt.state.params["cond"])).items()}
    ema = {f"dit.{n}": v for n, v in dit_from_jax(_np(jt.state.ema_params["dit"])).items()}
    ema |= {f"cond.{n}": v for n, v in video_feat_from_jax(
        _np(jt.state.ema_params["cond"])).items()}
    out["jax_train"] = {"params": params, "ema": ema, "metrics": metrics}
    # optax's adafactor (maa3_tpu/train/optim.py make_optimizer(factored=True))
    opt = jmake_optimizer(base_lr=1e-3, lr_multiplier=1.0, warm_up_steps=0, factored=True)
    p = {k: jnp.asarray(v) for k, v in ada.items()}
    state = opt.init(p)
    for g in ada_grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
    out["jax_ada"] = {k: np.asarray(v) for k, v in p.items()}
    # the port on one rank
    out["one_fwd"] = _moe_forward(st, None)
    out["one_serve"] = _serve(st, None)
    _, out["one_train"] = _train(st, os.path.join(d, "one"))
    out["one_ada"] = _adafactor(st, None)
    return out


@pytest.fixture(scope="module")
def e2(ref):
    return _spawn(ref["d"], "e2", 2, _rank_main)


@pytest.fixture(scope="module")
def e4(ref):
    return _spawn(ref["d"], "e4", 4, _rank_main)


def test_add_ep_specs_match_jax():
    """JAX's test_add_ep_specs: the port's owner of every expert tensor is
    the coordinate JAX's "expert" on the stacks' E axis gives (the TP
    placements unchanged), attention and embedders have none, and three
    expert ranks for four experts raise JAX's "not divisible"."""
    import jax
    from jax.sharding import PartitionSpec as P
    from maa3_tpu.models.dit_moe import MoEDiTConfig, moe_dit_init
    from maa3_tpu.parallel.mesh import add_ep_specs as jadd, dit_param_specs as jspecs
    from maa3_tpu_torch.models.dit_moe import MoEDiT, MoEDiTConfig as TConfig
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.weights import dit_from_jax
    p = moe_dit_init(jax.random.PRNGKey(0), MoEDiTConfig(**MOE, max_len=64))
    js = jadd(p, jspecs(p), 2)
    assert js["blocks"]["feed_forward"]["time_experts"]["w1"]["w"] == P(
        None, "expert", None, "model")

    def expert_index(x, spec):
        a = np.full(x.shape, -1.0, np.float32)
        if tuple(spec)[1:2] == ("expert",):
            a = a * 0 + np.arange(x.shape[1]).reshape([1, -1] + [1] * (x.ndim - 2))
        return a

    idx = dit_from_jax(jax.tree.map(expert_index, p, js))
    want = {n: ("expert", int(a.flatten()[0]) // 2) for n, a in idx.items()
            if a.flatten()[0] >= 0}
    named = dict(MoEDiT(TConfig(**MOE)).named_parameters())
    assert pmesh.add_ep_specs(named, 2) == want
    assert want["blocks.1.feed_forward.freq_experts.3.w2.weight"] == ("expert", 1)
    assert not any("attention" in n or "embedder" in n for n in want)
    with pytest.raises(ValueError, match="not divisible"):
        jadd(p, jspecs(p), 3)
    with pytest.raises(ValueError, match="not divisible by n_expert=3"):
        pmesh.add_ep_specs(named, 3)


def _check_forward(got: dict, one: dict, jax_ref: dict):
    _cmp(got["out"], one["out"], **FWD)
    _cmp(got["out"], jax_ref["out"])
    for n, g in got["grads"].items():
        _cmp(g, one["grads"][n], **GRAD)
        _cmp(g, jax_ref["grads"][n])


def test_one_rank_moe_matches_jax_tp(ref):
    """The port's MoE on one rank against JAX's forward and gradients on its
    data 2 x model 4 mesh (the expert stacks' TP shardings)."""
    _check_forward(ref["one_fwd"], ref["one_fwd"], ref["jax_fwd"])


@pytest.mark.parametrize("variant", ["tp_fwd", "ep_fwd"])
def test_moe_tensor_or_expert_parallel_forward_and_grads(ref, e2, variant):
    """Model 2 (each expert's w1 / w3 by output, w2 by input, the attention
    as the text DiT's) and expert 2 (two experts per rank, the others
    empty) on two ranks: one rank's and JAX's forward and gradients."""
    for rank, r in enumerate(e2):
        got = r[variant]
        _check_forward(got, ref["one_fwd"], ref["jax_fwd"])
        w1 = "blocks.0.feed_forward.time_experts.{}.w1.weight"
        full = ref["one_fwd"]["shapes"][w1.format(0)]
        if variant == "tp_fwd":
            assert got["shapes"][w1.format(0)] == (full[0] // 2, full[1])
        else:
            assert [got["shapes"][w1.format(e)] == full for e in range(4)] == [
                e // 2 == rank for e in range(4)]


def test_moe_tensor_and_expert_parallel_forward_and_grads(ref, e4):
    """Model 2 x expert 2 on four ranks (JAX's (1, 2, 2)): one rank's and
    JAX's; each rank stores a quarter of each expert stack."""
    for r in e4:
        _check_forward(r["tp_ep_fwd"], ref["one_fwd"], ref["jax_fwd"])
        n = sum(int(np.prod(s)) for k, s in r["tp_ep_fwd"]["shapes"].items()
                if "experts" in k)
        n1 = sum(int(np.prod(s)) for k, s in ref["one_fwd"]["shapes"].items()
                 if "experts" in k)
        assert n * 4 == n1


@pytest.mark.parametrize("variant", ["serve_122", "serve_212"])
def test_expert_parallel_serving(ref, e4, variant):
    """shard_serving over ("data", "model", "expert") meshes 1 x 2 x 2 and
    2 x 1 x 2: one device's latents (JAX's serving tolerance) and JAX's
    expert-parallel sampler's; the serving copy keeps this rank's experts."""
    one = ref["one_serve"]
    _cmp(one["z"], ref["jax_serve"])
    for rank, r in enumerate(e4):
        got = r[variant]
        _cmp(got["z"], one["z"], **SERVE)
        _cmp(got["z"], ref["jax_serve"])
        e_rank = rank % 2
        rows = one["w1"][0][0] // (2 if variant == "serve_122" else 1)
        assert got["w1"] == [(rows, one["w1"][0][1]) if e // 2 == e_rank else (0,)
                             for e in range(4)]


def _check_train(got: dict, one: dict, jax_ref: dict):
    """Every parameter and EMA shadow (DiT and video encoder) after two
    steps, the losses and grad norms: one rank's at the JAX tests' rule,
    JAX's at the port's."""
    for n, p in got["params"].items():
        _cmp(p, one["params"][n], **STEP)
        _cmp(p, jax_ref["params"][n])
    for e, e1, n in zip(got["ema"], one["ema"], got["params"], strict=True):
        _cmp(e, e1, **STEP)
        _cmp(e, jax_ref["ema"][n])
    for m, m1, mj in zip(got["metrics"], one["metrics"], jax_ref["metrics"]):
        for k in ("loss", "grad_norm"):
            _cmp(m[k], m1[k], **STEP)
            _cmp(m[k], mj[k])


@pytest.mark.parametrize("variant", ["ep_train", "train_122", "train_212",
                                     "train_tp_fsdp"])
def test_moe_trainer_steps(ref, e2, e4, variant):
    """Trainer on the video MoE: expert 2; model 2 x expert 2; data 2 x
    expert 2 with FSDP; data 2 x model 2 with FSDP; each against one rank and
    against JAX's Trainer(n_model=2, n_expert=2, fsdp=True)."""
    ranks = e2 if variant == "ep_train" else e4
    want_mesh = {"ep_train": {"data": 1, "model": 1, "expert": 2},
                 "train_122": {"data": 1, "model": 2, "expert": 2},
                 "train_212": {"data": 2, "model": 1, "expert": 2},
                 "train_tp_fsdp": {"data": 2, "model": 2}}[variant]
    for r in ranks:
        assert r[variant]["mesh"] == want_mesh
        _check_train(r[variant], ref["one_train"], ref["jax_train"])


def test_expert_parallel_checkpoint_loads_at_world_size_one(ref, e2, tmp_path):
    """The expert-2 trainer's checkpoint (every coordinate's experts
    gathered, rank 0 writes) loaded by a one-rank Trainer: every parameter
    equal to the file's and to one rank's step."""
    from maa3_tpu_torch.train.loop import Trainer
    path = e2[0]["ckpt"]
    payload = torch.load(path, weights_only=True)
    tr = Trainer(_port_video_system(ref["st"]), ckpt_dir=str(tmp_path), **TRAIN)
    tr.restore_checkpoint(path)
    assert tr.state.step == 2
    for k, m in tr.state.trainable().items():
        for n, p in m.named_parameters():
            assert torch.equal(p.detach(), payload["params"][k][n])
            _cmp(p, ref["one_train"]["params"][f"{k}.{n}"], **STEP)


@pytest.mark.parametrize("task", ["e2", "e4"])
def test_adafactor_over_shards(ref, e2, e4, task):
    """adafactor over leaves sharded on model 2 (two ranks) and on data 2 x
    model 2 (four): factored by the whole shape (leaf "a"'s 96-wide shard is
    still factored), and the update equals one rank's and optax's."""
    ranks = e2 if task == "e2" else e4
    one = ref["one_ada"]
    assert one["factored"] == [(1, 0), (0, 1), (0, 1), None, None]
    for k in ADA:
        _cmp(one["params"][k], ref["jax_ada"][k])
    for r in ranks:
        got = r["ada"]
        assert got["factored"] == one["factored"]
        assert got["local"]["a"][1] == 96
        for k in ADA:
            _cmp(got["params"][k], one["params"][k], **STEP)
            _cmp(got["params"][k], ref["jax_ada"][k])
