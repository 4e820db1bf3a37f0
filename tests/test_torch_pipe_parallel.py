"""GPipe pipeline parallelism of the port (maa3_tpu_torch/parallel/pipeline.py)
on gloo process groups, against the JAX package's dit_apply_pipelined and
Trainer(n_pipe, n_micro) on its 8-device virtual CPU mesh (tests/conftest.py)
and against the port on one rank.

As tests/test_torch_parallel.py: the parent computes JAX's results, writes
them with the numpy-seeded inputs and the weights to tmp_path, and spawns 2
or 4 ranks (gloo, init_method=file:// under tmp_path, one thread each, no
JAX, every wait bounded). The ranks run pipe 2, data 2 x pipe 2 and pipe 2 x
model 2.

Tolerances: the port against JAX at the port's rule (rtol 1e-3 / atol
1e-4, fp32); several ranks against one rank at the JAX tests' own (forward
1e-5, gradients 1e-4; parameters after a step 5e-5 / 5e-6)."""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_parallel import (B, DIT, SEEDS, STEP, TRAIN, VAE, ZSHAPE, _cmp,
                                       _jax_fit, _jax_system, _np, _port_system, _result,
                                       _spawn, _step_draws, _tiny_from_config, _train,
                                       XL, ROOT)

torch.set_num_threads(2)

# the JAX pipeline tests' DiT (tests/test_pipeline_parallel.py CFG)
PIPE_DIT = dict(in_channels=4, context_dim=16, hidden_size=64, depth=4, num_heads=4)
FWD, GRAD = dict(rtol=1e-5, atol=1e-5), dict(rtol=1e-4, atol=1e-5)


# -- the port's side (parent and ranks) -------------------------------------------------

def _pipe_dit(st: dict, remat: bool):
    from maa3_tpu_torch.models import dit as tdit
    d = tdit.DiT(tdit.DiTConfig(**PIPE_DIT, remat=remat))
    d.load_state_dict(st["pipe_dit"])
    return d.requires_grad_(True)


def _pipe_forward(st: dict, mesh, remat: bool) -> dict:
    """The depth-4 DiT's forward and gradients (the masked case: sum(out *
    cot); remat: sum(out^2), no mask, as the JAX tests), pipelined over
    mesh, or dit_apply on one rank (mesh None). Whole outputs and
    gradients, summed over the data ranks."""
    import torch.distributed as dist
    from maa3_tpu_torch.models.dit import dit_apply
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.pipeline import dit_apply_pipelined
    from maa3_tpu_torch.parallel.tp import TP
    d = _pipe_dit(st, remat)
    x, t, c, cm, cot = st["pipe_in"]
    if remat:
        cm = None
    if mesh is None:
        out = dit_apply(d, x, t, c, context_mask=cm, compute_dtype=torch.float32)
        loss = (out ** 2).sum() if remat else (out * cot).sum()
        loss.backward()
        return {"out": out.detach(), "grads": {n: p.grad for n, p in d.named_parameters()}}
    named = dict(d.named_parameters())
    full = {n: tuple(p.shape) for n, p in named.items()}
    specs, owners = pmesh.dit_param_specs(named), pmesh.add_pipe_specs(named, mesh.n_pipe)
    pmesh.free_unowned_(d, owners, mesh)
    pmesh.shard_params_(d, specs, mesh, ("model",))
    d.tp = TP.of(mesh)
    k = x.shape[0] // mesh.n_data
    rows = slice(mesh.data_rank * k, (mesh.data_rank + 1) * k)
    out = dit_apply_pipelined(d, x[rows], t[rows], c[rows], mesh, 2,
                              context_mask=None if cm is None else cm[rows],
                              compute_dtype=torch.float32)
    loss = (out ** 2).sum() if remat else (out * cot[rows]).sum()
    loss.backward()
    grads = {}
    for n, p in d.named_parameters():   # another stage's blocks: empty, no gradient
        g = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        if mesh.n_data > 1:
            dist.all_reduce(g, group=mesh.data_group)
        grads[n] = pmesh.gather_tensor(g, specs[n], mesh, owner=owners.get(n),
                                       full_shape=full[n])
    whole = pmesh.all_gather_dim(out.detach(), 0, mesh.data_group, mesh.n_data)
    return {"out": whole, "grads": grads,
            "shapes": {n: tuple(p.shape) for n, p in d.named_parameters()}}


def _task_p2(rank: int, d: str) -> dict:
    """Two ranks, pipe 2: the pipelined forward and gradients (masked, and
    remat), the Trainer's two steps and its checkpoint."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    mesh = pmesh.make_pipe_mesh(n_pipe=2)
    out = {"mesh": mesh.shape, "fwd": _pipe_forward(st, mesh, False),
           "remat": _pipe_forward(st, mesh, True)}
    tr, m = _train(st, os.path.join(d, "pp"), n_pipe=2, n_micro=2)
    out["train"] = _result(tr, m) | {"mesh": tr.mesh.shape}
    out["ckpt"] = tr.save_checkpoint()
    sys.modules["torch.utils.tensorboard"] = None      # the log line without TF
    out["val"] = tr.evaluate(iter(st["raws"][:1]), max_batches=1)["val/loss_simple"]
    tr, m = _train(st, os.path.join(d, "pp_ada"), n_pipe=2, n_micro=2, factored=True)
    out["ada"] = _result(tr, m)
    out["ada_ckpt"] = tr.save_checkpoint()
    return out


def _task_p4(rank: int, d: str) -> dict:
    """Four ranks: data 2 x pipe 2 and pipe 2 x model 2 forwards and
    gradients; the Trainer's steps on pipe 2 x model 2."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    dp = pmesh.make_pipe_mesh(n_pipe=2)
    tp = pmesh.make_pipe_mesh(n_pipe=2, n_model=2)
    out = {"meshes": (dp.shape, tp.shape),
           "dp_fwd": _pipe_forward(st, dp, False), "dp_remat": _pipe_forward(st, dp, True),
           "tp_fwd": _pipe_forward(st, tp, False), "tp_remat": _pipe_forward(st, tp, True)}
    tr, m = _train(st, os.path.join(d, "pp_tp"), n_pipe=2, n_micro=2, n_model=2)
    out["train"] = _result(tr, m) | {"mesh": tr.mesh.shape}
    tr, m = _train(st, os.path.join(d, "pp_dp"), n_pipe=2, n_micro=2)
    out["train_dp"] = _result(tr, m) | {"mesh": tr.mesh.shape}
    return out


TASKS = {"p2": _task_p2, "p4": _task_p4}


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

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.parallel.mesh import batch_sharding, dit_param_specs
    from maa3_tpu.parallel.pipeline import (add_pipe_specs, dit_apply_pipelined,
                                            make_pipe_mesh)
    from maa3_tpu.train.loop import Trainer as JTrainer
    from maa3_tpu.utils.nprand import unfreeze_zero_init
    from maa3_tpu_torch.weights import dit_from_jax, vae_from_jax

    d = str(tmp_path_factory.mktemp("pipe"))
    # the Trainer's tiny system (tests/test_torch_parallel.py) and its batches
    pd = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(0),
                                          jdit.DiTConfig(**DIT, max_len=128)),
                            jax.random.PRNGKey(1))
    pv = jvae.vae_init(jax.random.PRNGKey(2), jvae.VAEConfig(**VAE))
    rng = np.random.RandomState(7)
    raws = [{"image": rng.randn(B, 16, 40).astype(np.float32),
             "context": rng.randn(B, 6, 32).astype(np.float32)} for _ in SEEDS]
    # the pipeline tests' depth-4 DiT and inputs, with a context mask
    jcfg = jdit.DiTConfig(**PIPE_DIT, max_len=64)
    pp = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(5), jcfg), jax.random.PRNGKey(7))
    x = rng.randn(8, 4, 32).astype(np.float32)
    t = (np.arange(8) * 100).astype(np.int64)
    c = rng.randn(8, 6, 16).astype(np.float32)
    cm = np.arange(6)[None, :] < np.array([6, 4, 6, 5, 6, 3, 6, 2])[:, None]
    cot = rng.randn(8, 4, 32).astype(np.float32)
    st = {"dit": dit_from_jax(_np(pd)), "vae": vae_from_jax(_np(pv)), "raws": raws,
          "draws": [_step_draws(jax.random.split(jax.random.PRNGKey(s))[1], ZSHAPE)
                    for s in SEEDS],
          "pipe_dit": dit_from_jax(_np(pp)),
          "pipe_in": tuple(torch.tensor(a) for a in (x, t, c, cm, cot))}
    torch.save(st, os.path.join(d, "payload.pt"))
    out = {"d": d, "st": st}

    # JAX's pipelined forward and gradients on data 2 x pipe 2 x model 2
    mesh = make_pipe_mesh(2, 2, 2)
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), pp,
                           add_pipe_specs(dit_param_specs(pp)))
    put = lambda a: jax.device_put(jnp.asarray(a), batch_sharding(mesh, a.ndim))
    xd, td, cd, md, cotd = map(put, (x, t, c, cm, cot))
    for remat in (False, True):
        cfg = jdit.DiTConfig(**PIPE_DIT, max_len=64, remat=remat)

        def f(p, m):
            return dit_apply_pipelined(p, cfg, xd, td, cd, mesh=mesh, n_micro=2,
                                       context_mask=m, compute_dtype=jnp.float32)

        m = None if remat else md
        loss = ((lambda p: jnp.sum(f(p, m) ** 2)) if remat
                else (lambda p: jnp.sum(f(p, m) * cotd)))
        with jax.set_mesh(mesh):
            fwd = np.asarray(jax.jit(f)(sharded, m))
            g = jax.jit(jax.grad(loss))(sharded)
        out["jax_remat" if remat else "jax_fwd"] = {"out": fwd,
                                                    "grads": dit_from_jax(_np(g))}
    # JAX's Trainer(n_pipe=2, n_micro=2, n_model=2): data 2 x pipe 2 x model 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_log", lambda self, m: None)   # no TensorBoard
        out["jax_train"] = _jax_fit(_jax_system(pd, pv), os.path.join(d, "j"), raws,
                                    n_pipe=2, n_micro=2, n_model=2)
    # the port on one rank
    out["one_fwd"] = _pipe_forward(st, None, False)
    out["one_remat"] = _pipe_forward(st, None, True)
    tr, m = _train(st, os.path.join(d, "one"))
    out["one"] = _result(tr, m)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        out["one_val"] = tr.evaluate(iter(raws[:1]), max_batches=1)["val/loss_simple"]
    return out


@pytest.fixture(scope="module")
def p2(ref):
    return _spawn(ref["d"], "p2", 2, _rank_main)


@pytest.fixture(scope="module")
def p4(ref):
    return _spawn(ref["d"], "p4", 4, _rank_main)


def test_add_pipe_specs_match_jax():
    """JAX's test_add_pipe_specs_structure: the port's owners of every block
    tensor are the stages JAX's P("pipe", ...) gives its depth slice (the
    TP placements unchanged; embedders, proj_in and the final layer on
    every stage), and a depth the stages do not divide raises."""
    import jax
    from jax.sharding import PartitionSpec as P
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.parallel.mesh import dit_param_specs as jspecs
    from maa3_tpu.parallel.pipeline import add_pipe_specs as jadd
    from maa3_tpu_torch.models import dit as tdit
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.weights import dit_from_jax
    p = jdit.dit_init(jax.random.PRNGKey(0), jdit.DiTConfig(**PIPE_DIT, max_len=64))
    js = jadd(jspecs(p))
    assert js["blocks"]["attention"]["wq"]["w"] == P("pipe", None, "model")
    assert js["proj_in"]["w"] == P()

    def depth_index(x, spec):  # each leaf's depth index where its spec has "pipe"
        a = np.full(x.shape, -1.0, np.float32)
        if tuple(spec)[:1] == ("pipe",):
            a = a * 0 + np.arange(x.shape[0]).reshape([-1] + [1] * (x.ndim - 1))
        return a

    idx = dit_from_jax(jax.tree.map(depth_index, p, js))
    want = {n: ("pipe", int(a.flatten()[0]) // 2) for n, a in idx.items()
            if a.flatten()[0] >= 0}
    named = dict(tdit.DiT(tdit.DiTConfig(**PIPE_DIT)).named_parameters())
    assert pmesh.add_pipe_specs(named, 2) == want
    assert want["blocks.3.attention.wq.weight"] == ("pipe", 1)
    assert "proj_in.weight" not in want and "final_layer.linear.weight" not in want
    with pytest.raises(ValueError, match="depth 4 is not divisible into n_pipe=3"):
        pmesh.add_pipe_specs(named, 3)


def _check_forward(got: dict, one: dict, jax_ref: dict):
    _cmp(got["out"], one["out"], **FWD)
    _cmp(got["out"], jax_ref["out"])
    for n, g in got["grads"].items():
        _cmp(g, one["grads"][n], **GRAD)
        _cmp(g, jax_ref["grads"][n])


@pytest.mark.parametrize("variant", ["fwd", "remat"])
def test_one_rank_matches_jax_pipeline(ref, variant):
    """dit_apply on one rank against JAX's dit_apply_pipelined on data 2 x
    pipe 2 x model 2 (with the context mask; remat without)."""
    one, want = ref["one_" + variant], ref["jax_" + variant]
    _cmp(one["out"], want["out"])
    for n, g in one["grads"].items():
        _cmp(g, want["grads"][n])


@pytest.mark.parametrize("variant", ["fwd", "remat"])
def test_pipelined_forward_and_grads_pipe_2(ref, p2, variant):
    """Pipe 2 on two ranks: each stage stores only its two blocks; the
    forward and every gradient (proj_in, the embedders, the final layer
    and each block) equal one rank's and JAX's."""
    assert p2[0]["mesh"] == {"data": 1, "pipe": 2, "model": 1}
    for rank, r in enumerate(p2):
        shapes = r["fwd"]["shapes"]
        for n, s in shapes.items():
            stage = int(n.split(".")[1]) // 2 if n.startswith("blocks.") else None
            assert (s == (0,)) == (stage is not None and stage != rank), n
        _check_forward(r[variant], ref["one_" + variant], ref["jax_" + variant])


@pytest.mark.parametrize("variant", ["dp_fwd", "dp_remat", "tp_fwd", "tp_remat"])
def test_pipelined_forward_and_grads_four_ranks(ref, p4, variant):
    """Data 2 x pipe 2 and pipe 2 x model 2 (TP inside each stage) on four
    ranks: one rank's and JAX's forward and gradients."""
    assert p4[0]["meshes"] == ({"data": 2, "pipe": 2, "model": 1},
                               {"data": 1, "pipe": 2, "model": 2})
    kind = variant.split("_")[1]
    for r in p4:
        _check_forward(r[variant], ref["one_" + kind], ref["jax_" + kind])


def _check_train(got: dict, one: dict, jax_ref: dict):
    """Every parameter and EMA shadow after two steps (proj_in, embedders,
    final layer and blocks), the losses and grad norms: one rank's at the
    JAX tests' rule, JAX's at the port's."""
    for n, p in got["params"].items():
        _cmp(p, one["params"][n], **STEP)
        _cmp(p, jax_ref["params"][n])
    for e, e1, n in zip(got["ema"], one["ema"], one["params"]):
        _cmp(e, e1, **STEP)
        _cmp(e, jax_ref["ema"][n])
    for m, m1, mj in zip(got["metrics"], one["metrics"], jax_ref["metrics"]):
        for k in ("loss", "grad_norm"):
            _cmp(m[k], m1[k], **STEP)
            _cmp(m[k], mj[k])


def test_trainer_pipe_2(ref, p2):
    """Trainer(n_pipe=2, n_micro=2) on two ranks against JAX's
    Trainer(n_pipe=2, n_micro=2, n_model=2) with the same draws, two
    steps; then its evaluate (the pipelined apply without gradients)
    against one rank's."""
    assert ref["jax_train"]["mesh"] == {"data": 2, "pipe": 2, "model": 2}
    assert p2[0]["train"]["mesh"] == {"data": 1, "pipe": 2, "model": 1}
    for r in p2:
        _check_train(r["train"], ref["one"], ref["jax_train"])
        _cmp(r["val"], ref["one_val"], **STEP)


@pytest.mark.parametrize("variant", ["train", "train_dp"])
def test_trainer_pipe_2_on_four_ranks(ref, p4, variant):
    """Trainer(n_pipe=2, n_micro=2) on four ranks, pipe 2 x model 2 and data
    2 x pipe 2 (each a part of JAX's data 2 x pipe 2 x model 2): the same
    two steps."""
    want = {"train": {"data": 1, "pipe": 2, "model": 2},
            "train_dp": {"data": 2, "pipe": 2, "model": 1}}[variant]
    assert p4[0][variant]["mesh"] == want
    for r in p4:
        _check_train(r[variant], ref["one"], ref["jax_train"])


def test_pipelined_checkpoint_loads_at_world_size_one(ref, p2, tmp_path):
    """The pipe-2 trainer's checkpoint (every stage's blocks gathered, rank 0
    writes) loaded by a one-rank Trainer: the whole parameters and EMA
    shadows; its next step equals the one-rank trainer's."""
    from maa3_tpu_torch.train.loop import Trainer
    path = p2[0]["ckpt"]
    assert p2[1]["ckpt"] == path
    payload = torch.load(path, weights_only=True)
    for n, p in p2[0]["train"]["params"].items():
        assert torch.equal(payload["params"]["dit"][n], p)
    tr = Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path), **TRAIN)
    tr.restore_checkpoint(path)
    assert tr.state.step == 2
    for n, p in tr.state.dit.named_parameters():
        _cmp(p, ref["one"]["params"][n], **STEP)
    for e, e1 in zip(tr.state.ema, ref["one"]["ema"]):
        _cmp(e, e1, **STEP)
    one, _ = _train(ref["st"], str(tmp_path / "again"))
    raw, dr = ref["st"]["raws"][0], ref["st"]["draws"][0]
    tr.train_step(raw, draws=dr)
    one.train_step(raw, draws=dr)
    for p, q in zip(tr.state.dit.parameters(), one.state.dit.parameters()):
        _cmp(p, q.detach(), **STEP)


def test_pipelined_adafactor_checkpoint_loads_at_world_size_one(ref, p2, tmp_path):
    """Trainer(n_pipe=2, n_micro=2, factored=True): its two steps equal one
    rank's adafactor steps, and its checkpoint (every stage's statistics and
    placeholders gathered) loads into a one-rank adafactor Trainer whose
    optimizer state equals the one-rank run's."""
    from maa3_tpu_torch.train.loop import Trainer
    one, m = _train(ref["st"], str(tmp_path / "one"), factored=True)
    want = _result(one, m)
    for r in p2:
        for n, p in r["ada"]["params"].items():
            _cmp(p, want["params"][n], **STEP)
    tr = Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path / "load"), factored=True,
                 **TRAIN)
    tr.restore_checkpoint(p2[0]["ada_ckpt"])
    got, exp = tr.state.optimizer.state_dict(), one.state.optimizer.state_dict()
    for key in ("mu", "v_row", "v_col", "v"):
        for a, b in zip(got[key], exp[key], strict=True):
            _cmp(a, b.detach(), **STEP)


LAUNCH = """import json, os, sys
sys.path.insert(0, {root!r})
sys.modules["torch.utils.tensorboard"] = None
from maa3_tpu_torch.system import MAA3System
from tests.test_torch_parallel import _tiny_from_config
MAA3System.from_config = _tiny_from_config()
from maa3_tpu_torch.train import __main__ as cli
m = cli.main(sys.argv[1:])
with open(os.path.join({out!r}, "result_" + os.environ["RANK"] + ".json"), "w") as f:
    json.dump([m["loss"], m["grad_norm"], m["step"]], f)
"""


def test_train_cli_torchrun_pipe_2(ref, tmp_path):
    """torchrun --nproc_per_node 2 of the training CLI with --n_pipe 2
    --n_micro 2 (gloo from torchrun's environment; a launcher that swaps in
    a tiny conditioner and calls the CLI's main): both ranks log the losses
    and grad norms of the one-process run, and rank 0 writes last.pt."""
    import subprocess
    from tests.test_torch_parallel import _cli_train
    from maa3_tpu_torch.system import MAA3System
    tsv = os.path.join(ref["d"], "four_pp.tsv")
    from maa3_tpu.data import datasets as jdata
    rows = jdata.read_tsv(os.path.join(ROOT, "data", "synth", "manifest_mel.tsv"))[:4]
    with open(tsv, "w") as f:
        f.write("\t".join(rows[0]) + "\n")
        for r in rows:
            f.write("\t".join(dict(r, mel_path=os.path.join(ROOT, r["mel_path"])).values())
                    + "\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(MAA3System, "from_config", _tiny_from_config())
        one = _cli_train({"tsv": tsv}, str(tmp_path / "one"), [])
    launch = tmp_path / "launch.py"
    launch.write_text(LAUNCH.format(root=ROOT, out=str(tmp_path)))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    ckpt = tmp_path / "pp"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", str(launch), "-b", XL, "-t", "--device", "cpu", "--fp32", "--max_steps", "2",
         "--batch_size", "4", "--log_every", "1", "--ckpt_dir", str(ckpt),
         "--n_pipe", "2", "--n_micro", "2",
         f"data.params.train.params.dataset_cfg.dataset_name={tsv}",
         "data.params.train.params.dataset_cfg.spec_crop_len=64"],
        capture_output=True, text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(2):   # each rank's final metrics (stdout interleaves the two)
        loss, gn, step = json.loads((tmp_path / f"result_{rank}.json").read_text())
        assert step == one["step"] == 2
        _cmp(loss, one["loss"], **STEP)
        _cmp(gn, one["grad_norm"], **STEP)
    assert (ckpt / "last.pt").exists()
