"""Data, FSDP and tensor parallelism of the port (maa3_tpu_torch/parallel)
on gloo process groups, against the JAX package on its 8-device virtual CPU
mesh (tests/conftest.py) and against the port on one rank.

The parent process computes JAX's results (its Trainer on the mesh with
n_model, fsdp and seq_parallel; a sharded forward and its gradients;
tensor-parallel serving), writes them with the numpy-seeded inputs and the
weights to tmp_path, and spawns 2 or 4 ranks with torch.multiprocessing:
gloo, init_method=file:// under tmp_path, one thread each, no JAX (this
module imports JAX only inside the parent's functions), every wait bounded.

Tolerances: the port against JAX at the port's rule (rtol 1e-3 / atol
1e-4, fp32); several ranks against one rank at the JAX tests' own
(serving 2e-4 / 2e-5, parameters after a step 5e-5 / 5e-6); int8 codes
equal."""

import functools
import os
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
TOL = dict(rtol=1e-3, atol=1e-4)
STEP = dict(rtol=5e-5, atol=5e-6)
SERVE = dict(rtol=2e-4, atol=2e-5)
VAE = dict(in_channels=16, out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           attn_layers=(), z_channels=4, embed_dim=4)
DIT = dict(in_channels=4, context_dim=32, hidden_size=64, depth=2, num_heads=4,
           multiple_of=32)
B, ZSHAPE = 8, (8, 4, 20)         # the training batch and its latent
TRAIN = dict(batch_size=B, use_ema=True, ema_decay=0.99, warm_up_steps=0,
             log_every=100, ckpt_every=0)
SEEDS = (11, 12)                  # one JAX Trainer.fit per step
TIMEOUT = 240.0


def _cmp(got, want, **tol):
    np.testing.assert_allclose(torch.as_tensor(got).detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


# -- the port's side (parent and ranks) -------------------------------------------------

def _port_system(st: dict, qk: bool = False, scale_by_std: bool = False):
    """The tiny port system of the weights in st (no conditioner: batches
    carry their context)."""
    from maa3_tpu_torch import config as tconfig
    from maa3_tpu_torch.models import dit as tdit
    from maa3_tpu_torch.models import vae1d as tvae
    from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from maa3_tpu_torch.system import MAA3System
    dcfg = tdit.DiTConfig(**DIT, qk_norm=qk)
    spec = tconfig.ModelSpec(dit=dcfg, vae=tvae.VAEConfig(**VAE), mel_dim=4, mel_length=20,
                             scale_factor=0.7, base_learning_rate=1e-4,
                             scale_by_std=scale_by_std)
    dit, vae = tdit.DiT(dcfg), tvae.AutoencoderKL(spec.vae)
    dit.load_state_dict(st["dit_qk" if qk else "dit"])
    vae.load_state_dict(st["vae"])
    voc = BigVGAN(BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                upsample_initial_channel=32))
    return MAA3System(spec, dit, vae, voc, None, 0.7, compute_dtype=torch.float32)


def _train(st: dict, ckpt_dir: str, steps_draws=True, qk=False, scale_by_std=False,
           **kw):
    """Two Trainer steps of the tiny system on st's batches (JAX's draws, or
    the generator's with seed 3); returns the trainer and the metrics."""
    from maa3_tpu_torch.train.loop import Trainer
    tr = Trainer(_port_system(st, qk, scale_by_std), ckpt_dir=ckpt_dir, **TRAIN, **kw)
    metrics = []
    for i, raw in enumerate(st["raws"]):
        if steps_draws:
            metrics.append(tr.train_step(raw, draws=st["draws"][i]))
        else:
            metrics.append(tr.train_step(raw, seed=3))
    return tr, [{k: float(v) for k, v in m.items()} for m in metrics]


def _result(tr, metrics) -> dict:
    """The whole parameters and EMA shadows (a collective), each parameter's
    local shape, the metrics."""
    full = tr._full_params()["dit"]
    ema = tr._gather_list(tr.state.ema)
    return {"params": {n: t.detach().clone() for n, t in full.items()},
            "ema": [e.clone() for e in ema],
            "shapes": {n: tuple(p.shape) for n, p in tr.state.dit.named_parameters()},
            "metrics": metrics, "scale_factor": tr.state.scale_factor}


def _forward(st: dict, mesh, seq_parallel: bool) -> dict:
    """The qk_norm DiT's forward and the gradients of sum(out^2), its
    parameters sharded over mesh's model group."""
    import dataclasses
    from maa3_tpu_torch.models.dit import dit_apply
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.parallel.tp import TP
    dit = _port_system(st, qk=True).dit.requires_grad_(True)
    dit.cfg = dataclasses.replace(dit.cfg, seq_parallel=seq_parallel)
    specs = pmesh.dit_param_specs(dict(dit.named_parameters()))
    if mesh is not None:
        pmesh.shard_params_(dit, specs, mesh)
        dit.tp = TP.of(mesh)
    x, t, c = st["fwd"]
    out = dit_apply(dit, x, t, c, compute_dtype=torch.float32, training=True)
    (out ** 2).sum().backward()
    grads = {n: (p.grad if mesh is None else pmesh.gather_tensor(p.grad, specs[n], mesh))
             for n, p in dit.named_parameters()}
    return {"out": out.detach(), "grads": grads}


def _serve(st: dict, mesh) -> dict:
    """sample_cfg of the tiny system (4 steps, guidance 3) in fp32, int8 and
    int8:g32, on one device (mesh None) or sharded over mesh; with each int8
    mode this rank's codes and scales."""
    from maa3_tpu_torch.ops.quant import quant_weights
    s = _port_system(st)
    s.dit.requires_grad_(False)
    if mesh is not None:
        s.shard_serving(mesh)
    ctx, uc, x0 = st["serve"]
    out = {}
    for mode in (None, "int8", "int8:g32"):
        s.set_serving_quant(mode)
        out[mode] = s.sample_cfg(ctx, 3.0, uc, x0=x0, timesteps=4)
        if mode:
            out[mode + "/codes"] = {n: (q.w_q.clone(), q.w_scale.clone())
                                    for n, q in quant_weights(s.serving_dit()).items()}
    return out


def _task_w2(rank: int, d: str) -> dict:
    """Two ranks: DP, FSDP on data 2, TP and TP + SP steps on model 2, a TP
    checkpoint, the sharded forward and gradients, serving on 1 x 2."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    out = {}
    tr, m = _train(st, os.path.join(d, "dp"))
    out["dp"] = _result(tr, m) | {"mesh": tr.mesh.shape}
    tr, m = _train(st, os.path.join(d, "dp_gen"), steps_draws=False, scale_by_std=True)
    out["dp_gen"] = _result(tr, m)
    tr, m = _train(st, os.path.join(d, "fsdp"), fsdp=True, fsdp_min_size=1024)
    out["fsdp"] = _result(tr, m)
    tr, m = _train(st, os.path.join(d, "tp"), n_model=2)
    out["tp"] = _result(tr, m) | {"mesh": tr.mesh.shape}
    out["ckpt"] = tr.save_checkpoint()
    tr, m = _train(st, os.path.join(d, "tp_sp"), n_model=2, seq_parallel=True)
    out["tp_sp"] = _result(tr, m)
    tr, m = _train(st, os.path.join(d, "tp_qk"), qk=True, n_model=2, seq_parallel=True)
    out["tp_qk"] = _result(tr, m)
    mesh = pmesh.make_mesh(n_model=2)
    out["fwd"] = _forward(st, mesh, False)
    out["fwd_sp"] = _forward(st, mesh, True)
    out["serve"] = _serve(st, mesh)
    out["refused"] = {}
    for name, call in (
            ("mesh", lambda: pmesh.make_mesh(n_model=3)),
            ("fuse", lambda: _train(st, os.path.join(d, "x"), n_model=2, fuse_gemms=True)),
            ("pipe_mesh", lambda: pmesh.make_pipe_mesh(n_pipe=2, n_model=2)),
            ("pipe_trainer", lambda: _train(st, os.path.join(d, "x"), n_pipe=2,
                                            n_model=2))):
        try:
            call()
        except (ValueError, NotImplementedError) as e:
            out["refused"][name] = f"{type(e).__name__}: {e}"
    return out


def _task_w4(rank: int, d: str) -> dict:
    """Four ranks: FSDP x TP x SP on 2 x 2, serving on 2 x 2."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    st = torch.load(os.path.join(d, "payload.pt"), weights_only=False)
    tr, m = _train(st, os.path.join(d, "fsdp_tp"), n_model=2, fsdp=True,
                   fsdp_min_size=1024, seq_parallel=True)
    out = {"fsdp_tp": _result(tr, m) | {"mesh": tr.mesh.shape}}
    out["serve"] = _serve(st, pmesh.make_mesh(n_model=2))
    return out


def _task_cli(rank: int, d: str) -> dict:
    """Two ranks: the training CLI with --fsdp (data 2), txt2audio with
    --n_model 2, the server with --n_model 2 answering one request."""
    from maa3_tpu_torch.system import MAA3System
    st = torch.load(os.path.join(d, "cli.pt"), weights_only=False)
    sys.modules["torch.utils.tensorboard"] = None      # the log line without TF
    MAA3System.from_config = _tiny_from_config()
    out = {"train": _cli_train(st, os.path.join(d, "cli_train"), ["--fsdp"])}
    out["txt2audio"] = _cli_txt2audio(st, os.path.join(d, "cli_t2a"), ["--n_model", "2"])
    out["serve"] = _cli_serve(st, ["--n_model", "2"])
    return out


TASKS = {"w2": _task_w2, "w4": _task_w4, "cli": _task_cli}


def _rank_main(rank: int, world: int, init: str, task: str, d: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                            world_size=world)
    try:
        out = TASKS[task](rank, d)
        torch.save(out, os.path.join(d, f"{task}_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spawn(d: str, task: str, world: int, rank_main=None) -> list:
    """Run rank_main (default: this module's, which runs TASKS[task]) on
    `world` gloo ranks; their results, by rank. A rank that raises, or a run
    past TIMEOUT, fails the test."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(rank_main or _rank_main,
                             args=(world, os.path.join(d, f"pg_{task}"), task, d),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, f"{task}: ranks still running after {TIMEOUT} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
            assert not p.is_alive()
    return [torch.load(os.path.join(d, f"{task}_{r}.pt"), weights_only=False)
            for r in range(world)]


# -- the CLIs (a rank calls their main in-process, the group already started) ------

UP = "model.params.unet_config.params."
DD = "model.params.first_stage_config.params.ddconfig."
CLI_OVER = [UP + "hidden_size=32", UP + "depth=2", UP + "num_heads=2", UP + "context_dim=16",
            UP + "multiple_of=16", DD + "ch=32", DD + "ch_mult=[1, 2]",
            DD + "num_res_blocks=1", "model.params.cond_stage_trainable=false"]


def _tiny_from_config(extra=()):
    """MAA3System.from_config with a tiny conditioner and vocoder (and the
    overrides CLI_OVER + extra)."""
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System
    real = MAA3System.from_config.__func__

    def small(cls, paths, overrides=(), *a, **kw):
        kw.update(clap_cfg=CLAPFLANConfig(
            bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32),
            t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2), d_proj=16),
            voc_cfg=BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                  upsample_initial_channel=32))
        return real(cls, paths, list(overrides) + CLI_OVER + list(extra), *a, **kw)

    return classmethod(small)


def _cli_train(st: dict, ckpt_dir: str, extra) -> dict:
    from maa3_tpu_torch.train import __main__ as cli
    m = cli.main(["-b", XL, "-t", "--device", "cpu", "--fp32", "--max_steps", "2",
                  "--batch_size", "4", "--log_every", "1", "--ckpt_dir", ckpt_dir,
                  *extra, f"data.params.train.params.dataset_cfg.dataset_name={st['tsv']}",
                  "data.params.train.params.dataset_cfg.spec_crop_len=64"])
    return {k: m[k] for k in ("loss", "grad_norm", "step")}


def _cli_txt2audio(st: dict, outdir: str, extra) -> np.ndarray:
    from maa3_tpu_torch import txt2audio
    txt2audio.main(["-b", XL, "--prompt", "a bird chirps", "--outdir", outdir,
                    "--steps", "3", "-W", "8", "--n_samples", "2", "--fp32",
                    "--device", "cpu", *extra])
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() != 0:
        return None
    return np.stack([_read_wav(os.path.join(outdir, f"prompt_{i}.wav")) for i in range(2)])


def _read_wav(path: str) -> np.ndarray:
    import wave
    with wave.open(path) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32)


def _cli_serve(st: dict, extra):
    """The serve CLI; rank 0's serve_forever answers one request then
    shuts the server down. Returns rank 0's wav bytes."""
    import json
    import urllib.request
    from maa3_tpu_torch import serve
    from maa3_tpu_torch.serving import AudioServer
    from maa3_tpu_torch.system import MAA3System
    MAA3System.from_config = _tiny_from_config(["model.params.mel_length=8"])
    got = {}

    def one_request(self):
        self.start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{self.port}/generate",
            data=json.dumps({"prompt": "a cello", "seed": 5, "steps": 3}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            got["wav"] = r.read()
        self.shutdown()

    previous = AudioServer.serve_forever
    AudioServer.serve_forever = one_request
    try:
        serve.main(["-b", XL, "--port", "0", "--host", "127.0.0.1", "--warmup", "",
                    "--precision", "fp32", "--device", "cpu", *extra])
    finally:
        AudioServer.serve_forever = previous
    return got.get("wav")


# -- the parent: JAX's results and the port on one rank ----------------------------------

def _np(tree):
    import jax
    return jax.tree.map(np.asarray, tree)


def _step_draws(key, zshape):
    """The draws of one JAX train step from `key` (maa3_tpu/train/step.py: the
    posterior noise from the first half, the CFM timesteps and noise from the
    second)."""
    import jax
    import jax.numpy as jnp
    kvae, kcfm = jax.random.split(key)
    kt, kn = jax.random.split(kcfm)
    return {"noise": torch.tensor(np.asarray(jax.random.normal(kvae, zshape, jnp.float32))),
            "t_int": torch.tensor(np.asarray(jax.random.randint(kt, (zshape[0],), 0, 1000))),
            "x0": torch.tensor(np.asarray(jax.random.normal(kn, zshape, jnp.float32)))}


def _jax_system(pd, pv, qk=False):
    import jax.numpy as jnp
    from maa3_tpu.config import ModelSpec as JSpec
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.system import MAA3System as JSystem
    spec = JSpec(kind="cfm", backbone_kind="text_dit",
                 dit=jdit.DiTConfig(**DIT, max_len=128, qk_norm=qk), vae=jvae.VAEConfig(**VAE),
                 cond_kind="clap_flan", cond_params_cfg={}, mel_dim=4, mel_length=20,
                 scale_by_std=False, scale_factor=0.7, cond_stage_trainable=False,
                 base_learning_rate=1e-4)
    return JSystem(spec, {"dit": pd, "vae": pv}, scale_factor=0.7, compute_dtype=jnp.float32)


def _jax_fit(js, d, raws, **kw):
    """JAX's Trainer on the 8-device mesh, one fit of one step per batch;
    its parameters and EMA shadows in the port's names, its metrics."""
    from maa3_tpu.train.loop import Trainer as JTrainer
    from maa3_tpu_torch.weights import dit_from_jax
    jt = JTrainer(js, ckpt_dir=d, **TRAIN, **kw)
    metrics = [jt.fit(iter([raw]), max_steps=1, seed=s) for raw, s in zip(raws, SEEDS)]
    return {"params": dit_from_jax(_np(jt.state.params["dit"])),
            "ema": dit_from_jax(_np(jt.state.ema_params["dit"])),
            "metrics": metrics, "mesh": dict(jt.mesh.shape)}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """JAX's results on its mesh, the payload the ranks read, and the port's
    one-rank results."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.parallel.mesh import batch_sharding, dit_param_specs, make_mesh
    from maa3_tpu.train.loop import Trainer as JTrainer
    from maa3_tpu.utils.nprand import unfreeze_zero_init
    from maa3_tpu_torch.weights import dit_from_jax, vae_from_jax

    d = str(tmp_path_factory.mktemp("parallel"))
    jcfg = jdit.DiTConfig(**DIT, max_len=128)
    jcfg_qk = jdit.DiTConfig(**DIT, max_len=128, qk_norm=True)
    pd = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(0), jcfg), jax.random.PRNGKey(1))
    pd_qk = unfreeze_zero_init(jdit.dit_init(jax.random.PRNGKey(3), jcfg_qk),
                               jax.random.PRNGKey(4))
    pv = jvae.vae_init(jax.random.PRNGKey(2), jvae.VAEConfig(**VAE))
    rng = np.random.RandomState(7)
    raws = [{"image": rng.randn(B, 16, 40).astype(np.float32),
             "context": rng.randn(B, 6, 32).astype(np.float32)} for _ in SEEDS]
    x = rng.randn(8, 4, 32).astype(np.float32)
    t = (np.arange(8) * 100).astype(np.int64)
    c = rng.randn(8, 5, 32).astype(np.float32)
    ctx = rng.randn(2, 6, 32).astype(np.float32)
    x0 = rng.randn(2, 4, 20).astype(np.float32)
    st = {"dit": dit_from_jax(_np(pd)), "dit_qk": dit_from_jax(_np(pd_qk)),
          "vae": vae_from_jax(_np(pv)), "raws": raws,
          "draws": [_step_draws(jax.random.split(jax.random.PRNGKey(s))[1], ZSHAPE)
                    for s in SEEDS],
          "fwd": (torch.tensor(x), torch.tensor(t), torch.tensor(c)),
          "serve": (torch.tensor(ctx), torch.zeros(2, 6, 32), torch.tensor(x0))}
    torch.save(st, os.path.join(d, "payload.pt"))

    out = {"d": d, "st": st}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTrainer, "_log", lambda self, m: None)   # no TensorBoard
        # the most sharded JAX step: FSDP x TP x SP on data 4 x model 2
        out["jax"] = _jax_fit(_jax_system(pd, pv), os.path.join(d, "j"), raws, n_model=2,
                              fsdp=True, fsdp_min_size=1024, seq_parallel=True)
        out["jax_qk"] = _jax_fit(_jax_system(pd_qk, pv, qk=True), os.path.join(d, "jq"),
                                 raws, n_model=2, seq_parallel=True)
    # the qk_norm DiT's forward and gradients, SP, on data 4 x model 2
    mesh = make_mesh(4, 2)
    cfg_sp = jdit.DiTConfig(**DIT, max_len=128, qk_norm=True, seq_parallel=True)
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)),
                           pd_qk, dit_param_specs(pd_qk))
    xs = [jax.device_put(jnp.asarray(a), batch_sharding(mesh, a.ndim)) for a in (x, t, c)]

    def f(p, x, t, c):
        return jdit.dit_apply(p, cfg_sp, x, t, c, compute_dtype=jnp.float32, training=True)

    with jax.set_mesh(mesh):
        out["jax_fwd"] = np.asarray(jax.jit(f)(sharded, *xs))
        g = jax.jit(jax.grad(lambda p: jnp.sum(f(p, *xs) ** 2)))(sharded)
    out["jax_grads"] = dit_from_jax(_np(g))
    # tensor-parallel serving on model 2, fp32
    js = _jax_system(pd, pv)
    js.shard_serving(make_mesh(1, 2, devices=jax.devices()[:2]))
    out["jax_serve"] = np.asarray(js.sample_cfg(jnp.asarray(ctx), 3.0, jnp.zeros((2, 6, 32)),
                                                jax.random.PRNGKey(0), timesteps=4,
                                                x0=jnp.asarray(x0)))
    # the port on one rank
    tr, m = _train(st, os.path.join(d, "one"))
    out["one"] = _result(tr, m)
    tr, m = _train(st, os.path.join(d, "one_gen"), steps_draws=False, scale_by_std=True)
    out["one_gen"] = _result(tr, m)
    tr, m = _train(st, os.path.join(d, "one_qk"), qk=True)
    out["one_qk"] = _result(tr, m)
    out["one_fwd"] = _forward(st, None, False)
    out["one_serve"] = _serve(st, None)
    return out


@pytest.fixture(scope="module")
def w2(ref):
    return _spawn(ref["d"], "w2", 2)


@pytest.fixture(scope="module")
def w4(ref):
    return _spawn(ref["d"], "w4", 4)


def _check_step(got, one, jax_ref, ema=True):
    """Parameters (and EMA shadows) after two steps: several ranks against
    one rank at the JAX tests' rule, and against JAX at the port's."""
    for (n, p), (n1, p1) in zip(got["params"].items(), one["params"].items()):
        assert n == n1
        _cmp(p, p1, **STEP)
        _cmp(p, jax_ref["params"][n])
    if ema:
        for e, e1, n in zip(got["ema"], one["ema"], one["params"]):
            _cmp(e, e1, **STEP)
            _cmp(e, jax_ref["ema"][n])
    for m, m1, mj in zip(got["metrics"], one["metrics"], jax_ref["metrics"]):
        for k in ("loss", "grad_norm"):
            _cmp(m[k], m1[k], **STEP)
            _cmp(m[k], mj[k])


def test_one_rank_step_matches_jax_mesh(ref):
    """The port's Trainer on one rank against JAX's on data 4 x model 2 with
    FSDP and SP (the same function of the same draws)."""
    assert ref["jax"]["mesh"] == {"data": 4, "model": 2}
    _check_step(ref["one"], ref["one"], ref["jax"])


def test_data_parallel_step(ref, w2):
    """DP on data 2: each rank takes its 4 rows of the 8; the step equals
    one rank's and JAX's, on both ranks."""
    assert w2[0]["dp"]["mesh"] == {"data": 2, "model": 1}
    for r in w2:
        _check_step(r["dp"], ref["one"], ref["jax"])


def test_data_parallel_draws_for_the_global_batch(ref, w2):
    """With the generator's own draws and the std rescale on: the two ranks
    draw the noise, timesteps and flow noise of the whole batch and take
    their rows, and the rescale's std is the whole batch's."""
    one = ref["one_gen"]
    for r in w2:
        got = r["dp_gen"]
        assert got["scale_factor"] == pytest.approx(one["scale_factor"], rel=1e-6)
        for n, p in got["params"].items():
            _cmp(p, one["params"][n], **STEP)
        for m, m1 in zip(got["metrics"], one["metrics"]):
            _cmp(m["loss"], m1["loss"], **STEP)


def _jax_local_shapes(st, n_data, n_model, fsdp):
    """Each parameter's per-rank shape under JAX's specs (dit_param_specs,
    then add_fsdp_specs at min_size 1024), in the port's names."""
    import jax
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.parallel.mesh import add_fsdp_specs, dit_param_specs
    p = jdit.dit_init(jax.random.PRNGKey(0), jdit.DiTConfig(**DIT, max_len=128))
    specs = dit_param_specs(p)
    if fsdp:
        specs = add_fsdp_specs(p, specs, n_data, min_size=1024)
    port = _as_port_specs(p, specs)
    sizes = {"model": n_model, "data": n_data}
    return {n: tuple(s // (sizes[a] if a else 1) for s, a in zip(st["dit"][n].shape, spec))
            for n, spec in port.items()}


def _as_port_specs(params, specs):
    """JAX's PartitionSpec tree as the port's placements by name: each
    sharded dim is found by writing its index into an array of the leaf's
    shape and mapping the arrays with weights.dit_from_jax (which slices the
    depth axis and transposes the matmul weights)."""
    import jax
    from maa3_tpu_torch.weights import dit_from_jax
    found = {}
    for axis in ("model", "data"):
        def enc(x, spec):
            a = np.zeros(x.shape, np.float32)
            for dim, s in enumerate(tuple(spec)):
                if s == axis:
                    a = a + np.arange(x.shape[dim]).reshape(
                        [-1 if i == dim else 1 for i in range(x.ndim)])
            return a
        for n, t in dit_from_jax(jax.tree.map(enc, params, specs)).items():
            a = t.numpy()
            dims = [dim for dim in range(a.ndim) if np.any(np.diff(a, axis=dim) != 0)]
            assert len(dims) <= 1, (n, axis, dims)
            found.setdefault(n, [None] * a.ndim)
            if dims:
                found[n][dims[0]] = axis
    return {n: tuple(v) for n, v in found.items()}


def test_fsdp_step_data_2(ref, w2):
    """FSDP over data 2 (min_size 1024): each rank stores the shard JAX's
    specs give; the step equals one rank's and JAX's."""
    want = _jax_local_shapes(ref["st"], 2, 1, fsdp=True)
    for r in w2:
        assert r["fsdp"]["shapes"] == want
        _check_step(r["fsdp"], ref["one"], ref["jax"])
    assert any(want[n] != tuple(t.shape) for n, t in ref["st"]["dit"].items())


def test_fsdp_tp_seq_parallel_step_2x2(ref, w4):
    """FSDP over data 2 x TP over model 2 with SP, on four ranks: JAX's
    per-rank shapes, and the step equals one rank's and JAX's."""
    want = _jax_local_shapes(ref["st"], 2, 2, fsdp=True)
    assert w4[0]["fsdp_tp"]["mesh"] == {"data": 2, "model": 2}
    for r in w4:
        assert r["fsdp_tp"]["shapes"] == want
        _check_step(r["fsdp_tp"], ref["one"], ref["jax"])


@pytest.mark.parametrize("variant", ["tp", "tp_sp"])
def test_tensor_parallel_step(ref, w2, variant):
    """TP over model 2, SP off and on: JAX's per-rank shapes; the step
    equals one rank's and JAX's."""
    want = _jax_local_shapes(ref["st"], 1, 2, fsdp=False)
    assert w2[0]["tp"]["mesh"] == {"data": 1, "model": 2}
    for r in w2:
        assert r[variant]["shapes"] == want
        _check_step(r[variant], ref["one"], ref["jax"])


def test_tensor_parallel_qk_norm_step(ref, w2):
    """qk_norm's LayerNorms over sharded heads (all-reduced statistics),
    with SP: the step equals one rank's and JAX's (n_model 2 on its mesh)."""
    for r in w2:
        _check_step(r["tp_qk"], ref["one_qk"], ref["jax_qk"])


@pytest.mark.parametrize("variant", ["fwd", "fwd_sp"])
def test_tensor_parallel_forward_and_grads(ref, w2, variant):
    """The qk_norm DiT's forward and the gradients of sum(out^2) over model
    2, SP off and on: equal to one rank's (the JAX test's 1e-5 / 1e-4) and
    to JAX's sharded forward and gradients at the port's rule."""
    one = ref["one_fwd"]
    _cmp(one["out"], ref["jax_fwd"])
    for r in w2:
        got = r[variant]
        _cmp(got["out"], one["out"], rtol=1e-5, atol=1e-5)
        _cmp(got["out"], ref["jax_fwd"])
        for n, g in got["grads"].items():
            _cmp(g, one["grads"][n], rtol=1e-4, atol=1e-5)
            _cmp(g, ref["jax_grads"][n], rtol=1e-3, atol=1e-4)


def _check_serving(got, one, mesh_model: int, rank: int):
    """Latents against one device's; every int8 code and scale this rank
    holds equals its slice of one device's. An int8 activation code on a
    rounding boundary flips under any reordering of the fp32 sums (on one
    device, x0 x (1 + 1e-7 eps) moves one of these 160 latents by 6.5e-5),
    so the int8 latents are held by relative L2 <= 1e-4 (JAX's test: mean
    |dz| / rms < 5e-2) and max |dz| <= 1e-3, the float ones elementwise."""
    from maa3_tpu_torch.parallel.mesh import dit_param_specs, shard_tensor, Mesh
    for mode in (None, "int8", "int8:g32"):
        if mode == "int8":
            dz = got[mode] - one[mode]
            assert float(dz.norm() / one[mode].norm()) <= 1e-4
            assert float(dz.abs().max()) <= 1e-3
        else:
            _cmp(got[mode], one[mode], **SERVE)
        if not mode:
            continue
        codes, want = got[mode + "/codes"], one[mode + "/codes"]
        assert sorted(codes) == sorted(want)
        mesh = Mesh(n_model=mesh_model, model_rank=rank % mesh_model)
        for n, (w_q, w_s) in codes.items():
            full_q, full_s = want[n]
            specs = dit_param_specs({n + ".w_q": full_q, n + ".w_scale": full_s})
            if n.endswith(("wqkv", "w13")):   # the rank's part of each fused block
                parts = 3 if n.endswith("wqkv") else 2
                dim = 1 if full_q.dim() == 3 else 0
                exp_q = torch.cat([shard_tensor(b, specs[n + ".w_q"], mesh)
                                   for b in full_q.chunk(parts, dim)], dim)
                exp_s = torch.cat([shard_tensor(b, specs[n + ".w_scale"], mesh)
                                   for b in full_s.chunk(parts, dim)], dim)
            else:
                exp_q = shard_tensor(full_q, specs[n + ".w_q"], mesh)
                exp_s = shard_tensor(full_s, specs[n + ".w_scale"], mesh)
            assert torch.equal(w_q, exp_q), n
            assert torch.equal(w_s, exp_s), n


def test_tensor_parallel_serving_1x2(ref, w2):
    """shard_serving on 1 x 2 in fp32 (the fused serving layout), int8 and
    int8:g32: one device's latents and int8 codes; fp32 also against JAX's
    tensor-parallel sampler."""
    for rank, r in enumerate(w2):
        _check_serving(r["serve"], ref["one_serve"], 2, rank)
        _cmp(r["serve"][None], ref["jax_serve"])


def test_tensor_parallel_serving_2x2(ref, w4):
    """shard_serving on 2 x 2: each data rank samples one of the two rows,
    the latents are gathered; one device's latents and codes."""
    for rank, r in enumerate(w4):
        _check_serving(r["serve"], ref["one_serve"], 2, rank)


def test_two_rank_checkpoint_loads_at_world_size_one(ref, w2, tmp_path):
    """The TP=2 trainer's checkpoint (rank 0 writes the gathered state)
    loaded by a one-rank Trainer: the whole parameters, EMA shadows and
    moments, and its next step equals the one-rank trainer's."""
    from maa3_tpu_torch.train.loop import Trainer
    path = w2[0]["ckpt"]
    assert w2[1]["ckpt"] == path
    payload = torch.load(path, weights_only=True)
    for n, p in w2[0]["tp"]["params"].items():
        assert torch.equal(payload["params"]["dit"][n], p)
    tr = Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path), **TRAIN)
    tr.restore_checkpoint(path)
    assert tr.state.step == 2
    for n, p in tr.state.dit.named_parameters():
        _cmp(p, ref["one"]["params"][n], **STEP)
    one, _ = _train(ref["st"], str(tmp_path / "again"))
    raw, dr = ref["st"]["raws"][0], ref["st"]["draws"][0]
    tr.train_step(raw, draws=dr)
    one.train_step(raw, draws=dr)
    for p, q in zip(tr.state.dit.parameters(), one.state.dit.parameters()):
        _cmp(p, q.detach(), **STEP)


def test_refusals_on_two_ranks(w2):
    """n_model 3 on a world of 2 raises (no fallback to one device);
    fuse_gemms with n_model > 1 raises, as in JAX; a pipe mesh (and the
    Trainer's) of n_pipe 2 x n_model 2 on a world of 2 raises."""
    for r in w2:
        got = r["refused"]
        assert "does not divide the world size 2" in got["mesh"]
        assert got["fuse"].startswith("ValueError: fuse_gemms training requires")
        for k in ("pipe_mesh", "pipe_trainer"):
            assert got[k] == ("ValueError: n_pipe=2 x n_model=2 does not divide the "
                              "world size 2")


def test_refusals_on_one_process(ref, tmp_path, capsys):
    """Without a process group, n_model 2 raises in the Trainer and the three
    CLIs, and n_pipe 2 / n_expert 2 in the training CLI (no fallback to one
    device); fsdp on one data rank is a no-op that says so."""
    from maa3_tpu_torch import serve, txt2audio
    from maa3_tpu_torch.train import __main__ as cli
    from maa3_tpu_torch.train.loop import Trainer
    with pytest.raises(ValueError, match="no process group is initialised"):
        Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path), n_model=2)
    tr = Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path), fsdp=True)
    assert not tr.fsdp and not tr.sharded
    assert "fsdp: a no-op on a data dim of width 1" in capsys.readouterr().out
    for main, argv in ((cli.main, ["-b", XL]), (txt2audio.main, ["-b", XL]),
                       (serve.main, ["-b", XL])):
        with pytest.raises(ValueError, match="n_model=2: .* no process group"):
            main(argv + ["--n_model", "2", "--device", "cpu"])
    for flag in ("--n_pipe", "--n_expert"):
        with pytest.raises(ValueError, match=f"{flag[2:]}=2: .* no process group"):
            cli.main(["-b", XL, flag, "2", "--device", "cpu"])


def _port_moe_system():
    """A tiny port video-MoE system (random weights; no conditioner)."""
    from maa3_tpu_torch import config as tconfig
    from maa3_tpu_torch.models import vae1d as tvae
    from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
    from maa3_tpu_torch.models.dit_moe import MoEDiT, MoEDiTConfig
    from maa3_tpu_torch.system import MAA3System
    cfg = MoEDiTConfig(in_channels=4, context_dim=16, hidden_size=32, depth=2, num_heads=4,
                       multiple_of=16, num_experts=4)
    spec = tconfig.ModelSpec(dit=cfg, vae=tvae.VAEConfig(**VAE), mel_dim=4, mel_length=16,
                             cond_kind="video_feat", backbone_kind="video_moe_dit")
    voc = BigVGAN(BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                upsample_initial_channel=32))
    return MAA3System(spec, MoEDiT(cfg), tvae.AutoencoderKL(spec.vae), voc, None, 1.0,
                      compute_dtype=torch.float32)


# JAX's refusals of pipeline and expert parallelism (maa3_tpu/train/loop.py:
# 106-129): the backbone ("text" / "moe") and the Trainer's arguments
JAX_REFUSALS = {
    "pipe_fsdp": ("text", dict(n_pipe=2, fsdp=True)),
    "pipe_fuse_gemms": ("text", dict(n_pipe=2, fuse_gemms=True)),
    "pipe_seq_parallel": ("text", dict(n_pipe=2, seq_parallel=True)),
    "pipe_moe": ("moe", dict(n_pipe=2)),
    "expert_text_dit": ("text", dict(n_expert=2)),
    "expert_pipe": ("moe", dict(n_expert=2, n_pipe=2)),
}


@pytest.mark.parametrize("case", sorted(JAX_REFUSALS))
def test_pipe_and_expert_refusals_match_jax(ref, tmp_path, case):
    """Each combination JAX's Trainer refuses, the port's refuses with the
    same ValueError message (before any mesh is made)."""
    import jax
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.models import vae1d as jvae
    from maa3_tpu.train.loop import Trainer as JTrainer
    from maa3_tpu_torch.train.loop import Trainer
    from tests.test_parallel import _tiny_video_system
    kind, kw = JAX_REFUSALS[case]
    if kind == "text":
        pd = jdit.dit_init(jax.random.PRNGKey(0), jdit.DiTConfig(**DIT, max_len=128))
        js = _jax_system(pd, jvae.vae_init(jax.random.PRNGKey(2), jvae.VAEConfig(**VAE)))
        ts = _port_system(ref["st"])
    else:
        js, ts = _tiny_video_system(), _port_moe_system()
    with pytest.raises(ValueError) as want:
        JTrainer(js, batch_size=8, ckpt_dir=str(tmp_path / "j"), **kw)
    with pytest.raises(ValueError) as got:
        Trainer(ts, batch_size=8, ckpt_dir=str(tmp_path / "t"), **kw)
    assert str(got.value) == str(want.value)


def test_n_micro_without_pipe_is_a_no_op(ref, tmp_path, capsys):
    """n_micro > 1 with n_pipe 1 is JAX's no-op (its pipelined apply runs
    only for n_pipe > 1): the Trainer says so in one line and steps as
    without it."""
    from maa3_tpu_torch.train.loop import Trainer
    tr = Trainer(_port_system(ref["st"]), ckpt_dir=str(tmp_path), **TRAIN, n_micro=4)
    assert "n_micro=4: a no-op without n_pipe > 1 (as in JAX)" in capsys.readouterr().out
    assert not tr.sharded and tr.mesh.shape == {"data": 1, "model": 1}
    for i, raw in enumerate(ref["st"]["raws"]):
        tr.train_step(raw, draws=ref["st"]["draws"][i])
    for n, p in tr.state.dit.named_parameters():
        _cmp(p, ref["one"]["params"][n], rtol=0, atol=0)


def test_train_cli_accepts_jax_command_line():
    """scripts/train.py's documented command line (README, the train-to-eval
    script): -t is accepted and ignored; the parallelism flags parse with
    JAX's defaults."""
    from maa3_tpu_torch.train import __main__ as cli
    opt = cli.parse_args(["-b", "configs/txt2audio-cfm-cfg.yaml", "-t"])
    assert opt.train and opt.base == ["configs/txt2audio-cfm-cfg.yaml"]
    assert (opt.n_model, opt.fsdp, opt.seq_parallel, opt.n_pipe, opt.n_micro,
            opt.n_expert, opt.multihost) == (1, False, False, 1, 1, 1, False)
    opt = cli.parse_args(["-b", "c.yaml", "--train", "--n_model", "2", "--fsdp",
                          "--seq_parallel", "--multihost", "k=v"])
    assert (opt.n_model, opt.fsdp, opt.seq_parallel, opt.multihost,
            opt.overrides) == (2, True, True, True, ["k=v"])
    opt = cli.parse_args(["-b", "c.yaml", "-t", "--n_pipe", "2", "--n_micro", "4",
                          "--n_expert", "2"])
    assert (opt.n_pipe, opt.n_micro, opt.n_expert) == (2, 4, 2)


def test_torchrun_world_that_n_model_does_not_divide():
    """torchrun --standalone with 2 gloo ranks (the env:// path of
    init_distributed) and --n_model 3: every rank raises."""
    import subprocess
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "maa3_tpu_torch.train", "-b", XL, "-t",
         "--device", "cpu", "--n_model", "3"],
        capture_output=True, text=True, timeout=180, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert (out.stdout + out.stderr).count("n_model=3 does not divide the world size 2") >= 2


# -- the sampler, the placements ------------------------------------------------------------

@pytest.mark.parametrize("n,batch,replicas,drop_last", [
    (40, 4, 2, False), (41, 4, 2, False), (41, 4, 2, True), (10, 4, 3, True),
    (10, 4, 3, False), (3, 4, 2, False), (5, 2, 4, True), (0, 4, 2, False)])
def test_sampler_split_matches_jax(n, batch, replicas, drop_last):
    """BucketBatchSampler(num_replicas, rank, drop_last) against JAX's, every
    rank, two epochs."""
    from maa3_tpu.data.datasets import BucketBatchSampler as JSampler
    from maa3_tpu_torch.data.datasets import BucketBatchSampler
    for rank in range(replicas):
        a = BucketBatchSampler(range(n), batch, num_replicas=replicas, rank=rank,
                               seed=7, drop_last=drop_last)
        b = JSampler(list(range(n)), batch, num_replicas=replicas, rank=rank, seed=7,
                     drop_last=drop_last)
        for epoch in (0, 1):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b) and len(a) == len(b)


def test_dit_param_specs_match_jax():
    """The port's placements of every DiT parameter (qk_norm on) and of the
    video MoE's, name by name, against JAX's PartitionSpec tree mapped
    through weights.dit_from_jax."""
    import jax
    from maa3_tpu.models import dit as jdit
    from maa3_tpu.models.dit_moe import MoEDiTConfig, moe_dit_init
    from maa3_tpu.parallel import mesh as jmesh
    from maa3_tpu_torch.models import dit as tdit
    from maa3_tpu_torch.parallel.mesh import dit_param_specs
    from maa3_tpu_torch.weights import dit_from_jax
    p = jdit.dit_init(jax.random.PRNGKey(0), jdit.DiTConfig(**DIT, max_len=128, qk_norm=True))
    want = _as_port_specs(p, jmesh.dit_param_specs(p))
    got = dit_param_specs(dict(tdit.DiT(tdit.DiTConfig(**DIT, qk_norm=True)).named_parameters()))
    assert got == want
    assert got["blocks.0.attention.wq.weight"] == ("model", None)
    assert got["blocks.1.feed_forward.w2.weight"] == (None, "model")
    assert got["blocks.0.attention.gate"] == ("model",)
    assert got["blocks.0.adaLN_modulation.1.weight"] == (None, None)
    cfg = MoEDiTConfig(in_channels=4, context_dim=16, hidden_size=32, depth=2, num_heads=2,
                       max_len=16, multiple_of=16, num_experts=4)
    pm = moe_dit_init(jax.random.PRNGKey(0), cfg)
    got = dit_param_specs(dit_from_jax(_np(pm)))
    assert got == _as_port_specs(pm, jmesh.dit_param_specs(pm))
    assert got["blocks.0.feed_forward.time_experts.0.w1.weight"] == ("model", None)


def test_dit_param_specs_guard_and_int8_rule():
    """The coverage guard raises on a large block tensor no rule names; the
    int8 scales follow the output dim (sharded for column weights,
    replicated for row weights); a grouped row weight shards its groups."""
    from maa3_tpu_torch.parallel.mesh import dit_param_specs
    with pytest.raises(ValueError, match="unrecognized large block leaf"):
        dit_param_specs({"blocks.0.mystery.weight": torch.empty(1024, 1025, device="meta")})
    assert dit_param_specs({"blocks.0.mystery.weight": torch.empty(1000, 1000,
                                                                   device="meta")})
    e = functools.partial(torch.empty, device="meta")
    got = dit_param_specs({
        "blocks.0.attention.wqkv.w_q": e(96, 32), "blocks.0.attention.wqkv.w_scale": e(96),
        "blocks.0.feed_forward.w2.weight.w_q": e(32, 96),
        "blocks.0.feed_forward.w2.weight.w_scale": e(32),
        "blocks.0.feed_forward.w13.w_q": e(3, 192, 32),
        "blocks.0.feed_forward.w13.w_scale": e(3, 192),
        "blocks.0.feed_forward.w2.weight.w_q.g": e(1)})
    assert got["blocks.0.attention.wqkv.w_q"] == ("model", None)
    assert got["blocks.0.attention.wqkv.w_scale"] == ("model",)
    assert got["blocks.0.feed_forward.w2.weight.w_q"] == (None, "model")
    assert got["blocks.0.feed_forward.w2.weight.w_scale"] == (None,)
    assert got["blocks.0.feed_forward.w13.w_q"] == (None, "model", None)
    assert got["blocks.0.feed_forward.w13.w_scale"] == (None, "model")
    grouped = dit_param_specs({"blocks.0.feed_forward.w2.weight.w_q": e(3, 32, 32),
                               "blocks.0.feed_forward.w2.weight.w_scale": e(3, 32)})
    assert set(grouped.values()) == {("model", None, None), ("model", None)}


def test_add_fsdp_specs_dim_choice_matches_jax():
    """JAX's test_add_fsdp_specs_dim_choice cases (28 stacked blocks,
    n_fsdp 8): the port's per-block weights, transposed, get the dims
    JAX's stacked leaves get."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from maa3_tpu.parallel.mesh import add_fsdp_specs as jadd
    from maa3_tpu_torch.parallel.mesh import add_fsdp_specs
    cases = {"col": ((28, 1152, 3072), P(None, None, "model")),
             "row": ((28, 3072, 1152), P(None, "model", None)),
             "plain": ((28, 1152, 6912), P()), "tiny": ((28, 64), P()),
             "odd": ((7, 11, 13), P())}
    jax_out = jadd({k: jax.ShapeDtypeStruct(s, jnp.float32) for k, (s, _) in cases.items()},
                   {k: sp for k, (_, sp) in cases.items()}, 8)
    assert jax_out["col"] == P(None, "data", "model")

    def port(shape, spec):   # drop the depth axis, transpose (in, out) -> (out, in)
        spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        return tuple(reversed(shape[1:])), tuple(reversed(spec[1:]))

    tensors, specs = {}, {}
    for k, (shape, sp) in cases.items():
        pshape, pspec = port(shape, sp)
        for i in range(shape[0]):
            tensors[f"blocks.{i}.{k}.weight"] = torch.empty(pshape, device="meta")
            specs[f"blocks.{i}.{k}.weight"] = pspec
    got = add_fsdp_specs(tensors, specs, 8)
    for k, (shape, _) in cases.items():
        assert got[f"blocks.0.{k}.weight"] == port(shape, jax_out[k])[1], k
    # the video MoE, with and without expert parallelism: JAX's stacked
    # expert leaves (depth, E, in, out) count depth x E times a port expert
    # tensor against min_size (at 16384 the per-expert tensors are 3072, the
    # stacks 24576), and with "expert" on E the rule picks among the others
    from maa3_tpu.models.dit_moe import MoEDiTConfig, moe_dit_init
    from maa3_tpu.parallel import mesh as jmesh
    from maa3_tpu_torch.parallel.mesh import dit_param_specs
    from maa3_tpu_torch.weights import dit_from_jax
    pm = moe_dit_init(jax.random.PRNGKey(0), MoEDiTConfig(
        in_channels=4, context_dim=16, hidden_size=32, depth=2, num_heads=2, max_len=16,
        multiple_of=16, num_experts=4))
    named = dit_from_jax(_np(pm))
    for ep in (1, 2):
        jspecs = jmesh.dit_param_specs(pm)
        if ep > 1:
            jspecs = jmesh.add_ep_specs(pm, jspecs, ep)
        want = _as_port_specs(pm, jadd(pm, jspecs, 2, min_size=16384))
        got = add_fsdp_specs(named, dit_param_specs(named), 2, min_size=16384)
        assert got == want
        assert got["blocks.0.feed_forward.time_experts.0.w1.weight"] == ("model", "data")


# -- the CLIs on two ranks ------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(ref):
    """The three CLIs on one process (the parent) and on two gloo ranks."""
    from maa3_tpu.data import datasets as jdata
    from maa3_tpu_torch.system import MAA3System
    d = ref["d"]
    rows = jdata.read_tsv(os.path.join(ROOT, "data", "synth", "manifest_mel.tsv"))[:4]
    tsv = os.path.join(d, "four.tsv")
    with open(tsv, "w") as f:
        f.write("\t".join(rows[0]) + "\n")
        for r in rows:
            r = dict(r, mel_path=os.path.join(ROOT, r["mel_path"]))
            f.write("\t".join(r.values()) + "\n")
    st = {"tsv": tsv}
    torch.save(st, os.path.join(d, "cli.pt"))
    one = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(MAA3System, "from_config", _tiny_from_config())
        one["train"] = _cli_train(st, os.path.join(d, "cli_train_one"), [])
        one["txt2audio"] = _cli_txt2audio(st, os.path.join(d, "cli_t2a_one"), [])
        one["serve"] = _cli_serve(st, [])
    return one, _spawn(d, "cli", 2)


def test_train_cli_two_ranks_fsdp(cli_runs):
    """python -m maa3_tpu_torch.train -t --fsdp on two gloo ranks (batch 4
    per node: 2 rows per rank, the global std rescale and draws): the loss
    and grad norm of each step equal the one-process run's."""
    one, ranks = cli_runs
    for r in ranks:
        assert r["train"]["step"] == one["train"]["step"] == 2
        _cmp(r["train"]["loss"], one["train"]["loss"], **STEP)
        _cmp(r["train"]["grad_norm"], one["train"]["grad_norm"], **STEP)


def test_txt2audio_cli_two_ranks(cli_runs):
    """txt2audio --n_model 2: rank 0 writes the wavs of one process's run
    (16-bit samples within 2 steps)."""
    one, ranks = cli_runs
    assert ranks[1]["txt2audio"] is None
    np.testing.assert_allclose(ranks[0]["txt2audio"], one["txt2audio"], atol=2.0, rtol=0)


def test_serve_cli_two_ranks(cli_runs):
    """serve --n_model 2: rank 0 answers over HTTP while rank 1 samples in
    lockstep; shutdown releases rank 1; the wav is one process's."""
    one, ranks = cli_runs
    assert ranks[1]["serve"] is None and len(ranks[0]["serve"]) == len(one["serve"])
    a = np.frombuffer(ranks[0]["serve"][44:], "<i2").astype(np.float32)
    b = np.frombuffer(one["serve"][44:], "<i2").astype(np.float32)
    np.testing.assert_allclose(a, b, atol=2.0, rtol=0)
