"""DiT training through the port's Trainer.fit, fed by the port's loader
(TextSpecDataset over a manifest, BucketBatchSampler, PrefetchLoader, as
the training CLI's build_loader builds them) over seeded log-mel .npy files
written under TMPDIR at set-up.

Set-up builds the one Trainer and drives it from the seed through its first
`setup_steps` steps with fit(max_steps=1), each through the window's own
call and feed on rows that all differ, reading the loss of each, the
clipped first gradient from AdamW's first moment after step 1, and each
leaf's change over those steps; that same Trainer then runs the window.
The window is fit() over the feed until the first step that ends at least
`seconds` after the window opened: train_tokens_per_s is the latent tokens
of every step in it over its time, synchronised at both ends.

Cell parameters: batch, spec_crop_len, files, drop, loader_workers (one:
the loader's caption drops then follow the rows' order), setup_steps,
captions, rows_per_block (the reference's), profile_at (the window's step
that opens the profiler), profile_steps."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np

from benchmark import checks, harness, profiling, reference, yardstick
from benchmark.weights import sub_seed


def write_data(P: dict, seed: int, root: str) -> str:
    """`files` seeded log-mels (80 x spec_crop_len, fp32) and their manifest."""
    from benchmark.traffic.serve import captions
    pool = captions(P["captions"])
    rng = np.random.default_rng(sub_seed(seed, "mels"))
    mels = (rng.standard_normal((P["files"], 80, P["spec_crop_len"]), dtype=np.float32) * 2.0
            - 4.0)
    caps = rng.integers(0, len(pool), size=P["files"])
    lines = ["name\tmel_path\tori_cap\tcaption"]
    for i in range(P["files"]):
        path = os.path.join(root, f"mel_{i:04d}.npy")
        np.save(path, mels[i])
        c = pool[caps[i]]
        lines.append(f"clip{i:04d}\t{path}\t{c}\t<{c}& all>")
    manifest = os.path.join(root, "train.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return manifest


class Window:
    """The feed of the window: yields batches until the first step that ends
    at or after the deadline, timing the host's wait on the loader, and
    opening the profiler over `profile_steps` steps from step `profile_at`."""

    def __init__(self, feed, seconds: float, device, stretch=None, profile_at=0,
                 profile_steps=3):
        self.feed, self.seconds, self.device = feed, seconds, device
        self.stretch, self.profile_at, self.profile_steps = stretch, profile_at, profile_steps
        self.waits, self.steps = [], 0
        self.t0 = self.t1 = None

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __iter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        while True:
            if self.steps and time.perf_counter() >= self.t0 + self.seconds:
                break
            st = self.stretch
            if st is not None:
                if self.steps == self.profile_at:
                    st.start()
                elif self.steps == self.profile_at + self.profile_steps and st.open:
                    st.stop()
            s = time.perf_counter()
            raw = next(self.feed)
            self.waits.append((time.perf_counter() - s) * 1e3)
            self.steps += 1
            yield raw
        self._sync()
        self.t1 = time.perf_counter()
        if self.stretch is not None and self.stretch.open:
            self.stretch.stop()


def first_grad_norms(trainer, names):
    """Each leaf's norm of the clipped gradient AdamW took in the first
    step, from its first moment (mu = 0.1 g after one update)."""
    import torch
    opt = trainer.state.optimizer
    norms = torch.stack([torch.linalg.vector_norm(m.float()) for m in opt.mu]).tolist()
    return {n: v / (1.0 - 0.9) for n, v in zip(names, norms)}


def run(ctx) -> dict:
    import torch

    from maa3_tpu_torch.config import DataSpec
    from maa3_tpu_torch.train.__main__ import build_loader
    from maa3_tpu_torch.train.loop import Trainer
    P, cfg, seed, dev = ctx.params, ctx.cfg, ctx.seed, ctx.device
    B, crop = P["batch"], P["spec_crop_len"]
    tmp = tempfile.mkdtemp(prefix="maa3-bench-")
    feed = None
    try:
        manifest = write_data(P, seed, tmp)
        system = harness.build_system(cfg, seed, dev, crop // 2)
        trainer = Trainer(system, batch_size=B, warm_up_steps=cfg["warm_up_steps"],
                          grad_clip=cfg["train"]["grad_clip"], log_every=10 ** 9,
                          ckpt_every=0, ckpt_dir=os.path.join(tmp, "ckpt"))
        trainer._tb_failed = True  # no TensorBoard writer: the benchmark logs nothing
        if "trainer" in ctx.hooks:
            ctx.hooks["trainer"](trainer)
        names = ([f"dit.{n}" for n, _ in trainer.state.dit.named_parameters()]
                 + [f"cond.{n}" for n, _ in trainer.state.cond.named_parameters()])
        data_seed, fit_seed = sub_seed(seed, "data", 30), sub_seed(seed, "draws", 30)
        feed = build_loader(DataSpec(dataset_name=manifest, spec_crop_len=crop, drop=P["drop"],
                                     batch_size=B), B, data_seed,
                            2 * cfg["model"]["vae"]["embed_dim"],
                            num_workers=P.get("loader_workers", 1))
        prog = {"loss": []}
        for s in range(P.get("setup_steps", 3)):
            m = trainer.fit(feed, max_steps=1, seed=fit_seed)
            prog["loss"].append(float(m["loss"]))
            if s == 0:
                prog["grad_norms"] = first_grad_norms(trainer, names)
        start = harness.seeded_state(cfg, seed, dev, crop // 2)
        with torch.no_grad():
            prog["change_norms"] = dict(zip(names, torch.stack([
                torch.linalg.vector_norm(p.detach() - start[part][n])
                for part, m in (("dit", trainer.state.dit), ("cond", trainer.state.cond))
                for n, p in m.named_parameters()]).tolist()))
        del start
        harness.free_device()
        stretch = profiling.Stretch() if ctx.trace else None
        win = Window(feed, ctx.seconds, dev, stretch, P.get("profile_at", 5),
                     P.get("profile_steps", 3))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - ctx.t_start
        trainer.fit(win, max_steps=10 ** 9, seed=fit_seed)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        window_s = win.t1 - win.t0
        n_tok = B * crop // 2 ** len(cfg["model"]["vae"]["down_layers"])
        out = {"setup_s": setup_s, "attempted": win.steps, "failed": 0,
               "e2e": {"train_tokens_per_s": win.steps * n_tok / window_s},
               "memory_peak_bytes": peak}
        out["record"] = {
            "kind": "train", "config": cfg, "window_s": window_s, "steps": win.steps,
            "batch": B, "latent_len": crop // 2, "peak_bytes": peak,
            "loader_wait_ms": win.waits,
            "model_flops": win.steps * yardstick.train_step_flops(cfg, B, crop),
            "profile": stretch.reduce() if stretch is not None else None,
            "profiled_steps": win.profile_steps}
        feed.close()
        feed = None
        trainer.close()
        del trainer, system
        harness.free_device()
        # the reference, after the program's state is freed
        state = harness.seeded_state(cfg, seed, dev, crop // 2)
        state.pop("vocoder")
        batches = reference.loader_batches(manifest, B, data_seed, P["drop"], len(prog["loss"]))
        ref = reference.train(cfg, state, batches, crop, fit_seed,
                              cfg["model"]["base_learning_rate"] * B, dev,
                              rows_per_block=P.get("rows_per_block", 2))
        del state
        harness.free_device()
        out["numbers"] = checks.train_numbers(prog, ref)
        return out
    finally:
        if feed is not None:
            feed.close()
        shutil.rmtree(tmp, ignore_errors=True)
