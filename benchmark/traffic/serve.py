"""Text-to-audio served over HTTP: the port's AudioServer on 127.0.0.1 (port
0) in front of the Batcher, driven by benchmark/client.py in a child
process, under an open loop (arrivals on a schedule, latency from when each
request was due) or a closed loop (N clients, each sending its next request
when its reply arrives).

Cell parameters (benchmark/workloads/<cell>.json, "params"):
  loop: "open" | "closed"; open: rate_rps, schedule_seed (the arrival
  times are drawn once from it, so every run's seed gives the same arrivals;
  the run's seed orders the requests over them); closed: clients, tail_s;
  latent_len, steps, scale; server: ServeConfig's max_batch,
  batch_window_ms, max_latent_len; warm_buckets, warm_steps; captions (a
  file under benchmark/); check_requests (sampled from the seed after the
  window for the reference); profile_after (share of the window before the
  traced stretch), profile_batches.
End-to-end: open: serve_p95_ms over every request due in the window (one
that failed counts as the slowest); closed: serve_audio_s_per_s,
the audio of every batch completed from the first batch's completion to
the first completion at least `seconds` later, over that time."""

from __future__ import annotations

import base64
import io
import json
import subprocess
import sys
import time
import wave

import numpy as np

from benchmark import checks, harness, profiling, reference, yardstick
from benchmark.weights import sub_seed


def captions(name: str):
    return [c.strip() for c in (harness.PKG / name).read_text().splitlines() if c.strip()]


def requests(P: dict, seed: int, count: int):
    """count request bodies: captions from the pool and request seeds, both
    drawn from the run's seed."""
    pool = captions(P["captions"])
    rng = np.random.default_rng(sub_seed(seed, "requests"))
    caps = rng.integers(0, len(pool), size=count)
    seeds = rng.integers(0, 2 ** 31 - 1, size=count)
    return [{"prompt": pool[c], "struct_caption": f"<{pool[c]}& all>", "seed": int(s),
             "latent_len": P["latent_len"], "steps": P["steps"], "scale": P["scale"],
             "format": "wav"} for c, s in zip(caps, seeds)]


def arrivals(P: dict, seconds: float):
    """Poisson arrival offsets in [0, seconds) at rate_rps, drawn from the
    cell's schedule_seed."""
    rng = np.random.default_rng(P["schedule_seed"])
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / P["rate_rps"]))
        if t >= seconds:
            return out
        out.append(t)


def pcm(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767.0


def batch_groups(done_times, gap: float):
    """Completion times split where consecutive replies are more than `gap`
    apart: one group per launched batch."""
    groups, cur = [], []
    for t in sorted(done_times):
        if cur and t - cur[-1] > gap:
            groups.append(cur)
            cur = []
        cur.append(t)
    if cur:
        groups.append(cur)
    return groups


class Launches:
    """Wraps the batcher's _process on its own thread: logs each launched
    batch's start (monotonic) and rows and, given a profiler stretch, opens
    it at the first batch starting after `start_at` and closes it as the
    batch `batches` later starts."""

    def __init__(self, batcher, stretch=None, batches: int = 0):
        self.stretch, self.left = stretch, batches
        self.start_at = float("inf")
        self.log = []
        orig = batcher._process

        def process(batch):
            now = time.monotonic()
            self.log.append((now, len(batch)))
            st = self.stretch
            if st is not None:
                if st.open:
                    if self.left == 0:
                        st.stop()
                    self.left -= 1
                elif st.prof is None and now >= self.start_at:
                    st.start()
                    self.left -= 1
            return orig(batch)

        batcher._process = process

    def rows_since(self, t0: float):
        return [n for t, n in self.log if t >= t0]


def run(ctx) -> dict:
    import torch

    from maa3_tpu_torch.serving import AudioServer, ServeConfig
    P, cfg, seed, seconds = ctx.params, ctx.cfg, ctx.seed, ctx.seconds
    n = P["latent_len"]
    system = harness.build_system(cfg, seed, ctx.device, n)
    if "system" in ctx.hooks:
        ctx.hooks["system"](system)
    server = AudioServer(system, ServeConfig(
        default_steps=P["steps"], default_scale=P["scale"], seed=sub_seed(seed, "server", 31),
        **P["server"]), host="127.0.0.1", port=0)
    server.batcher.warmup(tuple(P["warm_buckets"]), steps=P.get("warm_steps", 2))
    spans = None
    stretch = profiling.Stretch() if ctx.trace else None
    if ctx.trace:
        spans = profiling.Spans(ctx.device)
        spans.wrap(system, "get_learned_conditioning", "encode",
                   lambda c: len(c["ori_caption"]) if isinstance(c, dict) else len(c))
        spans.wrap(system, "sample_cfg", "ode", lambda c, *a, **k: c.shape[0])
        spans.wrap(system, "decode_first_stage", "decode", lambda z: z.shape[0])
        spans.wrap(system, "vocode", "vocode", lambda m: m.shape[0])
    launches = Launches(server.batcher, stretch, P.get("profile_batches", 3))
    server.start()
    closed = P["loop"] == "closed"
    if closed:
        bodies = requests(P, seed, P["clients"] * 64)
        plan = {"loop": "closed", "clients": P["clients"]}
    else:
        due = arrivals(P, seconds)
        bodies = requests(P, seed, len(due))
        plan = {"loop": "open", "due": due}
    client = subprocess.Popen([sys.executable, str(harness.PKG / "client.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if client.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        if ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(ctx.device)
        hist0 = dict(server.batcher.stats()["batch_histogram"])
        t0 = time.monotonic() + 0.5
        setup_s = time.perf_counter() - ctx.t_start + 0.5
        launches.start_at = t0 + P.get("profile_after", 0.25) * seconds
        plan.update(port=server.port, t0=t0, requests=bodies, timeout=seconds + 120.0,
                    stop_at=t0 + seconds + P.get("tail_s", 8.0))
        client.stdin.write(json.dumps(plan) + "\n")
        client.stdin.flush()
        res = json.loads(client.stdout.readline())["results"]
        if stretch is not None and stretch.open:  # the window ended first
            stretch.stop()
        hist1 = server.batcher.stats()["batch_histogram"]
        ok = [r for r in res if r["status"] == 200]
        out = {"setup_s": setup_s, "attempted": len(res), "failed": len(res) - len(ok),
               "client": {"errors": [[r["i"], r["status"], r["error"]] for r in res
                                     if r["status"] != 200][:5]},
               "launches": launches.rows_since(t0)}
        voc = cfg["vocoder"]
        audio_s = (n * 2 ** len(cfg["model"]["vae"]["down_layers"])
                   * int(np.prod(voc["upsample_rates"])) / voc["sampling_rate"])
        if closed:
            groups = batch_groups([r["done"] for r in ok], P.get("cluster_gap_s", 0.5))
            ends = [g[-1] for g in groups]
            start = ends[0]
            last = next((i for i, e in enumerate(ends) if e >= start + seconds), len(ends) - 1)
            window = (start, ends[last])
            in_win = [r for r in ok if start < r["done"] <= ends[last]]
            out["e2e"] = {"serve_audio_s_per_s": len(in_win) * audio_s / (ends[last] - start)}
            out["attempted"] = len([r for r in res if r["sent"] <= ends[last]])
            out["failed"] = len([r for r in res if r["status"] != 200 and r["sent"] <= ends[last]])
            judged = in_win
        else:
            lat = [(r["done"] - r["due"]) * 1e3 if r["status"] == 200 else float("inf")
                   for r in res]
            out["e2e"] = {"serve_p95_ms": harness.percentile(lat, 95)}
            late = [(r["sent"] - r["due"]) * 1e3 for r in res]
            out["client"].update(sender_late_max_ms=max(late), requests=len(res),
                                 sender_late_p95_ms=harness.percentile(late, 95))
            window = (t0, max(r["done"] for r in res))
            in_win = ok
            judged = ok
        out["missing"] = float(len(res) - len(ok)) if not closed else float(out["failed"])
        rng = np.random.default_rng(sub_seed(seed, "check"))
        pick = sorted(int(i) for i in rng.choice(len(judged), size=min(P["check_requests"],
                                                                      len(judged)), replace=False))
        want = [judged[i]["i"] for i in pick]
        client.stdin.write(json.dumps({"indices": want}) + "\n")
        client.stdin.flush()
        wavs = json.loads(client.stdout.readline())
        client.wait(timeout=60)
    finally:
        if client.poll() is None:
            client.kill()
            client.wait()
        server.shutdown()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if ctx.device.type == "cuda" else 0)
    out["record"] = {
        "kind": "serve", "config": cfg, "latent_len": n, "item": 2,
        "window_s": window[1] - window[0],
        "batch_sizes": [b for b, c in hist1.items() for _ in range(c - hist0.get(b, 0))],
        "model_flops": len(in_win) * yardstick.request_flops(cfg, n, P["steps"]),
        "spans": spans.ms() if spans is not None else {},
        "profile": stretch.reduce() if stretch is not None else None,
        "vocode_rows": (spans.rows_between("vocode", stretch.t0, stretch.t1)
                        if stretch is not None and stretch.t1 is not None else [])}
    served = [pcm(base64.b64decode(wavs[str(i)])) for i in want]
    sampled = [bodies[i] for i in want]
    del system, server
    harness.free_device()
    # the reference, after the program's state is freed
    state = harness.seeded_state(cfg, seed, ctx.device, n)
    ref = reference.serve(cfg, state, [{"prompt": b["prompt"], "struct": b["struct_caption"],
                                        "seed": b["seed"], "latent_len": b["latent_len"],
                                        "steps": b["steps"], "scale": b["scale"]}
                                       for b in sampled], ctx.device, P.get("reference_block", 8))
    del state
    out["numbers"] = {"wav_gap": checks.wav_gap(served, ref), "missing": out["missing"],
                      "wav_rms": float(np.sqrt(np.mean(np.square(np.concatenate(ref)))))}
    return out
