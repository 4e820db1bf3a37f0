"""The port's tracer (maa3_tpu_torch/trace.py) on the CPU, and the
benchmark's reading of its spans (benchmark/metrics/_program.py): a served
batch's spans tile the batcher thread in order and each request's queue span
links to its batch; the server's padding counter; the training spans nested
under each step in order; nothing stored and no CUDA event made with
tracing off; the clock pair against the profiler's clock; a device idle gap
credited to the innermost span of the working thread."""

import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from maa3_tpu_torch import trace
from maa3_tpu_torch.models.bert import BertConfig
from maa3_tpu_torch.models.bigvgan import BigVGANConfig
from maa3_tpu_torch.models.clap import CLAPFLANConfig
from maa3_tpu_torch.models.t5 import T5Config
from maa3_tpu_torch.serving import AudioServer, Batcher, ServeConfig, _bucket, _Pending
from maa3_tpu_torch.system import MAA3System

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XL = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
UP, DD = "model.params.unet_config.params.", "model.params.first_stage_config.params.ddconfig."
OVER = [UP + "hidden_size=32", UP + "depth=1", UP + "num_heads=2", UP + "context_dim=16",
        UP + "multiple_of=16", DD + "ch=32", DD + "ch_mult=[1, 2]", DD + "num_res_blocks=1",
        "model.params.mel_length=8"]
BATCH_CHILDREN = ["serve.encode", "serve.noise", "serve.ode", "serve.decode", "serve.vocode",
                  "serve.deliver"]
STEP_CHILDREN = ["train.loader_wait", "train.prepare", "train.vae_encode", "train.cond",
                 "train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


@pytest.fixture(scope="module")
def system():
    return MAA3System.from_config(
        [XL], OVER, seed=1, device="cpu", compute_dtype=torch.float32, unfreeze=True,
        clap_cfg=CLAPFLANConfig(bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2,
                                                intermediate_size=32),
                                t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1,
                                            num_heads=2), d_proj=16),
        voc_cfg=BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                              upsample_initial_channel=64))


def _serve(system, bodies, **cfg):
    """Serve `bodies` concurrently (one batch: a 1.5 s window); returns the
    server's stats and each reply's JSON."""
    srv = AudioServer(system, ServeConfig(**{"max_batch": 4, "default_steps": 2,
                                             "batch_window_ms": 1500, **cfg}))
    srv.batcher.warmup((1,), steps=2)
    srv.start()
    out = {}

    def go(i, body):
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate",
                                     data=json.dumps({**body, "format": "json"}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            out[i] = json.loads(r.read())

    try:
        threads = [threading.Thread(target=go, args=(i, b)) for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        stats = srv.batcher.stats()
    finally:
        srv.shutdown()
    return stats, out


def _children(spans, parent):
    return sorted((s for s in spans if s["parent"] == parent["id"]), key=lambda s: s["start_ns"])


def _in_order(parent, kids):
    t = parent["start_ns"]
    for k in kids:
        assert t <= k["start_ns"] <= k["end_ns"]
        t = k["end_ns"]
    assert t <= parent["end_ns"]


def test_a_served_batch_tiles_the_batcher_thread(system):
    trace.enable("cpu")
    stats, replies = _serve(system, [{"prompt": f"a dog barks {i}", "seed": i}
                                     for i in range(3)])
    spans = trace.drain()["spans"]
    assert len(replies) == 3 and stats["batch_histogram"] == {1: 1, 3: 1}
    warm = [s for s in spans if s["name"] == "serve.warmup"]
    assert [w["attrs"] for w in warm] == [{"bucket": 1}]
    batches = [s for s in spans if s["name"] == "serve.batch" and s["thread"] == "maa3-batcher"]
    assert len(batches) == 1
    b = batches[0]
    assert b["attrs"] == {"rows": 3, "bucket": 4, "padded": 1}
    kids = _children(spans, b)
    assert [k["name"] for k in kids] == BATCH_CHILDREN
    _in_order(b, kids)
    # one Euler step of 2 through a block's dense self- and cross-attention (CPU)
    assert kids[2]["attrs"] == {"attn_flash": 0, "attn_dense": 2}
    collect = max((s for s in spans
                   if s["name"] == "serve.collect" and s["end_ns"] <= b["start_ns"]),
                  key=lambda s: s["end_ns"])
    assert collect["thread"] == b["thread"] and b["start_ns"] - collect["end_ns"] < 50e6
    queued = [s for s in spans if s["name"] == "serve.queue"]
    assert len(queued) == 3 and all(q["attrs"]["batch"] == b["id"] for q in queued)
    assert all(q["start_ns"] <= b["start_ns"] <= q["end_ns"] <= kids[0]["start_ns"]
               and q["thread"] != b["thread"] for q in queued)
    requests = {s["attrs"]["request"]: s for s in spans if s["name"] == "serve.request"}
    for q in queued:
        r = requests[q["attrs"]["request"]]
        assert r["thread"] == q["thread"] and r["start_ns"] <= q["start_ns"] < r["end_ns"]
        reply = _children(spans, r)
        assert [s["name"] for s in reply] == ["serve.reply"]
        assert reply[0]["start_ns"] >= kids[-1]["start_ns"]  # after the batch's deliver began
    assert all("device_ms" not in s for s in spans)  # no device time on the CPU


def test_padded_rows_and_latency_from_arrival(system):
    stats, replies = _serve(system, [{"prompt": "rain", "seed": i} for i in range(3)],
                            max_batch=8)
    hist = stats["batch_histogram"]
    assert hist == {1: 1, 3: 1} and stats["abandoned"] == 0
    assert stats["padded_rows"] == sum(n * (_bucket(r, 8) - r) for r, n in hist.items()) == 1
    assert 0 < stats["latency_p50_s"] <= stats["latency_p95_s"]
    assert all(0 < r["latency_s"] for r in replies.values())
    # the latency runs from the arrival at submit, not from the request's parse
    batcher = Batcher(system, ServeConfig())
    req = _Pending(prompt="x", struct="<x& all>", steps=2, scale=5.0, latent_len=8, seed=0)
    time.sleep(0.05)
    before = time.perf_counter_ns()
    batcher.submit(req)
    assert req.t_in_ns >= before and req.thread == threading.current_thread().name
    batcher._process(batcher._collect())
    assert req.wav is not None and req.latency_s < (time.perf_counter_ns() - before) / 1e9


def test_an_abandoned_request_is_counted(system):
    batcher = Batcher(system, ServeConfig())
    req = _Pending(prompt="x", struct="<x& all>", steps=2, scale=5.0, latent_len=8, seed=0)
    req.abandoned = True
    batcher.submit(req)
    assert batcher._collect() == [] and batcher.stats()["abandoned"] == 1


def _raw_batches(n, rows=2, frames=64, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": (rng.standard_normal((rows, 80, frames)) - 4.0).astype(np.float32),
             "caption": {"ori_caption": [f"clip {i} {r}" for r in range(rows)],
                         "struct_caption": [f"<clip {i}& all>" for _ in range(rows)]}}
            for i in range(n)]


def _trainer(system, tmp_path):
    from maa3_tpu_torch.train.loop import Trainer
    t = Trainer(system, batch_size=2, log_every=10 ** 9, ckpt_every=0,
                ckpt_dir=str(tmp_path / "ckpt"))
    t._tb_failed = True
    return t


def test_training_spans_nest_under_each_step_in_order(system, tmp_path):
    trainer = _trainer(system, tmp_path)
    assert trainer.state.cond is not None  # the XL config trains its conditioner
    trace.enable("cpu")
    trainer.fit(iter(_raw_batches(2)), max_steps=2)
    trainer.fit(iter(_raw_batches(1, seed=1)), max_steps=5)  # the loader ends after one
    spans = trace.drain()["spans"]
    steps = sorted((s for s in spans if s["name"] == "train.step"), key=lambda s: s["start_ns"])
    assert [s["attrs"]["step"] for s in steps] == [1, 2, 3, 4]
    for s in steps[:3]:
        kids = _children(spans, s)
        assert [k["name"] for k in kids] == STEP_CHILDREN
        _in_order(s, kids)
    # the last step found the loader's end: only its wait
    assert [k["name"] for k in _children(spans, steps[3])] == ["train.loader_wait"]


def test_tracing_off_stores_nothing_and_makes_no_event(system, tmp_path, monkeypatch):
    made = []

    class NoEvent:
        def __init__(self, *a, **kw):
            made.append(1)
            raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.cuda, "Event", NoEvent)
    with trace.span("x", device_time=True, rows=1) as sid:
        assert sid is None
    assert trace.add("y", 0) is None
    _serve(system, [{"prompt": "wind", "seed": 1}])
    _trainer(system, tmp_path).fit(iter(_raw_batches(1)), max_steps=1)
    assert trace.drain()["spans"] == [] and not made
    # on: device time is asked for, but the spans ran on the CPU
    trace.enable("cpu")
    with trace.span("x", device_time=True) as sid:
        assert isinstance(sid, int)
    assert [s["name"] for s in trace.drain()["spans"]] == ["x"] and not made


def test_the_clock_pair_puts_a_span_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    trace.enable("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer"):
            time.sleep(0.02)
            with record_function("marker"):
                torch.ones(64).sum()
            time.sleep(0.02)
    d = trace.drain()
    (s,) = d["spans"]
    c = d["clock"]
    start = s["start_ns"] - c["perf_ns"] + c["unix_ns"]
    end = s["end_ns"] - c["perf_ns"] + c["unix_ns"]
    (m,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "marker"]
    assert start + 15e6 < m.start_ns() <= m.end_ns() < end - 15e6


def _sp(i, name, t0, t1, parent=None, thread="maa3-batcher", **attrs):
    return {"id": i, "parent": parent, "name": name, "thread": thread, "start_ns": t0 * 1000,
            "end_ns": t1 * 1000, "attrs": attrs}


def test_program_credits_each_idle_piece_to_the_innermost_span():
    from benchmark.metrics import _program
    # times in us; the clock maps perf 0 to Unix 1e6 us
    spans = [_sp(1, "serve.collect", 0, 100),
             _sp(2, "serve.batch", 100, 500, rows=3, bucket=4, padded=1),
             _sp(3, "serve.encode", 100, 200, 2), _sp(4, "serve.noise", 200, 250, 2),
             _sp(5, "serve.ode", 250, 450, 2), _sp(6, "serve.deliver", 450, 480, 2),
             _sp(7, "serve.queue", 20, 100, thread="Thread-3", batch=2, request=9),
             _sp(8, "serve.request", 10, 520, thread="Thread-3", request=9)]
    k = 1e6  # the profiler's clock of perf 0, us
    kernels = [("a", k + 0, k + 50), ("b", k + 150, k + 210), ("c", k + 240, k + 460),
               ("d", k + 600, k + 650)]
    rec = {"kind": "serve", "window_s": 1.0,
           "profile": {"kernels": kernels, "window_s": 1e-3},
           "program": {"clock": {"unix_ns": 1_000_000_000, "perf_ns": 0}, "spans": spans}}
    idle = _program.idle_by_span(rec)
    # gaps: 50-150 (collect 50, encode 50), 210-240 (noise 40-ish), 460-600
    assert idle == pytest.approx({"serve.collect": 0.05, "serve.encode": 0.05,
                                  "serve.noise": 0.03, "serve.deliver": 0.02,
                                  "serve.batch": 0.02, "untraced": 0.1})
    # host-caused idle: all but the collect and the untraced, over the 1 ms stretch
    assert _program.host_idle_share(rec) == pytest.approx(100 * (0.05 + 0.03 + 0.02 + 0.02))
    assert _program.window_queue_ms(rec, closed=False) == pytest.approx([0.08])
    assert [b["id"] for b in _program.served_batches(rec["program"])] == [2]


def test_program_leaves_out_the_waits_over_the_profilers_pauses():
    from benchmark.metrics import _program
    # the batcher thread outside its spans from 600 to 2600 us: the benchmark's profiler stopping
    spans = [_sp(1, "serve.collect", 0, 100), _sp(2, "serve.batch", 100, 500),
             _sp(3, "serve.collect", 500, 600), _sp(4, "serve.batch", 2600, 2900),
             _sp(8, "serve.collect", 2900, 2950), _sp(9, "serve.batch", 2950, 3000),
             _sp(5, "serve.queue", 50, 100, thread="Thread-1", batch=2, request=1),
             _sp(6, "serve.queue", 450, 2600, thread="Thread-2", batch=4, request=2),
             _sp(7, "serve.queue", 2650, 2950, thread="Thread-3", batch=9, request=3)]
    rec = {"kind": "serve", "window_s": 1.0,
           "program": {"clock": {"unix_ns": 0, "perf_ns": 0}, "spans": spans}}
    assert _program.holes(rec["program"], "maa3-batcher") == [(600_000, 2_600_000)]
    assert _program.window_queue_ms(rec, closed=False) == pytest.approx([0.05, 0.3])


def test_attn_flash_share_reads_the_served_batches_ode_counts():
    """attn_flash_share.lat over every served batch's serve.ode counts,
    .tput over the batches that ended in the closed loop's window; None
    from spans without the counts (a program before them)."""
    from benchmark import harness
    bench = harness.Bench()
    lat, tput = (bench.reader(f"attn_flash_share.{k}") for k in ("lat", "tput"))
    spans = [_sp(1, "serve.collect", 0, 100), _sp(2, "serve.batch", 100, 500),
             _sp(3, "serve.ode", 150, 450, 2, attn_flash=56, attn_dense=0),
             _sp(4, "serve.collect", 500, 600), _sp(5, "serve.batch", 600, 900),
             _sp(6, "serve.ode", 650, 850, 5, attn_flash=28, attn_dense=28),
             _sp(7, "serve.warmup", 0, 90, thread="main"),
             _sp(8, "serve.ode", 10, 80, 7, thread="main", attn_flash=0, attn_dense=56)]

    def rec(spans, window_s=1.0):
        return {"kind": "serve", "window_s": window_s,
                "program": {"clock": {"unix_ns": 0, "perf_ns": 0}, "spans": spans}}

    assert lat(rec(spans)) == pytest.approx(100 * 84 / 112)
    assert tput(rec(spans)) == pytest.approx(50.0)  # the second batch alone
    bare = [dict(s, attrs={}) if s["name"] == "serve.ode" else s for s in spans]
    assert lat(rec(bare)) is None and tput(rec(bare)) is None
    assert lat({"kind": "serve", "window_s": 1.0, "program": None}) is None


@pytest.mark.parametrize("cli", ["serve", "train"])
def test_trace_out_writes_the_spans_as_json_lines(cli, tmp_path, monkeypatch):
    """--trace_out turns the tracer on around the CLI's work and writes
    drain() at its end: the clock first, then one span a line."""
    import importlib
    mod = importlib.import_module("maa3_tpu_torch.serve" if cli == "serve"
                                  else "maa3_tpu_torch.train.__main__")
    name = "_serve" if cli == "serve" else "_train"

    def work(opt, device):
        assert trace.enabled() and device.type == "cpu"
        with trace.span("work", rows=2):
            pass

    monkeypatch.setattr(mod, name, work)
    out = tmp_path / "spans.jsonl"
    argv = ["--device", "cpu", "--trace_out", str(out)] + (["-b", XL] if cli == "train" else [])
    mod.main(argv)
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert set(lines[0]) == {"clock"} and set(lines[0]["clock"]) == {"unix_ns", "perf_ns"}
    assert [(x["name"], x["attrs"]) for x in lines[1:]] == [("work", {"rows": 2})]
    assert lines[1]["end_ns"] >= lines[1]["start_ns"] and lines[1]["parent"] is None
