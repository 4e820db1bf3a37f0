"""Whole runs of tiny cells on the CPU: correct when the program is sound,
not correct with the timed path broken underneath, the controls outside
the limits, the open loop's schedule and timing, and the imports a run
may not make. The card test runs a tiny cell on the card."""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import torch

from benchmark import control, harness, run
from benchmark.traffic import serve

ROOT = harness.ROOT
SEED = 3300000007


def tiny_run(root, cell, hooks=None, trace=0, seconds=1.0):
    return run.run(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                    "--trace", str(trace)], root=root, device="cpu", hooks=hooks)


@pytest.mark.parametrize("cell", ["tiny-t2a.poisson", "tiny-t2a.closed", "tiny-t2a.train"])
def test_a_sound_program_is_correct(tiny_root, cell):
    r = tiny_run(tiny_root, cell)
    assert r["correct"], r["_checks"]
    assert r["attempted"] > 0 and r["failed"] == 0 and "setup_s" in r["metrics"]


def test_the_traced_run_reports_per_layer_metrics(tiny_root):
    r = tiny_run(tiny_root, "tiny-t2a.poisson", trace=1, seconds=2.0)
    assert r["correct"] and set(r["metrics"]) == {"batch_rows.lat"}


def _alter_answers(system):
    fn = system.vocode

    def vocode(mel):
        wav = fn(mel)
        return wav + 0.1 * wav.std() * torch.randn(wav.shape).numpy()

    system.vocode = vocode


def _unchanged_state(trainer):
    trainer.state.optimizer._adamw = lambda grads, lr: None


@pytest.mark.parametrize("cell,hook,fault", [
    ("tiny-t2a.poisson", "system", _alter_answers),
    ("tiny-t2a.closed", "system", _alter_answers),
    ("tiny-t2a.train", "trainer", _unchanged_state),
    ("tiny-t2a.train", "trainer", control.half_batch)])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, hook, fault):
    r = tiny_run(tiny_root, cell, hooks={hook: fault})
    assert not r["correct"], r["_checks"]


@pytest.mark.parametrize("cell,name", [
    ("tiny-t2a.poisson", "fp8"), ("tiny-t2a.closed", "fp8"), ("tiny-t2a.train", "fp8"),
    ("tiny-t2a.train", "half_batch")])
def test_the_controls_are_not_correct(tiny_root, cell, name):
    """Each control planted in the program through run.run, judged by the
    tiny cell's limits, while the program without it is correct."""
    r = control.reading(cell, SEED, 1.0, name, root=tiny_root, device="cpu")
    assert not r["correct"], r["checks"]
    assert control.reading(cell, SEED, 1.0, None, root=tiny_root, device="cpu")["correct"]


def test_the_open_loop_schedule_is_the_seeds():
    P = {"rate_rps": 4.0, "schedule_seed": 5, "captions": "captions.txt", "latent_len": 312,
         "steps": 25, "scale": 5.0}
    a = serve.arrivals(P, 50.0)
    assert a == serve.arrivals(P, 50.0) and 150 < len(a) < 250 and a == sorted(a)
    assert serve.requests(P, 11, 40) == serve.requests(P, 11, 40)
    assert serve.requests(P, 11, 40) != serve.requests(P, 12, 40)


class _Slow(BaseHTTPRequestHandler):
    """Answers POST /generate after 0.3 s for the first request, at once after."""
    first = threading.Lock()

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        if _Slow.first.acquire(blocking=False):
            time.sleep(0.3)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")


class _DropFirst(_Slow):
    """Closes the first connection without a reply, answers the others."""
    dropped = threading.Lock()

    def do_POST(self):
        if _DropFirst.dropped.acquire(blocking=False):
            self.close_connection = True
            return
        super().do_POST()


class _KeepAlive(_Slow):
    """HTTP/1.1: a connection serves request after request; counts them."""
    protocol_version = "HTTP/1.1"
    connections = 0

    def setup(self):
        super().setup()
        _KeepAlive.connections += 1


def _serve_load(handler, plan, want=0):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    client = subprocess.Popen([sys.executable, str(harness.PKG / "client.py")],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert client.stdout.readline().strip() == "ready"
        t0 = time.monotonic() + 0.2
        client.stdin.write(json.dumps({**plan, "port": httpd.server_address[1], "t0": t0,
                                       "stop_at": t0 + 0.5, "timeout": 10}) + "\n")
        client.stdin.flush()
        res = json.loads(client.stdout.readline())["results"]
        client.stdin.write(json.dumps({"indices": [want]}) + "\n")
        client.stdin.flush()
        assert json.loads(client.stdout.readline()) == {str(want): "b2s="}
        client.wait(timeout=10)
    finally:
        if client.poll() is None:
            client.kill()
        httpd.shutdown()
        th.join(timeout=10)
    return t0, res


def _open_loop(handler, due, want=0):
    return _serve_load(handler, {"loop": "open", "due": due, "requests": [{}] * len(due)}, want)


def test_latency_runs_from_when_a_request_was_due():
    due = [0.0, 0.05, 0.1]
    t0, res = _open_loop(_Slow, due)
    assert [round(r["due"] - t0, 6) for r in res] == due
    assert all(r["sent"] >= r["due"] and r["status"] == 200 for r in res)
    assert res[0]["done"] - res[0]["due"] >= 0.3


def test_a_dropped_connection_is_a_failure():
    _, res = _open_loop(_DropFirst, [0.0, 0.05], want=1)
    assert res[0]["status"] == -1 and "RemoteDisconnected" in res[0]["error"]
    assert res[1]["status"] == 200


def test_closed_loop_clients_keep_their_connections():
    _, res = _serve_load(_KeepAlive, {"loop": "closed", "clients": 2, "requests": [{}] * 400})
    assert len(res) > 4 and all(r["status"] == 200 for r in res)
    assert _KeepAlive.connections == 2


def _imports(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_the_program():
    mods = _imports("import json, sys\nimport benchmark.reference, benchmark.reference.dit, "
                    "benchmark.reference.vae, benchmark.reference.vocoder, "
                    "benchmark.reference.text, benchmark.reference.flow\n"
                    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & {"jax", "jaxlib", "flax", "orbax", "maa3_tpu", "maa3_tpu_torch"}


def test_a_run_imports_no_jax(tmp_path):
    from benchmark.conftest import write_root
    root = write_root(tmp_path / "checkout")
    mods = _imports("import json, sys, time\nfrom pathlib import Path\nfrom benchmark import run\n"
                    "r = run.run(['--workload', 'tiny-t2a.train', '--seed', '5', "
                    f"'--seconds', '0.3'], root=Path({str(root)!r}), device='cpu')\n"
                    "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "maa3_tpu_torch" in mods and not mods & set(harness.FORBIDDEN)


def test_no_result_without_a_card_or_outside_a_checkout(tmp_path):
    bare = tmp_path / "bare"
    bare.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    shutil.copytree(ROOT / "benchmark", bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, bare):
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                              "xl-t2a.serve-poisson", "--seed", "1", "--seconds", "1"],
                             cwd=cwd, capture_output=True, text=True, timeout=600)
        assert out.returncode != 0 and not out.stdout.strip()


def test_a_forbidden_module_is_named_by_its_whole_top_level_name():
    sys.modules["flax.core"] = object()
    try:
        assert harness.forbidden_loaded() == ["flax"]
    finally:
        del sys.modules["flax.core"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny_root, card):
    r = run.run(["--workload", "tiny-t2a.poisson", "--seed", str(SEED), "--seconds", "2"],
                root=tiny_root, device="cuda")
    assert r["correct"] and r["failed"] == 0
