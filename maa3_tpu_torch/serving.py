"""HTTP micro-batching server for text-to-audio (counterpart of
maa3_tpu/serving.py).

- **one worker thread owns the card**: HTTP handler threads only enqueue
  requests and wait; the batcher coalesces whatever arrived inside a short
  window into one dual-batch CFG ODE launch, decodes and vocodes it;
- **buckets**: a batch is padded up to a power of two (capped at
  max_batch), so a handful of batch shapes serve every load;
- **groups**: only requests with the same (steps, scale, latent_len) share
  a batch; a mismatched one starts the next batch;
- **reproducible requests**: each row's initial noise is drawn from numpy
  with the request's seed (else the server's seed and a counter), so a
  {prompt, seed} gives its audio whatever it is batched with, up to the
  GEMMs' batch-size-dependent rounding; a batch's rows are ordered by
  (prompt, structured caption, seed), not by arrival, because on the card
  cuDNN's bf16 vocoder convolutions round a row differently at another
  position in the batch (2 of 8 rows moved 2^-10 at BigVGAN's 768-channel
  stage), so the same requests batched together give the same bytes in
  whatever order they arrive;
- `AudioServer.shutdown` stops the HTTP loop, answers queued requests with
  503, and joins the batcher, HTTP and handler threads: no thread is left;
- **tensor-parallel serving** (system.shard_serving over several ranks):
  rank 0 owns the HTTP front and the batcher, and announces each batch's
  captions, noise, steps and scale to the other ranks (`Lockstep`), which
  sample it in lockstep (`follow`) until shutdown announces the end.

Endpoints: POST /generate {"prompt", "seed"?, "steps"?, "scale"?,
"latent_len"?, "struct_caption"?, "format": "wav" | "json"} -> a 16-bit wav
(or JSON with the wav in base64), 400 for a malformed field or one outside
ServeConfig's bounds (Batcher.check), 500 when the
batch failed (counted in /stats "errors"), 503 on a queue timeout or at
shutdown; GET /healthz (ok, device, stats); GET /stats (Batcher.stats).

With tracing on (maa3_tpu_torch/trace.py) the server records, on the
batcher thread, `serve.collect` (the wait for a first request and the batch
window) and `serve.batch` (rows, bucket, padded) with its children
`serve.encode`, `serve.noise`, `serve.ode` (with the batch's DiT attention
calls by route, `attn_flash` and `attn_dense`, and its planned block-steps
by route, `dit_fused` and `dit_plain`: trace.py `counts`),
`serve.decode`, `serve.vocode` (the four with device time) and
`serve.deliver`; per request `serve.queue`
(from its arrival at `Batcher.submit` to the start of the batch that takes
it: request id, batch = the id of that `serve.batch`), and on the handler
thread `serve.request` with its child `serve.reply` (the wav's bytes and
their write); `serve.warmup` per warmed bucket.
"""

from __future__ import annotations

import base64
import io
import itertools
import json
import threading
import time
import wave
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Optional

import numpy as np
import torch

from maa3_tpu_torch import trace
from maa3_tpu_torch.system import check_limits

MAX_STEPS = 1000  # a request's ODE steps: at most the model's timestep count
_request_ids = itertools.count(1)


@dataclass
class ServeConfig:
    max_batch: int = 8             # largest coalesced batch (bucket ceiling)
    batch_window_ms: float = 30.0  # how long the batcher waits for company
    default_steps: int = 25
    default_scale: float = 5.0
    request_timeout_s: float = 600.0
    sample_rate: int = 16000
    seed: int = 0
    # the longest latent_len a request may ask for (400 beyond it; None: the
    # config's own latent length)
    max_latent_len: Optional[int] = None


@dataclass
class _Pending:
    prompt: str
    struct: str
    steps: int
    scale: float
    latent_len: int
    seed: Optional[int]
    event: threading.Event = field(default_factory=threading.Event)
    wav: Optional[np.ndarray] = None
    error: Optional[str] = None
    status: int = 500              # the HTTP status of an error
    id: int = field(default_factory=lambda: next(_request_ids))
    # perf_counter_ns of the arrival at Batcher.submit (of the request's
    # creation for a warm-up row), and the submitting thread's name
    t_in_ns: int = field(default_factory=time.perf_counter_ns)
    thread: Optional[str] = None
    latency_s: float = 0.0         # from the arrival to the batch's wavs
    # set by the handler when the client stopped waiting (queue timeout):
    # the batcher drops abandoned requests instead of generating for nobody
    abandoned: bool = False

    def group_key(self):
        return (self.steps, round(self.scale, 6), self.latent_len)


def _row_key(req: _Pending):
    """A batch row's place: by its captions and seed, not its arrival."""
    return (req.prompt, req.struct, req.seed is None, req.seed or 0)


def _bucket(n: int, ceiling: int) -> int:
    """Smallest power of two >= n, capped at ceiling."""
    b = 1
    while b < n and b < ceiling:
        b *= 2
    return min(b, ceiling)


def wav_bytes(wav: np.ndarray, sample_rate: int) -> bytes:
    """float waveform in [-1, 1] -> 16-bit PCM RIFF/WAVE bytes."""
    pcm = (np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
           * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


class Lockstep:
    """Rank 0's side of a tensor-parallel server: every batch it samples is
    first broadcast over `group` (every rank; a gloo group with a long
    timeout, mesh.control_group), and close() releases the followers."""

    def __init__(self, group):
        self.group = group
        self.closed = False

    def announce(self, msg: Optional[dict]) -> None:
        import torch.distributed as dist
        dist.broadcast_object_list([msg], src=0, group=self.group)

    def close(self) -> None:
        if not self.closed:
            self.closed = True
            self.announce(None)


def follow(system, group) -> int:
    """A rank other than 0 of a tensor-parallel server: sample every batch
    rank 0 announces, in lockstep (its collectives), until the end. Returns
    the batches followed."""
    import torch.distributed as dist
    uc_cache: dict = {}
    n = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=group)
        msg = box[0]
        if msg is None:
            return n
        bucket = len(msg["prompts"])
        if bucket not in uc_cache:
            uc_cache[bucket] = system.get_learned_conditioning(
                system.captions([""] * bucket, [""] * bucket))
        c = system.get_learned_conditioning(system.captions(msg["prompts"], msg["structs"]))
        system.sample_cfg(c, msg["scale"], uc_cache[bucket], timesteps=msg["steps"],
                          x0=torch.from_numpy(msg["x0"]).to(system.device))
        n += 1


class Batcher(threading.Thread):
    """The single card-owner thread: dequeue -> coalesce -> generate."""

    def __init__(self, system, cfg: ServeConfig, lockstep: Optional[Lockstep] = None):
        super().__init__(daemon=True, name="maa3-batcher")
        self.system = system
        self.cfg = cfg
        self.lockstep = lockstep
        self.queue: "Queue[_Pending]" = Queue()
        # not `_stop`: Thread.join calls a Thread method of that name
        self._stop_event = threading.Event()
        self._holdover: Optional[_Pending] = None
        self._counter = 0
        self._uc_cache: dict = {}       # bucket -> unconditional context
        self.t_start = time.time()
        self.served = 0
        self.errors = 0
        self.audio_seconds = 0.0
        self.batch_hist: dict = {}
        self.padded_rows = 0            # bucket - rows, over the batches served
        self.abandoned = 0              # dropped: the client's wait timed out
        self._latencies: deque = deque(maxlen=256)
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()

    # -- public ------------------------------------------------------------

    def submit(self, req: _Pending) -> None:
        req.t_in_ns = time.perf_counter_ns()
        req.thread = threading.current_thread().name
        with self._submit_lock:
            if self._stop_event.is_set():
                self._refuse(req)
            else:
                self.queue.put(req)

    def stop(self) -> None:
        self._stop_event.set()

    def check(self, req: _Pending) -> None:
        """Refuse (ValueError, a 400) a request outside the server's bounds:
        steps in [2, MAX_STEPS], latent_len in [1, max_latent_len], and a
        latent length whose self-attention the card's kernels can run
        (system.check_limits at that length)."""
        top = self.cfg.max_latent_len or self.system.spec.mel_length
        if not 2 <= req.steps <= MAX_STEPS:
            raise ValueError(f"steps must be in [2, {MAX_STEPS}]")
        if not 1 <= req.latent_len <= top:
            raise ValueError(f"latent_len must be in [1, {top}]")
        check_limits(self.system.spec, self.system.device, req.latent_len)

    def stats(self) -> dict:
        """Counters since start: requests served, failed (errors) and
        abandoned; seconds of audio; the batch histogram (real rows ->
        batches) and the padding rows those batches ran (bucket - rows);
        latency_p50_s / latency_p95_s over the last 256 requests served,
        each from its arrival at submit to its batch's wavs (before the
        reply is encoded and written)."""
        with self._lock:
            lat = sorted(self._latencies)
            return {
                "uptime_s": round(time.time() - self.t_start, 1),
                "served": self.served,
                "errors": self.errors,
                "audio_seconds": round(self.audio_seconds, 1),
                "batch_histogram": dict(self.batch_hist),
                "padded_rows": self.padded_rows,
                "abandoned": self.abandoned,
                "latency_p50_s": round(lat[len(lat) // 2], 4) if lat else None,
                "latency_p95_s":
                    round(lat[int(len(lat) * 0.95)], 4) if lat else None,
            }

    def warmup(self, buckets=(1,), steps: Optional[int] = None) -> None:
        """Run each batch bucket once before accepting traffic (cuBLAS /
        cuDNN handles, the serving copy of the DiT)."""
        for b in buckets:
            batch = [_Pending(prompt="warmup", struct="<warmup& all>",
                              steps=steps or self.cfg.default_steps,
                              scale=self.cfg.default_scale,
                              latent_len=self.system.spec.mel_length, seed=0)
                     for _ in range(min(b, self.cfg.max_batch))]
            with trace.span("serve.warmup", bucket=len(batch)):
                self._process(batch)

    # -- worker loop -------------------------------------------------------

    def run(self) -> None:
        if self.system.device.type == "cuda":
            torch.cuda.set_device(self.system.device)
        while not self._stop_event.is_set():
            with trace.span("serve.collect"):
                batch = self._collect()
            if batch:
                self._process(batch)
        self._drain()

    @staticmethod
    def _refuse(req: _Pending) -> None:
        req.error, req.status = "the server is shutting down", 503
        req.event.set()

    def _drain(self) -> None:
        """After stop: answer what is still queued with 503."""
        with self._submit_lock:
            left = [self._holdover] if self._holdover is not None else []
            self._holdover = None
            while True:
                try:
                    left.append(self.queue.get_nowait())
                except Empty:
                    break
        for r in left:
            self._refuse(r)

    def _collect(self):
        """One request blocks; then keep taking same-group requests until the
        window closes or the batch is full. A request of another group is
        held over to start the next batch; abandoned requests (the client's
        wait timed out, 503 sent) are dropped."""
        def next_req(timeout):
            while True:
                req = self.queue.get(timeout=timeout)
                if not req.abandoned:
                    return req
                self._count_abandoned(1)

        if self._holdover is not None and not self._holdover.abandoned:
            first, self._holdover = self._holdover, None
        else:
            if self._holdover is not None:
                self._count_abandoned(1)
            self._holdover = None
            try:
                first = next_req(0.2)
            except Empty:
                return []
        batch = [first]
        deadline = time.perf_counter() + self.cfg.batch_window_ms / 1e3
        while len(batch) < self.cfg.max_batch:
            rest = deadline - time.perf_counter()
            if rest <= 0:
                break
            try:
                req = next_req(rest)
            except Empty:
                break
            if req.group_key() == first.group_key():
                batch.append(req)
            else:
                self._holdover = req
                break
        return batch

    def _count_abandoned(self, n: int) -> None:
        with self._lock:
            self.abandoned += n

    def _uncond(self, bucket: int):
        if bucket not in self._uc_cache:
            self._uc_cache[bucket] = self.system.get_learned_conditioning(
                self.system.captions([""] * bucket, [""] * bucket))
        return self._uc_cache[bucket]

    def _noise(self, batch, bucket: int, latent_len: int) -> torch.Tensor:
        """Row i from request i's seed (or the server's seed and a counter),
        the padding rows from the counter (maa3_tpu/serving.py:216-229)."""
        shape = (self.system.spec.mel_dim, latent_len)
        rows = []
        for i in range(bucket):
            self._counter += 1
            seed = batch[i].seed if i < len(batch) else None
            rng = np.random.default_rng(seed if seed is not None
                                        else (self.cfg.seed, self._counter))
            rows.append(rng.standard_normal(shape).astype(np.float32))
        return torch.from_numpy(np.stack(rows)).to(self.system.device)

    def _process(self, batch) -> None:
        kept = [r for r in batch if not r.abandoned]
        if len(kept) < len(batch):
            self._count_abandoned(len(batch) - len(kept))
        batch = sorted(kept, key=_row_key)
        if not batch:
            return
        bucket = _bucket(len(batch), self.cfg.max_batch)
        with trace.span("serve.batch", rows=len(batch), bucket=bucket,
                        padded=bucket - len(batch)) as bid:
            if bid is not None:
                for r in batch:
                    if r.thread is not None:  # came through submit
                        trace.add("serve.queue", r.t_in_ns, thread=r.thread,
                                  request=r.id, batch=bid)
            self._run_batch(batch, bucket)

    def _run_batch(self, batch, bucket: int) -> None:
        try:
            first = batch[0]
            pad = [""] * (bucket - len(batch))
            prompts = [r.prompt for r in batch] + pad
            structs = [r.struct for r in batch] + pad
            with trace.span("serve.encode", device_time=True):
                c = self.system.get_learned_conditioning(self.system.captions(prompts, structs))
                uc = self._uncond(bucket)
            with trace.span("serve.noise"):
                x0 = self._noise(batch, bucket, first.latent_len)
                if self.lockstep is not None:
                    self.lockstep.announce({"prompts": prompts, "structs": structs,
                                            "x0": x0.cpu().numpy(), "scale": first.scale,
                                            "steps": first.steps})
            with trace.span("serve.ode", device_time=True):
                since = dict(trace.counts)
                z = self.system.sample_cfg(c, first.scale, uc, timesteps=first.steps, x0=x0)
                trace.annotate(**trace.counts_since(since))
            with trace.span("serve.decode", device_time=True):
                mel = self.system.decode_first_stage(z)
            with trace.span("serve.vocode", device_time=True):
                wavs = self.system.vocode(mel)
            with trace.span("serve.deliver"):
                now = time.perf_counter_ns()
                with self._lock:
                    self.served += len(batch)
                    self.audio_seconds += (wavs.shape[-1] / self.cfg.sample_rate
                                           * len(batch))
                    self.batch_hist[len(batch)] = self.batch_hist.get(len(batch), 0) + 1
                    self.padded_rows += bucket - len(batch)
                for i, r in enumerate(batch):
                    r.wav = wavs[i]
                    r.latency_s = (now - r.t_in_ns) / 1e9
                    with self._lock:
                        self._latencies.append(r.latency_s)
                    r.event.set()
        except Exception as e:  # report to the waiting clients, keep serving
            with self._lock:
                self.errors += len(batch)
            for r in batch:
                r.error = repr(e)[:500]
                r.event.set()


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _make_handler(batcher: Batcher):
    cfg = batcher.cfg

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 10  # an idle keep-alive connection ends, so shutdown can join it

        def log_message(self, fmt, *args):  # stay quiet; /stats has counters
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"ok": True,
                                      "device": _device_name(batcher.system.device),
                                      **batcher.stats()})
            elif self.path == "/stats":
                self._send_json(200, batcher.stats())
            else:
                self._send_json(404, {"error": "unknown path"})

        def do_POST(self):
            rid = next(_request_ids)
            with trace.span("serve.request", request=rid):
                self._post(rid)

        def _post(self, rid: int):
            if self.path != "/generate":
                self._send_json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
                # numeric fields parsed inside the guard: "steps": "fast" is a 400
                req = _Pending(
                    prompt=str(prompt),
                    struct=str(body.get("struct_caption", f"<{prompt}& all>")),
                    steps=int(body.get("steps", cfg.default_steps)),
                    scale=float(body.get("scale", cfg.default_scale)),
                    latent_len=int(body.get("latent_len",
                                            batcher.system.spec.mel_length)),
                    seed=(int(body["seed"]) if "seed" in body else None), id=rid)
                batcher.check(req)
            except (ValueError, KeyError, TypeError, AttributeError) as e:
                self._send_json(400, {"error": f"bad request: {e!r}"})
                return

            batcher.submit(req)
            if not req.event.wait(cfg.request_timeout_s):
                req.abandoned = True  # the batcher drops it
                self._send_json(503, {"error": "timed out in queue"})
                return
            if req.error is not None:
                self._send_json(req.status, {"error": req.error})
                return
            with trace.span("serve.reply"):
                data = wav_bytes(req.wav, cfg.sample_rate)
                meta = {"latency_s": round(req.latency_s, 4),
                        "audio_seconds": req.wav.shape[-1] / cfg.sample_rate,
                        "sample_rate": cfg.sample_rate}
                if body.get("format") == "json":
                    self._send_json(200, {"wav_base64": base64.b64encode(data).decode(),
                                          **meta})
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("X-Latency-S", str(meta["latency_s"]))
                    self.end_headers()
                    self.wfile.write(data)

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # handler threads are joined by server_close
    daemon_threads = False


class AudioServer:
    """Owns the HTTP server and the batcher. `port=0` picks a free port."""

    def __init__(self, system, cfg: Optional[ServeConfig] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.cfg = cfg or ServeConfig()
        self.batcher = Batcher(system, self.cfg)
        self.httpd = _HTTPServer((host, port), _make_handler(self.batcher))
        self.port = self.httpd.server_address[1]
        self._http_thread: Optional[threading.Thread] = None
        self._closing = threading.Lock()
        self._closed = False

    def start(self) -> None:
        self.batcher.start()
        self._http_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True, name="maa3-http")
        self._http_thread.start()

    def serve_forever(self) -> None:
        """start(), then block until shutdown() is called from another
        thread or the caller is interrupted (Ctrl-C), and shut down."""
        self.start()
        try:
            while not self._closed:
                self._http_thread.join(0.5)
        except KeyboardInterrupt:
            pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        """Stop accepting, let the batch in flight finish, answer queued
        requests with 503, and join every thread the server started: the
        batcher, the HTTP loop and the request handlers."""
        with self._closing:
            if self._closed:
                return
            self._closed = True
            if self._http_thread is not None:
                self.httpd.shutdown()
                self._http_thread.join()
            self.batcher.stop()
            if self.batcher.is_alive():
                self.batcher.join()
            else:  # never started
                self.batcher._drain()
            if self.batcher.lockstep is not None:
                self.batcher.lockstep.close()
            self.httpd.server_close()
