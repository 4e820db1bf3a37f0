"""The port's micro-batching HTTP server and its CLIs on a tiny
text-to-music system (FLAN conditioner) on the CPU, over real HTTP on
127.0.0.1 (counterpart of tests/test_serve.py): bucket rounding, the wav
bytes round trip, requests end to end (coalescing, JSON format, stats, 400
and 404), group splitting, warm-up, seed reproducibility with batch
isolation, requests outside the server's bounds answered with 400, a
failed batch answered with 500 and counted, and no thread left
after shutdown; then `python -m maa3_tpu_torch.serve` and the txt2audio CLI
(-r, --vocoder-ckpt, --test-dataset, --batch_size, --interactive) serving
from checkpoint files."""

import base64
import io
import json
import os
import sys
import threading
import types
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from maa3_tpu_torch.models.bigvgan import BigVGANConfig
from maa3_tpu_torch.serving import AudioServer, ServeConfig, _bucket, wav_bytes
from maa3_tpu_torch.system import MAA3System
from tests.test_torch_ckpt import lightning_dict, small_clap, write_vocoder_dir

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUSIC = os.path.join(ROOT, "configs", "txt2music-cfm-cfg.yaml")
UP, DD = "model.params.unet_config.params.", "model.params.first_stage_config.params.ddconfig."
OVER = [UP + "hidden_size=32", UP + "depth=1", UP + "num_heads=2", UP + "context_dim=32",
        UP + "multiple_of=16", DD + "ch=32", DD + "ch_mult=[1, 2]",
        DD + "num_res_blocks=1", "model.params.mel_length=8"]
VOC = dict(upsample_rates=[2, 2], upsample_kernel_sizes=[4, 4], upsample_initial_channel=16,
           resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3, 5]])
WAV_LEN = 8 * 2 * 4  # latent 8 -> mel 16 -> wav 64


@pytest.fixture(scope="module")
def system():
    s = MAA3System.from_config([MUSIC], OVER, seed=1, device="cpu",
                               compute_dtype=torch.float32, clap_cfg=small_clap(),
                               voc_cfg=BigVGANConfig.from_dict(VOC), unfreeze=True)
    assert s.spec.cond_kind == "flan"
    return s


@pytest.fixture
def server(system):
    made = []

    def start(**kw):
        srv = AudioServer(system, ServeConfig(**{"max_batch": 4, "default_steps": 3, **kw}))
        srv.start()
        made.append(srv)
        return srv

    yield start
    for srv in made:
        srv.shutdown()


def _post(port, body, timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return json.loads(r.read())


def _pcm(data: bytes) -> np.ndarray:
    with wave.open(io.BytesIO(data)) as w:
        assert (w.getframerate(), w.getsampwidth()) == (16000, 2)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _concurrent(port, bodies):
    out = {}

    def go(i, body):
        with _post(port, body) as r:
            out[i] = (r.status, r.headers["Content-Type"], r.read())

    threads = [threading.Thread(target=go, args=(i, b)) for i, b in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    return out


def test_bucket_rounding():
    assert [_bucket(n, 8) for n in (1, 2, 3, 4, 5, 8, 9)] == [1, 2, 4, 4, 8, 8, 8]


def test_wav_bytes_roundtrip():
    x = np.sin(np.linspace(0, 20, 400)).astype(np.float32) * 0.5
    data = wav_bytes(x, 16000)
    assert data[:4] == b"RIFF"
    np.testing.assert_allclose(_pcm(data) / 32767.0, x, atol=2e-4)


def test_server_end_to_end(server):
    srv = server(batch_window_ms=300.0, seed=1)
    h = _get(srv.port, "/healthz")
    assert h["ok"] and h["device"] == "cpu" and h["served"] == 0
    results = _concurrent(srv.port, [{"prompt": f"sound {i}"} for i in range(3)])
    assert len(results) == 3
    for status, ctype, data in results.values():
        assert status == 200 and ctype == "audio/wav"
        pcm = _pcm(data)
        assert pcm.size == WAV_LEN and np.abs(pcm).max() > 0
    with _post(srv.port, {"prompt": "rain", "seed": 5, "format": "json"}) as r:
        out = json.loads(r.read())
    assert base64.b64decode(out["wav_base64"])[:4] == b"RIFF" and out["latency_s"] > 0
    assert out["audio_seconds"] == WAV_LEN / 16000
    stats = _get(srv.port, "/stats")
    assert stats["served"] == 4 and stats["errors"] == 0 and stats["audio_seconds"] >= 0
    hist = {int(k): v for k, v in stats["batch_histogram"].items()}
    assert sum(k * v for k, v in hist.items()) == 4
    assert sum(hist.values()) < 4  # the 3 concurrent requests shared a launch
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.port, {"steps": 3})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=60)
    assert e.value.code == 404


def test_group_splitting(server):
    """Requests with different steps never share a batch."""
    srv = server(batch_window_ms=300.0, seed=2)
    results = _concurrent(srv.port, [{"prompt": "p0", "steps": 3},
                                     {"prompt": "p1", "steps": 4},
                                     {"prompt": "p2", "steps": 3}])
    assert [results[i][0] for i in range(3)] == [200, 200, 200]
    stats = srv.batcher.stats()
    assert stats["served"] == 3 and stats["errors"] == 0
    assert sum(stats["batch_histogram"].values()) >= 2


def test_warmup_runs_buckets(system):
    srv = AudioServer(system, ServeConfig(max_batch=4, default_steps=3))
    srv.batcher.warmup((1, 4), steps=3)
    assert srv.batcher.stats()["served"] == 1 + 4
    srv.shutdown()


def test_seed_reproducible_and_batch_isolated(server):
    """{prompt, seed} gives the same bytes when repeated alone; co-batched
    with another request (batch 2 instead of 1) it is within one 16-bit step
    of them: the CPU's GEMMs may round a batch of 2 differently in the last
    bit of fp32. A malformed numeric field is a 400."""
    srv = server(batch_window_ms=300.0)
    body = {"prompt": "a dog", "seed": 7, "format": "json"}

    def wav_of(r):
        return base64.b64decode(json.loads(r.read())["wav_base64"])

    with _post(srv.port, body) as r:
        solo = wav_of(r)
    with _post(srv.port, body) as r:
        assert wav_of(r) == solo
    out = _concurrent(srv.port, [body, {"prompt": "a cat", "seed": 8, "format": "json"}])
    a, b = (base64.b64decode(json.loads(out[i][2])["wav_base64"]) for i in (0, 1))
    assert {int(k) for k in srv.batcher.stats()["batch_histogram"]} == {1, 2}
    assert np.abs(_pcm(a).astype(int) - _pcm(solo)).max() <= 1
    assert b != solo
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.port, {"prompt": "x", "steps": "fast"})
    assert e.value.code == 400


def test_request_bounds_are_400(server):
    """steps outside [2, 1000] and latent_len outside [1, max_latent_len]
    (default: the config's latent length) are refused with 400 before they
    reach the batcher; a shorter latent_len is served."""
    srv = server()
    for body in ({"latent_len": 9}, {"latent_len": 0}, {"steps": 1}, {"steps": 1001}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, {"prompt": "x", **body})
        assert e.value.code == 400, body
    with _post(srv.port, {"prompt": "x", "latent_len": 4}) as r:
        assert r.status == 200 and _pcm(r.read()).size == WAV_LEN // 2
    stats = srv.batcher.stats()
    assert stats["served"] == 1 and stats["errors"] == 0


def test_request_beyond_the_flash_kernels_is_refused():
    """On the card, a latent_len whose self-attention would run on the
    flash kernels with a head dim above theirs is refused per request, as
    the config is at load (system.check_limits at the request's length)."""
    from maa3_tpu_torch import config as tconfig
    from maa3_tpu_torch.serving import Batcher, _Pending
    spec = tconfig.parse_model_config(tconfig.load_config(
        [os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")],
        [UP + "hidden_size=160", UP + "num_heads=2"]))  # head dim 80; dense at 312
    card = types.SimpleNamespace(spec=spec, device=torch.device("cuda"))
    batcher = Batcher(card, ServeConfig(max_latent_len=8192))

    def req(n):
        return _Pending(prompt="x", struct="<x& all>", steps=25, scale=5.0,
                        latent_len=n, seed=None)

    batcher.check(req(4096))  # dense self-attention
    with pytest.raises(ValueError, match="head dim 80 .* exceeds the flash kernels' 72"):
        batcher.check(req(4097))
    with pytest.raises(ValueError, match="latent_len must be in"):
        batcher.check(req(8193))


def test_failed_batch_is_500_and_counted(server, system, monkeypatch):
    srv = server()

    def boom(*a, **kw):
        raise RuntimeError("the card fell over")

    monkeypatch.setattr(system, "sample_cfg", boom)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv.port, {"prompt": "x"})
    assert e.value.code == 500 and "fell over" in e.value.read().decode()
    monkeypatch.undo()
    with _post(srv.port, {"prompt": "x"}) as r:
        assert r.status == 200
    stats = srv.batcher.stats()
    assert stats["errors"] == 1 and stats["served"] == 1


def test_shutdown_leaves_no_thread(system):
    before = set(threading.enumerate())
    srv = AudioServer(system, ServeConfig(max_batch=2, default_steps=3))
    srv.start()
    assert _concurrent(srv.port, [{"prompt": "a"}, {"prompt": "b"}])[0][0] == 200
    srv.shutdown()
    srv.shutdown()  # a second call does nothing
    assert set(threading.enumerate()) - before == set()
    from maa3_tpu_torch.serving import _Pending
    late = _Pending("late", "<late& all>", 3, 5.0, 8, None)
    srv.batcher.submit(late)  # after shutdown: refused at once
    assert late.event.is_set() and late.status == 503


# -- the CLIs, serving from checkpoint files -----------------------------------

@pytest.fixture(scope="module")
def ckpt_files(system, tmp_path_factory):
    """A Lightning file of the tiny music system (its T5 under
    `transformer.`) and a vocoder directory, and from_config patched to the
    tiny conditioner and overrides the CLIs cannot pass."""
    tmp = tmp_path_factory.mktemp("serve_files")
    states = {"dit": system.dit.state_dict(), "vae": system.vae.state_dict(),
              "cond": system.cond.state_dict()}
    torch.save(lightning_dict(states), tmp / "music.ckpt")
    vdir = write_vocoder_dir(tmp / "vocoder", VOC, system.vocoder.state_dict())
    return str(tmp / "music.ckpt"), vdir


@pytest.fixture
def tiny_from_config(monkeypatch):
    real = MAA3System.from_config.__func__

    def small(cls, paths, overrides=(), *a, **kw):
        kw.update(clap_cfg=small_clap())
        return real(cls, paths, list(overrides) + OVER, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))


def test_serve_cli_from_checkpoint(ckpt_files, tiny_from_config, monkeypatch, capsys):
    """python -m maa3_tpu_torch.serve -b music -r ckpt --vocoder-ckpt dir:
    warm-up, then /healthz and /generate against the served system."""
    from maa3_tpu_torch import serve
    ckpt, vdir = ckpt_files
    seen = {}

    def serve_briefly(self):
        self.start()
        try:
            seen["health"] = _get(self.port, "/healthz")
            with _post(self.port, {"prompt": "a piano", "seed": 1}) as r:
                seen["pcm"] = _pcm(r.read())
            seen["dtype"] = self.batcher.system.compute_dtype
            seen["ema"] = self.batcher.system.dit.proj_in.weight.clone()
        finally:
            self.shutdown()

    monkeypatch.setattr(AudioServer, "serve_forever", serve_briefly)
    serve.main(["-b", MUSIC, "-r", ckpt, "--vocoder-ckpt", vdir, "--host", "127.0.0.1",
                "--port", "0", "--device", "cpu", "--precision", "fp32_highest",
                "--steps", "3", "--warmup", "1,2"])
    out = capsys.readouterr().out
    assert "using EMA weights" in out and "random weights" not in out
    assert "warming up buckets [1, 2]" in out
    assert seen["health"]["served"] == 3 and seen["pcm"].size == WAV_LEN
    assert seen["dtype"] == torch.float32
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    assert torch.equal(seen["ema"], sd["model_ema.diffusion_modelproj_inweight"])


def test_txt2audio_cli_from_checkpoint(ckpt_files, tiny_from_config, tmp_path,
                                       monkeypatch, capsys):
    """-r, --vocoder-ckpt, --test-dataset (3 rows) at --batch_size 2: the
    ragged tail repeats and drops its last prompt; then --interactive with
    prompts piped on stdin."""
    from maa3_tpu_torch import txt2audio
    ckpt, vdir = ckpt_files
    tsv = tmp_path / "test.tsv"
    tsv.write_text("name\tori_cap\tcaption\n" + "".join(
        f"clip{i}\tmusic {i}\t<music {i}& all>\n" for i in range(3)))
    common = ["-b", MUSIC, "-r", ckpt, "--vocoder-ckpt", vdir, "--steps", "3", "-W", "8",
              "--device", "cpu", "--fp32"]
    txt2audio.main(common + ["--test-dataset", str(tsv), "--batch_size", "2",
                             "--n_iter", "2", "--outdir", str(tmp_path / "set")])
    assert "random weights" not in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "set")) == [
        "clip0_0.wav", "clip1_0.wav", "clip2_0.wav", "result.csv"]
    with wave.open(str(tmp_path / "set" / "clip2_0.wav")) as w:
        assert w.getnframes() == WAV_LEN
    rows = (tmp_path / "set" / "result.csv").read_text().splitlines()
    assert rows == ["caption,file", "music 0,clip0_0.wav", "music 1,clip1_0.wav",
                    "music 2,clip2_0.wav"]
    monkeypatch.setattr(sys, "stdin", io.StringIO("a violin\nsoft rain\n\nignored\n"))
    txt2audio.main(common + ["--interactive", "--outdir", str(tmp_path / "repl")])
    assert sorted(os.listdir(tmp_path / "repl")) == ["interactive_0.wav",
                                                     "interactive_1.wav"]
