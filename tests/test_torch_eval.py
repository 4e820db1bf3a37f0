"""The evaluation layer's numpy modules, Cnn14 and the CLAP score, the port
against the JAX package on the CPU (fp32, rtol 1e-3 / atol 1e-4 unless a
test says otherwise), the same numpy inputs from a seed and the same
weights (maa3_tpu_torch.weights.*_from_jax, or one reference-keyed state
dict through both packages' importers):

- eval/metrics.py (average_precision, roc_auc, metrics with its absent-class
  fallback), data/transforms.py (StandardNormalizeAudio's statistics, cache
  file and apply; Crop), data/structurize.py (the heuristic, both
  directions, the live client's requests and the resumable TSV workflow
  against a loopback stub) and the structurize_captions CLI, each against
  the JAX copy; nothing reaches a host other than 127.0.0.1, and every
  server thread is joined with a timeout;
- Cnn14 at full width on 0.25 s clips (log-mel, embedding, clipwise
  output) and its importer on a PANNs-keyed state dict;
- CLAPScorer with a small BertConfig in both packages (audio resampled from
  16 kHz and tiled or cropped, text, score), from a CLAP_weights_2022-keyed
  file, and the cal_clap_score CLI against scripts/cal_clap_score.py."""

import csv
import importlib.util
import io
import json
import os
import sys
import threading
from contextlib import redirect_stdout
from http.server import BaseHTTPRequestHandler, HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from maa3_tpu.data import structurize as jstruct
from maa3_tpu.data import transforms as jtransforms
from maa3_tpu.data.tokenizers import HashTokenizer as JHashTokenizer
from maa3_tpu.eval import clap_score as jclap_score
from maa3_tpu.eval import metrics as jmetrics
from maa3_tpu.models import bert as jbert
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import cnn14 as jcnn14
from maa3_tpu_torch import cal_clap_score as tclap_cli
from maa3_tpu_torch import structurize_captions as tstruct_cli
from maa3_tpu_torch import torch_import as timport
from maa3_tpu_torch import weights as tw
from maa3_tpu_torch.data import structurize as tstruct
from maa3_tpu_torch.data import transforms as ttransforms
from maa3_tpu_torch.data.tokenizers import HashTokenizer
from maa3_tpu_torch.eval import clap_score as tclap_score
from maa3_tpu_torch.eval import metrics as tmetrics
from maa3_tpu_torch.models import cnn14 as tcnn14
from maa3_tpu_torch.models.bert import BertConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-4)
SMALL_BERT = dict(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
DURATION = 0.25  # seconds of 44.1 kHz audio per scored clip


def _close(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# metrics, transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, False), (1, True)])
def test_metrics_match_jax(seed, ties):
    """AP, ROC-AUC (midranks for ties) and metrics() over random posteriors,
    the same floats as JAX's numpy copy; a class absent from the targets
    takes the fallback (mAP 0, mROCAUC 0.5) in both."""
    rng = np.random.RandomState(seed)
    n, c = 40, 6
    logits = rng.randn(n, c)
    if ties:
        logits = np.round(logits, 1)
    y = rng.randint(0, c, n)
    for k in range(c):
        assert tmetrics.average_precision(y == k, logits[:, k]) == \
            jmetrics.average_precision(y == k, logits[:, k])
        assert tmetrics.roc_auc(y == k, logits[:, k]) == jmetrics.roc_auc(y == k, logits[:, k])
    assert tmetrics.metrics(y, logits, (1, 3)) == jmetrics.metrics(y, logits, (1, 3))
    absent = np.where(y == c - 1, 0, y)
    got = tmetrics.metrics(absent, logits, (1, 5))
    assert got == jmetrics.metrics(absent, logits, (1, 5))
    assert (got["mAP"], got["mROCAUC"]) == (0.0, 0.5)
    with pytest.raises(ValueError):
        tmetrics.roc_auc(np.zeros(4), np.arange(4.0))


def test_transforms_match_jax(tmp_path):
    """StandardNormalizeAudio from an ids file and from train_paths: the
    statistics, the cache file (name and %0.8f text) and its reload, the
    apply on (F, T), (B, F, T) and dict items; Crop centred and random
    (the same RandomState draws)."""
    rng = np.random.RandomState(0)
    specs = tmp_path / "mels"
    specs.mkdir()
    ids = []
    for i, t in enumerate((120, 200, 64, 310, 150)):
        np.save(specs / f"vid{i}_mel.npy",
                (rng.randn(80, t) * (1 + i * 0.3) - 2.0).astype(np.float32))
        ids.append(f"vid{i}")
    (tmp_path / "ids.txt").write_text("\n".join(ids) + "\n")
    name = "train_means_stds_mels.txt"
    for pkg, mod in (("t", ttransforms), ("j", jtransforms)):
        (tmp_path / pkg).mkdir()
        mod.StandardNormalizeAudio(str(specs), str(tmp_path / "ids.txt"), str(tmp_path / pkg))
    assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    paths = [str(specs / f"{i}_mel.npy") for i in ids[:3]]
    t_norm = ttransforms.StandardNormalizeAudio(str(specs), cache_path=str(tmp_path / "tp"),
                                                train_paths=paths)
    j_norm = jtransforms.StandardNormalizeAudio(str(specs), cache_path=str(tmp_path / "jp"),
                                                train_paths=paths)
    np.testing.assert_array_equal(t_norm.means, j_norm.means)
    np.testing.assert_array_equal(t_norm.stds, j_norm.stds)
    loaded = ttransforms.StandardNormalizeAudio.from_stats_file(str(tmp_path / "t" / name))
    x = rng.randn(2, 80, 30)
    for item in (x, x[0]):
        np.testing.assert_array_equal(
            loaded(item),
            jtransforms.StandardNormalizeAudio.from_stats_file(str(tmp_path / "j" / name))(item))
    np.testing.assert_array_equal(t_norm({"input": x[0]})["input"], j_norm(x[0]))
    for random_crop in (False, True):
        t_crop = ttransforms.Crop((60, 20), random_crop, np.random.RandomState(3))
        j_crop = jtransforms.Crop((60, 20), random_crop, np.random.RandomState(3))
        for _ in range(3):
            np.testing.assert_array_equal(t_crop(x[0]), j_crop(x[0]))
    with pytest.raises(ValueError):
        ttransforms.Crop((90, 20))(x[0])


# ---------------------------------------------------------------------------
# structurize
# ---------------------------------------------------------------------------

CAPTIONS = ["A dog barks, then a car horn", "train passing followed by short honks.",
            "a bird sings while a stream flows, then wind blows and then a door shuts",
            "Rain falls as thunder rolls", "", "wind, then birds after which silence"]


def test_structurize_heuristics_match_jax():
    """The heuristic structurizer, the trivial fallback, an LLM callable and
    the inverse: JAX's strings."""
    for cap in CAPTIONS:
        s = tstruct.heuristic_natural_to_struct(cap)
        assert s == jstruct.heuristic_natural_to_struct(cap)
        assert tstruct.struct_to_natural(s) == jstruct.struct_to_natural(s)
        assert tstruct.natural_to_struct(cap) == jstruct.natural_to_struct(cap)
        llm = lambda prompt: prompt[-20:]  # noqa: E731
        assert tstruct.natural_to_struct(cap, llm) == jstruct.natural_to_struct(cap, llm)
    assert tstruct.N2S_FEWSHOT_PROMPT == jstruct.N2S_FEWSHOT_PROMPT


class _Stub(BaseHTTPRequestHandler):
    """A loopback /chat/completions: pops 'ok:<answer>', '500' or 'sorry'
    off the server's script and records each request."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.server.requests.append({"path": self.path, "body": body,
                                     "auth": self.headers.get("Authorization", "")})
        action = self.server.script.pop(0) if self.server.script else "ok:<stub& all>"
        if action == "500":
            self.send_response(500)
            self.end_headers()
            return
        answer = "Sorry, no." if action == "sorry" else action[3:]
        payload = json.dumps({"choices": [{"message": {"content": answer}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


@pytest.fixture()
def stub():
    srv = HTTPServer(("127.0.0.1", 0), _Stub)
    srv.requests, srv.script = [], []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _clients(srv, **kw):
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1"
    kw = dict(api_key="k", base_url=url, timeout_s=10.0, retry_backoff_s=0.01, **kw)
    return tstruct.OpenAIStructurizer(**kw), jstruct.OpenAIStructurizer(**kw)


def test_structurizer_client_matches_jax(stub):
    """Against the loopback stub, the port's client sends JAX's request
    (path, bearer, body) and reads the answer, the refusal fallback and a
    retried 5xx the same way; a persistent 5xx raises after max_retries."""
    t_cli, j_cli = _clients(stub, max_retries=2)
    for client in (t_cli, j_cli):
        stub.script = ["ok:<dog& all>@<horn& end>", "sorry", "500", "ok:<rain& all>"]
        assert [client(c) for c in ("A dog barks, then a horn", "Loud Thunder", "rain")] == [
            "<dog& all>@<horn& end>", "<loud thunder& all>", "<rain& all>"]
    half = len(stub.requests) // 2
    assert stub.requests[:half] == stub.requests[half:]
    stub.script = ["500", "500"]
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        t_cli("rain")


def test_structurize_tsv_and_cli_match_jax(stub, tmp_path, monkeypatch):
    """structurize_tsv (a failing row falls back offline; a rerun resumes
    without requests), then the CLI's three modes against
    scripts/structurize_captions.py run in-process: the heuristic, --llm-cmd
    (a local command through the shell) and --openai (the loopback stub,
    OPENAI_API_KEY from the environment): the same files."""
    rows = [("a", "a dog barks"), ("b", "rain falls"), ("c", "wind blows")]
    for pkg in ("t", "j"):
        d = tmp_path / pkg
        d.mkdir()
        with open(d / "caps.tsv", "w", newline="") as f:
            w = csv.writer(f, delimiter="\t")
            w.writerow(["name", "caption"])
            w.writerows(rows)
    outs = []
    for pkg, (mod, client) in zip("tj", zip((tstruct, jstruct),
                                            _clients(stub, max_retries=1)), strict=True):
        stub.script = ["ok:<dog barking& all>", "500", "ok:<wind& all>"]
        outs.append(mod.structurize_tsv(str(tmp_path / pkg / "caps.tsv"), client))
        n = len(stub.requests)
        assert mod.structurize_tsv(str(tmp_path / pkg / "caps.tsv"), client) == outs[-1]
        assert len(stub.requests) == n
    assert [open(o).read() for o in outs][0] == open(outs[1]).read()
    assert (tmp_path / "t" / "caps.txt").read_text() == (tmp_path / "j" / "caps.txt").read_text()

    src = tmp_path / "in.tsv"
    src.write_text("name\tori_cap\n" + "".join(f"r{i}\t{c}\n" for i, c in enumerate(CAPTIONS)))
    llm = f"{sys.executable} -c \"import sys; print(sys.stdin.read()[-12:].upper())\""
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    url = f"http://127.0.0.1:{stub.server_address[1]}/v1"
    for extra in ([], ["--llm-cmd", llm], ["--openai", "--base_url", url]):
        got = {}
        for pkg in ("t", "j"):
            out = tmp_path / f"{pkg}{len(extra)}" / "out.tsv"
            out.parent.mkdir()
            argv = ["--tsv_path", str(src), "--out", str(out)] + extra
            buf = io.StringIO()
            with redirect_stdout(buf):
                if pkg == "t":
                    tstruct_cli.main(argv)
                else:
                    monkeypatch.setattr(sys, "argv", ["structurize_captions.py"] + argv)
                    _script("structurize_captions").main()
            written = (out.parent / "in_struct.tsv") if "--openai" in extra else out
            got[pkg] = written.read_text()
        assert got["t"] == got["j"], extra
        if not extra:
            assert "\t<A dog barks& all>@<a car horn& end>\n" in got["t"]


# ---------------------------------------------------------------------------
# Cnn14, CLAP score
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clap_params():
    """A JAX CLAPScorer params tree: Cnn14 at full width with nontrivial BN
    statistics, a small BERT, both projections."""
    rng = np.random.RandomState(7)
    k = jax.random.split(jax.random.PRNGKey(0), 4)
    audio = jcnn14.cnn14_init(k[0])
    for bn in [audio["bn0"]] + [b[n] for b in audio["blocks"] for n in ("bn1", "bn2")]:
        c = bn["mean"].shape[0]
        bn["mean"] = jnp.asarray(rng.normal(0, 0.3, c).astype(np.float32))
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c).astype(np.float32))
        bn["weight"] = jnp.asarray(rng.uniform(0.8, 1.2, c).astype(np.float32))
    bcfg = jbert.BertConfig(**SMALL_BERT)
    return {"audio": audio, "audio_proj": jclap.projection_init(k[1], 2048, 1024),
            "text": jbert.bert_init(k[2], bcfg),
            "text_proj": jclap.projection_init(k[3], SMALL_BERT["hidden_size"], 1024)}


def test_cnn14_matches_jax(clap_params):
    """Cnn14 at full width on two 0.25 s clips at 44.1 kHz: the log-mel
    frontend, the embedding and the clipwise output; then a PANNs-keyed
    state dict (the torchlibrosa frontend's keys, num_batches_tracked, a
    prefix) through both importers."""
    rng = np.random.RandomState(8)
    cfg = jcnn14.Cnn14Config()
    m = tcnn14.Cnn14()
    m.load_state_dict(tw.cnn14_from_jax(clap_params["audio"]), strict=True)
    wav = (0.3 * rng.randn(2, 11025)).astype(np.float32)
    j_apply = jax.jit(lambda p, w: (jcnn14.cnn14_logmel(w, cfg), jcnn14.cnn14_apply(p, cfg, w)))
    logmel, want = j_apply(clap_params["audio"], jnp.asarray(wav))
    with torch.no_grad():
        _close(tcnn14.cnn14_logmel(torch.from_numpy(wav), m.cfg), logmel, "logmel")
        got = tcnn14.cnn14_apply(m, torch.from_numpy(wav))
    for k in ("embedding", "clipwise_output"):
        _close(got[k], want[k], k)
    sd = {"audio_encoder.base." + k: v.clone() for k, v in m.state_dict().items()}
    sd["audio_encoder.base.spectrogram_extractor.stft.conv_real.weight"] = torch.zeros(513, 1, 1024)
    sd["audio_encoder.base.logmel_extractor.melW"] = torch.zeros(513, 64)
    sd["audio_encoder.base.bn0.num_batches_tracked"] = torch.tensor(1)
    imported = timport.cnn14_from_torch(sd, prefix="audio_encoder.base.")
    jp = jcnn14.cnn14_from_torch({k: v.numpy() for k, v in sd.items()}, cfg,
                                 prefix="audio_encoder.base.")
    with torch.no_grad():
        _close(tcnn14.cnn14_apply(imported, torch.from_numpy(wav))["embedding"],
               j_apply(jp, jnp.asarray(wav))[1]["embedding"], "imported")


def _scorers(params):
    jtok, ttok = JHashTokenizer(max_length=100), HashTokenizer(max_length=100)
    j = jclap_score.CLAPScorer(params, jcnn14.Cnn14Config(),
                               jbert.BertConfig(**SMALL_BERT), jtok, duration=DURATION)
    model = tclap_score.CLAPModel(bert_cfg=BertConfig(**SMALL_BERT))
    model.load_state_dict(tw.clap_scorer_from_jax(params), strict=True)
    return tclap_score.CLAPScorer(model, ttok, duration=DURATION), j


WAVS = [(16000, 0.1), (16000, 0.4), (22050, 0.3)]  # (rate, seconds): tiled, cropped


def test_clap_scorer_matches_jax(clap_params, tmp_path):
    """CLAPScorer with a small BERT in both packages: the audio prepared on
    the host (16 kHz resampled to 44.1 kHz, tiled or cropped to the
    duration), the audio and [CLS] text embeddings and the cosine scores;
    then a CLAP_weights_2022-keyed file ({'model': ...}, with the BERT
    pooler and a logit scale) through the port's from_torch_ckpt against
    JAX's importers of the same keys; random_init runs from a generator."""
    rng = np.random.RandomState(9)
    t, j = _scorers(clap_params)
    wavs = [(0.3 * rng.randn(int(16000 * s))).astype(np.float32) for _, s in WAVS[:2]]
    caps = ["a dog barks in the distance", "rain on a tin roof"]
    for w in wavs:
        np.testing.assert_array_equal(t._prep_audio(w, 16000), j._prep_audio(w, 16000))
    j_audio = jax.jit(lambda p, x: jclap.projection_apply(
        p["audio_proj"], jcnn14.cnn14_apply(p["audio"], j.audio_cfg, x)["embedding"]))
    batch = np.stack([j._prep_audio(w, 16000) for w in wavs])
    want_a = j_audio(clap_params, jnp.asarray(batch))
    _close(t.audio_embeddings(wavs, 16000), want_a, "audio")
    want_t = j.text_embeddings(caps)
    _close(t.text_embeddings(caps), want_t, "text")
    a = np.asarray(want_a) / np.linalg.norm(want_a, axis=-1, keepdims=True)
    tt = np.asarray(want_t) / np.linalg.norm(want_t, axis=-1, keepdims=True)
    _close(t.score(wavs, caps, 16000), (a * tt).sum(-1), "score")

    sd = {k: v.clone() for k, v in t.model.state_dict().items()}
    sd["caption_encoder.base.pooler.dense.weight"] = torch.zeros(32, 32)
    sd["logit_scale_a"] = torch.tensor(1.0)
    torch.save({"model": sd}, tmp_path / "clap.pth")
    loaded = tclap_score.CLAPScorer.from_torch_ckpt(
        str(tmp_path / "clap.pth"), bert_cfg=BertConfig(**SMALL_BERT), device="cpu")
    nsd = {k: v.numpy() for k, v in sd.items()}
    jcfg = jbert.BertConfig(**SMALL_BERT)
    jp = {"audio": jcnn14.cnn14_from_torch(nsd, j.audio_cfg, prefix="audio_encoder.base."),
          "audio_proj": jclap.projection_from_torch(nsd, prefix="audio_encoder.projection."),
          "text": jbert.bert_from_torch(nsd, jcfg, prefix="caption_encoder.base."),
          "text_proj": jclap.projection_from_torch(nsd, prefix="caption_encoder.projection.")}
    _close(loaded.text_embeddings(caps),
           jclap_score.CLAPScorer(jp, j.audio_cfg, jcfg, j.tokenizer).text_embeddings(caps),
           "file: text")
    loaded.duration = DURATION
    _close(loaded.audio_embeddings(wavs, 16000), j_audio(jp, jnp.asarray(batch)), "file: audio")
    rand = tclap_score.CLAPScorer.random_init(torch.Generator().manual_seed(1),
                                              bert_cfg=BertConfig(**SMALL_BERT), device="cpu")
    rand.duration = DURATION
    assert np.isfinite(rand.score(wavs, caps, 16000)).all()


def test_cal_clap_score_cli_matches_jax(clap_params, tmp_path, monkeypatch):
    """python -m maa3_tpu_torch.cal_clap_score against
    scripts/cal_clap_score.py in-process, both scorers built from the same
    weights (each package's random_init patched to them): the wavs matched
    by name (<name>_0.wav, <name>.wav, <name>_0_0.wav; a row without a wav
    skipped), int16 and float wavs, batches of 2, the same scores; mixed
    sample rates in one batch raise."""
    rng = np.random.RandomState(10)
    d = tmp_path / "wavs"
    d.mkdir()
    rows = ["name\tori_cap"]
    for i, (name, (sr, secs)) in enumerate(zip(("a_0", "b", "c_0_0"), WAVS[:2] * 2)):
        w = 0.3 * rng.randn(int(sr * secs))
        w = (w * 32767).astype(np.int16) if i != 1 else w.astype(np.float32)
        wavfile.write(d / f"{name}.wav", sr, w)
        rows.append(f"{name.split('_')[0]}\tcaption number {i}")
    rows.append("missing\tno wav for this row")
    (tmp_path / "m.tsv").write_text("\n".join(rows) + "\n")
    t, j = _scorers(clap_params)
    # JAX's scorer runs Cnn14 op by op; jitted, the same ops compile once
    monkeypatch.setattr(jclap_score, "cnn14_apply",
                        jax.jit(jcnn14.cnn14_apply, static_argnums=1))
    monkeypatch.setattr(tclap_score.CLAPScorer, "random_init",
                        classmethod(lambda cls, *a, **k: t))
    monkeypatch.setattr(jclap_score.CLAPScorer, "random_init",
                        classmethod(lambda cls, *a, **k: j))
    j_scores = []
    real = jclap_score.CLAPScorer.score
    monkeypatch.setattr(jclap_score.CLAPScorer, "score",
                        lambda self, *a, **k: j_scores.append(real(self, *a, **k)) or j_scores[-1])
    argv = ["--wav_dir", str(d), "--tsv", str(tmp_path / "m.tsv"), "--batch", "2"]
    with redirect_stdout(io.StringIO()):
        got = tclap_cli.main(argv + ["--device", "cpu"])
        monkeypatch.setattr(sys, "argv", ["cal_clap_score.py"] + argv)
        _script("cal_clap_score").main()
    _close(got, np.concatenate(j_scores), "scores")
    assert len(got) == 3
    wavfile.write(d / "b.wav", 22050, np.zeros(2205, np.float32))
    with pytest.raises(ValueError, match="one sample rate"):
        with redirect_stdout(io.StringIO()):
            tclap_cli.main(argv + ["--device", "cpu"])
