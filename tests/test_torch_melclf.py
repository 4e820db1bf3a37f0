"""The mel classifiers and the metrics over them, the port against the JAX
package on the CPU (fp32, rtol 1e-3 / atol 1e-4 unless a test says
otherwise), the same numpy inputs from a seed and the same weights
(maa3_tpu_torch.weights.*_from_jax, or one reference-keyed state dict
through both packages' importers):

- the VGGishish (--small's stack) with batch statistics and with running
  statistics, its feature taps and lpaps_distance; LPAPS at full width;
  the Melception at (2, 80, 96), logits, features and aux, from a
  torchvision-keyed file with running statistics and without;
- frechet_distance and kl_divergence_softmax on identical arrays, with
  more samples than dimensions and with fewer (a singular covariance);
- the CLIs, each against the JAX script run in-process: train_melclf (two
  steps from a shared state, --cls_weights, --norm, --val_tsv; the
  optimizer against optax.adamw), predict_melclf on each package's
  checkpoint, cal_fd_score on both backbones. FD over a 4096-d embedding
  takes scipy's sqrtm minutes on this CPU, so the CLI tests hold the
  embeddings each CLI hands to frechet_distance, not the FD."""

import importlib.util
import io
import json
import os
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maa3_tpu import torch_import as jimport
from maa3_tpu.eval import lpaps as jlpaps
from maa3_tpu.models import melception as jmc
from maa3_tpu.models import melclf as jmelclf
from maa3_tpu_torch import cal_fd_score as tfd_cli
from maa3_tpu_torch import predict_melclf as tpredict_cli
from maa3_tpu_torch import torch_import as timport
from maa3_tpu_torch import train_melclf as ttrain_cli
from maa3_tpu_torch import weights as tw
from maa3_tpu_torch.eval import lpaps as tlpaps
from maa3_tpu_torch.models import melception as tmc
from maa3_tpu_torch.models import melclf as tmelclf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-4)
SMALL = (16, "MP", 32, "MP", 64, "MP")
N_CLASSES = 7


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


def _run_jax_cli(name, argv, monkeypatch):
    """scripts/<name>.py's main() in this process; its standard output."""
    mod = _script(name)
    monkeypatch.setattr(sys, "argv", [name + ".py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


def _with_running_stats(p, rng):
    """JAX VGGishish params with nontrivial BN running statistics."""
    for layer in p["features"]:
        c = layer["b"].shape[0]
        layer["bn"]["mean"] = jnp.asarray(rng.normal(0, 0.05, c).astype(np.float32))
        layer["bn"]["var"] = jnp.asarray(rng.uniform(0.8, 1.2, c).astype(np.float32))
    return p


@pytest.mark.parametrize("running", [False, True])
def test_melclf_matches_jax(running):
    """The VGGishish at --small's stack: logits and the 4096-d embedding,
    batch statistics (random init, a train_melclf classifier) and running
    statistics (an imported one); the feature taps and lpaps_distance."""
    rng = np.random.RandomState(0)
    cfg = jmelclf.MelClfConfig(conv_layers=SMALL, num_classes=N_CLASSES)
    p = jmelclf.melclf_init(jax.random.PRNGKey(0), cfg)
    if running:
        p = _with_running_stats(p, rng)
    m = tmelclf.MelClf(tmelclf.MelClfConfig(conv_layers=SMALL, num_classes=N_CLASSES),
                       running_stats=running)
    m.load_state_dict(tw.melclf_from_jax(p, SMALL), strict=True)
    mel = rng.randn(3, 80, 96).astype(np.float32)
    logits, emb = jax.jit(lambda p, m: jmelclf.melclf_apply(p, cfg, m, return_embedding=True))(
        p, jnp.asarray(mel))
    with torch.no_grad():
        t_logits, t_emb = tmelclf.melclf_apply(m, torch.from_numpy(mel), True)
        taps = tmelclf.melclf_features(m.features, torch.from_numpy(mel))
        dist = tlpaps.lpaps_distance(m.features, torch.from_numpy(mel),
                                     torch.from_numpy(mel[::-1].copy()), [1.0, 0.5, 2.0, 1.0])
    _close(t_logits, logits, "logits")
    _close(t_emb, emb, "embedding")
    want_taps, want_dist = jax.jit(lambda p, a, b: (
        jlpaps.melclf_features(p, cfg, a),
        jlpaps.lpaps_distance(p, cfg, a, b, [1.0, 0.5, 2.0, 1.0])))(
            p, jnp.asarray(mel), jnp.asarray(mel[::-1]))
    for got, want in zip(taps, want_taps, strict=True):
        _close(got, want, "tap")
    _close(dist, want_dist, "lpaps_distance")


def test_melclf_importer_matches_jax():
    """A reference-keyed VGGishish state dict (BN running statistics and
    num_batches_tracked, --small's stack) through both importers: the same
    logits; the file's count buffers are skipped."""
    rng = np.random.RandomState(1)
    ref = tmelclf.MelClf(tmelclf.MelClfConfig(conv_layers=SMALL, num_classes=5),
                         running_stats=True)
    sd = {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32) * 0.1)
          for k, v in ref.state_dict().items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k] = sd[k].abs() + 0.5
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    m = timport.melclf_from_torch(sd, tmelclf.MelClfConfig(conv_layers=SMALL, num_classes=5))
    assert m.features[1].running_mean is not None
    jp = jimport.melclf_from_torch({k: v.numpy() for k, v in sd.items()},
                                   jmelclf.MelClfConfig(conv_layers=SMALL, num_classes=5))
    mel = rng.randn(2, 80, 64).astype(np.float32)
    with torch.no_grad():
        got = tmelclf.melclf_apply(m, torch.from_numpy(mel))
    _close(got, jmelclf.melclf_apply(jp, jmelclf.MelClfConfig(conv_layers=SMALL,
                                                              num_classes=5),
                                     jnp.asarray(mel)))


def test_lpaps_matches_jax():
    """LPAPS at full width (VGGishish16 without BN) with a per-frequency
    scaling and learned lins, through weights.lpaps_from_jax and through
    both importers from one reference-keyed state dict; lpaps_init_'s
    identity scaling and 1 / C lins."""
    rng = np.random.RandomState(2)
    p = jlpaps.lpaps_init(jax.random.PRNGKey(1))
    p["scaling"] = {"shift": jnp.asarray(rng.randn(80).astype(np.float32)),
                    "scale": jnp.asarray(rng.uniform(0.5, 2.0, 80).astype(np.float32))}
    p["lins"] = [jnp.asarray(rng.rand(c).astype(np.float32)) for c in tlpaps.LPAPS_CHNS]
    conv = jlpaps.LPAPS_BACKBONE_CFG.conv_layers
    m = tlpaps.LPAPS()
    m.load_state_dict(tw.lpaps_from_jax(p, conv), strict=True)
    a = rng.randn(2, 80, 64).astype(np.float32)
    b = (a + 0.3 * rng.randn(2, 80, 64)).astype(np.float32)
    j_lpaps = jax.jit(lambda p, a, b: jlpaps.lpaps_apply(p, jlpaps.LPAPS_BACKBONE_CFG, a, b))
    want = j_lpaps(p, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        _close(tlpaps.lpaps_apply(m, torch.from_numpy(a), torch.from_numpy(b)), want, "lpaps")
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        imported = timport.lpaps_from_torch(sd)
        _close(tlpaps.lpaps_apply(imported, torch.from_numpy(a), torch.from_numpy(b)),
               j_lpaps(jimport.lpaps_from_torch({k: v.numpy() for k, v in sd.items()}),
                       jnp.asarray(a), jnp.asarray(b)),
               "imported")
        fresh = tlpaps.lpaps_init_(tlpaps.LPAPS(), torch.Generator().manual_seed(0))
    assert float(fresh.scaling_layer.scale.min()) == 1.0
    assert torch.all(fresh.lin4.model[1].weight == 1.0 / 512)


@pytest.fixture(scope="module")
def melception_file():
    """A torchvision-keyed melception state dict (running statistics, the aux
    head, num_batches_tracked; convs at std 1 / sqrt(fan_in), so that the
    activations keep their scale through the running-statistics BNs), two
    mels, and JAX's (logits, features, aux) on them through JAX's importer:
    from the file, and from the file without its running statistics (batch
    statistics, as a random or trained-by-train_melclf model runs)."""
    rng = np.random.RandomState(3)
    ref = tmc.Melception(tmc.MelceptionConfig(num_classes=N_CLASSES), running_stats=True)
    sd = {}
    for k, v in ref.state_dict().items():
        if k.endswith("conv.weight"):
            v = rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[1:]))
        elif k.endswith("running_mean") or k.endswith("bias"):
            v = rng.normal(0, 0.05, v.shape)
        elif k.endswith("running_var") or k.endswith("bn.weight"):
            v = rng.uniform(0.8, 1.2, v.shape)
        else:  # fc, AuxLogits.fc
            v = rng.randn(*v.shape) * 0.05
        sd[k] = torch.from_numpy(np.asarray(v, np.float32))
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(3)
    mel = (rng.randn(2, 80, 96) * 0.5).astype(np.float32)
    cfg = jmc.MelceptionConfig(num_classes=N_CLASSES)
    want = {}
    for kind, keep in (("running", lambda k: True),
                       ("batch", lambda k: "running_" not in k and "num_batches" not in k)):
        jp = jimport.melception_from_torch({k: v.numpy() for k, v in sd.items() if keep(k)})
        want[kind] = tuple(np.asarray(x) for x in jax.jit(
            lambda p, m: jmc.melception_apply(p, cfg, m, return_features=True,
                                              return_aux=True))(jp, jnp.asarray(mel)))
    return sd, mel, want


def test_melception_matches_jax(melception_file):
    """The Melception's logits, features and aux from a torchvision-keyed
    file through both importers (running statistics), and from the same
    file without its statistics (batch statistics); the port's init
    (melception_init_) runs and is finite."""
    sd, mel, want = melception_file
    imported = timport.melception_from_torch(sd)
    assert imported.Conv2d_1a_3x3.bn.running_mean is not None
    batch = timport.melception_from_torch({k: v for k, v in sd.items() if "running_" not in k})
    assert batch.Conv2d_1a_3x3.bn.running_mean is None
    with torch.no_grad():
        for m, kind in ((imported, "running"), (batch, "batch")):
            got = tmc.melception_apply(m, torch.from_numpy(mel), True, True)
            for g, w, what in zip(got, want[kind], ("logits", "features", "aux"), strict=True):
                _close(g, w, f"{kind}: {what}")
        fresh = tmc.melception_init_(tmc.Melception(tmc.MelceptionConfig(num_classes=3)),
                                     torch.Generator().manual_seed(0))
        assert torch.isfinite(tmc.melception_apply(fresh, torch.from_numpy(mel))).all()


@pytest.mark.parametrize("n,d", [(24, 6), (5, 16)])
def test_fd_and_kl_match_jax(n, d):
    """frechet_distance and kl_divergence_softmax on identical arrays: more
    samples than dimensions, and fewer (a singular covariance, whose sqrtm
    is complex; both keep its real part). The FD agrees to 1e-6 of the sum
    of the covariances' traces, the scale of its rounding."""
    rng = np.random.RandomState(n)
    a = rng.randn(n, d)
    b = rng.randn(n, d) * 1.3 + 0.2
    want = jmelclf.frechet_distance(a, b)
    scale = np.trace(np.cov(a, rowvar=False)) + np.trace(np.cov(b, rowvar=False))
    assert abs(tmelclf.frechet_distance(a, b) - want) <= 1e-6 * scale
    assert abs(tmelclf.frechet_distance(a, a)) < 1e-6 * scale
    la, lb = rng.randn(n, 9), rng.randn(n, 9)
    assert tmelclf.kl_divergence_softmax(la, lb) == pytest.approx(
        jmelclf.kl_divergence_softmax(la, lb), rel=1e-12)


def test_optimizer_is_optax_adamw():
    """train_melclf's optimizer is optax.adamw(lr) (decay 1e-4, no clip):
    three steps on a parameter with a gradient and on one without (decay
    only, at a large lr, where torch's default 1e-2 would differ 100x)."""
    rng = np.random.RandomState(5)
    p0 = {"g": rng.randn(6).astype(np.float32), "z": rng.randn(4).astype(np.float32)}
    grads = [{"g": rng.randn(6).astype(np.float32) * 10, "z": np.zeros(4, np.float32)}
             for _ in range(3)]
    for lr in (3e-4, 100.0):
        tx = optax.adamw(lr)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = ttrain_cli.make_optimizer(list(tp.values()), lr)
        for g in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, upd)
            for k, v in g.items():
                tp[k].grad = torch.from_numpy(v.copy())
            opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=f"lr {lr} {k}")


def _write_mels(d, n, labels, seed):
    """n (80, T) log-mels (some shorter than --mel_len, so tiled) and their
    manifest (mel_path, label) under d."""
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    lines = ["name\tmel_path\tlabel"]
    for i in range(n):
        path = os.path.join(d, f"m{i:02d}.npy")
        t = 96 if i % 3 else 61
        np.save(path, (rng.randn(80, t) * 2.0 - 4.0 + 0.3 * (i % 4)).astype(np.float32))
        lines.append(f"m{i:02d}\t{path}\t{labels[i % len(labels)]}")
    tsv = os.path.join(d, "manifest.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tsv


def _json_line(out, prefix=""):
    line = [ln for ln in out.splitlines() if ln.startswith(prefix + "{")][-1]
    return json.loads(line[len(prefix):])


def test_classifier_clis_match_jax(tmp_path, monkeypatch):
    """train_melclf, then predict_melclf and cal_fd_score on what it wrote,
    each against its JAX script in-process on the same files. Training
    takes two steps of --small from JAX's initial weights (the port's
    init_model patched to them) with --cls_weights (uneven classes, so
    mean(ce w[y]) differs from a weight-normalised mean), --norm and
    --val_tsv: the losses and validation metrics as printed, the norm
    statistics cache, and every parameter after the steps. An Adam step
    moves an element by up to lr whatever the size of its gradient, so an
    element whose gradient is at rounding noise moves by noise in either
    package: every conv bias (a batch-statistics BatchNorm cancels it, so
    its gradient is zero up to rounding), and a rare element elsewhere (one
    of the fc2's 16.8 M, behind ReLUs). Every element is held within 2 lr x
    steps of JAX's, and all but 1e-5 of each other parameter's at TOL. Then predict_melclf's
    metrics from each package's checkpoint, and cal_fd_score's KL and the
    embeddings it hands to frechet_distance (with --norm_stats; the
    classifier in batch statistics, as JAX evaluates its own)."""
    labels = ["dog", "dog", "dog", "rain", "car", "rain"]
    tsv = _write_mels(str(tmp_path / "train"), 12, labels, 0)
    val = _write_mels(str(tmp_path / "val"), 5, labels, 1)
    classes = sorted(set(labels))
    cfg = jmelclf.MelClfConfig(conv_layers=SMALL, num_classes=len(classes))
    jp0 = jmelclf.melclf_init(jax.random.PRNGKey(0), cfg)

    def shared_init(backbone, num_classes, small):
        assert (backbone, num_classes, small) == ("vggishish", len(classes), True)
        m = tmelclf.MelClf(tmelclf.MelClfConfig(conv_layers=SMALL, num_classes=num_classes))
        m.load_state_dict(tw.melclf_from_jax(jp0, SMALL), strict=True)
        return m

    monkeypatch.setattr(ttrain_cli, "init_model", shared_init)
    common = ["--tsv", tsv, "--mel_len", "80", "--batch_size", "4", "--steps", "2",
              "--small", "--cls_weights", "--val_tsv", val, "--norm", "--lr", "1e-3"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = ttrain_cli.main(common + ["--ckpt_dir", str(tmp_path / "t"), "--norm_cache",
                                        str(tmp_path / "tn"), "--device", "cpu"])
    t_out = buf.getvalue()
    j_out = _run_jax_cli("train_melclf", common + ["--ckpt_dir", str(tmp_path / "j"),
                                                   "--norm_cache", str(tmp_path / "jn")],
                         monkeypatch)
    stats = "train_means_stds_train.txt"
    np.testing.assert_allclose(np.loadtxt(tmp_path / "tn" / stats),
                               np.loadtxt(tmp_path / "jn" / stats), rtol=0, atol=0)
    losses = [ln.split()[3] for ln in j_out.splitlines() if ln.startswith("step ")]
    assert losses == [f"{x:.4f}" for x in res["losses"]], (losses, res["losses"])
    jv, tv = _json_line(j_out, "val@1 "), _json_line(t_out, "val@1 ")
    assert sorted(jv) == sorted(tv)
    for k in jv:
        assert tv[k] == pytest.approx(jv[k], rel=1e-3, abs=2e-4), k

    import orbax.checkpoint as ocp
    jp = ocp.StandardCheckpointer().restore(str(tmp_path / "j" / "final"),
                                            target={"params": jp0})["params"]
    want = tw.melclf_from_jax(jp, SMALL)
    got = torch.load(res["ckpt"], weights_only=True)
    assert (got["backbone"], got["conv_layers"], got["num_classes"], got["classes"]) == (
        "vggishish", list(SMALL), len(classes), classes)
    assert sorted(got["model"]) == sorted(want)
    conv_bias = {k for k in want if k.endswith(".bias") and k.startswith("features.")
                 and k.replace(".bias", ".weight") in want and want[k].ndim == 1
                 and want[k.replace(".bias", ".weight")].ndim == 4}
    adam_noise = 2 * 1e-3 * 2  # 2 lr x steps
    for k, v in want.items():
        g, v = got["model"][k].numpy(), v.numpy()
        diff = np.abs(g - v)
        assert diff.max() <= adam_noise, k
        if k not in conv_bias:
            off = diff > TOL["atol"] + TOL["rtol"] * np.abs(v)
            assert off.sum() <= max(1, 1e-5 * off.size), (k, int(off.sum()))

    pred = ["--tsv", val, "--small", "--mel_len", "80", "--batch_size", "3", "--norm_stats",
            str(tmp_path / "tn" / stats)]
    with redirect_stdout(io.StringIO()):
        t_pred = tpredict_cli.main(pred + ["--clf_ckpt", res["ckpt"], "--device", "cpu"])
    j_pred = _json_line(_run_jax_cli("predict_melclf",
                                     pred + ["--clf_ckpt", str(tmp_path / "j" / "final")],
                                     monkeypatch))
    assert sorted(j_pred) == sorted(t_pred)
    assert t_pred["param_num"] == j_pred["param_num"]
    for k in j_pred:
        assert t_pred[k] == pytest.approx(j_pred[k], rel=1e-3, abs=2e-4), k

    seen = {}

    def recorder(pkg):
        def fd(a, b):
            seen[pkg] = (a, b)
            return 0.0
        return fd

    monkeypatch.setattr(tmelclf, "frechet_distance", recorder("port"))
    monkeypatch.setattr(jmelclf, "frechet_distance", recorder("jax"))
    fd_args = ["--gen_dir", str(tmp_path / "train"), "--ref_dir", str(tmp_path / "val"),
               "--small", "--mel_len", "80", "--batch", "5", "--num_classes",
               str(len(classes)), "--norm_stats", str(tmp_path / "tn" / stats)]
    with redirect_stdout(io.StringIO()):
        t_fd = tfd_cli.main(fd_args + ["--clf_ckpt", res["ckpt"], "--device", "cpu"])
    j_fd = eval(_run_jax_cli("cal_fd_score", fd_args + ["--clf_ckpt",
                                                       str(tmp_path / "j" / "final")],
                             monkeypatch).strip().splitlines()[-1])
    assert (t_fd["n_gen"], t_fd["n_ref"], "kl" in t_fd) == (12, 5, False) == (
        j_fd["n_gen"], j_fd["n_ref"], "kl" in j_fd)
    for got, want in zip(seen["port"], seen["jax"], strict=True):
        assert got.shape == (want.shape[0], 4096)
        _close(got, want, "embedding")


def test_cal_fd_score_melception_matches_jax(tmp_path, monkeypatch, melception_file):
    """cal_fd_score --backbone melception from a torchvision-keyed file: the
    features it hands to frechet_distance and its KL against JAX's
    melception on the same mels (running statistics, so the batching does
    not matter); a directory (an Orbax checkpoint) is refused."""
    sd, mel, want = melception_file
    logits, feats, _ = want["running"]
    path = tmp_path / "melception.pt"
    torch.save({"model": sd}, path)
    for name, i in (("gen", 0), ("ref", 1)):
        os.makedirs(tmp_path / name)
        np.save(tmp_path / name / f"m{i}.npy", mel[i])
    seen = {}
    monkeypatch.setattr(tmelclf, "frechet_distance",
                        lambda a, b: seen.setdefault("fd", (a, b)) and 0.0)
    argv = ["--gen_dir", str(tmp_path / "gen"), "--ref_dir", str(tmp_path / "ref"),
            "--backbone", "melception", "--mel_len", "96", "--batch", "1", "--device", "cpu"]
    with redirect_stdout(io.StringIO()):
        out = tfd_cli.main(argv + ["--clf_ckpt", str(path)])
    _close(seen["fd"][0], feats[:1], "gen features")
    _close(seen["fd"][1], feats[1:], "ref features")
    assert out["kl"] == pytest.approx(round(jmelclf.kl_divergence_softmax(logits[:1],
                                                                          logits[1:]), 4),
                                      abs=2e-4)
    with pytest.raises(SystemExit, match="Orbax"):
        tfd_cli.main(argv + ["--clf_ckpt", str(tmp_path)])
