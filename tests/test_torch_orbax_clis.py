"""The JAX training CLIs' Orbax directories through orbax_to_torch.py on
the CPU: scripts/train_vae.py, scripts/train_melclf.py --small and
scripts/train_vocoder.py run in this process into tmp_path, the converter
writes the port's files, and the port's readers give what JAX's give:
the --vae_ckpt VAE decodes as JAX's restored VAE does, predict_melclf's
metrics and the embeddings cal_fd_score hands to frechet_distance equal
JAX's CLIs' from the directory, and the converted generator vocodes as
JAX's (rtol 1e-3 / atol 1e-4)."""

import io
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

import orbax_to_torch
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.models import melclf as jmelclf
from maa3_tpu_torch import cal_fd_score as tfd_cli
from maa3_tpu_torch import predict_melclf as tpredict_cli
from maa3_tpu_torch import train_vae as tvae_cli
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import melclf as tmelclf
from maa3_tpu_torch.models import vae1d as tvae
from maa3_tpu_torch.train.__main__ import load_vae_ckpt
from tests.test_torch_melclf import _json_line, _run_jax_cli, _write_mels

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-4)
# a vocoder with the default hop (256 = 16 x 16) and mel frontend, two stages
VOC = dict(upsample_rates=(16, 16), upsample_kernel_sizes=(32, 32),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3, 5),))


def _restore(d):
    with ocp.PyTreeCheckpointer() as c:
        return c.restore(os.path.abspath(d))


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def test_train_vae_directory(tmp_path, monkeypatch):
    """Two iterations of scripts/train_vae.py (--ch 32); the converted file
    is the port's train_vae file: --vae_ckpt's VAE decodes a latent as JAX's
    restored VAE, and its PatchGAN and logvar load into the port's state."""
    tsv = _write_mels(str(tmp_path / "mels"), 4, ["a"], 0)
    _run_jax_cli("train_vae", ["--tsv", tsv, "--mel_len", "32", "--batch_size", "2",
                               "--steps", "2", "--ch", "32", "--disc_start", "0",
                               "--ckpt_dir", str(tmp_path / "j"), "--ckpt_every", "0"],
                 monkeypatch)
    d = str(tmp_path / "j" / "step_00000002")
    path = str(tmp_path / "vae.pt")
    assert orbax_to_torch.convert(d, path) == "train_vae"
    vae = tvae.AutoencoderKL(tvae.VAEConfig(ch=32))
    load_vae_ckpt(vae, path)
    jp = _restore(d)
    z = np.random.RandomState(3).randn(2, 20, 8).astype(np.float32)
    with torch.no_grad():
        got = tvae.vae_decode(vae, torch.tensor(z))
    _close(got, jvae.vae_decode(jp["vae"], jvae.VAEConfig(ch=32), jnp.asarray(z)), "decode")
    state = tvae_cli.init_state(tvae.VAEConfig(ch=32), torch.device("cpu"), 1e-4, 1.0)
    saved = torch.load(path, weights_only=True)
    state.disc.load_state_dict(saved["disc"], strict=True)
    assert float(saved["logvar"]) == float(np.asarray(jp["logvar"]))


def test_train_melclf_directory(tmp_path, monkeypatch):
    """Two steps of scripts/train_melclf.py --small; the converted file
    (backbone, stack and classes read from the shapes and --tsv) gives
    predict_melclf's metrics and cal_fd_score's embeddings as JAX's CLIs
    give them from the directory."""
    labels = ["dog", "dog", "rain", "car"]
    tsv = _write_mels(str(tmp_path / "train"), 8, labels, 0)
    val = _write_mels(str(tmp_path / "val"), 5, labels, 1)
    _run_jax_cli("train_melclf", ["--tsv", tsv, "--mel_len", "80", "--batch_size", "4",
                                  "--steps", "2", "--small", "--ckpt_dir", str(tmp_path / "j")],
                 monkeypatch)
    d = str(tmp_path / "j" / "final")
    path = str(tmp_path / "clf.pt")
    assert orbax_to_torch.convert(d, path, tsv=tsv) == "train_melclf"
    saved = torch.load(path, weights_only=True)
    assert (saved["backbone"], saved["num_classes"], saved["classes"]) == (
        "vggishish", 3, ["car", "dog", "rain"])
    with pytest.raises(ValueError, match="not a melception"):
        orbax_to_torch.convert(d, path, backbone="melception")

    pred = ["--tsv", val, "--small", "--mel_len", "80", "--batch_size", "3"]
    with redirect_stdout(io.StringIO()):
        got = tpredict_cli.main(pred + ["--clf_ckpt", path, "--device", "cpu"])
    want = _json_line(_run_jax_cli("predict_melclf", pred + ["--clf_ckpt", d], monkeypatch))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=2e-4), k

    seen = {}
    monkeypatch.setattr(tmelclf, "frechet_distance",
                        lambda a, b: seen.setdefault("port", (a, b)) and 0.0)
    monkeypatch.setattr(jmelclf, "frechet_distance",
                        lambda a, b: seen.setdefault("jax", (a, b)) and 0.0)
    fd = ["--gen_dir", str(tmp_path / "train"), "--ref_dir", str(tmp_path / "val"), "--small",
          "--mel_len", "80", "--batch", "5", "--num_classes", "3"]
    with redirect_stdout(io.StringIO()):
        tfd_cli.main(fd + ["--clf_ckpt", path, "--device", "cpu"])
    _run_jax_cli("cal_fd_score", fd + ["--clf_ckpt", d], monkeypatch)
    for a, b in zip(seen["port"], seen["jax"], strict=True):
        assert a.shape == (b.shape[0], 4096)
        _close(a, b, "embedding")


def test_train_vocoder_directory(tmp_path, monkeypatch):
    """One iteration of scripts/train_vocoder.py (its BigVGANConfig cut to
    two stages of the default hop); the converted {generator} vocodes a mel
    as JAX's restored generator."""
    from tests.test_torch_gan import _write_wavs
    tsv = _write_wavs(tmp_path, [(16000, 0.3, 1), (16000, 0.25, 1)])
    real = jvoc.BigVGANConfig
    monkeypatch.setattr(jvoc, "BigVGANConfig", lambda upsample_initial_channel: real(
        **dict(VOC, upsample_initial_channel=upsample_initial_channel)))
    _run_jax_cli("train_vocoder", ["--tsv", str(tsv), "--segment_frames", "4",
                                   "--batch_size", "1", "--steps", "1",
                                   "--upsample_initial_channel", "32",
                                   "--ckpt_dir", str(tmp_path / "j"), "--ckpt_every", "0"],
                 monkeypatch)
    monkeypatch.undo()
    d = str(tmp_path / "j" / "step_00000001")
    path = str(tmp_path / "generator.pt")
    assert orbax_to_torch.convert(d, path) == "train_vocoder"
    gen = tvoc.BigVGAN(tvoc.BigVGANConfig(**VOC))
    gen.load_state_dict(torch.load(path, weights_only=True)["generator"], strict=True)
    mel = np.random.RandomState(4).randn(1, 80, 6).astype(np.float32)
    want = jvoc.bigvgan_apply(_restore(d)["generator"], jvoc.BigVGANConfig(**VOC),
                              jnp.asarray(mel))
    _close(tvoc.bigvgan_apply(gen, torch.tensor(mel)), want, "wav")
