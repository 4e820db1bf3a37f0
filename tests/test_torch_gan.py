"""GAN training of the first stage and the vocoder on the port against the
JAX package, on the CPU in fp32 at rtol 1e-3 / atol 1e-4 (the port's
tolerance, tests/test_torch_import.py): the STFT / mel frontend (Hann and
rectangular windows), each discriminator's logits and feature maps, the
losses, two iterations of the VAE-GAN steps (adaptive weight and R1) and of
the vocoder-GAN steps with every metric and parameter compared, the
differentiable BigVGAN route's gradients, the discriminator importers of
reference files (weight norm in both namings), and the three CLIs
(train_vae, train_vocoder, mel_spec) on files written to tmp_path, the
training CLIs against JAX's step functions on the same batches, then the
hand-off of a train_vae checkpoint to the training CLI's frozen VAE.

JAX parameters go to the port through maa3_tpu_torch.weights; the port's
parameters (whose keys are the reference's) go to JAX through JAX's own
torch importers. Sizes are those of tests/test_gan.py and
tests/test_vocoder_gan.py, except that the vocoder runs at the default hop
and mels with two upsampling stages (VOC), on wavs of 1024 samples: the
MRD reflect-pads 904 samples, which torch's reflect pad needs the signal to
exceed.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maa3_tpu import torch_import as jimport
from maa3_tpu.data.datasets import read_tsv as jread_tsv
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import discriminators as jdisc
from maa3_tpu.models import vae1d as jvae
from maa3_tpu.native.io import NativeLoader as JNativeLoader
from maa3_tpu.ops import stft as jstft
from maa3_tpu.train import vae_gan as jvg
from maa3_tpu.train import vocoder_gan as jvocg
from maa3_tpu_torch import mel_spec as tmel_cli
from maa3_tpu_torch import torch_import as timport
from maa3_tpu_torch import train_vae as tvae_cli
from maa3_tpu_torch import train_vocoder as tvoc_cli
from maa3_tpu_torch import weights as tw
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import discriminators as tdisc
from maa3_tpu_torch.models import vae1d as tvae
from maa3_tpu_torch.ops import stft as tstft
from maa3_tpu_torch.train import vae_gan as tvg
from maa3_tpu_torch.train import vocoder_gan as tvocg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-3, atol=1e-4)
VAE = dict(in_channels=8, out_ch=8, ch=32, ch_mult=(1, 2), num_res_blocks=1,
           down_layers=(0,), kernel_size=5, z_channels=4, embed_dim=4)
# a vocoder with the default hop (256 = 16 x 16) and mel frontend, two stages
VOC = dict(upsample_rates=(16, 16), upsample_kernel_sizes=(32, 32),
           upsample_initial_channel=32, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3, 5),))


def _close(got, want, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=what, **TOL)


def _state_close(module: torch.nn.Module, want: dict, what: str):
    """Every entry of the module's state against the state dict `want`."""
    got = module.state_dict()
    assert sorted(got) == sorted(want), what
    for k, v in want.items():
        _close(got[k], v, f"{what}: {k}")


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict(sd, strict=True)
    return module


def _np_tree(module: torch.nn.Module) -> dict:
    """Copies: jnp.asarray may alias a numpy array's memory, which the port's
    optimizer then updates in place."""
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


class _AdamCheck:
    """One optimizer's parameters after Adam updates, the port's against
    JAX's. After each step update() holds the port's first moments (the
    gradients' running mean) to JAX's at rtol 1e-3 and 1e-4 of the largest.
    An early Adam step moves an element by about lr times the sign of its
    first moment, so where the two moments differ by more than a quarter of
    their size (a gradient at fp32's rounding noise: exactly zero for the
    key biases of the VAE's attention blocks, as softmax ignores a shift
    shared by all keys, or for a conv bias that a GroupNorm of one channel
    per group cancels, and tiny for some elements by chance) the update's
    direction is noise in either package; params_close() holds those
    elements, at most 1e-2 of all, to within 2 lr per update, every other
    one at TOL."""

    def __init__(self, lr: float, opt: torch.optim.Optimizer, params: dict):
        self.lr, self.opt, self.params = lr, opt, params
        self.steps, self.free = 0, {}

    def update(self, mu: dict, what: str) -> None:
        self.steps += 1
        scale = max(float(np.abs(np.asarray(v)).max()) for v in mu.values())
        for k, m in mu.items():
            got, m = self.opt.state[self.params[k]]["exp_avg"].numpy(), np.asarray(m)
            np.testing.assert_allclose(got, m, rtol=1e-3, atol=1e-4 * scale,
                                       err_msg=f"{what}: first moment of {k}")
            self.free[k] = (np.abs(got - m) > 0.25 * np.abs(m)) | self.free.get(k, False)

    def params_close(self, want: dict, what: str) -> None:
        assert sorted(self.params) == sorted(want), what
        for k, w in want.items():
            g, w = self.params[k].detach().numpy(), np.asarray(w)
            tol = (TOL["atol"] + TOL["rtol"] * np.abs(w)
                   + self.free.get(k, False) * 2 * self.lr * self.steps)
            bad = np.abs(g - w) > tol
            assert not bad.any(), (f"{what}: {k}: {bad.sum()} of {bad.size} elements, "
                                   f"max diff {np.abs(g - w).max():.3e}")
        n_free = sum(int(np.sum(f)) for f in self.free.values())
        assert n_free <= 1e-2 * sum(np.asarray(w).size for w in want.values()), (what, n_free)


def _port_adam(opt: torch.optim.Optimizer, params: dict):
    """(count, first moments, second moments) of a port optimizer by
    parameter name, as numpy copies (zeros before its first step)."""
    count, mu, nu = 0, {}, {}
    for k, p in params.items():
        st = opt.state.get(p, {})
        count = int(st["step"]) if st else 0
        zero = np.zeros(tuple(p.shape), np.float32)
        mu[k] = st["exp_avg"].numpy().copy() if st else zero
        nu[k] = st["exp_avg_sq"].numpy().copy() if st else zero
    return count, mu, nu


def _jax_adam(tx, count: int, mu, nu):
    """An optax adam state holding these moments."""
    st = tx.init(mu)
    return (st[0]._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu),) + tuple(st[1:])


# ---------------------------------------------------------------------------
# frontend, discriminators, losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["mel", "stft_hann", "stft_ones"])
def test_mel_frontend_matches_jax(what):
    y = (np.random.RandomState(0).randn(2, 17 * 256) * 0.6).astype(np.float32)
    if what == "mel":  # |y| beyond 1 exercises the clamp
        cfg = dict(sample_rate=16000, n_fft=1024, win_size=1024, hop_size=256, num_mels=80)
        np.testing.assert_array_equal(tstft.mel_filterbank(16000, 1024, 80, 0.0, 8000.0),
                                      jstft.mel_filterbank(16000, 1024, 80, 0.0, 8000.0))
        want = jstft.mel_spectrogram(jnp.asarray(y), jstft.MelConfig(**cfg))
        got = tstft.mel_spectrogram(torch.from_numpy(y), tstft.MelConfig(**cfg))
        assert got.shape == (2, 80, 17)
    elif what == "stft_hann":
        want = jstft.stft_magnitude(jnp.asarray(y), 1024, 256, 1024)
        got = tstft.stft_magnitude(torch.from_numpy(y), 1024, 256, 1024)
    else:  # the MRD's: torch.stft without a window, win 240 centred in 512
        for a, b in zip(tstft.stft_constants(512, 240, "ones"),
                        jstft._stft_constants(512, 240, window="ones")):
            np.testing.assert_array_equal(a, b)
        frames = jstft.frame_signal(jnp.asarray(y), 512, 50)
        cos_b, sin_b = jstft._stft_constants(512, 240, window="ones")
        re, im = frames @ cos_b, frames @ sin_b
        want = jnp.sqrt(re * re + im * im + 1e-9).transpose(0, 2, 1)
        got = tstft.stft_magnitude(torch.from_numpy(y), 512, 50, 240, window="ones")
    assert tuple(got.shape) == want.shape
    _close(got, want, what)


def _disc_pair(kind):
    """(JAX apply, port module, input) for one discriminator kind."""
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(1)
    wav = (rng.randn(2, 4000) * 0.3).astype(np.float32)
    if kind == "nlayer":
        p = jdisc.nlayer_disc_init(key, input_nc=1, ndf=16, n_layers=3)
        x = rng.randn(2, 1, 80, 64).astype(np.float32)
        return (lambda a: jdisc.nlayer_disc_apply(p, a),
                _load(tdisc.NLayerDiscriminator(1, 16, 3), tw.nlayer_disc_from_jax(p)), x)
    if kind == "mpd":  # 4000 samples: periods 3 and 7 take the reflect pad
        periods = (2, 3, 7)
        p = jdisc.mpd_init(key, periods=periods)
        return (lambda a: jdisc.mpd_apply(p, a, periods),
                _load(tdisc.MultiPeriodDiscriminator(periods), tw.mpd_from_jax(p)), wav)
    if kind == "mrd":
        res = ((512, 50, 240), (1024, 120, 600))
        p = jdisc.mrd_init(key, resolutions=res)
        return (lambda a: jdisc.mrd_apply(p, a, res),
                _load(tdisc.MultiResolutionDiscriminator(res), tw.mrd_from_jax(p)), wav)
    p = jdisc.multi_window_disc_init(key, time_lengths=(8, 16), freq_length=16, hidden=8)
    mod = _load(tdisc.MultiWindowDiscriminator((8, 16), 16, 8),
                tw.multi_window_disc_from_jax(p))
    mel = rng.randn(2, 40, 16).astype(np.float32)
    return (lambda a: jdisc.multi_window_disc_apply(p, a, (3, 10), (8, 16)),
            lambda a: mod(a, (3, 10)), mel)


@pytest.mark.parametrize("kind", ["nlayer", "mpd", "mrd", "multi_window"])
def test_discriminator_matches_jax(kind):
    j_apply, t_apply, x = _disc_pair(kind)
    want = j_apply(jnp.asarray(x))
    got = t_apply(torch.from_numpy(x))
    if kind in ("mpd", "mrd"):  # (logits, feature maps) per discriminator
        for i, (gl, wl) in enumerate(zip(got[0], want[0])):
            _close(gl, wl, f"{kind} logits {i}")
        for i, (gf, wf) in enumerate(zip(got[1], want[1])):
            assert len(gf) == len(wf) == 6
            for j, (a, b) in enumerate(zip(gf, wf)):
                _close(a, b, f"{kind} disc {i} fmap {j}")
    else:
        assert tuple(got.shape) == want.shape
        _close(got, want, kind)


def test_patchgan_gradient_matches_float64():
    """The PatchGAN's parameter gradients in fp32 against fp64 (1e-5 of the
    largest) on log-mels around -4 and a reconstruction near 0, the hinge
    loss of the VAE-GAN's disc step. Here JAX's train-mode BatchNorm, the
    formula (x - mean) * rsqrt(var + eps) differentiated through its
    statistics, loses precision in the first conv's gradient in fp32 (the
    same formula in torch does too); the port's F.batch_norm keeps fp64's
    value."""
    disc = tdisc.disc_init_(tdisc.NLayerDiscriminator(1, 64, 3),
                            torch.Generator().manual_seed(0))
    rng = np.random.RandomState(8)
    mel = torch.from_numpy((rng.randn(2, 1, 80, 32) - 4.0).astype(np.float32))
    rec = torch.from_numpy((rng.randn(2, 1, 80, 32) * 0.3).astype(np.float32))
    grads = []
    for dt in (torch.float32, torch.float64):
        disc.to(dt)
        loss = tdisc.hinge_d_loss(disc(mel.to(dt)), disc(rec.to(dt)))
        grads.append(torch.autograd.grad(loss, list(disc.parameters())))
    for (n, _), g32, g64 in zip(disc.named_parameters(), *grads):
        err = (g32.double() - g64).abs().max() / g64.abs().max()
        assert err <= 1e-5, (n, err.item())


@pytest.mark.parametrize("loss", ["hinge", "vanilla", "mse_d", "mse_g", "fm", "adopt"])
def test_losses_match_jax(loss):
    rng = np.random.RandomState(2)
    a = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    b = [rng.randn(2, 7).astype(np.float32) for _ in range(3)]
    ja, jb = [jnp.asarray(x) for x in a], [jnp.asarray(x) for x in b]
    ta, tb = [torch.from_numpy(x) for x in a], [torch.from_numpy(x) for x in b]
    if loss == "hinge":
        want, got = jdisc.hinge_d_loss(ja[0], jb[0]), tdisc.hinge_d_loss(ta[0], tb[0])
    elif loss == "vanilla":
        want, got = jdisc.vanilla_d_loss(ja[0], jb[0]), tdisc.vanilla_d_loss(ta[0], tb[0])
    elif loss == "mse_d":
        want, got = jdisc.mse_d_loss(ja, jb), tdisc.mse_d_loss(ta, tb)
    elif loss == "mse_g":
        want, got = jdisc.mse_g_loss(ja), tdisc.mse_g_loss(ta)
    elif loss == "fm":
        want = jdisc.feature_matching_loss([ja, jb], [jb, ja])
        got = tdisc.feature_matching_loss([ta, tb], [tb, ta])
    else:
        for step, thr in ((5, 10), (10, 10), (15, 10), (0, 0)):
            _close(tdisc.adopt_weight(0.7, step, thr), jdisc.adopt_weight(0.7, step, thr))
        return
    _close(got, want, loss)


# ---------------------------------------------------------------------------
# the differentiable BigVGAN route
# ---------------------------------------------------------------------------

def test_bigvgan_differentiable_route_grads_match_jax():
    """Every generator parameter's gradient (snake alpha and beta included)
    through bigvgan_apply(kernels=False) against jax.grad through
    bigvgan_apply(pallas_aa=False); the kernel route keeps no graph."""
    jcfg, tcfg = jvoc.BigVGANConfig(**VOC), tvoc.BigVGANConfig(**VOC)
    params = jvoc.bigvgan_init(jax.random.PRNGKey(3), jcfg)
    rng = np.random.RandomState(3)
    # nonzero snake parameters, so alpha and beta enter their gradients
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v + 0.3 * jnp.asarray(rng.randn(*v.shape).astype(np.float32))
        if any(getattr(k, "key", None) in ("alpha", "beta") for k in path) else v, params)
    mel = rng.randn(2, 80, 3).astype(np.float32)
    r = rng.randn(2, 3 * 256).astype(np.float32)

    def loss(p):
        return jnp.sum(jvoc.bigvgan_apply(p, jcfg, jnp.asarray(mel), pallas_aa=False) * r)

    want = tw.bigvgan_from_jax(jax.jit(jax.grad(loss))(params))
    voc = _load(tvoc.BigVGAN(tcfg), tw.bigvgan_from_jax(params))
    wav = tvoc.bigvgan_apply(voc, torch.from_numpy(mel), kernels=False)
    (wav * torch.from_numpy(r)).sum().backward()
    grads = dict(voc.named_parameters())
    assert sorted(grads) == sorted(want) and any(".act.beta" in k for k in grads)
    for k, g in want.items():
        _close(grads[k].grad, g, k)
    assert tvoc.bigvgan_apply(voc, torch.from_numpy(mel)).grad_fn is None


# ---------------------------------------------------------------------------
# two iterations of each trainer
# ---------------------------------------------------------------------------

def _vae_trees(js, what="params"):
    """{optimizer: JAX's parameters (or first moments) in the port's names}"""
    if what == "params":
        ae, disc = {"vae": js.vae_params, "logvar": js.logvar}, js.disc_params
    else:
        ae, disc = js.vae_opt[0].mu, js.disc_opt[0].mu
    return {"ae": {**tw.vae_from_jax(ae["vae"]), "logvar": ae["logvar"]},
            "disc": tw.nlayer_disc_from_jax(disc)}


def test_vae_gan_two_iterations_match_jax():
    """ae_step + disc_step twice with disc_start 0 and r1_weight 0.1 (every
    term live) from the same weights, JAX's posterior noise replayed: every
    metric, d_weight, and every parameter and logvar after each step."""
    jcfg, tcfg = jvae.VAEConfig(**VAE), tvae.VAEConfig(**VAE)
    key = jax.random.PRNGKey(0)
    vae_tx, disc_tx = jvg.make_vae_optimizers(lr=1e-4, lr_multiplier=1.0)
    js = jvg.create_vae_gan_state(key, jvae.vae_init(key, jcfg), vae_tx, disc_tx,
                                  disc_ndf=16, disc_layers=1)
    j_ae, j_disc = (jax.jit(f) for f in jvg.make_vae_gan_steps(
        jcfg, vae_tx, disc_tx, disc_start=0, r1_weight=0.1))

    vae = _load(tvae.AutoencoderKL(tcfg), tw.vae_from_jax(js.vae_params))
    ts = tvg.create_vae_gan_state(vae, torch.Generator().manual_seed(0), lr=1e-4,
                                  lr_multiplier=1.0, disc_ndf=16, disc_layers=1)
    _load(ts.disc, tw.nlayer_disc_from_jax(js.disc_params))
    t_ae, t_disc = tvg.make_vae_gan_steps(tcfg, disc_start=0, r1_weight=0.1)

    mel = np.array(jax.random.normal(key, (2, 8, 32)))
    checks = {"ae": _AdamCheck(1e-4, ts.vae_opt, {**dict(ts.vae.named_parameters()),
                                                   "logvar": ts.logvar}),
              "disc": _AdamCheck(1e-4, ts.disc_opt, dict(ts.disc.named_parameters()))}
    for it in range(2):
        k = jax.random.PRNGKey(7 + it)
        noise = torch.from_numpy(np.array(jax.random.normal(k, (2, 4, 16))))
        for name, j_step, t_step in (("ae", j_ae, t_ae), ("disc", j_disc, t_disc)):
            js, jm = j_step(js, jnp.asarray(mel), k)
            tm = t_step(ts, torch.from_numpy(mel), noise)
            assert sorted(tm) == sorted(jm)
            for m in jm:
                _close(tm[m], jm[m], f"iteration {it} {m}")
            checks[name].update(_vae_trees(js, "mu")[name], f"iteration {it}")
            checks[name].params_close(_vae_trees(js)[name], f"iteration {it} {name}")
            assert ts.step == int(js.step)
    assert float(tm["discloss"]) != 0.0 and ts.step == 2


def _vocoder_states(gen_np: dict, mpd_np: dict, mrd_np: dict, tcfg, jcfg):
    """A port and a JAX vocoder-GAN state from the same reference-layout
    weights, each with fresh adamw(2e-4, b1=0.8, b2=0.99) moments."""
    gen = _load(tvoc.BigVGAN(tcfg), {k: torch.from_numpy(v) for k, v in gen_np.items()})
    mpd = _load(tdisc.MultiPeriodDiscriminator(), {k: torch.from_numpy(v)
                                                  for k, v in mpd_np.items()})
    mrd = _load(tdisc.MultiResolutionDiscriminator(), {k: torch.from_numpy(v)
                                                      for k, v in mrd_np.items()})
    ts = tvocg.create_vocoder_gan_state(gen, mpd, mrd)
    tx = optax.adamw(2e-4, b1=0.8, b2=0.99)  # its moments' layout; _jax_vocoder_steps updates
    g = jimport.bigvgan_from_torch(gen_np, jcfg)
    d = {"mpd": jimport.mpd_from_torch(mpd_np), "mrd": jimport.mrd_from_torch(mrd_np)}
    js = jvocg.VocoderGanState(step=jnp.zeros((), jnp.int32), gen_params=g,
                               mpd_params=d["mpd"], mrd_params=d["mrd"],
                               gen_opt=tx.init(g), disc_opt=tx.init(d))
    return ts, js


@functools.lru_cache(maxsize=None)
def _jax_vocoder_steps():
    """JAX's (gen_step, disc_step), jitted once for both vocoder tests."""
    tx = optax.adamw(2e-4, b1=0.8, b2=0.99)
    return tuple(jax.jit(f) for f in jvocg.make_vocoder_gan_steps(
        jvoc.BigVGANConfig(**VOC), jstft.MelConfig(), tx, tx))


def _vocoder_tree(js, name: str, what: str = "params") -> dict:
    """JAX's parameters (or first moments) of one optimizer, "gen" or
    "disc", in the port's names (the MPD's and MRD's prefixed mpd. and mrd.)."""
    if name == "gen":
        return tw.bigvgan_from_jax(js.gen_params if what == "params" else js.gen_opt[0].mu)
    disc = ({"mpd": js.mpd_params, "mrd": js.mrd_params} if what == "params"
            else js.disc_opt[0].mu)
    return {f"{d}.{k}": v for d, conv in (("mpd", tw.mpd_from_jax), ("mrd", tw.mrd_from_jax))
            for k, v in conv(disc[d]).items()}


def _vocoder_checks(ts):
    disc = {f"{d}.{k}": v for d, m in (("mpd", ts.mpd), ("mrd", ts.mrd))
            for k, v in m.named_parameters()}
    return {"gen": _AdamCheck(2e-4, ts.gen_opt, dict(ts.gen.named_parameters())),
            "disc": _AdamCheck(2e-4, ts.disc_opt, disc)}


def _vocoder_iterations(ts, js, batches, what):
    """gen_step + disc_step of both packages over batches of numpy
    {"wav", "mel"} (a None mel: each package's frontend of the wav, the
    CLI's first segment_frames frames): every metric, and every first
    moment and parameter after each step."""
    j_gen, j_disc = _jax_vocoder_steps()
    t_gen, t_disc = tvocg.make_vocoder_gan_steps(tstft.MelConfig())
    checks = _vocoder_checks(ts)
    for it, b in enumerate(batches):
        jb = {"wav": jnp.asarray(b["wav"])}
        tb = {"wav": torch.from_numpy(b["wav"])}
        if b.get("mel") is None:
            frames = b["wav"].shape[1] // 256
            jb["mel"] = jstft.mel_spectrogram(jb["wav"], jstft.MelConfig())[:, :, :frames]
            tb["mel"] = tstft.mel_spectrogram(tb["wav"], tstft.MelConfig())[:, :, :frames]
        else:
            jb["mel"], tb["mel"] = jnp.asarray(b["mel"]), torch.from_numpy(b["mel"])
        for name, j_step, t_step in (("gen", j_gen, t_gen), ("disc", j_disc, t_disc)):
            js, jm = j_step(js, jb)
            tm = t_step(ts, tb)
            assert sorted(tm) == sorted(jm)
            for m in jm:
                _close(tm[m], jm[m], f"{what} iteration {it} {m}")
            checks[name].update(_vocoder_tree(js, name, "mu"), f"{what} iteration {it}")
            checks[name].params_close(_vocoder_tree(js, name), f"{what} iteration {it} {name}")
            assert ts.step == int(js.step)
    return js


def test_vocoder_gan_two_iterations_match_jax():
    """gen_step + disc_step twice from JAX's initial weights with adamw (the
    CLI's optimizers): every metric, every first moment and every parameter
    after each step (parameters as _AdamCheck holds them)."""
    jcfg, tcfg = jvoc.BigVGANConfig(**VOC), tvoc.BigVGANConfig(**VOC)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    ts, js = _vocoder_states(
        _np_tree(_load(tvoc.BigVGAN(tcfg), tw.bigvgan_from_jax(jvoc.bigvgan_init(k1, jcfg)))),
        {k: v.numpy() for k, v in tw.mpd_from_jax(jdisc.mpd_init(k2)).items()},
        {k: v.numpy() for k, v in tw.mrd_from_jax(jdisc.mrd_init(k3)).items()}, tcfg, jcfg)
    rng = np.random.RandomState(4)
    _vocoder_iterations(ts, js, [
        {"mel": rng.randn(2, 80, 4).astype(np.float32),
         "wav": np.clip(rng.randn(2, 1024) * 0.3, -1, 1).astype(np.float32)}
        for _ in range(2)], "steps")


# ---------------------------------------------------------------------------
# importers of reference files
# ---------------------------------------------------------------------------

def _reference_file(module: torch.nn.Module, naming, rng, extra=()):
    """A random reference-layout state dict for `module`: every conv weight
    weight-normed in `naming` (None: plain), plus the `extra` keys."""
    sd = {}
    for k, v in module.state_dict().items():
        if naming and k.endswith(".weight") and v.dim() == 4:
            name = k[:-len(".weight")]
            g = np.abs(rng.randn(v.shape[0], 1, 1, 1)).astype(np.float32) + 0.5
            vv = rng.randn(*v.shape).astype(np.float32)
            gk, vk = timport.WN_NAMES[naming]
            sd[name + gk], sd[name + vk] = g, vv
        else:
            sd[k] = rng.randn(*v.shape).astype(np.float32)
    for k, shape in extra:
        sd[k] = rng.randn(*shape).astype(np.float32)
    return sd


@pytest.mark.parametrize("kind,naming", [("mpd", 0), ("mpd", 1), ("mrd", 0), ("mrd", 1),
                                         ("nlayer", None)])
def test_discriminator_importers_match_jax(kind, naming):
    """mpd / mrd_from_torch (weight_g / weight_v, and parametrize's
    original0 / original1) and nlayer_disc_from_torch (a `discriminator.`
    prefix, BatchNorm running statistics to skip) against JAX's importers."""
    rng = np.random.RandomState(5)
    if kind == "nlayer":
        mod = tdisc.NLayerDiscriminator(1, 8, 2)
        bn = [(f"main.{i}.{s}", (mod.main[i].weight.shape[0],)) for i in (3, 6)
              for s in ("running_mean", "running_var")]
        sd = _reference_file(mod, None, rng, bn)
        sd = {"discriminator." + k: v for k, v in sd.items()}
        sd["discriminator.main.3.num_batches_tracked"] = np.zeros((), np.float32)
        timport.nlayer_disc_from_torch({k: torch.from_numpy(v) for k, v in sd.items()}, mod)
        want = tw.nlayer_disc_from_jax(jimport.nlayer_disc_from_torch(
            jimport.strip_prefix(sd, "discriminator."), n_layers=2))
    else:
        mod = (tdisc.MultiPeriodDiscriminator((2, 3)) if kind == "mpd"
               else tdisc.MultiResolutionDiscriminator())
        sd = _reference_file(mod, naming, rng)
        getattr(timport, f"{kind}_from_torch")({k: torch.from_numpy(v) for k, v in sd.items()},
                                               mod)
        jtree = getattr(jimport, f"{kind}_from_torch")(sd, n_discs=len(mod.discriminators))
        want = getattr(tw, f"{kind}_from_jax")(jtree)
    _state_close(mod, want, kind)
    with pytest.raises(KeyError):  # strict: a missing key raises
        getattr(timport, f"{kind}_disc_from_torch" if kind == "nlayer" else
                f"{kind}_from_torch")({}, mod)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _write_mels(tmp_path, n=3, frames=40, offset=-4.0):
    rng = np.random.RandomState(6)
    lines = ["name\tmel_path\tori_cap\tcaption"]
    for i in range(n):
        path = tmp_path / f"m{i}.npy"
        np.save(path, (rng.randn(80, frames + 7 * i) + offset).astype(np.float32))
        lines.append(f"m{i}\t{path}\ta sound {i}\t<a sound {i}& all>")
    tsv = tmp_path / "mels.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    return tsv


def test_train_vae_cli_matches_jax(tmp_path, monkeypatch):
    """Two iterations of python -m maa3_tpu_torch.train_vae: its checkpoint
    (vae, disc, logvar) equals the port's steps run here from the CLI's
    initial weights on the batches scripts/train_vae.py draws (RandomState(0),
    JAX's native loader in tile mode) with the CLI's posterior noise, and
    each of those steps matches JAX's step from the same state (parameters,
    Adam moments, step) on the same batch and noise: metrics, first moments
    and parameters, as _AdamCheck holds them. JAX starts each step from the
    port's state, and the mels are zero-mean, because at this width the
    PatchGAN's gradient through JAX's BatchNorm formula is off by up to a
    few percent in fp32 (test_patchgan_gradient_matches_float64), which a
    trajectory of two steps carries into every parameter."""
    tsv = _write_mels(tmp_path, offset=0.0)
    path = tvae_cli.main([
        "--tsv", str(tsv), "--mel_len", "32", "--batch_size", "2", "--steps", "2",
        "--ch", "32", "--disc_start", "0", "--lr", "1e-4", "--lr_multiplier", "1",
        "--ckpt_dir", str(tmp_path / "ck"), "--device", "cpu"])
    assert os.path.basename(path) == "step_00000002.pt"
    got = torch.load(path, weights_only=True)
    assert sorted(got) == ["disc", "logvar", "vae"]

    tcfg, jcfg = tvae.VAEConfig(ch=32), jvae.VAEConfig(ch=32)
    ts = tvae_cli.init_state(tcfg, torch.device("cpu"), 1e-4, 1.0)
    t_ae, t_disc = tvg.make_vae_gan_steps(tcfg, disc_start=0)
    vae_tx, disc_tx = jvg.make_vae_optimizers(1e-4, 1.0)
    vp = jimport.vae_from_torch(_np_tree(ts.vae), jcfg)
    dp = jimport.nlayer_disc_from_torch(_np_tree(ts.disc))
    ae_params = {**dict(ts.vae.named_parameters()), "logvar": ts.logvar}
    disc_params = dict(ts.disc.named_parameters())

    def ae_tree(d):
        return {"vae": jimport.vae_from_torch({k: v for k, v in d.items() if k != "logvar"},
                                              jcfg),
                "logvar": jnp.asarray(d["logvar"])}

    def synced():
        """JAX's state from the port's: parameters, Adam moments, step."""
        (ca, ma, va), (cd, md, vd) = (_port_adam(ts.vae_opt, ae_params),
                                      _port_adam(ts.disc_opt, disc_params))
        ae = ae_tree({k: v.detach().numpy().copy() for k, v in ae_params.items()})
        return jvg.VAEGanState(
            step=jnp.asarray(ts.step, jnp.int32), vae_params=ae["vae"],
            disc_params=jimport.nlayer_disc_from_torch(_np_tree(ts.disc)),
            logvar=ae["logvar"], vae_opt=_jax_adam(vae_tx, ca, ae_tree(ma), ae_tree(va)),
            disc_opt=_jax_adam(disc_tx, cd, jimport.nlayer_disc_from_torch(md),
                               jimport.nlayer_disc_from_torch(vd)))

    # the CLI's posterior noise rides in the key argument of JAX's steps
    # (JAX's CLI draws it from PRNGKey(it))
    monkeypatch.setattr(jvg, "gaussian_sample", lambda m, noise: (
        jvae.gaussian_sample(m, sample=False)
        + jnp.exp(0.5 * jnp.clip(jnp.split(m, 2, axis=1)[1], -30.0, 20.0)) * noise))
    j_ae, j_disc = (jax.jit(f) for f in jvg.make_vae_gan_steps(jcfg, vae_tx, disc_tx,
                                                               disc_start=0))
    paths = [r["mel_path"] for r in jread_tsv(str(tsv))]
    loader, rng = JNativeLoader(rows=80), np.random.RandomState(0)
    for it in range(2):  # scripts/train_vae.py's draws
        idx = rng.randint(0, len(paths), 2)
        mel = loader.load_batch([paths[i] for i in idx], 32, mode="tile")
        noise = tvg.posterior_noise(tcfg, 2, 32, it)
        for name, j_step, t_step, opt, params in (
                ("ae", j_ae, t_ae, ts.vae_opt, ae_params),
                ("disc", j_disc, t_disc, ts.disc_opt, disc_params)):
            js, jm = j_step(synced(), jnp.asarray(mel), jnp.asarray(noise.numpy()))
            tm = t_step(ts, torch.from_numpy(mel), noise)
            for m in jm:
                _close(tm[m], jm[m], f"iteration {it} {m}")
            check = _AdamCheck(1e-4, opt, params)
            check.update(_vae_trees(js, "mu")[name], f"iteration {it}")
            check.params_close(_vae_trees(js)[name], f"iteration {it} {name}")
    for k, v in ts.vae.state_dict().items():
        assert torch.equal(got["vae"][k], v), k
    for k, v in ts.disc.state_dict().items():
        assert torch.equal(got["disc"][k], v), k
    assert torch.equal(got["logvar"], ts.logvar.detach())


def _write_wavs(tmp_path, specs):
    """int16 wavs (sample rate, seconds, channels) and their manifest."""
    from scipy.io import wavfile
    rng = np.random.RandomState(7)
    lines = ["name\taudio_path"]
    for i, (sr, secs, ch) in enumerate(specs):
        n = int(sr * secs)
        w = np.sin(np.arange(n) * (0.01 + 0.003 * i))[:, None] * 0.5 + rng.randn(n, ch) * 0.1
        w = (np.clip(w, -1, 1) * 32767).astype(np.int16)
        path = tmp_path / f"w{i}.wav"
        wavfile.write(path, sr, w[:, 0] if ch == 1 else w)
        lines.append(f"w{i}\t{path}")
    tsv = tmp_path / "wavs.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    return tsv


def test_train_vocoder_cli_matches_jax(tmp_path, monkeypatch):
    """Two iterations of python -m maa3_tpu_torch.train_vocoder, its
    generator cut to the two stages of VOC (BigVGANConfig patched; the
    default hop and mels): the checkpoint equals the port's steps run here
    from the CLI's initial weights on the crops scripts/train_vocoder.py
    reads and draws (RandomState(0); a stereo wav; a short one and a
    missing one skipped), and those steps match JAX's on the same crops."""
    from scipy.io import wavfile
    tsv = _write_wavs(tmp_path, [(16000, 0.3, 1), (16000, 0.25, 2), (16000, 0.05, 1)])
    with open(tsv, "a") as f:
        f.write(f"gone\t{tmp_path / 'missing.wav'}\n")
    real = tvoc.BigVGANConfig
    monkeypatch.setattr(tvoc, "BigVGANConfig", lambda upsample_initial_channel: real(
        **dict(VOC, upsample_initial_channel=upsample_initial_channel)))
    path = tvoc_cli.main([
        "--tsv", str(tsv), "--segment_frames", "4", "--batch_size", "2", "--steps", "2",
        "--upsample_initial_channel", "32", "--ckpt_dir", str(tmp_path / "ck"),
        "--device", "cpu"])
    got = torch.load(path, weights_only=True)
    assert sorted(got) == ["generator"]
    monkeypatch.undo()

    tcfg, jcfg = tvoc.BigVGANConfig(**VOC), jvoc.BigVGANConfig(**VOC)
    init = tvoc_cli.init_state(tcfg, torch.device("cpu"), 2e-4)
    ts, js = _vocoder_states(_np_tree(init.gen), _np_tree(init.mpd), _np_tree(init.mrd),
                             tcfg, jcfg)
    seg, hop = 4 * 256, 256
    wavs = []
    for r in jread_tsv(str(tsv)):  # scripts/train_vocoder.py's reading and draws
        try:
            _, w = wavfile.read(r["audio_path"])
        except FileNotFoundError:
            continue
        w = w.astype(np.float32) / np.iinfo(w.dtype).max
        w = w.mean(1) if w.ndim == 2 else w
        if len(w) >= seg + hop:
            wavs.append(w.astype(np.float32))
    assert len(wavs) == 2
    rng, batches = np.random.RandomState(0), []
    for it in range(2):
        crops = []
        for _ in range(2):
            w = wavs[rng.randint(len(wavs))]
            start = rng.randint(0, len(w) - seg - hop)
            start = (start // hop) * hop
            crops.append(w[start:start + seg])
        batches.append({"wav": np.stack(crops), "mel": None})
    _vocoder_iterations(ts, js, batches, "cli")
    for k, v in ts.gen.state_dict().items():
        assert torch.equal(got["generator"][k], v), k


def _jax_mel_spec_script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_mel_spec", os.path.join(ROOT, "scripts", "mel_spec.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mel_spec_cli_matches_jax(tmp_path):
    """python -m maa3_tpu_torch.mel_spec over wavs at 16 and 22.05 kHz (one
    stereo, one longer than --duration, one missing) in batches of 2: each
    <name>_mel.npy against JAX's mel_spectrogram of JAX's load_audio, and
    the --out_tsv manifest."""
    tsv = _write_wavs(tmp_path, [(16000, 0.5, 1), (22050, 0.3, 2), (22050, 0.9, 1)])
    with open(tsv, "a") as f:
        f.write(f"gone\t{tmp_path / 'missing.wav'}\n")
    out = tmp_path / "mels"
    done = tmel_cli.main(["--tsv_path", str(tsv), "--save_path", str(out), "--duration",
                          "0.6", "--batch_size", "2", "--out_tsv", str(tmp_path / "o.tsv"),
                          "--device", "cpu"])
    assert done == 3
    rows = jread_tsv(str(tmp_path / "o.tsv"))
    assert [r["name"] for r in rows] == ["w0", "w1", "w2"]
    script = _jax_mel_spec_script()
    seg = (int(0.6 * 16000 / 256) + 1) * 256
    cfg = jstft.MelConfig()
    for r in rows:
        wav = script.load_audio(r["audio_path"], 16000)
        wav = np.pad(wav, (0, max(0, seg - len(wav))))[:seg]
        want = jstft.mel_spectrogram(jnp.asarray(wav[None]), cfg)[0]
        got = np.load(r["mel_path"])
        assert got.shape == (80, seg // 256)
        _close(got, want, r["name"])


def test_vae_ckpt_hands_off_to_the_trainer(tmp_path, monkeypatch):
    """train_vae for two iterations at a tiny width, then one step of the
    training CLI with --vae_ckpt: its frozen VAE (the checkpoint's
    `frozen` section) equals the file's; a file of another width raises."""
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.system import MAA3System
    from maa3_tpu_torch.train import __main__ as cli

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    tsv = _write_mels(tmp_path, n=4, frames=70)
    ckpt = tvae_cli.main(["--tsv", str(tsv), "--mel_len", "32", "--batch_size", "2",
                          "--steps", "2", "--ch", "32", "--disc_start", "0",
                          "--ckpt_dir", str(tmp_path / "vae"), "--device", "cpu"])
    real = MAA3System.from_config.__func__

    def small(cls, paths, overrides=(), *a, **kw):
        kw.update(clap_cfg=CLAPFLANConfig(
            bert=BertConfig(hidden_size=16, num_layers=1, num_heads=2, intermediate_size=32),
            t5=T5Config(d_model=16, d_kv=8, d_ff=32, num_layers=1, num_heads=2), d_proj=16),
            voc_cfg=tvoc.BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                                       upsample_initial_channel=128))
        return real(cls, paths, overrides, *a, **kw)

    monkeypatch.setattr(MAA3System, "from_config", classmethod(small))
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=32", up + "depth=1", up + "num_heads=2", up + "context_dim=16",
            up + "multiple_of=16", dd + "ch=32", "model.params.cond_stage_trainable=false",
            f"data.params.train.params.dataset_cfg.dataset_name={tsv}",
            "data.params.train.params.dataset_cfg.spec_crop_len=32"]
    xl = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")
    base = ["-b", xl, "--max_steps", "1", "--batch_size", "2", "--device", "cpu", "--fp32",
            "--log_every", "1", "--ckpt_every", "0"]
    m = cli.main(base + ["--vae_ckpt", ckpt, "--ckpt_dir", str(tmp_path / "t"), *over])
    assert m["step"] == 1 and np.isfinite(m["loss"])
    want = torch.load(ckpt, weights_only=True)["vae"]
    frozen = torch.load(tmp_path / "t" / "last.pt", weights_only=True)["frozen"]["vae"]
    assert sorted(frozen) == sorted(want)
    for k, v in want.items():
        assert torch.equal(frozen[k], v), k
    with pytest.raises(RuntimeError, match="size mismatch"):
        cli.main(base + ["--vae_ckpt", ckpt, "--ckpt_dir", str(tmp_path / "u"),
                         *[o.replace("ch=32", "ch=64") for o in over]])
