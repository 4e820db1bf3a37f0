"""The port's legacy models and samplers against the JAX package on the
CPU: DDPM schedules, DDIM / PLMS with CFG, the DDPM loss, the transport
library (paths, losses, Euler / Heun / dopri5 / SDE samplers), the noisy
classifier and its guidance, the 2-D VAE (KL and VQ), the 2-D UNet and
the AudioLDM pipeline end to end. Inputs come from numpy with a seed;
JAX's random draws are replayed into the port's explicit `draws`.
Tolerance: rtol 1e-3 / atol 1e-4 in fp32, equality where JAX's side is
numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.diffusion import classifier_guidance as jcg
from maa3_tpu.diffusion import ddim as jddim
from maa3_tpu.diffusion import ddpm_loss as jloss
from maa3_tpu.diffusion import schedules as jsched
from maa3_tpu.diffusion import transport as jtr
from maa3_tpu.models import unet2d as junet
from maa3_tpu.models import vae2d as jvae
from maa3_tpu.models.bigvgan import BigVGANConfig as JBigVGANConfig
from maa3_tpu.pipeline_audioldm import AudioLDMPipeline as JAudioLDM
from maa3_tpu_torch import weights
from maa3_tpu_torch.diffusion import classifier_guidance as cg
from maa3_tpu_torch.diffusion import ddim, ddpm_loss, schedules, transport
from maa3_tpu_torch.models.bigvgan import BigVGAN, BigVGANConfig
from maa3_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, unet2d_apply
from maa3_tpu_torch.models.vae2d import (VAE2D, VAE2DConfig, vae2d_decode,
                                         vae2d_encode_moments, vq_quantize)
from maa3_tpu_torch.pipeline_audioldm import AudioLDMPipeline, hifigan_config

torch.set_num_threads(2)

RTOL, ATOL = 1e-3, 1e-4
SCHED = dict(timesteps=1000, beta_schedule="linear", linear_start=0.00085,
             linear_end=0.012)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got) else got),
                               np.asarray(want), rtol=rtol, atol=atol)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def randn(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def unzero(params, seed, scale=0.1):
    """The tree with every all-zero leaf (the zero-init convs, biases)
    replaced by normals, so that each path contributes."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(randn(rng, *a.shape, scale=scale))
                        if not np.any(np.asarray(a)) else a, params)


def load(module, state):
    module.load_state_dict(state)
    return module.eval().requires_grad_(False)


# -- schedules (numpy on both sides: equal) ------------------------------------

@pytest.mark.parametrize("kind", ["linear", "cosine", "sqrt_linear", "sqrt"])
def test_schedules_equal(kind):
    np.testing.assert_array_equal(schedules.make_beta_schedule(kind, 1000),
                                  jsched.make_beta_schedule(kind, 1000))
    mine = schedules.DDPMSchedule.create(1000, kind, v_posterior=0.1)
    ref = jsched.DDPMSchedule.create(1000, kind, v_posterior=0.1)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(mine, f.name), getattr(ref, f.name))


@pytest.mark.parametrize("method", ["uniform", "quad"])
def test_ddim_tables_equal(method):
    ts = schedules.make_ddim_timesteps(50, 1000, method)
    np.testing.assert_array_equal(ts, jsched.make_ddim_timesteps(50, 1000, method))
    ac = jsched.DDPMSchedule.create(**SCHED).alphas_cumprod
    for a, b in zip(schedules.make_ddim_sampling_parameters(ac, ts, 0.5),
                    jsched.make_ddim_sampling_parameters(ac, ts, 0.5)):
        np.testing.assert_array_equal(a, b)


# -- DDIM / PLMS ---------------------------------------------------------------

W_EPS = randn(np.random.default_rng(7), 4, 4, scale=0.5)


def eps_jax(x, t, c):
    return jnp.tanh(jnp.einsum("ij,bjk->bik", W_EPS, x) + t[:, None, None] / 1000.0
                    + c[:, :, None])


def eps_torch(x, t, c):
    return torch.tanh(torch.einsum("ij,bjk->bik", T(W_EPS), x) + t[:, None, None] / 1000.0
                      + c[:, :, None])


def _sampler_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return randn(rng, 2, 4, 6), randn(rng, 2, 4), randn(rng, 2, 4)


@pytest.mark.parametrize("eta,scale", [(0.0, 3.0), (0.7, 3.0), (0.0, 1.0)])
def test_ddim_matches_jax(eta, scale):
    x, c, uc = _sampler_inputs()
    s = jsched.DDPMSchedule.create(**SCHED)
    key = jax.random.PRNGKey(3)
    want = jddim.ddim_sample(eps_jax, jnp.asarray(x), jnp.asarray(c), s, steps=8,
                             eta=eta, uncond=jnp.asarray(uc), guidance_scale=scale, key=key)
    draws = [T(jax.random.normal(k, x.shape)) for k in jax.random.split(key, 8)]
    got = ddim.ddim_sample(eps_torch, T(x), T(c), schedules.DDPMSchedule.create(**SCHED),
                           steps=8, eta=eta, uncond=T(uc), guidance_scale=scale,
                           draws=draws)
    close(got, want)


def test_ddim_cfg_dual_batch_and_skip():
    """[uncond; cond] in one call at scale != 1; the cond batch alone at 1.0
    or without an uncond."""
    seen = []

    def eps(x, t, c):
        seen.append((x.shape[0], c[0, 0].item()))
        return torch.zeros_like(x)

    s = schedules.DDPMSchedule.create(**SCHED)
    x, c, uc = torch.zeros(1, 2, 2), torch.ones(1, 1), torch.full((1, 1), -1.0)
    ddim.ddim_sample(eps, x, c, s, steps=2, uncond=uc, guidance_scale=3.0)
    assert seen[0] == (2, -1.0)
    seen.clear()
    ddim.ddim_sample(eps, x, c, s, steps=2, uncond=uc, guidance_scale=1.0)
    ddim.ddim_sample(eps, x, c, s, steps=2, uncond=None, guidance_scale=3.0)
    assert all(b == 1 for b, _ in seen) and len(seen) == 4


@pytest.mark.parametrize("steps,scale", [(6, 2.5), (5, 1.0)])
def test_plms_matches_jax(steps, scale):
    x, c, uc = _sampler_inputs(1)
    s = jsched.DDPMSchedule.create(**SCHED)
    want = jddim.plms_sample(eps_jax, jnp.asarray(x), jnp.asarray(c), s, steps=steps,
                             uncond=jnp.asarray(uc), guidance_scale=scale)
    got = ddim.plms_sample(eps_torch, T(x), T(c), schedules.DDPMSchedule.create(**SCHED),
                           steps=steps, uncond=T(uc), guidance_scale=scale)
    close(got, want)


def test_q_sample_matches_jax():
    rng = np.random.default_rng(2)
    x, n = randn(rng, 3, 2, 5), randn(rng, 3, 2, 5)
    t = np.array([0, 417, 999])
    s = jsched.DDPMSchedule.create(**SCHED)
    want = jddim.q_sample(s, jnp.asarray(x), jnp.asarray(t), jnp.asarray(n))
    got = ddim.q_sample(schedules.DDPMSchedule.create(**SCHED), T(x), torch.tensor(t), T(n))
    close(got, want)


# -- DDPM loss ------------------------------------------------------------------

def _replay_t_noise(key, b, shape, n_t):
    kt, kn = jax.random.split(key)
    return (torch.tensor(np.asarray(jax.random.randint(kt, (b,), 0, n_t))),
            T(jax.random.normal(kn, shape)))


@pytest.mark.parametrize("param,loss_type,elbo", [("eps", "l2", 0.0), ("x0", "l1", 0.0),
                                                  ("eps", "l2", 0.1)])
def test_ddpm_loss_matches_jax(param, loss_type, elbo):
    rng = np.random.default_rng(4)
    x, w = randn(rng, 4, 2, 8), randn(rng, 2, 2, scale=0.3)
    s = jsched.DDPMSchedule.create(**SCHED)
    key = jax.random.PRNGKey(5)

    def model_j(xn, t, ctx):
        return jnp.einsum("ij,bjk->bik", w, xn) * (t[:, None, None] / 1000.0)

    def model_t(xn, t, ctx):
        return torch.einsum("ij,bjk->bik", T(w), xn) * (t[:, None, None] / 1000.0)

    kw = dict(parameterization=param, loss_type=loss_type, original_elbo_weight=elbo)
    want, want_aux = jloss.ddpm_loss(model_j, s, jnp.asarray(x), key, **kw)
    t, noise = _replay_t_noise(key, 4, x.shape, 1000)
    got, aux = ddpm_loss.ddpm_loss(model_t, schedules.DDPMSchedule.create(**SCHED), T(x),
                                   t=t, noise=noise, **kw)
    close(got, want)
    assert set(aux) == set(want_aux)
    for k in aux:
        close(aux[k], want_aux[k])
    np.testing.assert_array_equal(ddpm_loss.vlb_weights(schedules.DDPMSchedule.create(**SCHED)),
                                  jloss.vlb_weights(s))


def test_film_pool_and_concat_match_jax():
    rng = np.random.default_rng(6)
    ctx, x, c = randn(rng, 2, 7, 16), randn(rng, 2, 3, 8), randn(rng, 2, 2, 8)
    close(ddpm_loss.film_pool(T(ctx)), jloss.film_pool(jnp.asarray(ctx)))
    close(ddpm_loss.film_pool(T(ctx[:, 0])), ctx[:, 0])
    close(ddpm_loss.concat_condition(T(x), T(c)),
          jloss.concat_condition(jnp.asarray(x), jnp.asarray(c)))


# -- transport ------------------------------------------------------------------

def _tr_inputs(seed=8):
    rng = np.random.default_rng(seed)
    return randn(rng, 3, 2, 5), randn(rng, 3, 2, 5), randn(rng, 2, 2, scale=0.4)


def _model_j(w):
    return lambda x, t, c: jnp.tanh(jnp.einsum("ij,bjk->bik", w, x)) * (1.0 + t[:, None, None])


def _model_t(w):
    return lambda x, t, c: torch.tanh(torch.einsum("ij,bjk->bik", T(w), x)) * (1.0 + t[:, None, None])


@pytest.mark.parametrize("name", ["linear", "gvp", "vp"])
def test_paths_match_jax(name):
    x1, x0, _ = _tr_inputs()
    t = np.array([0.03, 0.5, 0.97], np.float32)
    for a, b in zip(transport.Path(name).alpha_sigma(T(t)),
                    jtr.Path(name).alpha_sigma(jnp.asarray(t))):
        close(a, b)
    for a, b in zip(transport.Path(name).interpolate(T(x1), T(x0), T(t)),
                    jtr.Path(name).interpolate(jnp.asarray(x1), jnp.asarray(x0),
                                               jnp.asarray(t))):
        close(a, b)


@pytest.mark.parametrize("model_type", ["velocity", "noise", "score"])
@pytest.mark.parametrize("name", ["linear", "vp"])
def test_training_losses_and_velocity_from_match_jax(name, model_type):
    x1, _, w = _tr_inputs()
    key = jax.random.PRNGKey(9)
    want = jtr.training_losses(_model_j(w), jtr.Path(name), jnp.asarray(x1), None, key,
                               model_type)
    kt, kn = jax.random.split(key)
    t = T(jax.random.uniform(kt, (3,), minval=1e-5, maxval=1.0 - 1e-5))
    x0 = T(jax.random.normal(kn, x1.shape))
    got = transport.training_losses(_model_t(w), transport.Path(name), T(x1), None,
                                    model_type=model_type, t=t, x0=x0)
    close(got, want)
    tt = np.array([0.2, 0.5, 0.8], np.float32)
    close(transport.velocity_from(_model_t(w), transport.Path(name), model_type)(
              T(x1), T(tt), None),
          jtr.velocity_from(_model_j(w), jtr.Path(name), model_type)(
              jnp.asarray(x1), jnp.asarray(tt), None))


def test_shift_time_grid_and_linspace_match_jax():
    """The grids within fp32 rounding (XLA computes jnp.linspace's points a
    rounding apart between eager and jit)."""
    g = jnp.linspace(0.0, 1.0, 9)
    np.testing.assert_array_equal(transport.linspace_f32(0.0, 1.0, 9), np.asarray(g))
    np.testing.assert_allclose(transport.linspace_f32(1e-3, 1.0, 25),
                               np.asarray(jnp.linspace(1e-3, 1.0, 25)), rtol=2.5e-7, atol=0)
    close(transport.shift_time_grid(torch.from_numpy(np.asarray(g)), 3.0),
          jtr.shift_time_grid(g, 3.0), atol=1e-7)


@pytest.mark.parametrize("method,shift", [("euler", None), ("heun", None), ("euler", 3.0)])
def test_ode_sample_matches_jax(method, shift):
    _, x0, w = _tr_inputs(10)
    want = jtr.ode_sample(_model_j(w), jnp.asarray(x0), None, steps=7, method=method,
                          time_shifting_factor=shift)
    got = transport.ode_sample(_model_t(w), T(x0), None, steps=7, method=method,
                               time_shifting_factor=shift)
    close(got, want)


@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_dopri5_matches_jax_with_equal_stats(tol):
    _, x0, w = _tr_inputs(11)
    want, ws = jtr.dopri5_sample(_model_j(w), jnp.asarray(x0), None, rtol=tol, atol=tol)
    got, gs = transport.dopri5_sample(_model_t(w), T(x0), None, rtol=tol, atol=tol)
    close(got, want)
    assert gs == {k: int(v) for k, v in ws.items()}
    assert gs["n_accepted"] > 1


def test_sde_sample_matches_jax_with_replayed_noise():
    _, x0, w = _tr_inputs(12)
    key = jax.random.PRNGKey(13)
    score_j = _model_j(-w)
    want = jtr.sde_sample(_model_j(w), score_j, jnp.asarray(x0), None, key, steps=6,
                          diffusion=0.5)
    draws = [T(jax.random.normal(k, x0.shape)) for k in jax.random.split(key, 5)]
    got = transport.sde_sample(_model_t(w), _model_t(-w), T(x0), None, steps=6,
                               diffusion=0.5, draws=draws)
    close(got, want)


# -- noisy classifier and guidance ---------------------------------------------

CLF = dict(in_channels=4, hidden=32, num_blocks=2, num_classes=3, temb_dim=16)


def _clf():
    p = jcg.noisy_clf_init(jax.random.PRNGKey(1), jcg.NoisyClfConfig(**CLF))
    return p, load(cg.NoisyClf(cg.NoisyClfConfig(**CLF)), weights.noisy_clf_from_jax(p))


def test_noisy_clf_apply_loss_grad_and_guidance_match_jax():
    p, clf = _clf()
    jcfg = jcg.NoisyClfConfig(**CLF)
    rng = np.random.default_rng(14)
    x = randn(rng, 3, 4, 16)
    t, y = np.array([10, 500, 990]), np.array([0, 2, 1])
    close(cg.noisy_clf_apply(clf, T(x), torch.tensor(t)),
          jcg.noisy_clf_apply(p, jcfg, jnp.asarray(x), jnp.asarray(t)))
    s = jsched.DDPMSchedule.create(**SCHED)
    key = jax.random.PRNGKey(15)
    want, want_aux = jcg.noisy_clf_loss(p, jcfg, s, jnp.asarray(x), jnp.asarray(y), key)
    tt, noise = _replay_t_noise(key, 3, x.shape, 1000)
    got, aux = cg.noisy_clf_loss(clf, schedules.DDPMSchedule.create(**SCHED), T(x),
                                 torch.tensor(y), t=tt, noise=noise)
    close(got, want)
    close(aux["acc"], want_aux["acc"])
    g_want = jcg.classifier_grad(p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    g = cg.classifier_grad(clf, T(x), torch.tensor(t), torch.tensor(y))
    close(g, g_want)
    base_j = _model_j(W_EPS)
    vel_j = jcg.guided_velocity(base_j, p, jcfg, jnp.asarray(y), guidance_scale=2.0)
    vel_t = cg.guided_velocity(_model_t(W_EPS), clf, torch.tensor(y), guidance_scale=2.0)
    close(vel_t(T(x), torch.tensor(t).float(), None),
          vel_j(jnp.asarray(x), jnp.asarray(t, jnp.float32), None))


# -- 2-D VAE -------------------------------------------------------------------

VAE_SMALL = dict(in_channels=1, out_ch=1, ch=32, ch_mult=(1, 2), num_res_blocks=1,
                 z_channels=4, embed_dim=4, resolution=16, attn_resolutions=(8,))


def _vae(n_embed=0, seed=0):
    """The KL model, or the VQ model (single z: its quant_conv takes
    z_channels)."""
    kw = dict(VAE_SMALL, n_embed=n_embed, double_z=not n_embed)
    p = unzero(jvae.vae2d_init(jax.random.PRNGKey(seed), jvae.VAE2DConfig(**kw)), seed + 100)
    return p, jvae.VAE2DConfig(**kw), load(VAE2D(VAE2DConfig(**kw)), weights.vae2d_from_jax(p))


def test_vae2d_kl_matches_jax():
    p, jcfg, vae = _vae()
    x = randn(np.random.default_rng(16), 2, 1, 16, 24)
    m_want = jvae.vae2d_encode_moments(p, jcfg, jnp.asarray(x))
    m = vae2d_encode_moments(vae, T(x))
    close(m, m_want)
    z = np.asarray(m_want)[:, :4]
    close(vae2d_decode(vae, T(z)), jvae.vae2d_decode(p, jcfg, jnp.asarray(z)))


def test_vae2d_vq_matches_jax():
    """Indices equal wherever the two nearest codes are further apart than
    the tolerance; z_q and the loss as values."""
    p, jcfg, vae = _vae(n_embed=16, seed=1)
    x = randn(np.random.default_rng(17), 2, 1, 16, 24)
    z_want = np.asarray(jvae.vae2d_encode_moments(p, jcfg, jnp.asarray(x)))
    close(vae2d_encode_moments(vae, T(x)), z_want)
    cb = np.asarray(p["codebook"]) * 40  # codes spread over the latents' range
    zq_w, idx_w, loss_w = jvae.vq_quantize(jnp.asarray(cb), jnp.asarray(z_want))
    zq, idx, loss = vq_quantize(T(cb), T(z_want))
    flat = z_want.transpose(0, 2, 3, 1).reshape(-1, 4)
    d = np.sort(((flat[:, None] - cb[None]) ** 2).sum(-1), axis=1)
    clear = (d[:, 1] - d[:, 0] > 1e-4).reshape(np.asarray(idx_w).shape)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(idx_w)[clear])
    close(zq, zq_w)
    close(loss, loss_w)
    zt = T(z_want).requires_grad_(True)
    vq_quantize(T(cb), zt)[0].sum().backward()
    close(zt.grad, np.ones_like(z_want))  # the straight-through estimator


# -- 2-D UNet ------------------------------------------------------------------

UNET_CTX = dict(in_channels=4, out_channels=4, model_channels=32, channel_mult=(1, 2),
                num_res_blocks=1, attention_levels=(1,), num_heads=4, context_dim=24)
UNET_FILM = dict(in_channels=4, out_channels=4, model_channels=16, channel_mult=(1, 2),
                 num_res_blocks=1, attention_levels=(0, 1), num_heads=2, film_dim=12,
                 transformer_depth=2)


@pytest.mark.parametrize("kw", [UNET_CTX, UNET_FILM], ids=["context", "film"])
def test_unet2d_matches_jax(kw):
    p = unzero(junet.unet2d_init(jax.random.PRNGKey(2), junet.UNet2DConfig(**kw)), 3)
    unet = load(UNet2D(UNet2DConfig(**kw)), weights.unet2d_from_jax(p))
    rng = np.random.default_rng(18)
    x, t = randn(rng, 2, 4, 8, 12), np.array([10, 700])
    ctx = randn(rng, 2, 7, 24) if kw.get("context_dim") else None
    film = randn(rng, 2, 12) if kw.get("film_dim") else None
    want = jax.jit(junet.unet2d_apply, static_argnums=1)(
        p, junet.UNet2DConfig(**kw), jnp.asarray(x), jnp.asarray(t),
        None if ctx is None else jnp.asarray(ctx), None if film is None else jnp.asarray(film))
    got = unet2d_apply(unet, T(x), torch.tensor(t), None if ctx is None else T(ctx),
                       None if film is None else T(film))
    assert float(np.abs(np.asarray(want)).max()) > 1e-2
    close(got, want)


# -- AudioLDM --------------------------------------------------------------------

AL_UNET = dict(in_channels=4, out_channels=4, model_channels=16, channel_mult=(1, 2),
               num_res_blocks=1, attention_levels=(1,), num_heads=2, film_dim=24)
AL_VAE = dict(ch=16, ch_mult=(1, 2), z_channels=4, embed_dim=4, num_res_blocks=1)
AL_VOC = dict(num_mels=8, upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4),
              upsample_initial_channel=16, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),), activation="lrelu")


@pytest.fixture(scope="module")
def audioldm():
    """JAX's tiny pipeline (tests/test_audioldm.py's configs, the zero-init
    leaves made nonzero) and the port's from the same weights."""
    jp = JAudioLDM.random_init(
        jax.random.PRNGKey(0), unet_cfg=junet.UNet2DConfig(**AL_UNET),
        vae_cfg=jvae.VAE2DConfig(**AL_VAE), voc_cfg=JBigVGANConfig(**AL_VOC),
        latent_f=4, latent_t=8)
    jp.params = unzero(jp.params, 4, scale=0.05)
    sd = weights.audioldm_from_jax(jp.params)
    pipe = AudioLDMPipeline(load(UNet2D(UNet2DConfig(**AL_UNET)), sd["unet"]),
                            load(VAE2D(VAE2DConfig(**AL_VAE)), sd["vae"]),
                            load(BigVGAN(BigVGANConfig(**AL_VOC)), sd["vocoder"]),
                            schedules.DDPMSchedule.create(), latent_f=4, latent_t=8)
    return jp, pipe


@pytest.mark.parametrize("case", [
    dict(ddim_steps=4, unconditional_guidance_scale=3.0),
    dict(ddim_steps=4, unconditional_guidance_scale=3.0, use_plms=True),
    dict(ddim_steps=5, unconditional_guidance_scale=1.0, pooled=True),
    dict(ddim_steps=2, unconditional_guidance_scale=2.0, n_candidate_gen_per_text=2),
    dict(ddim_steps=2, unconditional_guidance_scale=1.5, n_candidate_gen_per_text=3,
         select="quiet"),
], ids=["ddim_cfg", "plms_cfg", "ddim_pooled", "best_of_2", "best_of_3_select"])
def test_audioldm_generate_sample_matches_jax(audioldm, case):
    jp, pipe = audioldm
    case = dict(case)
    pooled, select = case.pop("pooled", False), case.pop("select", None)
    rng = np.random.default_rng(19)
    cond = randn(rng, 2, 24) if pooled else randn(rng, 2, 5, 24)
    key = jax.random.PRNGKey(2)
    jsel = (lambda w: -jnp.mean(jnp.abs(w), axis=-1)) if select else None
    tsel = (lambda w: -w.abs().mean(dim=-1)) if select else None
    wav_w, mel_w = jp.generate_sample(jnp.asarray(cond), key, select_fn=jsel, **case)
    n = case.get("n_candidate_gen_per_text", 1)
    x_T = T(jax.random.normal(jax.random.split(key)[0], (2 * n, 4, 4, 8), jnp.float32))
    wav, mel = pipe.generate_sample(T(cond), x_T=x_T, select_fn=tsel, **case)
    assert wav.shape == (2, 8 * mel.shape[-1]) and mel.shape == (2, 8, 16)
    close(mel, mel_w)
    close(wav, wav_w)


def test_audioldm_blowup_guard_tests_the_whole_batch(audioldm):
    """One sample past 1e2 clips every sample of the batch to [-10, 10]."""
    jp, pipe = audioldm
    x_T = np.zeros((2, 4, 4, 8), np.float32)
    x_T[0] = 5e3
    x_T[1] = 20.0 * np.random.default_rng(20).standard_normal((4, 4, 8))
    film = np.zeros((2, 24), np.float32)
    want = jp._sample(jp.params, jnp.asarray(x_T), jnp.asarray(film), None,
                      jax.random.PRNGKey(0), guidance_scale=1.0, ddim_steps=2)
    got = pipe.sample(T(x_T), T(film), None, 1.0, ddim_steps=2)
    assert float(np.abs(np.asarray(want)).max()) <= 10.0
    assert float(got[1].abs().max()) <= 10.0  # the tame sample was clipped too
    close(got, want)


def test_audioldm_refuses_mismatched_mels():
    """JAX's defaults: VAE2DConfig() decodes latent_f 16 to 64 mel bands,
    hifigan_config() takes 80; the port refuses before building anything."""
    assert hifigan_config().num_mels == 80
    with pytest.raises(ValueError, match="num_mels=64"):
        AudioLDMPipeline.random_init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="num_mels=8"):
        AudioLDMPipeline(UNet2D(UNet2DConfig(**AL_UNET)), VAE2D(VAE2DConfig(**AL_VAE)),
                         BigVGAN(BigVGANConfig(**dict(AL_VOC, num_mels=80))),
                         schedules.DDPMSchedule.create(), latent_f=4, latent_t=8)


def test_audioldm_random_init_runs():
    pipe = AudioLDMPipeline.random_init(
        torch.Generator().manual_seed(0), UNet2DConfig(**AL_UNET), VAE2DConfig(**AL_VAE),
        BigVGANConfig(**AL_VOC), device="cpu", latent_f=4, latent_t=8)
    wav, mel = pipe.generate_sample(torch.zeros(1, 24), torch.Generator().manual_seed(1),
                                    ddim_steps=2, unconditional_guidance_scale=2.0)
    assert wav.shape == (1, 128) and torch.isfinite(wav).all()
