"""Port VAE decoder, BigVGAN, BERT, T5 and CLAP+FLAN against the JAX
package at small widths, the same weights (weights.params_from_jax) and the
same numpy inputs, fp32 on the CPU: rtol 1e-3 / atol 1e-4. On the CPU the
vocoder's K1/K2 wrappers run their plain versions, so the vocoder test also
holds the kernel routing (C <= 48 -> K2, else K1) to the JAX vocoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maa3_tpu.models import bert as jbert
from maa3_tpu.models import bigvgan as jvoc
from maa3_tpu.models import clap as jclap
from maa3_tpu.models import t5 as jt5
from maa3_tpu.models import vae1d as jvae
from maa3_tpu_torch import weights
from maa3_tpu_torch.models import bert as tbert
from maa3_tpu_torch.models import bigvgan as tvoc
from maa3_tpu_torch.models import clap as tclap
from maa3_tpu_torch.models import t5 as tt5
from maa3_tpu_torch.models import vae1d as tvae

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cmp(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32) if isinstance(got, np.ndarray)
                               else got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **(tol or TOL))


def test_vae_decode_matches_jax():
    kw = dict(out_ch=16, ch=32, ch_mult=(1, 2), num_res_blocks=1,
              attn_layers=(1,), z_channels=4, embed_dim=4)
    p = jvae.vae_init(jax.random.PRNGKey(0), jvae.VAEConfig(in_channels=16, **kw))
    m = tvae.AutoencoderKL(tvae.VAEConfig(in_channels=16, **kw))
    m.load_state_dict(weights.vae_from_jax(_np(p)))
    z = np.random.RandomState(0).randn(2, 4, 12).astype(np.float32)
    want = jvae.vae_decode(p, jvae.VAEConfig(in_channels=16, **kw), jnp.asarray(z))
    with torch.no_grad():
        got = tvae.vae_decode(m, torch.tensor(z))
    assert got.shape == (2, 16, 24)
    _cmp(got, want)


VOC = dict(num_mels=8, upsample_rates=(2, 2, 2), upsample_kernel_sizes=(4, 4, 4),
           upsample_initial_channel=256)


def _jit_voc(p, cfg, mel, dtype):
    fn = jax.jit(lambda p_, m_: jvoc.bigvgan_apply(
        p_, jvoc.BigVGANConfig(**cfg), m_, compute_dtype=dtype, pallas_aa=False))
    return fn(p, jnp.asarray(mel))


@pytest.mark.parametrize("activation", ["snakebeta", "snake"])
def test_bigvgan_matches_jax(activation):
    """Stages of 128 and 64 channels take K1, the 32-channel stage K2."""
    cfg = dict(VOC, activation=activation)
    p = jvoc.bigvgan_init(jax.random.PRNGKey(0), jvoc.BigVGANConfig(**cfg))
    rng = np.random.RandomState(1)
    # nonzero snake parameters, so alpha != beta and exp() matters
    p = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.3)
                         if getattr(path[-1], "key", None) in ("alpha", "beta") else v),
        p)
    m = tvoc.BigVGAN(tvoc.BigVGANConfig(**cfg))
    m.load_state_dict(weights.bigvgan_from_jax(_np(p)))
    mel = rng.randn(2, 8, 10).astype(np.float32)
    want = _jit_voc(p, cfg, mel, jnp.float32)
    got = tvoc.bigvgan_apply(m, torch.tensor(mel), compute_dtype=torch.float32)
    assert got.shape == (2, 80)
    _cmp(got, want)


def test_bigvgan_bf16_matches_jax():
    """bf16 vocoder with the poly sin^2 (one K1 and one K2 stage): atol =
    rtol = 5e-2 on [-1, 1] outputs (bf16 convs, rounding of intermediates
    in different places)."""
    cfg = dict(VOC, upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
               upsample_initial_channel=128)
    p = jvoc.bigvgan_init(jax.random.PRNGKey(3), jvoc.BigVGANConfig(**cfg))
    m = tvoc.BigVGAN(tvoc.BigVGANConfig(**cfg))
    m.load_state_dict(weights.bigvgan_from_jax(_np(p)))
    mel = np.random.RandomState(4).randn(1, 8, 8).astype(np.float32)
    want = _jit_voc(p, cfg, mel, jnp.bfloat16)
    got = tvoc.bigvgan_apply(m, torch.tensor(mel), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _cmp(got, want, rtol=5e-2, atol=5e-2)


BERT = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64)
T5 = dict(vocab_size=120, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_heads=4)


def _ids(b, l, vocab, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, l // 2:] = 0
    return ids, mask


def test_clap_flan_encode_matches_jax():
    """BERT + projection + T5 (the relative-bias buckets included: L = 40
    reaches the log-spaced buckets) through clap_flan_encode."""
    jcfg = jclap.CLAPFLANConfig(bert=jbert.BertConfig(**BERT), t5=jt5.T5Config(**T5),
                                d_proj=32)
    p = jclap.clap_flan_init(jax.random.PRNGKey(0), jcfg)
    m = tclap.CLAPFLAN(tclap.CLAPFLANConfig(bert=tbert.BertConfig(**BERT),
                                            t5=tt5.T5Config(**T5), d_proj=32))
    m.load_state_dict(weights.clap_flan_from_jax(_np(p)))
    ori, om = _ids(2, 40, 100)
    st, sm = _ids(2, 40, 120, seed=1)
    want = jclap.clap_flan_encode(p, jcfg, jnp.asarray(ori), jnp.asarray(st),
                                  jnp.asarray(om), jnp.asarray(sm))
    with torch.no_grad():
        got = tclap.clap_flan_encode(m, torch.tensor(ori).long(), torch.tensor(st).long(),
                                     torch.tensor(om), torch.tensor(sm))
    assert got.shape == (2, 80, 32)
    _cmp(got, want)
    # the towers on their own, and the bucketing
    want_b = jbert.bert_apply(p["bert"], jcfg.bert, jnp.asarray(ori), jnp.asarray(om))
    with torch.no_grad():
        got_b = tbert.bert_apply(m.caption_encoder.base, torch.tensor(ori).long(),
                                 torch.tensor(om))
    _cmp(got_b, want_b)
    rel = np.arange(-200, 200)
    np.testing.assert_array_equal(tt5.relative_position_bucket(rel, 32, 128),
                                  jt5._relative_position_bucket(rel, 32, 128))
