#!/usr/bin/env python
"""Convert an Orbax checkpoint directory of the JAX package into the file
the PyTorch port writes for the same thing, so that the port (which has
neither JAX nor Orbax) serves, resumes and scores it. Run it where JAX and
Orbax are installed:

    python orbax_to_torch.py SRC_DIR DST.pt [-b CONFIG ...] [key=value ...]
        [--accum_steps N] [--mu_dtype bfloat16] [--fuse_gemms]
        [--backbone vggishish|melception] [--small] [--num_classes N] [--tsv T]

The kind is read from the directory's top-level keys:

- {params, opt_state, step, scale_factor, frozen?, ema_params?}: a Trainer
  checkpoint (maa3_tpu/train/loop.py save_checkpoint, scripts/train.py).
  It is restored as Trainer.restore_checkpoint restores it: against a
  target built (jax.eval_shape, nothing allocated) from the -b configs,
  the key=value overrides and --accum_steps / --mu_dtype / --fuse_gemms,
  the flags scripts/train.py trained it with; -b is required, and a
  shape, dtype or entry that does not fit raises. It becomes the port's
  Trainer file (params and EMA shadows in the canonical names, the AdamW
  state, step, scale_factor, the frozen VAE when the directory has it),
  which `python -m maa3_tpu_torch.train -r`, `MAA3System.from_config(
  ckpt_path=)` (txt2audio / video2audio / serve -r) and encode_latents -r
  read;
- {vae, disc, logvar}: scripts/train_vae.py -> the port's train_vae file
  (`python -m maa3_tpu_torch.train --vae_ckpt`);
- {params} alone: scripts/train_melclf.py -> the port's train_melclf file
  (cal_fd_score / predict_melclf --clf_ckpt). The backbone, --small and the
  class count are read from the shapes (--backbone / --small / --num_classes
  given anyway must agree); --tsv, the training manifest, recovers the
  class names as train_melclf derives them (sorted labels);
- {generator}: scripts/train_vocoder.py -> {generator}, the generator.pt of
  a vocoder directory (its BigVGAN config is scripts/train_vocoder.py's
  with the upsample_initial_channel the weights have).

Anything else raises. This file and the tests are the only code of the
port that imports JAX or Orbax; the mapping itself is
maa3_tpu_torch/weights.py (*_checkpoint_from_jax), on numpy arrays.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from maa3_tpu_torch import weights  # noqa: E402

KINDS = {"trainer": {"params", "opt_state", "step", "scale_factor"},
         "train_vae": {"vae", "disc", "logvar"},
         "train_melclf": {"params"},
         "train_vocoder": {"generator"}}
OPTIONAL = {"trainer": {"frozen", "ema_params"}}


def _ocp():
    import orbax.checkpoint as ocp
    return ocp


def _metadata(src: str):
    return _ocp().StandardCheckpointer().metadata(os.path.abspath(src)).item_metadata.tree


def classify(src: str) -> str:
    """The kind of an Orbax directory, from its top-level keys."""
    if not os.path.isdir(src):
        raise ValueError(f"{src} is not a directory (an Orbax checkpoint is one)")
    keys = set(_metadata(src))
    for kind, need in KINDS.items():
        if need <= keys <= need | OPTIONAL.get(kind, set()):
            return kind
    raise ValueError(f"{src}: top-level keys {sorted(keys)} are none of the JAX "
                     f"package's checkpoints ({', '.join(KINDS)})")


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                    for k in keys)


def _leaves(tree, leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]
    return {_path(p): (tuple(x.shape), np.dtype(x.dtype)) for p, x in flat}


def check_fits(src: str, target) -> None:
    """Raise unless the directory holds exactly the target's entries with its
    shapes and dtypes (Orbax would restore another shape or dtype
    silently)."""
    have = _leaves(_metadata(src), leaf=lambda x: hasattr(x, "shape"))
    want = _leaves(target)
    bad = ([f"{k}: missing" for k in sorted(set(want) - set(have))]
           + [f"{k}: not in the configs' state" for k in sorted(set(have) - set(want))]
           + [f"{k}: {have[k][0]} {have[k][1]} in the checkpoint, {want[k][0]} "
              f"{want[k][1]} from the configs" for k in sorted(set(want) & set(have))
              if have[k] != want[k]])
    if bad:
        raise ValueError(f"{src} does not fit the configs and flags given "
                         f"({len(bad)} entries): " + "; ".join(bad[:6]))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_clap_cfg(jcfg):
    """The port's CLAPFLANConfig with the JAX config's sizes."""
    from maa3_tpu_torch.models import bert, clap, t5

    def cp(cls, obj):
        return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})

    return clap.CLAPFLANConfig(bert=cp(bert.BertConfig, jcfg.bert),
                               t5=cp(t5.T5Config, jcfg.t5), d_proj=jcfg.d_proj)


class _ShapeRng:
    """nprand.np_rng's stand-in while the target is traced: traced zeros of
    each drawn shape, so that the initializers allocate nothing."""

    def uniform(self, low=0.0, high=1.0, size=None):
        import jax.numpy as jnp
        return jnp.zeros(size, jnp.float32)

    def standard_normal(self, size=None):
        return self.uniform(size=size)


def trainer_target(configs: Sequence[str], overrides: Sequence[str], accum_steps: int,
                   mu_dtype: str, fuse_gemms: bool, frozen: bool, ema: bool, clap_cfg=None):
    """The restore target of a Trainer checkpoint, as maa3_tpu/train/loop.py
    builds its state from these configs and flags (shapes only)."""
    import jax.numpy as jnp
    import optax
    from maa3_tpu import config as jconfig
    from maa3_tpu.models import clap as jclap
    from maa3_tpu.models.dit import dit_init
    from maa3_tpu.models.dit_moe import moe_dit_init
    from maa3_tpu.models.vae1d import vae_init
    from maa3_tpu.train.optim import make_optimizer
    from maa3_tpu.utils import nprand
    spec = jconfig.parse_model_config(jconfig.load_config(list(configs), list(overrides)))

    def build():
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        moe = spec.backbone_kind == "video_moe_dit"
        dit = (moe_dit_init if moe else dit_init)(k1, spec.dit)
        train = {"dit": nprand.fuse_dit_gemms(dit) if fuse_gemms else dit}
        if spec.cond_stage_trainable:
            train["cond"] = (jclap.video_feat_encoder_init(k3, 512, spec.dit.context_dim)
                             if spec.cond_kind.startswith("video_feat") else
                             jclap.clap_flan_init(k3, clap_cfg or jclap.CLAPFLANConfig()))
        tx = make_optimizer(spec.base_learning_rate, mu_dtype=jnp.dtype(mu_dtype))
        if accum_steps > 1:
            tx = optax.MultiSteps(tx, every_k_schedule=accum_steps)
        out = {"params": train, "opt_state": tx.init(train), "step": jnp.zeros((), jnp.int32),
               "scale_factor": jnp.float32(spec.scale_factor)}
        if frozen:
            out["frozen"] = {"vae": vae_init(k2, spec.vae)}
        if ema:
            out["ema_params"] = train
        return out

    from unittest import mock
    with mock.patch.object(nprand, "np_rng", lambda key: _ShapeRng()):
        return jax.eval_shape(build)


def restore_trainer(src: str, configs: Sequence[str], overrides: Sequence[str] = (),
                    accum_steps: int = 1, mu_dtype: str = "float32",
                    fuse_gemms: bool = False, clap_cfg=None) -> dict:
    """A Trainer checkpoint directory restored against the target of these
    configs and flags, as Trainer.restore_checkpoint restores it (the
    optimizer state as optax's named tuples). clap_cfg: the JAX
    CLAPFLANConfig the conditioner was built with (the default's sizes
    otherwise)."""
    if not configs:
        raise ValueError("a Trainer checkpoint needs the -b configs it was trained with")
    top = set(_metadata(src))
    target = trainer_target(configs, overrides, accum_steps, mu_dtype, fuse_gemms,
                            "frozen" in top, "ema_params" in top, clap_cfg)
    check_fits(src, target)
    return _ocp().StandardCheckpointer().restore(os.path.abspath(src), target=target)


def trainer_payload(restored: dict, configs: Sequence[str], overrides: Sequence[str] = (),
                    accum_steps: int = 1, mu_dtype: str = "float32",
                    fuse_gemms: bool = False, clap_cfg=None) -> dict:
    """The port's Trainer payload of a JAX Trainer's saved state
    ({params, opt_state, step, scale_factor, frozen?, ema_params?}, as
    save_checkpoint writes it and restore_trainer reads it back)."""
    import optax
    from maa3_tpu_torch import config as tconfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig, make_conditioner
    from maa3_tpu_torch.system import dit_module
    opt = restored["opt_state"]
    adam = [s for s in jax.tree.leaves(opt, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"{len(adam)} AdamW states in the optimizer state")
    tree = {k: _np(v) for k, v in restored.items() if k != "opt_state"}
    tree["opt"] = {"count": adam[0].count, "mu": _np(adam[0].mu), "nu": _np(adam[0].nu)}
    if accum_steps > 1:
        tree["opt"].update(mini_step=opt.mini_step, acc=_np(opt.acc_grads))

    spec = tconfig.parse_model_config(tconfig.load_config(list(configs), list(overrides)))
    pcfg = port_clap_cfg(clap_cfg) if clap_cfg is not None else CLAPFLANConfig()
    with torch.device("meta"):
        dit = dit_module(spec)
        cond = (make_conditioner(spec.cond_kind, pcfg, spec.dit.context_dim)
                if spec.cond_stage_trainable else None)
    return weights.trainer_checkpoint_from_jax(
        tree, dit, cond, spec.cond_kind, fuse_gemms, accum_steps,
        getattr(torch, mu_dtype))


def _restore_raw(src: str) -> dict:
    with _ocp().PyTreeCheckpointer() as ckptr:
        return _np(ckptr.restore(os.path.abspath(src)))


def convert_melclf(src: str, backbone: Optional[str] = None, small: Optional[bool] = None,
                   num_classes: int = 0, tsv: Optional[str] = None) -> dict:
    """A train_melclf directory -> the port's train_melclf payload."""
    from maa3_tpu_torch.models.melclf import DEFAULT_CONV_LAYERS, SMALL_CONV_LAYERS
    params = _restore_raw(src)["params"]
    found = "vggishish" if "features" in params else "melception"
    if backbone not in (None, found):
        raise ValueError(f"{src} holds a {found} classifier, not a {backbone}")
    conv = None
    if found == "vggishish":
        widths = [int(np.asarray(f["w"]).shape[0]) for f in params["features"]]
        stacks = {True: SMALL_CONV_LAYERS, False: DEFAULT_CONV_LAYERS}
        is_small = [s for s, c in stacks.items() if [v for v in c if v != "MP"] == widths]
        if not is_small or small not in (None, is_small[0]):
            raise ValueError(f"{src}: conv widths {widths} are not the "
                             f"{'small' if small else 'default'} VGGishish stack's")
        conv = stacks[is_small[0]]
    classes = None
    if tsv:
        from maa3_tpu_torch.data.datasets import read_tsv
        classes = sorted({r["label"] for r in read_tsv(tsv)})
    payload = weights.melclf_checkpoint_from_jax(params, found, conv, classes)
    n = payload["num_classes"]
    if (num_classes and num_classes != n) or (classes and len(classes) != n):
        raise ValueError(f"{src} has {n} classes, not {num_classes or len(classes)}")
    return payload


def convert(src: str, dst: str, configs: Sequence[str] = (), overrides: Sequence[str] = (),
            accum_steps: int = 1, mu_dtype: str = "float32", fuse_gemms: bool = False,
            clap_cfg=None, backbone: Optional[str] = None, small: Optional[bool] = None,
            num_classes: int = 0, tsv: Optional[str] = None) -> str:
    """Classify src, convert it and torch.save the payload to dst (written
    under a temporary name and renamed into place). The configs, overrides
    and training flags serve a Trainer checkpoint, the classifier flags a
    train_melclf one. Returns the kind."""
    kind = classify(src)
    if kind == "trainer":
        flags = dict(accum_steps=accum_steps, mu_dtype=mu_dtype, fuse_gemms=fuse_gemms,
                     clap_cfg=clap_cfg)
        payload = trainer_payload(restore_trainer(src, configs, overrides, **flags),
                                  configs, overrides, **flags)
    elif kind == "train_melclf":
        payload = convert_melclf(src, backbone, small, num_classes, tsv)
    elif kind == "train_vae":
        payload = weights.vae_gan_checkpoint_from_jax(_restore_raw(src))
    else:
        payload = weights.vocoder_checkpoint_from_jax(_restore_raw(src))
    tmp = f"{dst}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, dst)
    return kind


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                epilog="key=value items anywhere on the line override the configs")
    p.add_argument("src", help="the Orbax checkpoint directory")
    p.add_argument("dst", help="the torch file to write")
    p.add_argument("-b", "--base", nargs="*", default=[],
                   help="the config yamls a Trainer checkpoint was trained with")
    p.add_argument("--accum_steps", type=int, default=1)
    p.add_argument("--mu_dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--fuse_gemms", action="store_true")
    p.add_argument("--backbone", default=None, choices=["vggishish", "melception"])
    p.add_argument("--small", action="store_true", default=None)
    p.add_argument("--num_classes", type=int, default=0)
    p.add_argument("--tsv", default=None, help="train_melclf's manifest (class names)")
    # the key=value overrides may stand anywhere, also right after -b's
    # configs (which would otherwise take them as config paths)
    argv = sys.argv[1:] if argv is None else list(argv)
    overrides = [a for a in argv if "=" in a and not a.startswith("-")]
    opt = p.parse_args([a for a in argv if a not in overrides])
    jax.config.update("jax_platforms", "cpu")
    kind = convert(opt.src, opt.dst, opt.base, overrides, accum_steps=opt.accum_steps,
                   mu_dtype=opt.mu_dtype, fuse_gemms=opt.fuse_gemms, backbone=opt.backbone,
                   small=opt.small, num_classes=opt.num_classes, tsv=opt.tsv)
    print(f"{opt.src} ({kind}) -> {opt.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
