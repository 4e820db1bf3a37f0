"""Parameter bridges into the port's modules.

`params_from_jax` turns the JAX package's parameter trees (nested dicts of
numpy arrays: dense weights (in, out), DiT blocks stacked along a leading
depth axis) into state dicts with the reference checkpoints' torch keys,
which the port's modules carry (the vocoder's weight norm is already
folded on the JAX side); the legacy 2-D UNet and the noisy classifier
keep the JAX tree's names. The `*_checkpoint_from_jax` functions turn the
JAX package's checkpoints, restored to numpy by orbax_to_torch.py, into
the payloads the port's own writers save (the Trainer's .pt, train_vae's,
train_melclf's and the vocoder trainer's files).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

State = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _lin(sd: State, name: str, p: dict) -> None:
    """JAX dense {w (in, out), b?} -> <name>.weight (out, in), <name>.bias."""
    sd[name + ".weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        sd[name + ".bias"] = _t(p["b"])


def _vec(sd: State, name: str, p: dict) -> None:
    for k in ("weight", "bias"):
        if k in p:
            sd[f"{name}.{k}"] = _t(p[k])


def _conv(sd: State, name: str, p: dict) -> None:
    """Conv weights keep torch layout on both sides."""
    sd[name + ".weight"] = _t(p["w"])
    if p.get("b") is not None:
        sd[name + ".bias"] = _t(p["b"])


def dit_from_jax(p: dict) -> State:
    """The text DiT, or the video MoE DiT (its stacked time / freq experts
    (depth, E, in, out) and its c_embedder)."""
    if "wqkv" in p["blocks"]["attention"]:
        raise ValueError("pass the canonical (unfused) DiT parameters")
    sd: State = {}
    _lin(sd, "proj_in", p["proj_in"])
    _lin(sd, "t_embedder.mlp.0", p["t_embedder"]["mlp0"])
    _lin(sd, "t_embedder.mlp.2", p["t_embedder"]["mlp2"])
    if "c_embedder" in p:
        ce = p["c_embedder"]
        _lin(sd, "c_embedder.mlp.0", ce["mlp0"])
        _lin(sd, "c_embedder.mlp.2", ce["mlp2"])
        _vec(sd, "c_embedder.mlp.3", ce["ln"])
    _vec(sd, "cap_embedder.0", p["cap_embedder"]["norm"])
    _lin(sd, "cap_embedder.1", p["cap_embedder"]["linear"])
    blocks = p["blocks"]
    depth = np.asarray(blocks["adaLN"]["w"]).shape[0]

    def at(tree, i):
        return {k: (at(v, i) if isinstance(v, dict) else np.asarray(v)[i])
                for k, v in tree.items()}

    for i in range(depth):
        b = at(blocks, i)
        pre = f"blocks.{i}."
        att = b["attention"]
        for nm in ("wq", "wk", "wv", "wo", "wk_y", "wv_y"):
            _lin(sd, pre + "attention." + nm, att[nm])
        sd[pre + "attention.gate"] = _t(att["gate"])
        for nm in ("q_norm", "k_norm", "ky_norm"):
            if nm in att:
                _vec(sd, pre + "attention." + nm, att[nm])
        ff = b["feed_forward"]
        if "time_experts" in ff:  # the video MoE: (E, in, out) stacks
            for kind in ("time_experts", "freq_experts"):
                for nm in ("w1", "w2", "w3"):
                    for e, w in enumerate(np.asarray(ff[kind][nm]["w"])):
                        _lin(sd, f"{pre}feed_forward.{kind}.{e}.{nm}", {"w": w})
        else:
            for nm in ("w1", "w2", "w3"):
                _lin(sd, pre + "feed_forward." + nm, ff[nm])
        for nm in ("attention_norm", "ffn_norm", "attention_y_norm"):
            _vec(sd, pre + nm, b[nm])
        _lin(sd, pre + "adaLN_modulation.1", b["adaLN"])
    _lin(sd, "final_layer.linear", p["final_layer"]["linear"])
    _lin(sd, "final_layer.adaLN_modulation.1", p["final_layer"]["adaLN"])
    return sd


def _resblock(sd: State, name: str, p: dict) -> None:
    for nm in ("norm1", "norm2"):
        _vec(sd, f"{name}.{nm}", p[nm])
    for nm in ("conv1", "conv2", "nin_shortcut"):
        if nm in p:
            _conv(sd, f"{name}.{nm}", p[nm])


def _attnblock(sd: State, name: str, p: dict) -> None:
    _vec(sd, name + ".norm", p["norm"])
    for nm in ("q", "k", "v", "proj_out"):
        _conv(sd, f"{name}.{nm}", p[nm])


def vae_from_jax(p: dict) -> State:
    """AutoencoderKL: encoder.* + quant_conv, post_quant_conv + decoder.*."""
    sd: State = {}
    e = p["encoder"]
    _conv(sd, "encoder.conv_in", e["conv_in"])
    for lvl, lp in enumerate(e["down"]):
        for i, bp in enumerate(lp["block"]):
            _resblock(sd, f"encoder.down.{lvl}.block.{i}", bp)
        for i, ap in enumerate(lp["attn"]):
            _attnblock(sd, f"encoder.down.{lvl}.attn.{i}", ap)
        if "downsample" in lp:
            _conv(sd, f"encoder.down.{lvl}.downsample.conv", lp["downsample"])
    _resblock(sd, "encoder.mid.block_1", e["mid"]["block_1"])
    _attnblock(sd, "encoder.mid.attn_1", e["mid"]["attn_1"])
    _resblock(sd, "encoder.mid.block_2", e["mid"]["block_2"])
    _vec(sd, "encoder.norm_out", e["norm_out"])
    _conv(sd, "encoder.conv_out", e["conv_out"])
    _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    d = p["decoder"]
    _conv(sd, "decoder.conv_in", d["conv_in"])
    _resblock(sd, "decoder.mid.block_1", d["mid"]["block_1"])
    _attnblock(sd, "decoder.mid.attn_1", d["mid"]["attn_1"])
    _resblock(sd, "decoder.mid.block_2", d["mid"]["block_2"])
    for lvl, lp in enumerate(d["up"]):
        for i, bp in enumerate(lp["block"]):
            _resblock(sd, f"decoder.up.{lvl}.block.{i}", bp)
        for i, ap in enumerate(lp.get("attn", ())):  # the 2-D decoder has none
            _attnblock(sd, f"decoder.up.{lvl}.attn.{i}", ap)
        if "upsample" in lp:
            _conv(sd, f"decoder.up.{lvl}.upsample.conv", lp["upsample"])
    _vec(sd, "decoder.norm_out", d["norm_out"])
    _conv(sd, "decoder.conv_out", d["conv_out"])
    return sd


def vae2d_from_jax(p: dict) -> State:
    """The 2-D KL or VQ autoencoder (models/vae2d.py): vae_from_jax's keys
    and, for VQ, the codebook as quantize.embedding.weight."""
    sd = vae_from_jax(p)
    if "codebook" in p:
        sd["quantize.embedding.weight"] = _t(p["codebook"])
    return sd


def _unet_res(sd: State, name: str, p: dict) -> None:
    for nm in ("norm1", "norm2"):
        _vec(sd, f"{name}.{nm}", p[nm])
    for nm in ("conv1", "conv2", "skip"):
        if nm in p:
            _conv(sd, f"{name}.{nm}", p[nm])
    _lin(sd, name + ".temb", p["temb"])


def _unet_st(sd: State, name: str, p: dict) -> None:
    _vec(sd, name + ".norm", p["norm"])
    _conv(sd, name + ".proj_in", p["proj_in"])
    _conv(sd, name + ".proj_out", p["proj_out"])
    for j, bp in enumerate(p["blocks"]):
        for nm, v in bp.items():
            (_vec if nm.startswith("ln") else _lin)(sd, f"{name}.blocks.{j}.{nm}", v)


def unet2d_from_jax(p: dict) -> State:
    """The legacy 2-D UNet (models/unet2d.py), keys as the JAX tree's."""
    sd: State = {}
    for nm in ("temb1", "temb2", "film_emb"):
        if nm in p:
            _lin(sd, nm, p[nm])
    _conv(sd, "conv_in", p["conv_in"])
    for side, move in (("down", "down"), ("up", "up")):
        for lvl, lp in enumerate(p[side]):
            pre = f"{side}.{lvl}."
            for i, rp in enumerate(lp["res"]):
                _unet_res(sd, f"{pre}res.{i}", rp)
            for i, ap in enumerate(a for a in lp["attn"] if a is not None):
                _unet_st(sd, f"{pre}attn.{i}", ap)
            if move in lp:
                _conv(sd, pre + move, lp[move])
    _unet_res(sd, "mid.res1", p["mid"]["res1"])
    _unet_st(sd, "mid.attn", p["mid"]["attn"])
    _unet_res(sd, "mid.res2", p["mid"]["res2"])
    _vec(sd, "norm_out", p["norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def noisy_clf_from_jax(p: dict) -> State:
    """The noisy-latent classifier (diffusion/classifier_guidance.py)."""
    sd: State = {}
    for nm in ("temb1", "temb2", "head"):
        _lin(sd, nm, p[nm])
    _conv(sd, "conv_in", p["conv_in"])
    for i, bp in enumerate(p["blocks"]):
        _conv(sd, f"blocks.{i}.conv1", bp["conv1"])
        _conv(sd, f"blocks.{i}.conv2", bp["conv2"])
        _lin(sd, f"blocks.{i}.film", bp["film"])
    return sd


def audioldm_from_jax(p: dict) -> Dict[str, State]:
    """AudioLDMPipeline.params {unet, vae, vocoder} -> the state dicts of
    the port's pipeline modules."""
    return {"unet": unet2d_from_jax(p["unet"]), "vae": vae2d_from_jax(p["vae"]),
            "vocoder": bigvgan_from_jax(p["vocoder"])}


def _snake(sd: State, name: str, p: dict) -> None:
    for k in ("alpha", "beta"):
        if k in p:
            sd[f"{name}.act.{k}"] = _t(p[k])


def bigvgan_from_jax(p: dict) -> State:
    sd: State = {}
    _conv(sd, "conv_pre", p["conv_pre"])
    for i, up in enumerate(p["ups"]):
        _conv(sd, f"ups.{i}.0", up)
    for n, rb in enumerate(p["resblocks"]):
        for key in ("convs1", "convs2", "convs"):  # AMPBlock1; AMPBlock2
            for j, c in enumerate(rb.get(key, ())):
                _conv(sd, f"resblocks.{n}.{key}.{j}", c)
        for j, a in enumerate(rb["acts"]):
            _snake(sd, f"resblocks.{n}.activations.{j}", a)
    _snake(sd, "activation_post", p["activation_post"])
    _conv(sd, "conv_post", p["conv_post"])
    return sd


def nlayer_disc_from_jax(p: dict) -> State:
    """PatchGAN {layers: [{conv, bn}]} -> main.{i}: the first conv at 0, each
    conv + BN group at i, i + 1 (3 apart, LeakyReLUs between), the last conv."""
    sd: State = {}
    layers = p["layers"]
    _conv(sd, "main.0", layers[0]["conv"])
    idx = 2
    for lp in layers[1:-1]:
        _conv(sd, f"main.{idx}", lp["conv"])
        _vec(sd, f"main.{idx + 1}", lp["bn"])
        idx += 3
    _conv(sd, f"main.{idx}", layers[-1]["conv"])
    return sd


def mpd_from_jax(p: dict) -> State:
    """MultiPeriodDiscriminator {discs: [{convs, post}]}; the
    MultiResolutionDiscriminator has the same layout (mrd_from_jax)."""
    sd: State = {}
    for i, d in enumerate(p["discs"]):
        for j, c in enumerate(d["convs"]):
            _conv(sd, f"discriminators.{i}.convs.{j}", c)
        _conv(sd, f"discriminators.{i}.conv_post", d["post"])
    return sd


mrd_from_jax = mpd_from_jax


def multi_window_disc_from_jax(p: dict) -> State:
    """MultiWindowDiscriminator {discs: [{blocks: [{conv, bn}], adv}]}."""
    sd: State = {}
    for i, d in enumerate(p["discs"]):
        pre = f"discriminators.{i}."
        for j, bp in enumerate(d["blocks"]):
            _conv(sd, f"{pre}blocks.{j}.conv", bp["conv"])
            if bp["bn"] is not None:
                _vec(sd, f"{pre}blocks.{j}.bn", bp["bn"])
        _lin(sd, pre + "adv", d["adv"])
    return sd


def _bert_proj(sd: State, p: dict) -> None:
    """The CLAP caption tower: caption_encoder.{base (BERT), projection}."""
    bert, pre = p["bert"], "caption_encoder.base."
    e = bert["embeddings"]
    sd[pre + "embeddings.word_embeddings.weight"] = _t(e["word"])
    sd[pre + "embeddings.position_embeddings.weight"] = _t(e["position"])
    sd[pre + "embeddings.token_type_embeddings.weight"] = _t(e["token_type"])
    _vec(sd, pre + "embeddings.LayerNorm", e["ln"])
    for i, lp in enumerate(bert["layers"]):
        lpre = f"{pre}encoder.layer.{i}."
        _lin(sd, lpre + "attention.self.query", lp["q"])
        _lin(sd, lpre + "attention.self.key", lp["k"])
        _lin(sd, lpre + "attention.self.value", lp["v"])
        _lin(sd, lpre + "attention.output.dense", lp["attn_out"])
        _vec(sd, lpre + "attention.output.LayerNorm", lp["attn_ln"])
        _lin(sd, lpre + "intermediate.dense", lp["ff_in"])
        _lin(sd, lpre + "output.dense", lp["ff_out"])
        _vec(sd, lpre + "output.LayerNorm", lp["ff_ln"])
    pj, pre = p["projection"], "caption_encoder.projection."
    _lin(sd, pre + "linear1", pj["linear1"])
    _lin(sd, pre + "linear2", pj["linear2"])
    _vec(sd, pre + "layer_norm", pj["ln"])


def _t5(sd: State, t5: dict, pre: str) -> None:
    sd[pre + "shared.weight"] = _t(t5["shared"])
    sd[pre + "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        _t(t5["rel_bias"]))
    _vec(sd, pre + "encoder.final_layer_norm", t5["final_ln"])
    for i, lp in enumerate(t5["layers"]):
        lpre = f"{pre}encoder.block.{i}.layer."
        _vec(sd, lpre + "0.layer_norm", lp["attn_ln"])
        for nm in ("q", "k", "v", "o"):
            _lin(sd, f"{lpre}0.SelfAttention.{nm}", lp[nm])
        _vec(sd, lpre + "1.layer_norm", lp["ff_ln"])
        for nm in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{lpre}1.DenseReluDense.{nm}", lp[nm])


def clap_flan_from_jax(p: dict) -> State:
    """FrozenCLAPFLANEmbedder: caption_encoder.* and t5_transformer.*."""
    sd: State = {}
    _bert_proj(sd, p)
    _t5(sd, p["t5"], "t5_transformer.")
    return sd


def flan_from_jax(p: dict) -> State:
    """FrozenFLANEmbedder: its T5 under transformer.* (the tree's t5)."""
    sd: State = {}
    _t5(sd, p["t5"], "transformer.")
    return sd


def clap_from_jax(p: dict) -> State:
    """FrozenCLAPEmbedder: caption_encoder.* (the tree's bert, projection)."""
    sd: State = {}
    _bert_proj(sd, p)
    return sd


def video_feat_from_jax(p: dict) -> State:
    """Video_Feat_Encoder_NoPosembed: embedder.0.*."""
    sd: State = {}
    _lin(sd, "embedder.0", p["embedder"])
    return sd


def clap_fusion_from_jax(p: dict) -> State:
    """The CLIP-visual + CLAP-text fusion layer: fuse.*."""
    sd: State = {}
    _lin(sd, "fuse", p["fuse"])
    return sd


COND_FROM_JAX = {"clap_flan": clap_flan_from_jax, "flan": flan_from_jax,
                 "clap": clap_from_jax, "video_feat": video_feat_from_jax,
                 "video_feat_inpaint": video_feat_from_jax}


def params_from_jax(params: dict, cond_kind: str = "clap_flan") -> Dict[str, State]:
    """{dit, vae, vocoder, cond, clap_fusion} JAX trees -> state dicts for the
    port's DiT (text or video MoE), AutoencoderKL, BigVGAN (AMPBlock1 or 2;
    snake, snake-beta or lrelu), conditioner of `cond_kind` (CLAPFLAN, FLAN,
    CLAP or the video feature encoder; the JAX tree may hold more towers than
    the kind reads) and ClapFusion, whichever are present."""
    conv = {"dit": dit_from_jax, "vae": vae_from_jax,
            "vocoder": bigvgan_from_jax, "cond": COND_FROM_JAX[cond_kind],
            "clap_fusion": clap_fusion_from_jax}
    return {k: conv[k](v) for k, v in params.items() if k in conv}


# ---------------------------------------------------------------------------
# Eval towers
# ---------------------------------------------------------------------------

def _bn(sd: State, name: str, p: dict) -> None:
    """BatchNorm {weight, bias, mean?, var?} -> weight, bias, running_*."""
    _vec(sd, name, p)
    for k, tk in (("mean", "running_mean"), ("var", "running_var")):
        if k in p:
            sd[f"{name}.{tk}"] = _t(p[k])


def cnn14_from_jax(p: dict, prefix: str = "") -> State:
    """Cnn14 {bn0, blocks, fc1, fc_audioset} -> PANNs keys."""
    sd: State = {}
    _bn(sd, prefix + "bn0", p["bn0"])
    for i, b in enumerate(p["blocks"], 1):
        pre = f"{prefix}conv_block{i}."
        _conv(sd, pre + "conv1", b["conv1"])
        _conv(sd, pre + "conv2", b["conv2"])
        _bn(sd, pre + "bn1", b["bn1"])
        _bn(sd, pre + "bn2", b["bn2"])
    _lin(sd, prefix + "fc1", p["fc1"])
    _lin(sd, prefix + "fc_audioset", p["fc_audioset"])
    return sd


def clap_scorer_from_jax(p: dict) -> State:
    """CLAPScorer.params {audio, audio_proj, text, text_proj} -> the
    CLAP_weights_2022.pth keys of CLAPModel."""
    sd = cnn14_from_jax(p["audio"], "audio_encoder.base.")
    pj = p["audio_proj"]
    _lin(sd, "audio_encoder.projection.linear1", pj["linear1"])
    _lin(sd, "audio_encoder.projection.linear2", pj["linear2"])
    _vec(sd, "audio_encoder.projection.layer_norm", pj["ln"])
    _bert_proj(sd, {"bert": p["text"], "projection": p["text_proj"]})
    return sd


def melclf_from_jax(p: dict, conv_layers) -> State:
    """VGGishish {features, fc1, fc2, fc3} -> features.{i} (conv, then its
    BN when present, then ReLU; one index per max-pool), classifier.{0,2,4}."""
    sd: State = {}
    idx, layers = 0, iter(p["features"])
    for v in conv_layers:
        if v == "MP":
            idx += 1
            continue
        layer = next(layers)
        _conv(sd, f"features.{idx}", layer)
        idx += 2
        if "bn" in layer:
            _bn(sd, f"features.{idx - 1}", layer["bn"])
            idx += 1
    for i, nm in ((0, "fc1"), (2, "fc2"), (4, "fc3")):
        _lin(sd, f"classifier.{i}", p[nm])
    return sd


def melception_from_jax(p: dict) -> State:
    """Melception's torchvision-named tree -> its keys: a {conv, bn} node is
    a BasicConv2d (<path>.conv.weight, <path>.bn.*), an {w, b} node a
    Linear (fc, AuxLogits.fc)."""
    sd: State = {}

    def walk(node: dict, path: str) -> None:
        if "conv" in node and "bn" in node:
            sd[path + "conv.weight"] = _t(node["conv"]["w"])
            _bn(sd, path + "bn", node["bn"])
        elif "w" in node:
            _lin(sd, path[:-1], node)
        else:
            for k, v in node.items():
                walk(v, f"{path}{k}.")

    walk(p, "")
    return sd


def lpaps_from_jax(p: dict, conv_layers) -> State:
    """LPAPS {scaling, features, lins} -> scaling_layer.{shift, scale}
    (1, 1, F, 1), net.slice{s}.{i} and lin{k}.model.1.weight (1, C, 1, 1)."""
    from maa3_tpu_torch.eval.lpaps import SLICE_BOUNDS
    sd: State = {}
    for k in ("shift", "scale"):
        sd[f"scaling_layer.{k}"] = _t(np.asarray(p["scaling"][k]).reshape(1, 1, -1, 1))
    idx, layers = 0, iter(p["features"])
    for v in conv_layers:
        if v == "MP":
            idx += 1
            continue
        s = next(i for i, (lo, hi) in enumerate(SLICE_BOUNDS, 1) if lo <= idx < hi)
        _conv(sd, f"net.slice{s}.{idx}", next(layers))
        idx += 2
    for k, w in enumerate(p["lins"]):
        sd[f"lin{k}.model.1.weight"] = _t(np.asarray(w).reshape(1, -1, 1, 1))
    return sd


# ---------------------------------------------------------------------------
# Checkpoints of the JAX package (Orbax directories restored to numpy trees
# by orbax_to_torch.py) -> the port's own checkpoint files
# ---------------------------------------------------------------------------

def unfuse_dit_np(p: dict, n_heads: int, n_kv_heads=None) -> dict:
    """A JAX DiT tree in the fused training layout (wqkv, w13) in the
    canonical names (maa3_tpu/utils/nprand.py:73, on numpy arrays)."""
    blocks = dict(p["blocks"])
    att = dict(blocks["attention"])
    if "wqkv" in att:
        w = np.asarray(att.pop("wqkv")["w"])
        n_kv = n_heads if n_kv_heads is None else n_kv_heads
        hd = w.shape[-2] // n_heads
        wq, wk, wv = np.split(w, [n_heads * hd, (n_heads + n_kv) * hd], axis=-1)
        att.update(wq={"w": wq}, wk={"w": wk}, wv={"w": wv})
    ffn = dict(blocks["feed_forward"])
    if "w13" in ffn:
        w1, w3 = np.split(np.asarray(ffn.pop("w13")["w"]), 2, axis=-1)
        ffn.update(w1={"w": w1}, w3={"w": w3})
    blocks.update(attention=att, feed_forward=ffn)
    return dict(p, blocks=blocks)


def trainer_checkpoint_from_jax(tree: dict, dit: torch.nn.Module,
                                cond: Optional[torch.nn.Module], cond_kind: str,
                                fuse_gemms: bool, accum_steps: int,
                                mu_dtype: torch.dtype) -> dict:
    """The payload the port's Trainer.save_checkpoint writes
    (train/loop.py), from a JAX Trainer checkpoint restored to numpy:
    tree = {params: {dit, cond?}, ema_params?, frozen?: {vae}, step,
    scale_factor, opt: {count, mu, nu, mini_step?, acc?}} (the moment trees
    with the params' structure; fused when fuse_gemms). `dit` and `cond`
    are the port's modules of the same configs (on any device, "meta"
    will do): their parameter order orders the EMA shadows (canonical) and
    the optimizer's lists (the training layout: fused when fuse_gemms, as
    the port's writer keeps them)."""
    from maa3_tpu_torch.models.dit import fuse_dit_gemms, fuse_dit_state
    cfg = dit.cfg
    train = {"dit": dit} | ({"cond": cond} if cond is not None else {})
    if set(tree["params"]) != set(train):
        raise ValueError(f"the checkpoint trains {sorted(tree['params'])}, the configs "
                         f"{sorted(train)} (cond_stage_trainable differs)")
    order = {k: [n for n, _ in m.named_parameters()] for k, m in train.items()}
    fused_order = ([n for n, _ in fuse_dit_gemms(dit).named_parameters()]
                   if fuse_gemms else order["dit"])

    def states(t: dict) -> Dict[str, State]:
        """{dit, cond?} JAX trees -> canonical port state dicts."""
        d = unfuse_dit_np(t["dit"], cfg.num_heads, cfg.n_kv_heads) if fuse_gemms else t["dit"]
        out = {"dit": dit_from_jax(d)}
        if "cond" in t:
            full = COND_FROM_JAX[cond_kind](t["cond"])
            out["cond"] = {n: full[n] for n in cond.state_dict()}
        return out

    def canonical_list(t: dict) -> List[torch.Tensor]:
        sd = states(t)
        return [sd[k][n] for k in train for n in order[k]]

    def training_list(t: dict, dtype=torch.float32) -> List[torch.Tensor]:
        sd = states(t)
        d = fuse_dit_state(sd["dit"], cfg.depth) if fuse_gemms else sd["dit"]
        out = [d[n] for n in fused_order] + [sd["cond"][n] for n in order.get("cond", ())]
        return [x.to(dtype) for x in out]

    opt = tree["opt"]
    opt_state = {"count": int(opt["count"]), "mini_step": int(opt.get("mini_step", 0)),
                 "mu": training_list(opt["mu"], mu_dtype), "nu": training_list(opt["nu"]),
                 "kind": "adamw", "mu_dtype": str(mu_dtype).replace("torch.", ""),
                 "accum_steps": accum_steps,
                 "n_params": len(fused_order) + len(order.get("cond", ()))}
    if accum_steps > 1:
        opt_state["acc"] = training_list(opt["acc"])
    payload = {"params": states(tree["params"]), "opt_state": opt_state,
               "fuse_gemms": fuse_gemms, "step": int(tree["step"]),
               "scale_factor": float(tree["scale_factor"])}
    if "frozen" in tree:
        payload["frozen"] = {"vae": vae_from_jax(tree["frozen"]["vae"])}
    if "ema_params" in tree:
        payload["ema_params"] = canonical_list(tree["ema_params"])
    return payload


def vae_gan_checkpoint_from_jax(tree: dict) -> dict:
    """scripts/train_vae.py's {vae, disc, logvar} -> the port's train_vae
    file (train/vae_gan.py vae_gan_checkpoint)."""
    return {"vae": vae_from_jax(tree["vae"]), "disc": nlayer_disc_from_jax(tree["disc"]),
            "logvar": _t(tree["logvar"])}


def vocoder_checkpoint_from_jax(tree: dict) -> dict:
    """scripts/train_vocoder.py's {generator} -> the port's {generator}."""
    return {"generator": bigvgan_from_jax(tree["generator"])}


def melclf_checkpoint_from_jax(params: dict, backbone: str, conv_layers=None,
                               classes=None) -> dict:
    """scripts/train_melclf.py's {params} -> the port's train_melclf file
    (eval/classifier.py checkpoint): the VGGishish of `conv_layers` or the
    Melception, its class count read from the head."""
    if backbone == "melception":
        sd = melception_from_jax(params)
        conv = None
    else:
        sd = melclf_from_jax(params, conv_layers)
        conv = list(conv_layers)
    head = "fc.weight" if backbone == "melception" else "classifier.4.weight"
    return {"model": sd, "backbone": backbone, "conv_layers": conv,
            "num_classes": int(sd[head].shape[0]), "classes": classes}
