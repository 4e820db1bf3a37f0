"""The yardstick's arithmetic, frozen with the benchmark: the H100's
published peaks, the operations and bytes of the port's kernels (K1, K2,
K3a, K4a) at the shapes they run, and the model FLOPs a request or a
training step needs, all counted from shapes.

The kernel counts are those of chip_smoke.py's phases 3 and 6 (kept there
for its own logs): a later change to that file does not move these."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense: DRAM bytes/s, fp32 FLOP/s outside the
# tensor cores, bf16 tensor-core FLOP/s
PEAK_BW, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# fp32 operations per output sample of the anti-aliased snake as the
# kernels run it: two 6-tap FIRs (24), two snakes of 24 (a v, sin^2 by the
# polynomial: 21, v + s^2 / b as an FMA), one 12-tap FIR (24)
ACT_OPS = 96
AMP_SITES = 18  # AMPBlock1: 3 resblocks x 3 dilations x 2 activations a stage
K2_MAX_CH = 48  # stages at or below this width run K2 (act -> conv fused)


def vocoder_stages(mel_len: int, rates: Sequence[int], c0: int) -> List[Tuple[int, int]]:
    """(channels, samples) of each upsampling stage of BigVGAN."""
    out, t = [], mel_len
    for i, u in enumerate(rates):
        t *= u
        out.append((c0 // 2 ** (i + 1), t))
    return out


def k1_bound_s(b: int, c: int, t: int, item: int) -> float:
    """K1 (anti-aliased snake over (b, c, t)): max(bytes / BW, ops / fp32
    peak); the input read and the output written once, alpha and beta."""
    n = b * c * t
    return max((2 * n * item + 8 * c) / PEAK_BW, n * ACT_OPS / PEAK_FP32)


def k2_bound_s(b: int, c: int, t: int, c_out: int, k: int, item: int) -> float:
    """K2 (snake then a k-tap conv to c_out channels): the activation on the
    fp32 units, the conv on the bf16 tensor cores (fp32 units in fp32)."""
    n = b * t
    nbytes = n * (c + c_out) * item + 4 * (c_out * c * k + c_out + 2 * c)
    conv_peak = PEAK_BF16 if item == 2 else PEAK_FP32
    return max(nbytes / PEAK_BW, n * c * ACT_OPS / PEAK_FP32 + 2 * n * c_out * c * k / conv_peak)


def vocode_bounds(b: int, mel_len: int, voc: dict, item: int) -> Dict[str, float]:
    """The K1 and K2 bound seconds of one vocode of b rows (AMPBlock1): each
    K1 stage 18 launches; each K2 stage, per resblock kernel k, (k, 1) four
    times and (k, 3), (k, 5) once; conv_post once at the last width."""
    k1 = k2 = 0.0
    stages = vocoder_stages(mel_len, voc["upsample_rates"], voc["upsample_initial_channel"])
    for c, t in stages:
        if c > K2_MAX_CH:
            k1 += AMP_SITES * k1_bound_s(b, c, t, item)
            continue
        for k in voc["resblock_kernel_sizes"]:
            for d in voc["resblock_dilation_sizes"][0]:
                k2 += (4 if d == 1 else 1) * k2_bound_s(b, c, t, c, k, item)
    c, t = stages[-1]
    k2 += k2_bound_s(b, c, t, 1, 7, item)
    return {"k1": k1, "k2": k2}


def flash_bounds_s(b: int, h: int, n: int, d: int, item: int = 2) -> Dict[str, float]:
    """K3a (forward) and K4a (fused backward) over (b, h, n, d), unmasked:
    4 and 10 x pairs x d operations on the bf16 tensor cores; q, k, v, o (and
    do, dq, dk, dv) once, the fp32 row statistics."""
    pairs, nq = h * n * n * b, b * h * n * d
    return {"k3a": max((4 * nq * item + 4 * b * h * n) / PEAK_BW, 4 * pairs * d / PEAK_BF16),
            "k4a": max((7 * nq * item + 8 * b * h * n) / PEAK_BW, 10 * pairs * d / PEAK_BF16)}


# -- model FLOPs (a multiply-add counts two) ----------------------------------

def ffn_hidden(d: int, multiple_of: int = 256) -> int:
    h = int(2 * (4 * d) / 3)
    return multiple_of * ((h + multiple_of - 1) // multiple_of)


def dit_forward_flops(dit: dict, rows: int, n: int, ly: int = 154) -> float:
    """One DiT forward over rows x n latent tokens and an ly-token context."""
    d, c, ctx = dit["hidden_size"], dit["in_channels"], dit["context_dim"]
    f = ffn_hidden(d, dit.get("multiple_of", 256))
    per_block = (2 * n * d * 4 * d          # q, k, v, o
                 + 4 * n * n * d            # self-attention logits and values
                 + 2 * ly * ctx * 2 * d     # the context's keys and values
                 + 4 * n * ly * d           # cross-attention
                 + 2 * n * d * f * 3        # SwiGLU
                 + 2 * d * 6 * d)           # adaLN
    embed = 2 * n * c * d * 2 + 2 * ctx * d + 2 * 256 * d + 2 * d * d  # in, out, caption, time
    return rows * (dit["depth"] * per_block + embed + 2 * d * 2 * d)


def bert_flops(cfg: dict, rows: int, n: int = 77) -> float:
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    return rows * cfg["num_layers"] * (2 * n * d * 4 * d + 4 * n * n * d + 2 * n * d * f * 2)


def t5_flops(cfg: dict, rows: int, n: int = 77) -> float:
    d, inner, f = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    return rows * cfg["num_layers"] * (2 * n * d * inner * 4 + 4 * n * n * inner
                                       + 2 * n * d * f * 3)


def conditioner_flops(cond: dict, rows: int) -> float:
    d_in, p = cond["bert"]["hidden_size"], cond["d_proj"]
    return (bert_flops(cond["bert"], rows) + t5_flops(cond["t5"], rows)
            + rows * 77 * 2 * (d_in * p + p * p))


def _conv_flops(t: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * t * cin * cout * k


def vae_flops(vae: dict, mel_len: int, rows: int, decode: bool) -> float:
    """The encoder (mel_len frames in) or the decoder (mel_len frames out)."""
    ch, mult, nres, k = vae["ch"], vae["ch_mult"], vae["num_res_blocks"], vae["kernel_size"]
    total = 0.0
    if decode:
        t = mel_len // 2 ** len(vae["down_layers"])
        cin = ch * mult[-1]
        total += _conv_flops(t, vae["embed_dim"], vae["z_channels"], 1)
        total += _conv_flops(t, vae["z_channels"], cin, k)
        total += (2 * 2 * _conv_flops(t, cin, cin, 3) + 4 * _conv_flops(t, cin, cin, 1)
                  + 4 * t * t * cin)  # mid: two resnet blocks and the attention
        up = {d + 1 for d in vae["down_layers"]}
        for lvl in reversed(range(len(mult))):
            cout = ch * mult[lvl]
            for _ in range(nres + 1):
                total += _conv_flops(t, cin, cout, 3) + _conv_flops(t, cout, cout, 3)
                if cin != cout:
                    total += _conv_flops(t, cin, cout, 1)
                cin = cout
            if lvl in up:
                t *= 2
                total += _conv_flops(t, cin, cin, 3)
        return rows * (total + _conv_flops(t, cin, vae["out_ch"], k))
    t, cin = mel_len, ch
    total += _conv_flops(t, vae["in_channels"], ch, k)
    for lvl, m in enumerate(mult):
        cout = ch * m
        for _ in range(nres):
            total += _conv_flops(t, cin, cout, k) + _conv_flops(t, cout, cout, k)
            if cin != cout:
                total += _conv_flops(t, cin, cout, 1)
            cin = cout
        if lvl in vae["down_layers"]:
            t //= 2
            total += _conv_flops(t, cin, cin, 3)
    total += (2 * 2 * _conv_flops(t, cin, cin, k) + 4 * _conv_flops(t, cin, cin, 1)
              + 4 * t * t * cin)
    zc = 2 * vae["z_channels"]
    return rows * (total + _conv_flops(t, cin, zc, k) + _conv_flops(t, zc, 2 * vae["embed_dim"], 1))


def vocoder_flops(voc: dict, mel_len: int, rows: int) -> float:
    """BigVGAN's convolutions (AMPBlock1) and transposed convolutions."""
    c0 = voc["upsample_initial_channel"]
    total = _conv_flops(mel_len, voc["num_mels"], c0, 7)
    cin, t = c0, mel_len
    for (c, t_out), k in zip(vocoder_stages(mel_len, voc["upsample_rates"], c0),
                             voc["upsample_kernel_sizes"]):
        total += 2.0 * t * cin * c * k
        for rk in voc["resblock_kernel_sizes"]:
            total += len(voc["resblock_dilation_sizes"][0]) * 2 * _conv_flops(t_out, c, c, rk)
        cin, t = c, t_out
    return rows * (total + _conv_flops(t, cin, 1, 7))


def request_flops(cfg: dict, n: int, steps: int) -> float:
    """One served request of latent length n: the caption's encode, the CFG
    ODE (two DiT rows a step), the VAE decode and the vocode."""
    m = cfg["model"]
    mel = n * 2 ** len(m["vae"]["down_layers"])
    return (conditioner_flops(cfg["conditioner"], 1)
            + (steps - 1) * dit_forward_flops(m["dit"], 2, n)
            + vae_flops(m["vae"], mel, 1, decode=True)
            + vocoder_flops(cfg["vocoder"], mel, 1))


def train_step_flops(cfg: dict, rows: int, mel_len: int) -> float:
    """One training step: the frozen VAE encode, then forward and backward
    (three forwards' worth) of the trainable conditioner and the DiT."""
    m = cfg["model"]
    n = mel_len // 2 ** len(m["vae"]["down_layers"])
    return (vae_flops(m["vae"], mel_len, rows, decode=False)
            + 3 * conditioner_flops(cfg["conditioner"], rows)
            + 3 * dit_forward_flops(m["dit"], rows, n))


def vocode_launches(voc: dict) -> Dict[str, int]:
    """K1 and K2 launches of one vocode (AMPBlock1), as vocode_bounds counts
    them."""
    stages = vocoder_stages(1, voc["upsample_rates"], voc["upsample_initial_channel"])
    wide = sum(c > K2_MAX_CH for c, _ in stages)
    per_k2 = len(voc["resblock_kernel_sizes"]) * sum(
        4 if d == 1 else 1 for d in voc["resblock_dilation_sizes"][0])
    return {"k1": AMP_SITES * wide, "k2": per_k2 * (len(stages) - wide) + 1}
