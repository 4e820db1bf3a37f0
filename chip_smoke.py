#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (maa3_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile | --xxl-batch-probe | --attn-crossover]

Phases, each timed on a line of its own:
  1. environment: card name and power limit (nvidia-smi), torch, nvcc;
  2. build: nvcc compiles maa3_tpu_torch/csrc into build/ (ctypes-loaded),
     with each kernel's registers and spills (every function of K1 must
     spill nothing: its runs live in registers); cuobjdump's SASS of the
     library must show tensor-core instructions (HMMA/HGMMA) in every bf16
     flash forward kernel (flash_fwd_tc_*), every bf16 flash backward kernel
     (flash_bwd_tc_*: K4a, K4b, K4c) and every bf16 K2 kernel
     (conv_snake_tc_*), and none in any fp32 kernel (no TF32); K1's
     instruction mix is logged from the same SASS;
  3. kernels: K1 (AA-snake) and K2 (AA-snake -> conv) against their plain
     PyTorch versions at every shape the XL batch-4 vocode gives them, in
     fp32 and bf16, at every shape phase 11's served batch-8 music vocode
     gives them, in bf16, and at every shape phase 13's vocoder-GAN disc
     step gives them (batch 8 x 8192 samples), in fp32, with error, kernel
     time, plain time, bound and share of
     the bound (the bound's operations counted both as the kernels execute
     the snake and with sin as one operation, the older count; K2 also with
     its conv's TFLOP/s and the time of one call alone between two events,
     the older method of PERF.md's records);
  4. reference: a small system on the card against the same weights on the
     CPU (plain versions), fp32;
  5. main path: the XL system (random weights from a seed, zero-init gates
     made nonzero) turns 4 prompts into 10 s of 16 kHz audio each: CLAP+FLAN
     conditioning -> planned 25-step CFG ODE (bf16, fp32 residual) -> fp32
     VAE decode -> bf16 BigVGAN, with the kernel launch counts of the run
     (K3a 2 x 28 x 24: self- and cross-attention, each block, each step)
     (--profile adds one run under torch.profiler: device busy share and
     the kernels that take the most device time);
  6. flash kernels: K3a / K3b (forward), K4a (fused backward) and K4b / K4c
     (split backward) against their plain PyTorch versions in fp32 and bf16
     at the XL training shape, the K3b route, the serving length, an odd
     masked length with a fully masked batch row, and a forced block_k, with
     kernel, plain, bound and library (scaled_dot_product_attention, timed
     as a yardstick only) times, and each kernel's achieved TFLOP/s and
     share of its bound; the split's dk / dv against K4a's, and K3a's / K3b's
     o and lse, K4b's dk and dv and K4c's dq the same bits over two launches;
     then the long-Lq timing at (1, 16, 14336, 72) bf16: the K3b forward
     against SDPA's forward, K4a against K4b + K4c against SDPA's backward,
     all held to the plain versions two heads at a time; then the serving
     DiT's attention on the card's route (bf16, latent 312): K3a against
     its plain version at XL's closed-loop shape (32 dual rows x 16 heads of
     72) and XXL's (8 dual rows x 32 heads of 48), self and the 154-token
     context, and at phase 5's shape (8 dual rows, XL) the card's time
     (torch.profiler) of K3a, self and cross, of the layout copies the
     planned step makes for it, and of the dense `_sdpa` it replaces.
     --attn-crossover instead times K3a against `_sdpa` as the planned step
     calls each at 2-32 dual rows over latent lengths 39-624, self and
     cross, alone (no result line): whether flash still wins at every
     length, as models/dit.py card_attention_route assumes;
  7. small training on the card against the CPU: two fp32 steps of a small
     DiT with flash attention forced on, same weights and draws; then two
     Trainer steps that also train a small conditioner with
     MAA3_FLASH_BWD=split, and a checkpoint saved after step 1 and restored
     into a fresh Trainer, whose step 2 must equal the uninterrupted one's;
  8. the XL training path through Trainer.fit: full width and depth, batch
     6 x latent 1248, captions through the frozen conditioner, bf16 compute,
     one warm step and three timed steps, with K3a / K4a counted per step
     (--profile adds one step under torch.profiler), and the frozen VAE
     encode of the batch once with cuDNN's TF32 and once in fp32: max |dz|
     and the loss each gives;
  9. the K3b route: XL width at depth 4, batch 2 x latent 2048, remat on;
 10. the XL training path as the YAML configures it: the trainable CLAP+FLAN
     conditioner, batch 6 x latent 1248, bf16, first with MAA3_FLASH_BWD
     unset (auto: K3a 28, K4a 28 per step), then with `split` (K3a 28, K4b
     28, K4c 28), each with one warm step and three timed steps (--profile
     adds one step of each under torch.profiler); the conditioner's
     parameters must move;
 11. serving from checkpoint files: the text-to-music model of
     configs/txt2music-cfm-cfg.yaml at full width (DiT 768 x 16, FLAN-T5-large,
     VAE, BigVGAN 1536; random weights from a seed) written as a Lightning
     `.ckpt` (a full `model_ema.` section that differs from the live weights,
     HF's tied T5 embedding, a scale_factor) and a vocoder directory
     (config.json, generator.pt, weight norm in both namings); loaded with
     MAA3System.from_config (EMA chosen, every tensor as written, vocoder
     folded within 1e-6, the file's scale_factor) and served by AudioServer
     on 127.0.0.1: 8 concurrent requests and 2 of another group, then the 8
     twice more (each round one launch of 8, the same bytes both times; each
     launch's rows logged in arrival order and in the order the batcher
     runs them, by captions and seed: cuDNN's bf16 vocoder convolutions
     round a row by its place in the batch),
     every response a 16 kHz wav of 131,072 samples, no error, K1 72 / K2 37
     launches per batch vocode, K3a 2 x 16 x 24 per 25-step batch over
     rounds 2-3 and the request alone, no thread left after shutdown; p50
     latency and audio seconds per second at batch 8; then the XL ODE at
     batch 8 and 16 with MAA3_ODE_CHUNK 0 and 8 (K3a 2 x 28 x 24 per
     sub-batch ODE); then an AMPBlock2 and an lrelu vocoder
     at BigVGAN 1536 width on the card against the CPU (fp32, 1e-3; AMP2
     reaches K1 and K2, lrelu neither). --profile leaves it unprofiled.
 12. the remaining trainer options at XL width (random weights from the
     seed), fed by 64 log-mels of 80 x 2496 written from the seed under
     build/: (a) the remat sweep, frozen conditioner, batch 6 x latent 1248,
     without remat and under each of the five policies from the same
     weights: the first step's loss the same bits, its grad norm within
     1e-2, K3a / K4a 28 / 28 per step without remat and 56 / 28 under each
     policy, peaks ordered nothing <= save_gemms_lite <= save_gemms_h1 <=
     save_gemms <= no remat, step ms and peak per setting; (b) the recipe as
     the YAML writes it through the training CLI's pieces: the trainable
     conditioner, global batch 16 as 2 micro-batches of 8 (accum_steps 2),
     save_gemms_lite, a bf16 first moment, the fused GEMMs, the lazy native
     loader behind 2 PrefetchLoader threads, validation every 2 micro-steps
     over 2 batches, the audio logger at update 2 on 4 captions (25 steps):
     parameters unchanged by the first micro-step of each update and moved
     by the second, K3a 56 / K4a 28 per micro-step, finite validation
     losses, 4 16 kHz wavs, K1 72 / K2 37 in the logger's vocode and K3a
     2 x 28 x 24 in its ODE, no thread
     left once the loader is closed; ms per update, tokens per second, peak,
     the host's wait on the loader; (c) cached latents: encode_latents over
     the manifest with the XL VAE, then the frozen-conditioner 6 x 1248 step
     from the moments and from the mels, the same weights and draws: first
     losses within 1e-4, each path's step ms.
 13. GAN training of the first stage and the vocoder, and the mel frontend,
     at the JAX CLIs' defaults: (a) two VAE-GAN iterations (disc_start 0,
     r1_weight 0.1) and two vocoder-GAN iterations of small configs on the
     card against the CPU, fp32 under full_fp32(), each step from the same
     state: every loss, and every parameter after it within phase 7's rule
     (elements whose update direction is rounding noise allowed 2 lr); (b)
     VAE-GAN at train_vae's defaults (VAE ch 384, batch 8 x 624, PatchGAN
     ndf 64 x 3, disc_start 0) over phase 12's mels for 20
     iterations: ms per ae and disc step, peak, finite losses, the
     checkpoint written, then the CLI for 2 iterations; (c) vocoder GAN at
     train_vocoder's defaults (BigVGAN 1536, batch 8 x 32 frames, MPD + MRD)
     over int16 wavs written from the seed under build/ for 20 iterations:
     ms per gen and disc step, peak, K1 / K2 72 / 37 per disc step and 0 / 0
     per gen step, the disc step's fake wav through the kernels against the
     plain route (1e-3), then the CLI for 2 iterations; (d) mel_spec over 16
     clips of 10 s (some at 22.05 kHz, some stereo): clips per second and one
     clip against the CPU; (e) the hand-off: one step of the training CLI
     with --vae_ckpt of (b)'s file, whose frozen VAE must equal the file's.
     Every time is logged beside the card's name and power limit.
 14. int8 serving and video-to-audio with the MoE DiT: (a) fp32, the card
     against the CPU: dense_w8a8 (torch._int_mm; 4 rows padded, the grouped
     loop) and both w8a8 convs with the same int8 codes and outputs within
     1e-3 x max(1, |cpu|); small text systems in int8 and int8:g32,voc and a
     small video MoE system in fp32 and in int8, card vs CPU (codes,
     latent, wav); one MoE training step with flash forced (K3a 2, K4a 2)
     against the same step with dense attention on the card (loss, grad
     norm, parameters by phase 7's rule); (b) the XL system of phase 5 (4
     prompts x 10 s, 25 steps, guidance 5.0) in bf16 and in int8, int8:g128,
     int8:now2, int8:smooth (after calibrate_smooth) and int8:voc from the
     same weights and noise: end-to-end and ODE ms, the latent's relative L2
     to bf16, _int_mm launches per request, K1 / K2 72 / 37 and K3a
     2 x 28 x 24 in every mode;
     then the ODE alone at batch 16, bf16 and int8 (--profile adds one of
     each under torch.profiler); (c) python -m
     maa3_tpu_torch.video2audio at the video config's full width (MoE DiT
     768 x 16 x 32 heads, 4 + 4 experts; XL VAE; BigVGAN 1536) over 4 feature
     files of 40 x 512 written from the seed under build/, plain and
     --inpaint over GT mels: one 10 s 16 kHz wav per clip, K1 / K2 72 / 37
     per vocode, ms per clip; (d) the MoE trained at full width and depth,
     batch 16 x latent 312 from VideoSpecDataset over clips written from the
     seed, the trainable video encoder, bf16: one warm and three timed
     steps, ms per step, tokens per second, peak memory, finite losses,
     parameters moved.
 15. evaluation: (a) fp32 without TF32, the card against the CPU on the
     same weights (1e-3 x max(1, max|cpu|)): Cnn14 on 2 x 5 s, the CLAP text
     and audio towers and score at full width, the VGGishish on (8, 80,
     624) with running BN statistics and without, the Melception's logits,
     features and aux, LPAPS; (b) the eval flow, every file under
     build/chip_smoke_eval/ (the norm statistics too): phase 5's XL system
     generates 8 clips of 10 s (2 x batch 4; K1 / K2 and K3a counted as
     "eval"),
     their wavs, manifest and VAE mels, reference mels by mel_spec; then
     train_melclf (VGGishish, 20 steps over phase 12's mels with labels,
     --norm, --val_tsv), predict_melclf on its file, cal_fd_score with that
     classifier (--norm_stats; batch statistics, as JAX evaluates its own;
     in a process of its own on the host, --device cpu and 4 BLAS threads,
     so that scipy's sqrtm of the 4096-d product runs beside phases 16-18
     while the card stays this process's; phases 16 and 17 log whether it
     still runs, phase 18 waits for it) and with a random Melception,
     cal_clap_score with random towers, and structurize_captions: ms per
     classifier step, embeddings per second per backbone, ms per
     CLAP-scored clip, the host's FD time, peak memory.
 16. XXL through the parallel entry points (maa3_tpu_torch/parallel): an
     NCCL process group of world size 1 in this process (a FileStore under
     build/) and its 1 x 1 ("data", "model") DeviceMesh: (a) the XXL system
     as configs/txt2audio-cfm-cfg-XXL.yaml writes it (DiT 1536 x 32 x 32
     heads of 48, 1.47 B; random weights from the seed, gates made nonzero)
     serves 4 prompts x 10 s, 25 steps, guidance 5.0, bf16 through
     shard_serving: end-to-end and ODE ms, peak memory, K1 / K2 72 / 37,
     K3a 2 x 32 x 24 ("xxl_serve"); a depth-2 model of XXL width in fp32
     sampled with shard_serving and without it: the same bits; (b) the
     YAML's training (trainable conditioner) through Trainer(n_model=1,
     fsdp=True), a no-op
     FSDP at data width 1, batch XXL_TRAIN at latent 1248 (the flash route),
     bf16: one warm and three timed steps, K3a / K4a 32 / 32 per step at
     (8, 32, 1248, 48) ("xxl_train"; phase 6 holds that shape to its plain
     versions), median step ms, tokens per second, peak; a checkpoint
     through the gathered path loaded back, every parameter equal; (c) two
     spawned gloo ranks on the card: a depth-2 XXL-width TP=2 serving
     sample and a DP=2 + FSDP step against one rank (1e-3 and 1e-4 x
     max(1, |ref|)). --xxl-batch-probe runs phase 6's head-dim-48 check
     and the XXL step at several batches, with and without remat, alone
     (no result line).
 17. GPipe and expert parallelism on two spawned gloo ranks sharing the
     card (the same helper as 16 (c); two processes on one card over gloo,
     so nothing here speaks for NCCL; gloo's point-to-point calls fail on
     CUDA tensors, so the ring shift sends host copies over gloo): (a)
     Trainer(n_pipe=2, n_micro=2) on the
     XL width (1152 x 16 heads of 72) at depth 4, fp32, batch 4 x latent
     1248 (the flash route), context given: the loss and every parameter
     after one step against one rank's step (1e-4 x max(1, |ref|)), two
     blocks stored a stage, K3a / K4a 6 / 6 a stage (3 ticks of 2 blocks;
     "pipe_stage_step_xl_depth4_fp32"); (b) the XL YAML's DiT at full depth
     (14 blocks a stage), bf16, 6 x 1248, n_micro 3: step ms, tokens per
     second, the peak and parameter bytes of each rank, K3a / K4a 56 / 56 a
     stage ("pipe_stage_step_xl"); (c) the video YAML's MoE as written (768
     x 16 x 32 heads, 4 experts, 2 a rank) over ("data", "model", "expert")
     1 x 1 x 2: in fp32 a 10 s window of video2audio's sampler (25 steps)
     through shard_serving against one rank (1e-3) and one training step at
     16 x 312 (the trainable video encoder) against one rank's (1e-4); in
     bf16 three timed 10 s clips (latent, decode, vocode through K1 / K2
     72 / 37, "video2audio_expert_parallel_per_vocode") and three timed
     steps, the expert bytes each rank holds.
 18. AudioLDM (the legacy 2-D UNet, DDIM / PLMS, 2-D VAE and HiFi-GAN) at
     JAX's default configs, fp32 under full_fp32 (no TF32): the defaults'
     80-mel vocoder must be refused (ValueError); with the 64-mel vocoder a
     JAX caller passes too (BigVGAN 1536, lrelu: neither K1 nor K2 launches)
     and the zero-init leaves drawn small, (a) batch 2, CFG 3.0, 4 DDIM
     steps (eta 0) and 4 PLMS steps: latent, mel and wav on the card against
     the CPU (1e-3 x max(1, |ref|)); (b) batch 4, CFG 3.0, 200 DDIM steps
     timed once beside phase 15's FD process (its state logged), then,
     after waiting for that process and checking its FD, alone, and alone
     with n_candidate_gen_per_text 2: ms per step, seconds per clip, peak
     GiB.
Kernel, plain and library times are per call over 10 calls queued back to
back (time_ms). Then the `kernels` JSON line, the card line, and the result
line. Any failure exits non-zero without the result line; without a CUDA
device, or without the rest of the repository beside it, the script exits 2
at once.
"""

import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): DRAM bytes/s, fp32 FLOP/s
# outside the tensor cores, dense bf16 tensor-core FLOP/s.
PEAK_BW, PEAK_FP32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# fp32 operations (an FMA is two) per output sample of the anti-aliased
# snake as the kernels execute it: two 6-tap FIRs (24), two snakes of 24
# each (a v; sin2_poly's 21: a multiply, a round, a subtract, two
# multiplies, seven FMAs, a subtract and a multiply; v + ib s^2 as an FMA),
# one 12-tap FIR (24). fp32's libm sinf is counted as the polynomial (its
# fast path, a three-term reduction and a short polynomial, is of that
# size); the fp32 bound is the bytes either way. ACT_OPS_SIN_AS_ONE is the
# older count, which took sin as one operation; phase 3 logs both.
ACT_OPS, ACT_OPS_SIN_AS_ONE = 96, 56

B, LATENT = 4, 312                       # 4 prompts, 10 s clips
XL_DEPTH = 28                            # configs/txt2audio-cfm-cfg-XL.yaml's DiT
K1_STAGES = [(768, 2496), (384, 9984), (192, 19968), (96, 39936)]
K2_STAGES = [(48, 79872), (24, 159744)]
# phase 11's served music vocode (batch 8, mel 512 -> 131,072 samples): its
# K1 / K2 stage shapes, held against the plain versions in phase 3 (bf16)
MUSIC_B = 8
MUSIC_K1_STAGES = [(768, 2048), (384, 8192), (192, 16384), (96, 32768)]
MUSIC_K2_STAGES = [(48, 65536), (24, 131072)]
KS, DILS = (3, 7, 11), (1, 3, 5)
TOL_FP32, TOL_BF16 = 1e-4, 2.0 ** -6     # times max(1, max|plain|)

# phase 6 shapes (B, H, Lq = Lk, D, masked, block_k): the XL training shape
# (batch 6 x latent 1248, 16 heads of 72), the K3b route by length, the
# serving length, an odd masked length with a fully masked batch row, and a
# forced block_k
# phase 16's XXL training: batch x latent (the flash route from 1248 tokens),
# and its per-step K3a / K4a shape (32 heads of 48)
XXL_TRAIN = (8, 1248)
XXL_FLASH = (XXL_TRAIN[0], 32, XXL_TRAIN[1], 48)
FLASH_SHAPES = [(6, 16, 1248, 72, False, None), (2, 16, 2048, 72, False, None),
                (4, 16, 312, 72, False, None), (3, 4, 1000, 24, True, None),
                (4, 16, 312, 72, False, 64), XXL_FLASH + (False, None)]
# the serving DiT's attention on the card's route, a 154-token context:
# the shapes held to the plain versions (B, H, L, D): XL's closed loop (16
# requests, 32 dual rows, 16 heads of 72) and phase 16's XXL (4 prompts, 8
# dual rows, 32 heads of 48); phase 5's shape, timed; dual rows x latent
# lengths of --attn-crossover
SERVE_EULER_STEPS = 24     # a 25-point grid
SERVE_ATTN_SHAPES = {"xl_closed_loop": (32, 16, 312, 72), "xxl": (8, 32, 312, 48)}
SERVE_STEP_ATTN = (2 * B, 16, LATENT, 72)
CONTEXT_LEN = 154
SERVE_ROWS = (2, 4, 8, 16, 32)
SERVE_LENS = (39, 78, 117, 156, 234, 312, 468, 624)

# long-Lq timing: the first 256-multiple of query rows past the JAX
# package's split point for head dim 72 in bf16 (~13.8k rows, where the fused
# body's fp32 dq block outgrows its 10 MiB VMEM budget)
LONG_LQ = (1, 16, 14336, 72)
XL_TRAIN = (6, 1248)     # phases 8 and 10: batch x latent length
K3B_TRAIN = (2, 2048)    # phase 9
NO_COND = "model.params.cond_stage_trainable=false"
FLASH_KERNELS = ("K3a", "K3b", "K4a", "K4b", "K4c")
# phase 11: the text-to-music model served from checkpoint files
MUSIC_SAMPLES = 131072              # latent 256 -> mel 512 -> 8.19 s at 16 kHz
SERVE_PROMPTS = ["a calm piano melody", "an upbeat drum and bass loop",
                 "a string quartet plays a waltz", "lo-fi hip hop with vinyl crackle",
                 "a solo acoustic guitar ballad", "an epic orchestral crescendo",
                 "a jazz trio in a smoky bar", "synthwave with a driving bassline"]
K1_K2_PER_VOCODE = (72, 37)         # AMPBlock1, BigVGAN 1536: phase 5's counts
K1_K2_PER_AMP2_VOCODE = (24, 13)    # AMPBlock2, dilations (1, 3): one site per dilation


@contextlib.contextmanager
def flash_bwd_mode(mode):
    """MAA3_FLASH_BWD set to `mode` (None: unset) inside, restored after."""
    old = os.environ.pop("MAA3_FLASH_BWD", None)
    if mode is not None:
        os.environ["MAA3_FLASH_BWD"] = mode
    try:
        yield
    finally:
        os.environ.pop("MAA3_FLASH_BWD", None)
        if old is not None:
            os.environ["MAA3_FLASH_BWD"] = old


def require(ok, what: str) -> None:
    """A check of the run (kept under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def kernel_name(mangled: str) -> str:
    """A short name of a mangled kernel symbol, e.g.
    ..._26flash_fwd_tc_direct_kernelILi72ELi8EEEv... -> flash_fwd_tc_direct_kernel<72, 8>."""
    m = re.search(r"\d([a-z][a-z_]*kernel)I((?:f|13__nv_bfloat16|Li\d+E|Lb[01]E)+)E",
                  mangled)
    if not m:
        return mangled[:60]
    args = [{"f": "fp32", "13__nv_bfloat16": "bf16"}.get(a, a.strip("LibE") or "0")
            for a in re.findall(r"f|13__nv_bfloat16|Li\d+E|Lb[01]E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


# tensor-core kernels by name prefix: the instantiations each must have
TC_KERNELS = (("flash_fwd_tc_", "flash forward (K3a, K3b)", 16),
              ("flash_bwd_tc_", "flash backward (K4a, K4b, K4c)", 24),
              ("conv_snake_tc_", "K2", 6))


def ptxas_report(build_log: str) -> dict:
    """{mangled name: {registers, stack, spill_stores, spill_loads}} of every
    function in ptxas's -v report: the entry kernels and the device
    functions they call."""
    funcs, name = {}, None
    for line in build_log.splitlines():
        head = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)",
                         line)
        if head:
            name = head.group(1)
            funcs.setdefault(name, {})
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
        if frame:
            funcs[name].update(stack=int(frame.group(1)), spill_stores=int(frame.group(2)),
                               spill_loads=int(frame.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            funcs[name]["registers"] = int(regs.group(1))
    return funcs


def check_k1_spills(build_log: str) -> None:
    """Every function of K1 (its two kernels and the generic run they call,
    the instantiations over RowTail) spills nothing: its runs live in
    registers."""
    k1 = {n: v for n, v in ptxas_report(build_log).items()
          if re.search(r"aa_snake_kernel|RowTail", n)}
    for n, v in sorted(k1.items()):
        log(f"build: K1 {kernel_name(n)}: {v}")
    require(sum("aa_snake_kernel" in n for n in k1) == 2
            and all(v.get("spill_stores") == 0 and v.get("spill_loads") == 0
                    for v in k1.values()),
            f"ptxas reports no spill in any function of K1: {k1}")


def check_sass(lib_path: str, nvcc: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per kernel in the built
    library's SASS (cuobjdump): every bf16 flash forward kernel
    (flash_fwd_tc_*, 16 instantiations), every bf16 flash backward kernel
    (flash_bwd_tc_*: K4a, K4b and K4c, 24) and every bf16 K2 kernel
    (conv_snake_tc_*, 6) must have some, and no kernel instantiated for fp32
    may have any (that would be TF32). Also logs K1's instruction mix (its
    kernels are issue-bound). Returns {short name: count}."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts, name, k1_ops = {}, None, {}
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = kernel_name(fn.group(1))
            counts[name] = 0
            continue
        op = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if name and name.startswith("aa_snake_kernel") and op:
            k1_ops.setdefault(name, {}).setdefault(op.group(1), 0)
            k1_ops[name][op.group(1)] += 1
        if name and re.search(r"\bH(G)?MMA\b", line):
            counts[name] += 1
    for k, ops in sorted(k1_ops.items()):
        fp32 = sum(ops.get(o, 0) for o in ("FFMA", "FMUL", "FADD"))
        log(f"sass: {k}: {sum(ops.values())} instructions, {fp32} fp32 FFMA / FMUL / FADD, "
            f"{ops.get('FRND', 0)} FRND, {ops.get('LDG', 0)} LDG, {ops.get('STG', 0)} STG")
    fp32 = {k: v for k, v in counts.items() if "<fp32" in k}
    for prefix, what, want in TC_KERNELS:
        tc = {k: v for k, v in counts.items() if k.startswith(prefix)}
        for k in sorted(tc):
            log(f"sass: {k}: {tc[k]} HMMA/HGMMA")
        require(len(tc) == want and all(v > 0 for v in tc.values()),
                f"every bf16 {what} kernel runs on the tensor cores: {tc}")
    log(f"sass: {len(counts)} kernels; fp32 kernels with tensor-core instructions: "
        f"{sorted(k for k, v in fp32.items() if v)}")
    require(fp32 and not any(fp32.values()), f"no fp32 kernel uses TF32: {fp32}")
    return counts


def time_ms(fn, reps: int = 7, launches: int = 10) -> float:
    """Milliseconds per call: CUDA events around `launches` calls queued back
    to back (the card's time per call in a run of many, without the idle gap
    of one call's host work), the median over `reps` such runs."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def time_once_ms(fn, reps: int = 7) -> float:
    """Milliseconds of one call alone between two events (the older method of
    PERF.md's records: it adds the call's host work to the card's time), the
    median over `reps`."""
    return time_ms(fn, reps, launches=1)


def check_kernels(torch, k1, k2, full_fp32):
    """Phase 3: returns per-shape rows, each with its path: "xl" (phase 5's
    batch-4 XL vocode, fp32 and bf16), "music" (phase 11's batch-8 served
    vocode, bf16 as it is served) or "gan" (phase 13's vocoder-GAN disc
    step, batch 8 x 8192 samples, fp32)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for path, nb, k1_stages, k2_stages, dtype in (
            ("xl", B, K1_STAGES, K2_STAGES, torch.float32),
            ("xl", B, K1_STAGES, K2_STAGES, torch.bfloat16),
            ("music", MUSIC_B, MUSIC_K1_STAGES, MUSIC_K2_STAGES, torch.bfloat16),
            ("gan", GAN_B, GAN_K1_STAGES, GAN_K2_STAGES, torch.float32)):
        item = torch.finfo(dtype).bits // 8
        tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
        fast = dtype == torch.bfloat16
        for c, t in k1_stages:
            x = (torch.randn(nb, c, t, generator=g, device=dev) * 2).to(dtype)
            a = torch.randn(c, generator=g, device=dev) * 0.5
            bt = torch.randn(c, generator=g, device=dev) * 0.5

            def kern():
                return k1.aa_snake_fused(x, a, bt, fast_sin2=fast)

            def plain():
                return k1.aa_snake_plain(x, a, bt, fast_sin2=fast)

            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            lim = tol * max(1.0, want.abs().max().item())
            n = nb * c * t
            rows.append(dict(kernel="K1", path=path, dtype=str(dtype)[6:], shape=(nb, c, t),
                             launches=18, err=err, tol=lim, ms=time_ms(kern),
                             plain_ms=time_ms(plain),
                             bytes_ms=(2 * n * item + 8 * c) / PEAK_BW * 1e3,
                             ops_ms=n * ACT_OPS / PEAK_FP32 * 1e3,
                             ops_sin_as_one_ms=n * ACT_OPS_SIN_AS_ONE / PEAK_FP32 * 1e3))
            del x, got, want
        for (c, t), post in [(s, False) for s in k2_stages] + [(k2_stages[-1], True)]:
            combos = [(7, 1, 1)] if post else [(k, d, c) for k in KS for d in DILS]
            x = (torch.randn(nb, c, t, generator=g, device=dev) * 2).to(dtype)
            a = torch.randn(c, generator=g, device=dev) * 0.5
            bt = torch.randn(c, generator=g, device=dev) * 0.5
            for k, d, c_out in combos:
                w = torch.randn(c_out, c, k, generator=g, device=dev) / (c * k) ** 0.5
                bias = torch.randn(c_out, generator=g, device=dev) * 0.1

                def kern():
                    return k2.conv_snake_fused(x, a, bt, w, bias, k=k, dilation=d,
                                               fast_sin2=fast)

                def plain():
                    with full_fp32():
                        return k2.conv_snake_plain(x, a, bt, w, bias, k=k,
                                                   dilation=d, fast_sin2=fast)

                got, want = kern(), plain()
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                lim = tol * max(1.0, want.abs().max().item())
                n = nb * t
                nbytes = n * (c + c_out) * item + 4 * (c_out * c * k + c_out + 2 * c)
                peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
                t_conv = 2 * n * c_out * c * k / peak
                # launches per vocode at this shape: convs1 (k, d)
                # once per resblock; convs2 (k, 1) three times; post once
                launches = 1 if post else (4 if d == 1 else 1)
                rows.append(dict(kernel="K2", path=path, dtype=str(dtype)[6:],
                                 shape=(nb, c, t, c_out, k, d), launches=launches,
                                 err=err, tol=lim, ms=time_ms(kern),
                                 once_ms=time_once_ms(kern),
                                 plain_ms=time_ms(plain),
                                 bytes_ms=nbytes / PEAK_BW * 1e3,
                                 ops_ms=(n * c * ACT_OPS / PEAK_FP32 + t_conv) * 1e3,
                                 ops_sin_as_one_ms=(n * c * ACT_OPS_SIN_AS_ONE / PEAK_FP32
                                                    + t_conv) * 1e3,
                                 conv_flops=2 * n * c_out * c * k))
                del got, want
            del x
    for r in rows:
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        # the share of the bound; K2: the conv's operations per second and
        # one call alone
        rate = (f"{r['conv_flops'] / r['ms'] / 1e9:.1f} TFLOP/s conv, "
                if r["kernel"] == "K2" else "")
        once = f"; one call alone {r['once_ms']:.4f} ms" if r["kernel"] == "K2" else ""
        log(f"{r['kernel']} {r['path']:5s} {r['dtype']:8s} {str(r['shape']):34s} err {r['err']:.3e} "
            f"(tol {r['tol']:.3e}) kernel {r['ms']:.4f} ms ({rate}"
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound{once}) plain "
            f"{r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms (bytes "
            f"{r['bytes_ms']:.4f}, operations {r['ops_ms']:.4f}; with sin as one "
            f"operation {r['ops_sin_as_one_ms']:.4f})")
    bad = [r for r in rows if not r["err"] <= r["tol"]]
    require(not bad, f"kernels agree with their plain versions: {bad}")
    return rows


def check_small_reference(torch, system_mod, config_path):
    """Phase 4: a small system on the card vs the same weights on the CPU."""
    import copy
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.ops import pallas_aa_snake as k1, pallas_amp as k2
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=64", up + "depth=2", up + "num_heads=4",
            up + "context_dim=32", up + "multiple_of=32", dd + "ch=32",
            dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1"]
    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=32, num_layers=2, num_heads=4,
                                          intermediate_size=64),
                          t5=T5Config(d_model=32, d_kv=8, d_ff=48, num_layers=2,
                                      num_heads=4), d_proj=32)
    voc = BigVGANConfig(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
                        upsample_initial_channel=256)
    sys_g = system_mod.MAA3System.from_config(
        [config_path], over, seed=1, compute_dtype=torch.float32, device="cuda",
        clap_cfg=clap, voc_cfg=voc, unfreeze=True)
    sys_c = system_mod.MAA3System(
        sys_g.spec, *(copy.deepcopy(m).cpu() for m in
                      (sys_g.dit, sys_g.vae, sys_g.vocoder, sys_g.cond)),
        compute_dtype=torch.float32)
    prompts = {"ori_caption": ["a dog barks", "rain on a tin roof"],
               "struct_caption": ["<dog barks& all>", "<rain& all>"]}
    empty = {"ori_caption": [""] * 2, "struct_caption": [""] * 2}
    x0 = torch.randn(2, 20, 24, generator=torch.Generator().manual_seed(2))
    k1.launches = k2.launches = 0
    outs = []
    for s in (sys_c, sys_g):
        c, uc = s.get_learned_conditioning(prompts), s.get_learned_conditioning(empty)
        z = s.sample_cfg(c, 5.0, uc, x0=x0.to(s.device), timesteps=6)
        mel = s.decode_first_stage(z)
        outs.append((c.cpu(), z.cpu(), mel.cpu(), s.vocode(mel)))
    n1, n2 = k1.launches, k2.launches
    require(n1 > 0 and n2 > 0, "the small system reaches both kernels")
    for name, a, b in zip(("context", "latent", "mel"), outs[0][:3], outs[1][:3]):
        err = (a - b).abs().max().item()
        log(f"reference {name} {tuple(a.shape)} max|cuda - cpu| {err:.3e}")
        require(err <= 1e-3 * max(1.0, a.abs().max().item()), f"reference {name}")
    import numpy as np
    err = float(np.abs(outs[0][3] - outs[1][3]).max())
    log(f"reference wav {outs[0][3].shape} max|cuda - cpu| {err:.3e}")
    require(err <= 1e-3 and np.isfinite(outs[1][3]).all(), "reference wav")


def profile_run(torch, run, ref_ms) -> None:
    """One more run of a path (run(False)) under torch.profiler: device busy
    time and the kernels that take the most of it. The profiler inflates the
    host's wall clock, so the busy share is also given against ref_ms, the
    wall clock of the unprofiled run just before it (the same work)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s = time.perf_counter()
        run(False)
        wall = time.perf_counter() - s
    evts = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    # device-side ranges of user annotations (AdamW.step) overlap their kernels
    notes = [e for e in evts if getattr(e, "is_user_annotation", False)]
    evts = [e for e in evts if e not in notes]
    busy = sum(e.self_device_time_total for e in evts) / 1e3  # us -> ms
    for e in notes:
        log(f"profile: annotation range {e.key[:60]} {e.self_device_time_total / 1e3:.2f} "
            "ms (not counted as busy)")
    log(f"profile: wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f} % of the profiled wall), "
        f"{sum(e.count for e in evts)} kernels; against the unprofiled run before "
        f"it ({ref_ms:.1f} ms) {100 * busy / ref_ms:.1f} %")
    for e in sorted(evts, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"profile: {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:90]}")
    for e in sorted(evts, key=lambda e: e.key):  # the port's own kernels, each
        name = re.match(r"void (?:maa3_flash::)?\(anonymous namespace\)::"
                        r"((?:flash|conv_snake|aa_snake)_\w*kernel<[^>]*>)", e.key)
        if name:
            log(f"profile: port kernel {e.self_device_time_total / 1e3:9.2f} ms "
                f"{e.count:6d}x {name.group(1)}")


def serve_k3a(depth: int, odes: int = 1) -> int:
    """K3a launches of `odes` 25-step CFG ODEs on the card's serving route:
    self- and cross-attention in each of `depth` blocks at each Euler
    step."""
    return 2 * depth * SERVE_EULER_STEPS * odes


def main_path(torch, system_mod, config_path, k1, k2, profile=False):
    """Phase 5: the XL main path; returns (stage times, K1 / K2 launch
    counts, K3a launches of the ODE: the planned step's self- and
    cross-attention in every block at every Euler step)."""
    from maa3_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    system = system_mod.MAA3System.from_config(
        [config_path], seed=0, compute_dtype=torch.bfloat16, device="cuda",
        unfreeze=True)
    n_par = sum(p.numel() for m in (system.dit, system.vae, system.vocoder,
                                    system.cond) for p in m.parameters())
    torch.cuda.synchronize()
    log(f"main path: XL system built on the card, {n_par / 1e6:.1f} M parameters, "
        f"{time.perf_counter() - t:.2f} s")
    caps = ["a dog barks in the distance", "rain falls on a tin roof",
            "a crowd cheers at a stadium", "an engine idles then revs up"]
    prompts = {"ori_caption": caps, "struct_caption": [f"<{p}& all>" for p in caps]}
    empty = {"ori_caption": [""] * B, "struct_caption": [""] * B}

    def run(counted: bool):
        times = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - s
            return out

        gen = torch.Generator(device="cuda").manual_seed(0)
        if counted:  # count exactly this run's launches
            k1.launches = 0
            k2.launches = 0
            fa.launches["K3a"] = 0
        s0 = time.perf_counter()
        c = stage("encode", lambda: system.get_learned_conditioning(prompts))
        uc = stage("encode_uncond", lambda: system.get_learned_conditioning(empty))
        z = stage("ode", lambda: system.sample_cfg(c, 5.0, uc, gen,
                                                   shape=(B, 20, LATENT),
                                                   timesteps=25))
        mel = stage("vae_decode", lambda: system.decode_first_stage(z))
        wav = stage("vocode", lambda: system.vocode(mel))
        times["end_to_end"] = time.perf_counter() - s0
        counts = (k1.launches, k2.launches)
        return c, z, mel, wav, times, counts

    run(False)  # warm-up: cuBLAS/cuDNN handles, the serving copy, caches
    torch.cuda.reset_peak_memory_stats()
    c, z, mel, wav, times, counts = run(True)
    k3a = fa.launches["K3a"]
    import numpy as np
    log(f"main path: context {tuple(c.shape)} latent {tuple(z.shape)} "
        f"mel {tuple(mel.shape)} wav {wav.shape}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    require(tuple(c.shape) == (B, 154, 1024) and tuple(z.shape) == (B, 20, LATENT)
            and tuple(mel.shape) == (B, 80, 2 * LATENT)
            and wav.shape == (B, 159744), "main-path shapes")
    require(torch.isfinite(z).all() and torch.isfinite(mel).all()
            and np.isfinite(wav).all(), "finite outputs")
    require(0 < np.abs(wav).max() <= 1.0, "wav in [-1, 1] and not silent")
    for k, v in times.items():
        log(f"main path stage {k}: {v * 1e3:.2f} ms")
    want_k3a = serve_k3a(system.spec.dit.depth)
    log(f"main path launches: K1 {counts[0]}, K2 {counts[1]} (expect {K1_K2_PER_VOCODE}), "
        f"K3a {k3a} (expect {want_k3a}: self and cross in each block at each Euler step)")
    require(counts == K1_K2_PER_VOCODE, f"launch counts {counts} == {K1_K2_PER_VOCODE}")
    require(k3a == want_k3a, f"the ODE's K3a launches {k3a} == {want_k3a}")
    if profile:
        profile_run(torch, run, times["end_to_end"] * 1e3)
    return times, counts, k3a


def check_flash(torch, fa, full_fp32, shapes=FLASH_SHAPES):
    """Phase 6: returns per-(shape, dtype, kernel) rows."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.finfo(dtype).bits // 8
        tol = TOL_FP32 if dtype == torch.float32 else TOL_BF16
        peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        for b, h, L, d, masked, block_k in shapes:
            q, k, v, do = (torch.randn(b, h, L, d, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            mask = None
            valid = torch.full((b,), L, device=dev)
            if masked:  # row 0 all valid, row 1 ragged, the last row all masked
                mask = torch.ones(b, L, dtype=torch.int32, device=dev)
                mask[1, (2 * L) // 3:] = 0
                mask[-1] = 0
                valid = mask.sum(1)
            pairs = h * L * int(valid.sum())        # (query, valid key) pairs
            scale = d ** -0.5
            route = fa.route_for(L, block_k)
            fwd_name = "K3a" if route == "direct" else "K3b"
            mbytes = 4 * b * L if masked else 0
            nq = b * h * L * d

            def fwd():
                return fa.flash_fwd(q, k, v, mask, scale, route)

            def fwd_plain():
                with full_fp32():
                    return fa.flash_fwd_plain(q, k, v, mask, scale, route)

            o, lse = fwd()
            o_again, lse_again = fwd()
            o_ref, lse_ref = fwd_plain()
            torch.cuda.synchronize()
            require(torch.equal(o, o_again) and torch.equal(lse, lse_again),
                    f"{fwd_name} gives the same bits over two launches at {(b, h, L, d)}")
            del o_again, lse_again
            delta = (do.float() * o_ref.float()).sum(-1)

            def bwd():
                return fa.flash_bwd(q, k, v, mask, lse_ref, do, delta, scale)

            def bwd_plain():
                with full_fp32():
                    return fa.flash_bwd_plain(q, k, v, mask, lse_ref, do, delta, scale)

            def dkv():
                return fa.flash_bwd_dkv(q, k, v, mask, lse_ref, do, delta, scale)

            def dkv_plain():
                with full_fp32():
                    return fa.flash_bwd_dkv_plain(q, k, v, mask, lse_ref, do, delta, scale)

            def dq():
                return fa.flash_bwd_dq(q, k, v, mask, lse_ref, do, delta, scale)

            def dq_plain():
                with full_fp32():
                    return fa.flash_bwd_dq_plain(q, k, v, mask, lse_ref, do, delta, scale)

            grads, grads_ref = bwd(), bwd_plain()
            split = (dq(), *dkv())
            split_ref = (dq_plain(), *dkv_plain())
            dq_again, (dk_again, dv_again) = dq(), dkv()
            torch.cuda.synchronize()
            require(torch.equal(split[0], dq_again),
                    f"K4c's dq is the same bits over two launches at {(b, h, L, d)}")
            require(torch.equal(split[1], dk_again) and torch.equal(split[2], dv_again),
                    f"K4b's dk and dv are the same bits over two launches at {(b, h, L, d)}")
            live = lse_ref > -1e29
            errs = {}
            for nm, got, want in (("o", o, o_ref), ("lse", lse[live], lse_ref[live]),
                                  ("dq", grads[0], grads_ref[0]),
                                  ("dk", grads[1], grads_ref[1]),
                                  ("dv", grads[2], grads_ref[2]),
                                  ("dq_split", split[0], split_ref[0]),
                                  ("dk_split", split[1], split_ref[1]),
                                  ("dv_split", split[2], split_ref[2]),
                                  ("dk_split_vs_K4a", split[1], grads[1]),
                                  ("dv_split_vs_K4a", split[2], grads[2])):
                ok = bool(torch.isfinite(got).all()) and got.dtype == want.dtype
                err = (got.float() - want.float()).abs().max().item() if ok else float("inf")
                lim = (TOL_FP32 if want.dtype == torch.float32 else tol) * max(
                    1.0, want.abs().max().item())
                errs[nm] = (err, lim)
            for nm in ("dk_split_vs_K4a", "dv_split_vs_K4a"):
                err, lim = errs.pop(nm)
                require(err <= lim, f"{nm} at {(b, h, L, d)} {dtype}: {err} <= {lim}")
            if masked:
                require(not o[-1].any() and not any(t[-1].any() for t in grads + split),
                        "a fully masked row gives o = 0 and zero gradients")
            del o, lse, grads, grads_ref, o_ref, split, split_ref, dq_again, dk_again, dv_again

            am = None if mask is None else mask.bool()[:, None, None, :]
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lo = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=am, scale=scale)

            def lib_fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=am, scale=scale)

            def lib_bwd():
                return torch.autograd.grad(lo, (ql, kl, vl), do, retain_graph=True)

            shape = (b, h, L, d) + (("masked",) if masked else ()) + (
                (f"block_k={block_k}",) if block_k else ())
            for name, kern, plain, lib, flops, nbytes, keys in (
                    (fwd_name, fwd, fwd_plain, lib_fwd, 4 * pairs * d,
                     (4 * nq * item + 4 * b * h * L + mbytes), ("o", "lse")),
                    ("K4a", bwd, bwd_plain, lib_bwd, 10 * pairs * d,
                     (7 * nq * item + 8 * b * h * L + mbytes), ("dq", "dk", "dv")),
                    ("K4b", dkv, dkv_plain, lib_bwd, 8 * pairs * d,
                     (6 * nq * item + 8 * b * h * L + mbytes),
                     ("dk_split", "dv_split")),
                    ("K4c", dq, dq_plain, lib_bwd, 6 * pairs * d,
                     (5 * nq * item + 8 * b * h * L + mbytes), ("dq_split",))):
                err = max(errs[x][0] for x in keys)
                rows.append(dict(kernel=name, dtype=str(dtype)[6:], shape=shape,
                                 err=err, tol=min(errs[x][1] for x in keys),
                                 errs={x: errs[x] for x in keys},
                                 ms=time_ms(kern), plain_ms=time_ms(plain),
                                 library_ms=time_ms(lib), flops=flops,
                                 bytes_ms=nbytes / PEAK_BW * 1e3,
                                 ops_ms=flops / peak * 1e3))
            del q, k, v, do, ql, kl, vl, lo, delta, lse_ref
            torch.cuda.empty_cache()
    for r in rows:
        r["bound_ms"] = max(r["bytes_ms"], r["ops_ms"])
        # useful operations per second (the unpadded head dim, valid keys only)
        # and the share of the bound
        log(f"{r['kernel']} {r['dtype']:8s} {str(r['shape']):40s} err {r['err']:.3e} "
            f"kernel {r['ms']:.4f} ms ({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound) plain "
            f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.4f} ms library "
            f"{r['library_ms']:.4f} ms")
    bad = [r for r in rows if not all(e <= lim for e, lim in r["errs"].values())]
    require(not bad, f"flash kernels agree with their plain versions: {bad}")
    return rows


def profiled_ms(torch, fn, calls: int = 20) -> float:
    """The card's time per call of fn, in ms: the device time of every kernel
    that `calls` calls launch, as torch.profiler records it (after one warm
    call), over `calls`."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False))
    require(us > 0, "the profiler records the card's kernels")
    return us / 1e3 / calls


def serve_attention(torch, fa, full_fp32):
    """Phase 6, the serving DiT's attention on the card's route (bf16, a
    CONTEXT_LEN-token context): K3a against its plain version at each
    SERVE_ATTN_SHAPES shape, self and cross; then, at phase 5's shape
    (SERVE_STEP_ATTN), the card's time (profiled_ms) of K3a alone, self and
    cross, of the layout copies the planned step makes for them (q, and the
    self-attention's k and v, to contiguous (B, H, L, D)), and of the dense
    `_sdpa` the route replaces, self and cross. Returns those times, per
    call."""
    from maa3_tpu_torch.ops.attention import _sdpa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    for what, (b, h, n, d) in SERVE_ATTN_SHAPES.items():
        scale = d ** -0.5
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(bf) for _ in range(3))
        yk, yv = (torch.randn(b, h, CONTEXT_LEN, d, generator=g, device=dev).to(bf)
                  for _ in range(2))
        for kind, kk, vv in (("self", k, v), ("cross", yk, yv)):
            n0 = fa.launches["K3a"]
            o = fa.flash_attention(q, kk, vv, scale=scale)
            torch.cuda.synchronize()
            require(fa.launches["K3a"] == n0 + 1, f"{what} serving {kind} attention runs K3a")
            with full_fp32():
                o_ref, _ = fa.flash_fwd_plain(q, kk, vv, None, scale, "direct")
            err = (o.float() - o_ref.float()).abs().max().item()
            lim = TOL_BF16 * max(1.0, o_ref.abs().max().item())
            require(err <= lim, f"K3a {what} serving {kind} {(b, h, n, d)} x Lk "
                    f"{kk.shape[2]}: {err:.3e} <= {lim:.3e}")
            log(f"serving attention ({what}) {kind} {(b, h, n, d)} x Lk {kk.shape[2]}: "
                f"K3a vs plain {err:.3e} (limit {lim:.3e})")
        del q, k, v, yk, yv, o, o_ref
    b, h, n, d = SERVE_STEP_ATTN
    scale = d ** -0.5
    # as the planned step holds them: (B, L, H, D) projections, the context
    # K/V head-major and contiguous from the plan
    q, k, v = (torch.randn(b, n, h, d, generator=g, device=dev).to(bf) for _ in range(3))
    yk, yv = (torch.randn(b, h, CONTEXT_LEN, d, generator=g, device=dev).to(bf)
              for _ in range(2))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms = {"k3a_self": profiled_ms(torch, lambda: fa.flash_attention(qh, kh, vh, scale=scale)),
          "k3a_cross": profiled_ms(torch, lambda: fa.flash_attention(qh, yk, yv, scale=scale)),
          "layout": profiled_ms(torch, lambda: [t.transpose(1, 2).contiguous()
                                               for t in (q, k, v)]),
          "dense_self": profiled_ms(torch, lambda: _sdpa(q.transpose(1, 2), k.transpose(1, 2),
                                                         v.transpose(1, 2), scale, None)),
          "dense_cross": profiled_ms(torch, lambda: _sdpa(q.transpose(1, 2), yk, yv, scale,
                                                          None))}
    log(f"serving attention at phase 5's {SERVE_STEP_ATTN} x Lk {n} / {CONTEXT_LEN}, "
        f"card ms per call (profiler): K3a self {ms['k3a_self']:.4f}, cross "
        f"{ms['k3a_cross']:.4f}, layout copies {ms['layout']:.4f}; dense self "
        f"{ms['dense_self']:.4f}, cross {ms['dense_cross']:.4f}")
    del q, k, v, yk, yv, qh, kh, vh
    torch.cuda.empty_cache()
    return ms


def attn_crossover(torch, fa):
    """chip_smoke.py --attn-crossover: K3a against `_sdpa` as
    ops/attention.py calls each in the planned step (flash: q copied to
    (B, H, L, D) once, k and v of self-attention too, the context already
    head-major; dense: views), bf16, 16 heads of 72, over SERVE_ROWS x
    SERVE_LENS, self, cross and both: whether flash still wins at every
    length, as models/dit.py card_attention_route assumes."""
    from maa3_tpu_torch.ops.attention import _sdpa
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    h, d = SERVE_STEP_ATTN[1], SERVE_STEP_ATTN[3]
    scale = d ** -0.5
    bf = torch.bfloat16
    ms = {}
    for rows in SERVE_ROWS:
        for n_tok in SERVE_LENS:
            q, k, v = (torch.randn(rows, n_tok, h, d, generator=g, device=dev).to(bf)
                       for _ in range(3))
            yk, yv = (torch.randn(rows, h, CONTEXT_LEN, d, generator=g, device=dev).to(bf)
                      for _ in range(2))

            def self_flash():
                return fa.flash_attention(q.transpose(1, 2).contiguous(), k.transpose(1, 2),
                                          v.transpose(1, 2), scale=scale)

            def cross_flash():
                return fa.flash_attention(q.transpose(1, 2).contiguous(), yk, yv, scale=scale)

            def both_flash():
                qc = q.transpose(1, 2).contiguous()
                return (fa.flash_attention(qc, k.transpose(1, 2), v.transpose(1, 2),
                                           scale=scale),
                        fa.flash_attention(qc, yk, yv, scale=scale))

            def self_dense():
                return _sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale,
                             None)

            def cross_dense():
                return _sdpa(q.transpose(1, 2), yk, yv, scale, None)

            def both_dense():
                return self_dense(), cross_dense()

            ms[rows, n_tok] = {nm: time_ms(fn) for nm, fn in (
                ("self_flash", self_flash), ("self_dense", self_dense),
                ("cross_flash", cross_flash), ("cross_dense", cross_dense),
                ("both_flash", both_flash), ("both_dense", both_dense))}
            m = ms[rows, n_tok]
            log(f"serving attention {rows:2d} rows x L {n_tok:3d}: self flash "
                f"{m['self_flash']:.4f} / dense {m['self_dense']:.4f} ms, cross flash "
                f"{m['cross_flash']:.4f} / dense {m['cross_dense']:.4f} ms, both "
                f"{m['both_flash']:.4f} / {m['both_dense']:.4f} ms "
                f"({m['both_dense'] / m['both_flash']:.2f}x)")
            del q, k, v, yk, yv
    losses = [(r, n_tok, kind) for (r, n_tok), m in ms.items() for kind in ("self", "cross")
              if m[f"{kind}_flash"] > m[f"{kind}_dense"]]
    log(f"serving attention crossover: the card's route takes flash at every length, "
        f"which {'NO LONGER holds: flash slower at ' + str(losses) if losses else 'still holds'}"
        f" (rows {SERVE_ROWS}, lengths {SERVE_LENS})")


def long_lq(torch, fa, full_fp32):
    """Phase 6, long-Lq timing at LONG_LQ in bf16: K4a against K4b + K4c
    against SDPA's backward alone (a yardstick), and the split's dq / dk / dv
    (and K4a's) held to the plain versions two heads at a time (a
    full-length plain backward needs tens of GB). Returns a dict of ms."""
    import torch.nn.functional as F
    b, h, L, d = LONG_LQ
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(b, h, L, d, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = d ** -0.5
    route = fa.route_for(L)
    require(route == "online", "long-Lq: the forward takes the online route (K3b)")
    o, lse = fa.flash_fwd(q, k, v, None, scale, route)
    # the forward (K3b, the inference route above 4096 tokens) against SDPA's
    # forward, and held to the plain version two heads at a time
    fwd_ms = time_ms(lambda: fa.flash_fwd(q, k, v, None, scale, route), reps=5)
    with torch.no_grad():
        sdpa_fwd_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
                              reps=5)
    fwd_err = 0.0
    for h0 in range(0, h, 2):
        sl = slice(h0, h0 + 2)
        with full_fp32():
            o_ref, lse_ref = fa.flash_fwd_plain(*(t[:, sl].contiguous() for t in (q, k, v)),
                                                None, scale, route)
        for got, want, tol in ((o[:, sl], o_ref, TOL_BF16), (lse[sl], lse_ref, TOL_FP32)):
            err = (got.float() - want.float()).abs().max().item()
            lim = tol * max(1.0, want.abs().max().item())
            require(bool(torch.isfinite(got).all()) and err <= lim,
                    f"long-Lq forward heads {h0}-{h0 + 1}: {err} <= {lim}")
        fwd_err = max(fwd_err, (o[:, sl].float() - o_ref.float()).abs().max().item())
        del o_ref, lse_ref
    flops = 4 * b * h * L * L * d
    bound = max(flops / PEAK_BF16, (4 * b * h * L * d * 2 + 4 * b * h * L) / PEAK_BW) * 1e3
    log(f"long-Lq {LONG_LQ} bf16 forward: K3b {fwd_ms:.3f} ms "
        f"({flops / fwd_ms / 1e9:.1f} TFLOP/s, {100 * bound / fwd_ms:.1f} % of the bound "
        f"{bound:.4f} ms), SDPA forward {sdpa_fwd_ms:.3f} ms, max |o - plain| {fwd_err:.3e}")
    delta = (do.float() * o.float()).sum(-1)
    del o
    args = (q, k, v, None, lse, do, delta, scale)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
    ms = {"K4a": time_ms(lambda: fa.flash_bwd(*args), reps=3),
          "K4b": time_ms(lambda: fa.flash_bwd_dkv(*args), reps=3),
          "K4c": time_ms(lambda: fa.flash_bwd_dq(*args), reps=3),
          "library": time_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                         retain_graph=True), reps=3)}
    ms["split"] = ms["K4b"] + ms["K4c"]
    ms["K3b"], ms["library_fwd"] = fwd_ms, sdpa_fwd_ms
    del lo, ql, kl, vl
    fused = fa.flash_bwd(*args)
    split = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    require(torch.equal(split[0], fa.flash_bwd_dq(*args)),
            "long-Lq: K4c's dq is the same bits on every run")
    require(all(torch.equal(a, b) for a, b in zip(split[1:], fa.flash_bwd_dkv(*args))),
            "long-Lq: K4b's dk and dv are the same bits on every run")
    worst = 0.0
    for h0 in range(0, h, 2):
        sl = slice(h0, h0 + 2)
        part = [t[:, sl].contiguous() for t in (q, k, v)]
        with full_fp32():
            dq_ref = fa.flash_bwd_dq_plain(*part, None, lse[sl], do[:, sl].contiguous(),
                                           delta[:, sl], scale)
            dk_ref, dv_ref = fa.flash_bwd_dkv_plain(*part, None, lse[sl],
                                                    do[:, sl].contiguous(),
                                                    delta[:, sl], scale)
        for got, want in zip(split + fused, (dq_ref, dk_ref, dv_ref) * 2):
            got = got[:, sl]
            err = (got.float() - want.float()).abs().max().item()
            lim = TOL_BF16 * max(1.0, want.abs().max().item())
            require(bool(torch.isfinite(got).all()) and err <= lim,
                    f"long-Lq heads {h0}-{h0 + 1}: {err} <= {lim}")
            worst = max(worst, err)
        del dq_ref, dk_ref, dv_ref, part
    del q, k, v, do, lse, delta, split, fused
    torch.cuda.empty_cache()
    # useful operations and the bound (operations) of each backward
    pairs = b * h * L * L
    rate = {n: (f * pairs * d / ms[n] / 1e9, 100 * f * pairs * d / PEAK_BF16 * 1e3 / ms[n])
            for n, f in (("K4a", 10), ("K4b", 8), ("K4c", 6))}
    log(f"long-Lq {LONG_LQ} bf16: K4a {ms['K4a']:.2f} ms, split {ms['split']:.2f} ms "
        f"(K4b {ms['K4b']:.2f} + K4c {ms['K4c']:.2f}), SDPA backward "
        f"{ms['library']:.2f} ms; split / K4a {ms['split'] / ms['K4a']:.3f}; "
        + "; ".join(f"{n} {t:.1f} TFLOP/s, {p:.1f} % of its bound"
                    for n, (t, p) in rate.items())
        + f"; max |kernel - plain| {worst:.3e}")
    return ms


def small_train_reference(torch, config_path, fa, full_fp32):
    """Phase 7: two fp32 training steps of a small DiT with flash forced on,
    on the card and on the CPU from the same weights and draws."""
    import copy
    from maa3_tpu_torch.train.optim import make_optimizer
    from maa3_tpu_torch.train.step import create_train_state, make_train_step
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=64", up + "depth=2", up + "num_heads=4",
            up + "context_dim=32", up + "multiple_of=32", up + "use_flash=true",
            dd + "ch=32", dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1"]
    from maa3_tpu_torch import config as config_mod
    from maa3_tpu_torch.models.dit import DiT, dit_init_, unfreeze_zero_init
    from maa3_tpu_torch.models.vae1d import AutoencoderKL, vae_init_
    spec = config_mod.parse_model_config(config_mod.load_config([config_path], over))
    gen = torch.Generator().manual_seed(3)
    dit = unfreeze_zero_init(dit_init_(DiT(spec.dit), gen), gen)
    vae = vae_init_(AutoencoderKL(spec.vae), gen)
    batches = [{"mel": torch.randn(2, 80, 96, generator=gen),
                "context": torch.randn(2, 8, 32, generator=gen)} for _ in range(2)]
    draws = [{"noise": torch.randn(2, 20, 48, generator=gen),
              "t_int": torch.randint(0, 1000, (2,), generator=gen),
              "x0": torch.randn(2, 20, 48, generator=gen)} for _ in range(2)]
    out = []
    reset_launches(fa)
    for dev in ("cpu", "cuda"):
        d, a = copy.deepcopy(dit).to(dev), copy.deepcopy(vae).to(dev)
        # full LR from the first update, so two updates move parameters ~2e-3,
        # well above the comparison's 1e-4
        opt = make_optimizer(d.parameters(), base_lr=1e-3, lr_multiplier=1.0,
                             warm_up_steps=0)
        state = create_train_state(d, a, opt, scale_factor=0.8)
        step = make_train_step(compute_dtype=torch.float32)
        with full_fp32():
            ms = [step(state, {k: t.to(dev) for k, t in bt.items()},
                       draws={k: t.to(dev) for k, t in dr.items()})
                  for bt, dr in zip(batches, draws)]
        out.append(([{k: v.item() for k, v in m.items()} for m in ms],
                    [p.detach().cpu() for p in d.parameters()]))
    moved = max((a - b).abs().max().item() for a, b in zip(
        out[0][1], (p.detach() for p in dit.parameters())))
    require(fa.launches["K3a"] == 4 and fa.launches["K4a"] == 4,
            f"the card's steps ran K3a and K4a twice each per step: {fa.launches}")
    for i, (mc, mg) in enumerate(zip(out[0][0], out[1][0])):
        for key in ("loss", "grad_norm"):
            rel = abs(mc[key] - mg[key]) / abs(mc[key])
            log(f"train reference step {i + 1} {key}: cpu {mc[key]:.6f} cuda "
                f"{mg[key]:.6f} (rel {rel:.2e})")
            require(rel <= 1e-4, f"train reference {key}")
    err = max(((a - b).abs().max().item() / max(1.0, a.abs().max().item()))
              for a, b in zip(out[0][1], out[1][1]))
    log(f"train reference: {len(out[0][1])} parameters after 2 steps moved up to "
        f"{moved:.2e}; max |cuda - cpu| / max(1, |cpu|) {err:.2e}")
    require(moved > 1e-3, "the two updates moved the parameters past the tolerance")
    require(err <= 1e-4, "train reference parameters")


def reset_launches(fa) -> None:
    for name in FLASH_KERNELS:
        fa.launches[name] = 0


def small_train_cond_reference(torch, system_mod, config_path, fa):
    """Phase 7 additions, with MAA3_FLASH_BWD=split (set by the caller): two
    fp32 Trainer steps that train a small DiT and a small CLAP+FLAN
    conditioner, on the card and on the CPU from the same weights and draws
    (1e-4 relative); then a card Trainer saves a checkpoint after step 1 and
    a fresh one restored from it must take step 2 exactly as the
    uninterrupted one did (the split backward has no atomics)."""
    import copy
    import numpy as np
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.train.loop import Trainer
    up = "model.params.unet_config.params."
    dd = "model.params.first_stage_config.params.ddconfig."
    over = [up + "hidden_size=64", up + "depth=2", up + "num_heads=4",
            up + "context_dim=32", up + "multiple_of=32", up + "use_flash=true",
            dd + "ch=32", dd + "ch_mult=[1, 2]", dd + "num_res_blocks=1",
            # the std rescale would draw its noise from each device's own generator
            "model.params.scale_by_std=false"]
    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=32, num_layers=2, num_heads=4,
                                          intermediate_size=64),
                          t5=T5Config(d_model=32, d_kv=8, d_ff=48, num_layers=2,
                                      num_heads=4), d_proj=32)
    voc = BigVGANConfig(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
                        upsample_initial_channel=64)
    sys_c = system_mod.MAA3System.from_config(
        [config_path], over, seed=4, compute_dtype=torch.float32, device="cpu",
        clap_cfg=clap, voc_cfg=voc, unfreeze=True)
    mods = (sys_c.dit, sys_c.vae, sys_c.vocoder, sys_c.cond)
    sys_a, sys_b = (system_mod.MAA3System(sys_c.spec, *(copy.deepcopy(m).cuda() for m in mods),
                                          compute_dtype=torch.float32) for _ in range(2))
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")

    def trainer(system, name):
        tr = Trainer(system, batch_size=2, lr_multiplier=1.0, warm_up_steps=0, log_every=1,
                     ckpt_every=0, ckpt_dir=os.path.join(root, name))
        require(tr.state.cond is system.cond, "the Trainer trains the conditioner")
        # full LR from the first update, so parameters move past the tolerance
        tr.state.optimizer.schedule = lambda n: 1e-3
        return tr

    cpu, card = trainer(sys_c, "cpu"), trainer(sys_a, "card")
    start = [p.detach().clone() for p in cpu.state.trainable_parameters()]
    n_cond = sum(1 for _ in sys_c.cond.parameters())
    rng = np.random.RandomState(7)
    caps = ["a dog barks", "rain on a tin roof"]
    raws = [{"image": rng.randn(2, 80, 96).astype(np.float32) - 4.0,
             "caption": {"ori_caption": caps, "struct_caption": [f"<{c}& all>" for c in caps]}}
            for _ in range(2)]
    gen = torch.Generator().manual_seed(8)
    draws = [{"noise": torch.randn(2, 20, 48, generator=gen),
              "t_int": torch.randint(0, 1000, (2,), generator=gen),
              "x0": torch.randn(2, 20, 48, generator=gen)} for _ in range(2)]

    def step(tr, i):
        m = tr.train_step(raws[i], draws={k: t.to(tr.device) for k, t in draws[i].items()})
        return {k: v.item() for k, v in m.items()}

    reset_launches(fa)
    mc = [step(cpu, i) for i in range(2)]
    mg = [step(card, 0)]
    path = card.save_checkpoint()
    mg.append(step(card, 1))
    counts = dict(fa.launches)
    require(counts == {"K3a": 4, "K3b": 0, "K4a": 0, "K4b": 4, "K4c": 4},
            f"the card's split steps ran K3a, K4b and K4c twice each per step: {counts}")
    for i in range(2):
        for key in ("loss", "grad_norm"):
            rel = abs(mc[i][key] - mg[i][key]) / abs(mc[i][key])
            log(f"train+cond reference step {i + 1} {key}: cpu {mc[i][key]:.6f} cuda "
                f"{mg[i][key]:.6f} (rel {rel:.2e})")
            require(rel <= 1e-4, f"train+cond reference {key}")
    pc = [p.detach() for p in cpu.state.trainable_parameters()]
    pg = [p.detach().cpu() for p in card.state.trainable_parameters()]
    err = max((a - b).abs().max().item() / max(1.0, a.abs().max().item())
              for a, b in zip(pc, pg))
    moved = [(a - s).abs().max().item() for a, s in zip(pc, start)]
    log(f"train+cond reference: {len(pc)} parameters ({n_cond} of the conditioner) "
        f"after 2 steps moved up to {max(moved[:-n_cond]):.2e} (DiT) and "
        f"{max(moved[-n_cond:]):.2e} (conditioner); max |cuda - cpu| / max(1, |cpu|) "
        f"{err:.2e}")
    require(min(max(moved[:-n_cond]), max(moved[-n_cond:])) > 1e-3,
            "the two updates moved the DiT and the conditioner past the tolerance")
    require(err <= 1e-4, "train+cond reference parameters")

    resumed = trainer(sys_b, "resumed")
    resumed.restore_checkpoint(path)
    mr = step(resumed, 1)
    same = all(torch.equal(a, b) for a, b in zip(card.state.trainable_parameters(),
                                                 resumed.state.trainable_parameters()))
    log(f"checkpoint: {os.path.getsize(path) / 2 ** 20:.1f} MiB after step 1; the "
        f"restored Trainer's step 2: loss {mr['loss']:.8f} vs {mg[1]['loss']:.8f}, "
        f"grad norm {mr['grad_norm']:.8f} vs {mg[1]['grad_norm']:.8f}, parameters "
        f"{'bit-identical' if same else 'DIFFER'}")
    require(mr["loss"] == mg[1]["loss"] and mr["grad_norm"] == mg[1]["grad_norm"] and same,
            "the restored Trainer's step 2 equals the uninterrupted one's")


def tf32_probe(torch, trainer, raw):
    """Phase 8: the frozen VAE encode of the batch once with cuDNN's TF32 (the
    default for fp32 convolutions, which the training encode ran in before
    it was wrapped in full_fp32) and once in fp32, the same posterior noise:
    max |z_tf32 - z_fp32| and the loss each latent gives (the same draws)."""
    from maa3_tpu_torch.models.vae1d import gaussian_sample, vae_encode_moments
    from maa3_tpu_torch.pipeline import full_fp32
    st = trainer.state
    batch = trainer.prepare_batch(raw)
    g = torch.Generator(device="cuda").manual_seed(9)
    b, _, t = batch["mel"].shape
    draws = {"noise": torch.randn(b, 20, t // 2, generator=g, device="cuda"),
             "t_int": torch.randint(0, 1000, (b,), generator=g, device="cuda"),
             "x0": torch.randn(b, 20, t // 2, generator=g, device="cuda")}
    out = {}
    with torch.no_grad():
        for name, tf32 in (("tf32", True), ("fp32", False), ("tf32", True), ("fp32", False)):
            with full_fp32(), torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
                moments = vae_encode_moments(st.vae, batch["mel"])
                ms = time_ms(lambda: vae_encode_moments(st.vae, batch["mel"]), reps=3)
            z = gaussian_sample(moments, noise=draws["noise"]) * st.scale_factor
            loss = trainer._eval_step(st, {"moments": moments, "context": batch["context"]},
                                      draws=draws)
            out[name] = (z, float(loss), out.get(name, (0, 0, []))[2] + [ms])
    dz = (out["tf32"][0] - out["fp32"][0]).abs().max().item()
    zmax = out["fp32"][0].abs().max().item()
    dl = abs(out["tf32"][1] - out["fp32"][1])
    log(f"TF32 probe {tuple(batch['mel'].shape)} mel: max |z_tf32 - z_fp32| {dz:.3e} "
        f"(max |z_fp32| {zmax:.3f}, scale factor {st.scale_factor:.5f}); loss tf32 "
        f"{out['tf32'][1]:.6f} fp32 {out['fp32'][1]:.6f} (|diff| {dl:.3e}); encode ms "
        f"tf32 {out['tf32'][2]}, fp32 {out['fp32'][2]} (tf32, fp32, tf32, fp32 in turn)")
    require(dz < float("inf") and dl < float("inf"), "TF32 probe finite")
    return dz, dl


def train_path(torch, system_mod, config_path, fa, batch, latent, depth=None,
               remat=False, steps=3, profile=False, train_cond=False,
               measure_tf32=False):
    """Phases 8, 9 and 10: Trainer.fit on the XL config (full width; depth
    cut when given) with batch x latent mels made from the seed; the
    conditioner frozen unless train_cond (the YAML's own setting). Returns
    the per-step (ms, counts, metrics) of the timed steps and the peak
    memory in GiB."""
    import numpy as np
    from maa3_tpu_torch.train.loop import Trainer
    up = "model.params.unet_config.params."
    over = ([] if train_cond else [NO_COND]) + (
        [up + f"depth={depth}"] if depth else []) + ([up + "remat=true"] if remat else [])
    t = time.perf_counter()
    system = system_mod.MAA3System.from_config(
        [config_path], over, seed=0, compute_dtype=torch.bfloat16, device="cuda",
        unfreeze=True)
    root = os.path.dirname(os.path.abspath(__file__))
    trainer = Trainer(system, batch_size=batch, log_every=1, ckpt_every=0,
                      ckpt_dir=os.path.join(root, "build", "chip_smoke_train"))
    require((trainer.state.cond is not None) == train_cond,
            f"the conditioner trains iff train_cond={train_cond}")
    n_par = sum(p.numel() for p in system.dit.parameters())
    n_cond = sum(p.numel() for p in system.cond.parameters()) if train_cond else 0
    log(f"train {batch}x{latent}: system built, DiT {n_par / 1e6:.1f} M parameters "
        f"(depth {system.dit.cfg.depth}, remat {system.dit.cfg.remat}), trainable "
        f"conditioner {n_cond / 1e6:.1f} M, MAA3_FLASH_BWD="
        f"{os.environ.get('MAA3_FLASH_BWD', '(unset)')}, {time.perf_counter() - t:.2f} s")
    caps = ["a dog barks in the distance", "rain falls on a tin roof",
            "a crowd cheers at a stadium", "an engine idles then revs up",
            "birds chirp at dawn", "a door creaks open"]
    c = [caps[i % len(caps)] for i in range(batch)]
    raw = {"image": np.random.RandomState(0).randn(batch, 80, 2 * latent).astype(
               np.float32) - 4.0,
           "caption": {"ori_caption": c, "struct_caption": [f"<{x}& all>" for x in c]}}
    loader = itertools.repeat(raw)  # one log-mel batch made from the seed
    m = trainer.fit(loader, max_steps=1)  # warm-up: scale_by_std, cuBLAS, caches
    require(np.isfinite(m["loss"]), f"warm-up loss finite: {m}")
    tf32 = tf32_probe(torch, trainer, raw) if measure_tf32 else None
    cond0 = ([p.detach().clone() for p in system.cond.parameters()] if train_cond
             else None)
    torch.cuda.reset_peak_memory_stats()
    results = []
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_launches(fa)  # count exactly this step
        s = time.perf_counter()
        m = trainer.fit(loader, max_steps=1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - s) * 1e3
        results.append((ms, dict(fa.launches), m))
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"finite loss and grad norm: {m}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for ms, counts, m in results:
        log(f"train {batch}x{latent} step {m['step']}: {ms:.1f} ms, "
            f"{batch * latent / ms * 1e3:.0f} tokens/s, loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, launches {counts}")
    log(f"train {batch}x{latent}: peak memory {peak:.2f} GiB")
    if train_cond:
        changed = sum(int((p.detach() != p0).sum()) for p, p0 in
                      zip(system.cond.parameters(), cond0))
        most = max((p.detach() - p0).abs().max().item()
                   for p, p0 in zip(system.cond.parameters(), cond0))
        log(f"train {batch}x{latent}: {changed} of {n_cond} conditioner parameters "
            f"changed over the timed steps (largest change {most:.3e})")
        require(changed > 0, "the conditioner's parameters moved")
        del cond0
    if profile:  # one more step; fit logs the step's metrics, which syncs
        profile_run(torch, lambda _: trainer.fit(loader, max_steps=1), results[-1][0])
    del trainer, system
    gc.collect()
    torch.cuda.empty_cache()
    return results, peak, tf32


def weight_normed(torch, state: dict, seed: int) -> dict:
    """A vocoder state dict with every conv weight as weight norm's (g, v),
    the two namings (weight_g / weight_v and parametrizations'
    original0 / original1) alternating."""
    g = torch.Generator().manual_seed(seed)
    out, i = {}, 0
    for k, w in state.items():
        if k.endswith(".weight") and w.dim() == 3:
            name = k[:-len(".weight")]
            norm = w.double().square().sum(dim=(1, 2), keepdim=True).sqrt().float()
            v = w * (0.5 + torch.rand(w.shape[0], 1, 1, generator=g))
            names = (("weight_g", "weight_v") if i % 2 else
                     ("parametrizations.weight.original0", "parametrizations.weight.original1"))
            out[f"{name}.{names[0]}"], out[f"{name}.{names[1]}"] = norm, v
            i += 1
        else:
            out[k] = w
    return out


def write_music_files(torch, system_mod, music_path, tmp):
    """Phase 11, step 1: a Lightning .ckpt and a vocoder directory of the
    full-width text-to-music model. Returns (ckpt path, vocoder dir, the EMA
    DiT tensors written, the vocoder's weights before weight norm, the
    scale factor written, parameter counts)."""
    t = time.perf_counter()
    src = system_mod.MAA3System.from_config([music_path], seed=11, device="cuda",
                                            compute_dtype=torch.float32, unfreeze=True)
    counts = {k: sum(p.numel() for p in getattr(src, k).parameters())
              for k in ("dit", "cond", "vae", "vocoder")}
    g = torch.Generator(device="cuda").manual_seed(12)
    sd, ema = {}, {}
    for k, v in src.dit.state_dict().items():
        sd["model.diffusion_model." + k] = v.cpu()
        ema[k] = (v + 0.01 * torch.randn(v.shape, generator=g, device="cuda")).cpu()
        sd["model_ema." + ("diffusion_model." + k).replace(".", "")] = ema[k]
    sd["model_ema.decay"] = torch.tensor(0.9999)
    sd["model_ema.num_updates"] = torch.tensor(100000, dtype=torch.int32)
    sd.update({"first_stage_model." + k: v.cpu() for k, v in src.vae.state_dict().items()})
    cond = {k: v.cpu() for k, v in src.cond.state_dict().items()}
    cond["transformer.encoder.embed_tokens.weight"] = cond["transformer.shared.weight"]
    sd.update({"cond_stage_model." + k: v for k, v in cond.items()})
    scale = 0.4728
    sd["scale_factor"] = torch.tensor(scale)
    voc = {k: v.cpu() for k, v in src.vocoder.state_dict().items()}
    voc_cfg = dataclasses.asdict(src.vocoder.cfg)
    del src, cond
    gc.collect()
    torch.cuda.empty_cache()
    log(f"serve files: source weights made on the card and copied to the host, "
        f"{time.perf_counter() - t:.2f} s; parameters (M): "
        + ", ".join(f"{k} {n / 1e6:.1f}" for k, n in counts.items()))
    ckpt, vdir = os.path.join(tmp, "music.ckpt"), os.path.join(tmp, "vocoder")
    t = time.perf_counter()
    torch.save({"state_dict": sd, "global_step": 100000, "epoch": 40}, ckpt)
    os.makedirs(vdir)
    with open(os.path.join(vdir, "config.json"), "w") as f:
        json.dump(dict(voc_cfg, segment_size=8192), f)
    torch.save({"generator": weight_normed(torch, voc, 13)},
               os.path.join(vdir, "generator.pt"))
    write_s = time.perf_counter() - t
    sizes = [os.path.getsize(ckpt), os.path.getsize(os.path.join(vdir, "generator.pt"))]
    log(f"serve files: wrote {sizes[0] / 2 ** 30:.3f} GiB Lightning file ({len(sd)} keys) "
        f"and {sizes[1] / 2 ** 20:.1f} MiB generator in {write_s:.2f} s")
    return ckpt, vdir, ema, voc, scale, counts, {"write_s": write_s, "sizes": sizes}


def _http(port, body=None, path="/generate"):
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    t = time.perf_counter()
    with urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=data), timeout=600) as r:
        return r.status, r.read(), time.perf_counter() - t


def _pcm(data: bytes):
    import io
    import wave
    import numpy as np
    with wave.open(io.BytesIO(data)) as w:
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _round(port, bodies):
    """The requests sent at once, one thread each; returns (responses in
    order, the round's wall seconds)."""
    import threading
    out = [None] * len(bodies)

    def go(i):
        out[i] = _http(port, bodies[i])

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(bodies))]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return out, time.perf_counter() - t


def serve_from_files(torch, system_mod, music_path, k1, k2):
    """Phase 11, steps 1-5: write, load, serve, shut down. Returns the
    measurements and the K1 / K2 launches of the counted requests."""
    import tempfile
    import threading
    import numpy as np
    from maa3_tpu_torch.models.clap import FLAN
    from maa3_tpu_torch.ops import flash_attention as fa
    from maa3_tpu_torch.serving import AudioServer, ServeConfig
    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(root, "build")) as tmp:
        ckpt, vdir, ema, voc, scale, counts, out = write_music_files(
            torch, system_mod, music_path, tmp)
        t = time.perf_counter()
        system = system_mod.MAA3System.from_config(
            [music_path], ckpt_path=ckpt, vocoder_dir=vdir, device="cuda",
            compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t
    log(f"serve files: loaded onto the card in {out['load_s']:.2f} s")
    require(system.spec.cond_kind == "flan" and isinstance(system.cond, FLAN),
            "the music config's FLAN conditioner")
    require(all(torch.equal(v, ema[k].cuda()) for k, v in system.dit.state_dict().items())
            and len(ema) == len(system.dit.state_dict()),
            "the EMA weights were chosen, each DiT tensor as written")
    voc_err = max((v.cpu() - voc[k]).abs().max().item() / max(1.0, voc[k].abs().max().item())
                  for k, v in system.vocoder.state_dict().items())
    require(voc_err <= 1e-6 and len(voc) == len(system.vocoder.state_dict()),
            f"vocoder weights equal the folded ones within 1e-6: {voc_err}")
    require(abs(system.scale_factor - scale) < 1e-6, "scale_factor read from the file")
    del ema, voc
    log(f"serve files: EMA DiT as written, vocoder within {voc_err:.2e} of its "
        f"unnormed weights, scale factor {system.scale_factor:.6f}")

    before = set(threading.enumerate())
    server = AudioServer(system, ServeConfig(max_batch=8, batch_window_ms=50.0),
                         host="127.0.0.1", port=0)
    t = time.perf_counter()
    server.batcher.warmup((1, 8))
    torch.cuda.synchronize()
    log(f"serve: warm-up of buckets 1 and 8, {time.perf_counter() - t:.2f} s")
    server.start()
    bodies = [{"prompt": p, "seed": 100 + i} for i, p in enumerate(SERVE_PROMPTS)]
    other = [{"prompt": "a music box lullaby", "seed": 200 + i, "steps": 10}
             for i in range(2)]
    try:
        health = json.loads(_http(server.port, path="/healthz")[1])
        require(health["ok"] and health["device"] == torch.cuda.get_device_name(0),
                f"/healthz names the card: {health}")
        hists, rounds = [], []

        def hist():
            return dict(server.batcher.stats()["batch_histogram"])

        launched = []  # each launch's rows: (arrival order, the order run)
        real_process, real_captions = server.batcher._process, system.captions

        def logged_process(batch):
            arrival = [r.prompt for r in batch]
            real_process(batch)
            launched[-1] = (arrival, launched[-1])

        def logged_captions(ori, struct):
            if any(ori):  # not the bucket's empty unconditional captions
                launched.append([o for o in ori if o])
            return real_captions(ori, struct)

        server.batcher._process, system.captions = logged_process, logged_captions
        k1.launches = k2.launches = 0  # count exactly the requests below
        for n, bs in enumerate((bodies + other, bodies, bodies)):
            if n == 1:  # K3a: rounds 2-3 and the request alone, 25 steps a batch
                fa.launches["K3a"] = 0
            h0 = hist()
            rounds.append(_round(server.port, bs))
            h1 = hist()
            hists.append({n: h1[n] - h0.get(n, 0) for n in h1 if h1[n] != h0.get(n, 0)})
        h0 = hist()
        alone = _http(server.port, bodies[0])
        h1 = hist()
        hists.append({n: h1[n] - h0.get(n, 0) for n in h1 if h1[n] != h0.get(n, 0)})
        launches, k3a = (k1.launches, k2.launches), fa.launches["K3a"]
        stats = server.batcher.stats()
    finally:
        server.shutdown()
    left = set(threading.enumerate()) - before
    require(not left, f"no thread of the server is left: {left}")
    n_batches = sum(sum(h.values()) for h in hists)
    log(f"serve: batch histograms per round {hists}; stats {stats}")
    responses = [r for rs, _ in rounds for r in rs] + [alone]
    for status, data, _ in responses:
        rate, pcm = _pcm(data)
        require(status == 200 and rate == 16000 and pcm.size == MUSIC_SAMPLES
                and np.isfinite(pcm.astype(np.float32) / 32767).all()
                and np.abs(pcm).max() > 0,
                f"a 16 kHz wav of {MUSIC_SAMPLES} samples: {status}, {rate}, {pcm.size}")
    # served: the warm-up's 1 + 8, then 10 + 8 + 8 + 1 requests
    require(stats["errors"] == 0 and stats["served"] == 9 + 27, f"/stats: {stats}")
    require(sum(hists[0].values()) < 10 and max(hists[0]) > 1,
            f"the concurrent requests coalesced: {hists[0]}")
    require(hists[1] == {8: 1} and hists[2] == {8: 1},
            f"the 8 concurrent requests ran as one launch of 8: {hists[1:3]}")
    index = {p: i for i, p in enumerate(SERVE_PROMPTS)}
    for n, (arrival, run) in enumerate(launched[-3:-1]):
        log(f"serve: launch of 8 in round {n + 2}: rows by arrival "
            f"{[index[p] for p in arrival]}, as run {[index[p] for p in run]}")
    require(launched[-3][1] == launched[-2][1],
            "the two launches of the same 8 requests run their rows in one order")
    same = [rounds[1][0][i][1] == rounds[2][0][i][1] for i in range(8)]
    require(all(same), f"a repeated {{prompt, seed}} in the same bucket gives the same "
                       f"bytes: {same}")
    require(launches == (K1_K2_PER_VOCODE[0] * n_batches, K1_K2_PER_VOCODE[1] * n_batches),
            f"K1 / K2 launches {launches} over {n_batches} batch vocodes")
    want_k3a = serve_k3a(system.dit.cfg.depth, sum(sum(h.values()) for h in hists[1:]))
    require(k3a == want_k3a, f"serve: K3a launches {k3a} == {want_k3a} over rounds 2-3 and "
            f"the request alone")
    diff = np.abs(_pcm(alone[1])[1].astype(np.int32)
                  - _pcm(rounds[1][0][0][1])[1].astype(np.int32)).max()
    lat = sorted(r[2] for rs, _ in rounds[1:] for r in rs)
    p50 = statistics.median(lat)
    walls = [rounds[1][1], rounds[2][1]]
    rate = 8 * MUSIC_SAMPLES / 16000 / statistics.median(walls)
    log(f"serve: one request alone against the same co-batched: max |pcm diff| {diff} "
        f"16-bit steps (bf16 GEMMs may differ by batch; not gated)")
    log(f"serve: batch 8 of 8.19 s clips: p50 latency {p50 * 1e3:.1f} ms, round walls "
        f"{[round(w * 1e3, 1) for w in walls]} ms, {rate:.2f} s of audio per s; "
        f"launches per batch vocode K1 {launches[0] // n_batches}, "
        f"K2 {launches[1] // n_batches} ({n_batches} batches); K3a {k3a} over rounds 2-3 "
        f"and the request alone")
    out.update(p50_ms=p50 * 1e3, audio_s_per_s=rate, launches=launches, k3a=k3a,
               n_batches=n_batches, alone_diff=int(diff), counts=counts)
    del system, server
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ode_chunk_probe(torch, system_mod, config_path):
    """Phase 11: the XL serving ODE (25 steps, latent 312, bf16) at batch 8
    and 16 with MAA3_ODE_CHUNK 0 and 8 in turns (0, 8, 0, 8 after one warm
    call per batch), each call's K3a launches those of its sub-batch ODEs;
    returns {(batch, chunk): [ms, ms]}."""
    from maa3_tpu_torch.ops import flash_attention as fa
    system = system_mod.MAA3System.from_config(
        [config_path], seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    g = torch.Generator(device="cuda").manual_seed(21)
    old = os.environ.pop("MAA3_ODE_CHUNK", None)
    ms = {}
    try:
        for b in (8, 16):
            c, uc = (torch.randn(b, 154, 1024, generator=g, device="cuda") for _ in range(2))
            x0 = torch.randn(b, 20, LATENT, generator=g, device="cuda")
            zs = {}
            for i, chunk in enumerate((8, 0, 8, 0, 8)):
                os.environ["MAA3_ODE_CHUNK"] = str(chunk)
                n0 = fa.launches["K3a"]
                torch.cuda.synchronize()
                t = time.perf_counter()
                zs[chunk] = system.sample_cfg(c, 5.0, uc, x0=x0, timesteps=25)
                torch.cuda.synchronize()
                want = serve_k3a(XL_DEPTH, b // chunk if chunk and b > chunk else 1)
                require(fa.launches["K3a"] - n0 == want, f"ODE chunk: batch {b} chunk {chunk}: "
                        f"K3a launches {fa.launches['K3a'] - n0} == {want}")
                if i:  # the first call warms up
                    ms.setdefault((b, chunk), []).append((time.perf_counter() - t) * 1e3)
            dz = (zs[8] - zs[0]).abs().max().item()
            require(torch.isfinite(zs[8]).all(), "finite chunked latents")
            log(f"ODE chunk: XL batch {b}: chunk 0 {[round(x, 1) for x in ms[(b, 0)]]} ms, "
                f"chunk 8 {[round(x, 1) for x in ms[(b, 8)]]} ms; max |z_8 - z_0| {dz:.3e}")
    finally:
        os.environ.pop("MAA3_ODE_CHUNK", None)
        if old is not None:
            os.environ["MAA3_ODE_CHUNK"] = old
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return ms


def amp2_lrelu_vocoders(torch, k1, k2, full_fp32):
    """Phase 11, step 6: an AMPBlock2 vocoder (dilations (1, 3)) and an lrelu
    vocoder at BigVGAN 1536 width from a seed (snake parameters nonzero), on
    the card against the CPU's plain path, fp32 at 1e-3. Returns the
    AMP2 run's K1 / K2 launches."""
    import copy
    from maa3_tpu_torch.models.bigvgan import (BigVGAN, BigVGANConfig, Snake,
                                               bigvgan_apply, bigvgan_init_)
    out = {}
    for name, kw, want in (
            ("AMP2", dict(resblock="2", resblock_dilation_sizes=((1, 3),) * 3),
             K1_K2_PER_AMP2_VOCODE),
            ("lrelu", dict(activation="lrelu"), (0, 0))):
        gen = torch.Generator().manual_seed(14)
        voc_c = bigvgan_init_(BigVGAN(BigVGANConfig(**kw)), gen)
        with torch.no_grad():
            for m in voc_c.modules():
                if isinstance(m, Snake):
                    for p in m.parameters():
                        p.uniform_(-0.3, 0.3, generator=gen)
        voc_g = copy.deepcopy(voc_c).cuda()
        mel = torch.randn(2, 80, 32, generator=gen)
        with full_fp32():
            k1.launches = k2.launches = 0
            wav_g = bigvgan_apply(voc_g, mel.cuda())
            torch.cuda.synchronize()
            n = (k1.launches, k2.launches)
            wav_c = bigvgan_apply(voc_c, mel)
        err = (wav_g.cpu() - wav_c).abs().max().item()
        log(f"{name} vocoder (BigVGAN 1536, {sum(p.numel() for p in voc_c.parameters()) / 1e6:.1f}"
            f" M parameters) {tuple(wav_g.shape)}: max |cuda - cpu| {err:.3e}; launches "
            f"K1 {n[0]}, K2 {n[1]} (expect {want})")
        require(err <= 1e-3 and bool(torch.isfinite(wav_g).all()), f"{name} vocoder")
        require(n == want, f"{name} vocoder launches {n} == {want}")
        out[name] = n
    return out["AMP2"]


# phase 12: the remaining trainer options at XL width
REMAT_SETTINGS = (None, "nothing", "dots_no_batch", "save_gemms", "save_gemms_lite",
                  "save_gemms_h1")                  # None: no remat
PHASE12_MELS = (64, 80, 2496)       # mels written from the seed: clips x bins x frames
RECIPE = dict(accum_steps=2, micro_batch=8, micro_steps=6, val_every=2, val_batches=2,
              audio_log_every=4, policy="save_gemms_lite", workers=2)
LOGGER_CAPTIONS = [{"ori_caption": c, "struct_caption": f"<{c}& all>"} for c in
                   ("a dog barks in the distance", "rain falls on a tin roof",
                    "a crowd cheers at a stadium", "an engine idles then revs up")]


def write_mels():
    """Phase 12: PHASE12_MELS log-mels from the seed as .npy files and their
    manifest under build/ (never the repository's data/)."""
    import numpy as np
    n, bins, frames = PHASE12_MELS
    d = os.path.join(ROOT, "build", "chip_smoke_mels")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(12)
    lines = ["name\tmel_path\tori_cap\tcaption"]
    for i in range(n):
        path = os.path.join(d, f"clip{i:02d}.npy")
        np.save(path, rng.randn(bins, frames).astype(np.float32) - 4.0)
        cap = LOGGER_CAPTIONS[i % 4]
        lines.append(f"clip{i:02d}\t{path}\t{cap['ori_caption']} {i}\t{cap['struct_caption']}")
    tsv = os.path.join(d, "manifest.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tsv


def _phase12_system(torch, system_mod, config_path, over, unfreeze=True):
    return system_mod.MAA3System.from_config(
        [config_path], over, seed=0, compute_dtype=torch.bfloat16, device="cuda",
        unfreeze=unfreeze)


def _timed_steps(torch, fa, trainer, loader, steps):
    """steps Trainer.fit steps of one micro-step each, synchronised: per step
    (ms, flash launches, metrics)."""
    out = []
    for _ in range(steps):
        torch.cuda.synchronize()
        reset_launches(fa)
        s = time.perf_counter()
        m = trainer.fit(loader, max_steps=1)
        torch.cuda.synchronize()
        out.append(((time.perf_counter() - s) * 1e3, dict(fa.launches), m))
    return out


def activation_memory(torch, trainer, raw):
    """(GiB held from the forward for the backward, GiB of the forward and
    backward's peak), each above what is allocated before the forward, for
    one CFM loss of the batch through the trainer's DiT (the training
    step's loss and routes; draws from a fixed generator): what a remat
    policy trades, apart from the weights, moments and the optimizer pass
    that set the step's own peak."""
    from maa3_tpu_torch.diffusion import cfm
    from maa3_tpu_torch.models.dit import dit_apply
    from maa3_tpu_torch.train.step import sample_latent
    st = trainer.state
    batch = trainer.prepare_batch(raw)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    z = sample_latent(st.vae, batch, gen) * st.scale_factor
    st.optimizer.zero_grad()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cdt = trainer.system.compute_dtype
    loss, _ = cfm.cfm_loss(lambda x, t, c: dit_apply(st.dit, x, t, c, compute_dtype=cdt,
                                                     training=True),
                           z, batch["context"], gen)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    st.optimizer.zero_grad()
    return held / 2 ** 30, peak / 2 ** 30


def remat_sweep(torch, system_mod, config_path, fa):
    """Phase 12a: XL, frozen conditioner, batch 6 x latent 1248, with no remat
    and each remat policy: from the same weights and batch, the first step's
    loss must be the same bits, its grad norm within 1e-2 relative (K4a's dq
    atomics), K3a / K4a 28 / 28 per step without remat and 56 / 28 under
    each policy (the flash forward reruns in the backward), and the memory
    the forward holds for the backward and the forward and backward's peak
    (activation_memory) each ordered nothing <= save_gemms_lite <=
    save_gemms_h1 <= save_gemms <= no remat. Logs each setting's median
    step ms of 3 after a warm-up step and the step's peak (set by the
    optimizer pass, whatever the policy)."""
    import dataclasses
    import numpy as np
    from maa3_tpu_torch.train.loop import Trainer
    batch, latent = XL_TRAIN
    system = _phase12_system(torch, system_mod, config_path, [NO_COND])
    start = {k: v.clone() for k, v in system.dit.state_dict().items()}
    caps = [LOGGER_CAPTIONS[i % 4] for i in range(batch)]
    raw = {"image": np.random.RandomState(0).randn(batch, 80, 2 * latent).astype(
        np.float32) - 4.0, "caption": {k: [c[k] for c in caps] for k in caps[0]}}
    loader = itertools.repeat(raw)
    rows = {}
    for policy in REMAT_SETTINGS:
        system.dit.load_state_dict(start)
        system.dit.cfg = dataclasses.replace(system.dit.cfg, remat=policy is not None,
                                             remat_policy=policy or "nothing")
        trainer = Trainer(system, batch_size=batch, log_every=1, ckpt_every=0,
                          ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_remat"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps = _timed_steps(torch, fa, trainer, loader, 4)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        held, fb_peak = activation_memory(torch, trainer, raw)
        first = steps[0][2]
        med = statistics.median(ms for ms, _, _ in steps[1:])
        counts = {k: steps[-1][1][k] for k in ("K3a", "K4a")}
        rows[policy] = dict(ms=med, peak=peak, held=held, fb_peak=fb_peak, loss=first["loss"],
                            grad_norm=first["grad_norm"], counts=counts,
                            all_ms=[round(ms, 1) for ms, _, _ in steps])
        log(f"remat {policy or 'off'}: first loss {first['loss']!r} grad norm "
            f"{first['grad_norm']!r}; step ms {rows[policy]['all_ms']} (median of the "
            f"last 3 {med:.1f}, {batch * latent / med * 1e3:.0f} tokens/s); step peak "
            f"{peak:.2f} GiB; forward holds {held:.3f} GiB, forward + backward peak "
            f"{fb_peak:.3f} GiB above the weights and moments; per step {counts}")
        want = {"K3a": 28, "K4a": 28} if policy is None else {"K3a": 56, "K4a": 28}
        require(all(c[1]["K3a"] == want["K3a"] and c[1]["K4a"] == want["K4a"]
                    for c in steps), f"remat {policy}: launches per step {want}")
        require(all(np.isfinite(m["loss"]) for _, _, m in steps), f"remat {policy}: finite")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    ref = rows[None]
    for policy, r in rows.items():
        require(r["loss"] == ref["loss"],
                f"remat {policy}: first loss {r['loss']!r} == no remat's {ref['loss']!r}")
        require(abs(r["grad_norm"] - ref["grad_norm"]) <= 1e-2 * ref["grad_norm"],
                f"remat {policy}: grad norm within 1e-2 of no remat's")
    order = ["nothing", "save_gemms_lite", "save_gemms_h1", "save_gemms", None]
    for key in ("held", "fb_peak"):
        got = [rows[p][key] for p in order]
        require(got == sorted(got), f"{key} ordered {order}: {got}")
    del system, start
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def _timed_loader(loader, waits):
    """Yield loader's batches, appending the host's wait for each to waits."""
    while True:
        s = time.perf_counter()
        try:
            raw = next(loader)
        except StopIteration:
            return
        waits.append(time.perf_counter() - s)
        yield raw


def recipe_run(torch, system_mod, config_path, fa, k1, k2, tsv):
    """Phase 12b: the XL recipe as the YAML writes it, through the training
    CLI's pieces (train/__main__.py build_loader, Trainer, AudioLogger, the
    fit / evaluate interleave): the trainable conditioner, global batch 16 as
    2 micro-batches of 8 at latent 1248, save_gemms_lite, a bf16 first
    moment, the fused GEMMs, the lazy native loader behind 2 PrefetchLoader
    threads; validation every 2 micro-steps over 2 batches, the audio logger
    at micro-step 4 (update 2) on 4 captions, 25 steps."""
    import threading
    import numpy as np
    from maa3_tpu_torch import config as config_mod
    from maa3_tpu_torch.train import __main__ as cli
    from maa3_tpu_torch.train.audio_logger import AudioLogger
    from maa3_tpu_torch.train.loop import Trainer
    r = RECIPE
    up = "model.params.unet_config.params."
    dp = "data.params.train.params.dataset_cfg."
    over = [up + "remat=true", up + f"remat_policy={r['policy']}",
            dp + f"dataset_name={tsv}", dp + f"spec_crop_len={2 * XL_TRAIN[1]}"]
    t = time.perf_counter()
    system = _phase12_system(torch, system_mod, config_path, over)
    cfg = config_mod.load_config([config_path], over)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_recipe")
    trainer = Trainer(system, batch_size=r["micro_batch"], log_every=1, ckpt_every=0,
                      ckpt_dir=ckpt_dir, accum_steps=r["accum_steps"],
                      mu_dtype=torch.bfloat16, fuse_gemms=True)
    require(trainer.state.cond is not None and trainer.state.dit is not system.dit,
            "recipe: the conditioner trains, the DiT trains in the fused layout")
    logger = AudioLogger(ckpt_dir, every_n_steps=r["audio_log_every"])
    log(f"recipe: system and trainer built, {time.perf_counter() - t:.2f} s")
    threads0 = set(threading.enumerate())
    data = config_mod.parse_data_config(cfg)
    moments_dim = 2 * system.spec.vae.embed_dim
    loader = cli.build_loader(data, r["micro_batch"], 0, moments_dim, r["workers"])
    waits, steps, vals, logged = [], [], [], []
    real_log = logger.log_samples

    def log_samples(*a, **kw):  # time the logger and count its launches
        k1.launches = k2.launches = 0
        flash0 = dict(fa.launches)
        torch.cuda.synchronize()
        s = time.perf_counter()
        out = real_log(*a, **kw)
        torch.cuda.synchronize()
        logged.append((out, (time.perf_counter() - s) * 1e3, (k1.launches, k2.launches),
                       {n: fa.launches[n] - flash0[n] for n in FLASH_KERNELS}))
        return out

    logger.log_samples = log_samples

    def params():  # the warm-up LR moves few weights by a representable amount
        return [p.detach().clone() for p in trainer.state.dit.parameters()]

    try:
        feed = _timed_loader(loader, waits)
        torch.cuda.reset_peak_memory_stats()
        for i in range(r["micro_steps"]):
            before = params()
            torch.cuda.synchronize()
            reset_launches(fa)
            n_logged = len(logged)
            s = time.perf_counter()
            m = trainer.fit(feed, max_steps=1, audio_logger=logger,
                            sample_captions=LOGGER_CAPTIONS)
            torch.cuda.synchronize()
            # the step's time and launches without the audio logger's (its
            # sampling runs the serving route), each counted on its own
            ms = (time.perf_counter() - s) * 1e3 - sum(x[1] for x in logged[n_logged:])
            moved = max((a - b).abs().max().item() for a, b in zip(params(), before))
            counts = {n: fa.launches[n] - sum(x[3][n] for x in logged[n_logged:])
                      for n in FLASH_KERNELS}
            steps.append((ms, counts, m, moved))
            require(np.isfinite(m["loss"]), f"recipe micro-step {i + 1}: finite loss")
            require((moved > 0) == ((i + 1) % r["accum_steps"] == 0),
                    f"recipe micro-step {i + 1}: parameters moved {moved:.3e} only on "
                    f"the update's micro-step")
            if (i + 1) % r["val_every"] == 0:
                val = cli.build_loader(config_mod.parse_data_config(cfg, "validation"),
                                       r["micro_batch"], 0, moments_dim, r["workers"])
                try:
                    s = time.perf_counter()
                    vals.append(trainer.evaluate(val, max_batches=r["val_batches"]))
                    vals[-1]["ms"] = (time.perf_counter() - s) * 1e3
                finally:
                    val.close()
                require(np.isfinite(vals[-1]["val/loss_simple"])
                        and vals[-1]["val/batches"] == r["val_batches"],
                        f"recipe: validation {vals[-1]}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        loader.close()
        trainer.close()
    left = set(threading.enumerate()) - threads0
    require(not left, f"recipe: no thread left once the loader is closed: {left}")
    return steps, vals, logged, waits, peak


def check_recipe(steps, vals, logged, waits, peak):
    """Phase 12b's checks and log lines."""
    import numpy as np
    from scipy.io import wavfile
    r = RECIPE
    for i, (ms, counts, m, moved) in enumerate(steps):
        log(f"recipe micro-step {i + 1}: {ms:.1f} ms, loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, largest parameter change {moved:.3e}, launches {counts}")
        require(counts["K3a"] == 56 and counts["K4a"] == 28,
                f"recipe micro-step {i + 1}: K3a 56, K4a 28 ({counts})")
    # an update: its micro-steps (the audio logger's time taken out)
    k = r["accum_steps"]
    per_update = [sum(x[0] for x in steps[i:i + k]) for i in range(0, len(steps), k)]
    tokens = k * r["micro_batch"] * XL_TRAIN[1]
    med = statistics.median(per_update[1:])
    log(f"recipe: ms per update {[round(u, 1) for u in per_update]}; median after the "
        f"first {med:.1f} ms, {tokens / med * 1e3:.0f} tokens/s; peak {peak:.2f} GiB")
    log(f"recipe: host wait on the loader per micro-step ms "
        f"{[round(w * 1e3, 2) for w in waits]}")
    for v in vals:
        log(f"recipe: validation loss {v['val/loss_simple']:.4f} over {v['val/batches']:.0f} "
            f"batches, {v['ms']:.1f} ms")
    require(len(vals) == r["micro_steps"] // r["val_every"], "recipe: every validation ran")
    require(len(logged) == 1, f"recipe: the audio logger ran once ({len(logged)})")
    out, ms, counts, flash = logged[0]
    wavs = sorted(f for f in os.listdir(out) if f.endswith(".wav"))
    log(f"recipe: audio logger at micro-step {r['audio_log_every']}: {len(wavs)} wavs in "
        f"{ms:.1f} ms, K1 {counts[0]}, K2 {counts[1]}, flash {flash}")
    require(wavs == [f"{i:02d}.wav" for i in range(4)], f"recipe: 4 wavs ({wavs})")
    for w in wavs:
        rate, pcm = wavfile.read(os.path.join(out, w))
        require(rate == 16000 and pcm.dtype == np.int16 and pcm.size > 0
                and np.abs(pcm).max() > 0, f"recipe: {w} a 16 kHz int16 wav, not silent")
    require(counts == K1_K2_PER_VOCODE, f"recipe: K1 / K2 per vocode {counts}")
    want = {n: serve_k3a(XL_DEPTH) if n == "K3a" else 0 for n in FLASH_KERNELS}
    require(flash == want, f"recipe: the audio logger's 25-step ODE runs the serving "
            f"route, flash launches {flash} == {want}")
    return {"per_update": per_update, "logger_counts": counts + (flash["K3a"],),
            "micro_step_counts": steps[-1][1]}


def cached_latents(torch, system_mod, config_path, fa, tsv):
    """Phase 12c: encode_latents over the manifest with the XL VAE (the
    training system's: the same seed, unfreeze), then the frozen-conditioner
    6 x 1248 step from those moments and from the mels, the same weights and
    draws: first losses within 1e-4 relative; each path's step ms."""
    import numpy as np
    from maa3_tpu_torch import encode_latents
    from maa3_tpu_torch.data.datasets import TextSpecDataset
    from maa3_tpu_torch.train.loop import Trainer
    batch, latent = XL_TRAIN
    t = time.perf_counter()
    out_tsv = encode_latents.main(
        ["--tsv_path", tsv, "--save_path", os.path.join(os.path.dirname(tsv), "latents"),
         "-b", config_path, "--batch", "16", "--crop_len", str(2 * latent),
         "--device", "cuda"], unfreeze=True)
    torch.cuda.synchronize()
    log(f"cached latents: encode_latents over {PHASE12_MELS[0]} mels, "
        f"{time.perf_counter() - t:.2f} s (system build included)")
    system = _phase12_system(torch, system_mod, config_path, [NO_COND])
    start = {k: v.clone() for k, v in system.dit.state_dict().items()}
    rows = {}
    for name, path in (("mel", tsv), ("moments", out_tsv)):
        ds = TextSpecDataset("train", path, 2 * latent, moments_dim=40)
        raw = ds.collater([ds[i] for i in range(batch)])
        require(("moments" in raw) == (name == "moments"), f"cached latents: {name} batch")
        system.dit.load_state_dict(start)
        trainer = Trainer(system, batch_size=batch, log_every=1, ckpt_every=0,
                          ckpt_dir=os.path.join(os.path.dirname(tsv), "train_" + name))
        steps = _timed_steps(torch, fa, trainer, itertools.repeat(raw), 4)
        rows[name] = dict(loss=steps[0][2]["loss"], ms=[ms for ms, _, _ in steps])
        log(f"cached latents, from {name}: first loss {rows[name]['loss']!r}, step ms "
            f"{[round(x, 1) for x in rows[name]['ms']]}, median of the last 3 "
            f"{statistics.median(rows[name]['ms'][1:]):.1f}")
        require(all(np.isfinite(m["loss"]) for _, _, m in steps), f"{name}: finite")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    a, b = rows["mel"]["loss"], rows["moments"]["loss"]
    require(abs(a - b) <= 1e-4 * abs(a), f"cached latents: losses {a!r} / {b!r} within 1e-4")
    saved = statistics.median(rows["mel"]["ms"][1:]) - statistics.median(rows["moments"]["ms"][1:])
    log(f"cached latents: step saved {saved:.1f} ms; |loss diff| / loss {abs(a - b) / abs(a):.2e}")
    del system, start
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# phase 13: GAN training of the first stage and the vocoder, and the mel
# frontend, at the JAX CLIs' defaults (scripts/train_vae.py,
# scripts/train_vocoder.py, scripts/mel_spec.py)
GAN_ITERS = 20
GAN_B = 8                            # train_vocoder's batch: 8 x 32 frames
GAN_K1_STAGES = [(768, 128), (384, 512), (192, 1024), (96, 2048)]
GAN_K2_STAGES = [(48, 4096), (24, 8192)]
GAN_WAVS = [(16000, 3.0, 1), (16000, 2.5, 2), (22050, 3.0, 1), (16000, 4.0, 1)] * 2
MEL_SPEC_CLIPS = [(22050 if i % 4 == 0 else 16000, 10.0, 2 if i % 3 == 0 else 1)
                  for i in range(16)]


def write_wavs(name: str, specs) -> str:
    """int16 wavs (sample rate, seconds, channels) from the seed and their
    manifest under build/chip_smoke_<name>/ (never the repository's data/)."""
    import numpy as np
    from scipy.io import wavfile
    d = os.path.join(ROOT, "build", f"chip_smoke_{name}")
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(13)
    lines = ["name\taudio_path"]
    for i, (sr, secs, ch) in enumerate(specs):
        t = np.arange(int(sr * secs)) / sr
        w = 0.4 * np.sin(2 * np.pi * (110 + 40 * i) * t * (1 + 0.1 * t))[:, None]
        w = (np.clip(w + 0.05 * rng.randn(len(t), ch), -1, 1) * 32767).astype(np.int16)
        path = os.path.join(d, f"w{i:02d}.wav")
        wavfile.write(path, sr, w[:, 0] if ch == 1 else w)
        lines.append(f"w{i:02d}\t{path}")
    tsv = os.path.join(d, "manifest.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tsv


def _adam_agree(pairs, opts, lr: float, what: str):
    """Parameters of the card against the CPU after one step from the same
    state, phase 7's rule: |cuda - cpu| <= 1e-4 * max(1, max|cpu|) per
    tensor. Adam moves an element by about lr times the sign of its first
    moment, so where the two devices' moments differ by more than a quarter
    of their size (a gradient at rounding noise: exactly zero for an
    attention block's key bias, whose shift softmax ignores) the update's
    direction is noise; those elements, at most 1 % of all, may differ by
    2 lr more. The moments (the gradients) are logged, not held to the
    rule: at initialisation the hinge's constant gradient reaches the
    PatchGAN's third BatchNorm nearly constant per channel, and BatchNorm's
    backward cancels it to a remainder that fp32 resolves poorly (cuDNN and
    the CPU alike); Adam divides the gradient out, so the parameters still
    agree. Returns
    (largest parameter error, such elements, largest moment difference over
    max(1, max|cpu|))."""
    worst, n_free, n_all, m_worst = 0.0, 0, 0, 0.0
    for pc, pg in pairs:
        mc, mg = opts[0].state[pc]["exp_avg"], opts[1].state[pg]["exp_avg"].cpu()
        m_worst = max(m_worst, (mg - mc).abs().max().item() / max(1.0, mc.abs().max().item()))
        free = (mg - mc).abs() > 0.25 * mc.abs()
        d = (pg.detach().cpu() - pc.detach()).abs() - free * (2 * lr)
        worst = max(worst, d.max().item() / max(1.0, pc.detach().abs().max().item()))
        n_free += int(free.sum())
        n_all += pc.numel()
    require(worst <= 1e-4 and n_free <= 0.01 * n_all,
            f"{what}: parameters on the card vs the CPU (error {worst:.3e}, {n_free} "
            f"elements whose update direction is noise)")
    return worst, n_free, m_worst


def _copy_state(dst, src) -> None:
    """A GAN trainer state (vae_gan / vocoder_gan) copied from src into dst
    on dst's device: modules, parameters, optimizers and the step."""
    import copy
    import torch
    for f in dataclasses.fields(src):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if isinstance(b, torch.nn.Module):
            a.load_state_dict(b.state_dict())
        elif isinstance(b, torch.nn.Parameter):
            with torch.no_grad():
                a.copy_(b)
        elif isinstance(b, torch.optim.Optimizer):  # copies: a CPU state loaded
            a.load_state_dict(copy.deepcopy(b.state_dict()))  # as is would alias
        else:
            setattr(dst, f.name, b)


def _two_devices(torch, full_fp32, name, states, steps, batches, lr):
    """Each step from the same state on the CPU (states[0]) and on the card
    (states[1], copied from the CPU's before every step, so that no
    difference carries over) for every batch (a function of the device
    giving the step's arguments after the state): every metric, and the
    stepped optimizer's parameters (_adam_agree)."""
    devs = (torch.device("cpu"), torch.device("cuda"))
    worst, n_free = 0.0, 0
    for it, batch in enumerate(batches):
        for label, fn, opt_of, params_of in steps:
            _copy_state(states[1], states[0])
            with full_fp32():
                ms = [{k: v.item() for k, v in fn(st, *batch(dev)).items()}
                      for st, dev in zip(states, devs)]
            for k, c in ms[0].items():
                require(abs(ms[1][k] - c) <= 1e-4 * max(1.0, abs(c)),
                        f"{name} iteration {it + 1} {k}: cuda {ms[1][k]} cpu {c}")
            w, n, m = _adam_agree(list(zip(params_of(states[0]), params_of(states[1]))),
                                  (opt_of(states[0]), opt_of(states[1])), lr,
                                  f"{name} iteration {it + 1} {label}")
            worst, n_free = max(worst, w), n_free + n
            log(f"GAN reference: {name} iteration {it + 1} {label}: " + ", ".join(
                f"{k} cpu {c:.6f} cuda {ms[1][k]:.6f}" for k, c in ms[0].items())
                + f"; parameters within {w:.2e}, first moments within {m:.2e} of max(1, |cpu|)")
    log(f"GAN reference: {name}: after every step from the same state, every parameter "
        f"of the card within {worst:.2e} x max(1, |cpu|) of the CPU's ({n_free} element "
        f"updates whose direction is rounding noise held to 2 lr more)")


def gan_small_reference(torch, full_fp32):
    """Phase 13 (a): two VAE-GAN iterations (disc_start 0, r1_weight 0.1) and
    two vocoder-GAN iterations of small configs on the card against the CPU,
    fp32 under full_fp32(), each step from the same state, noise and batch
    (_two_devices). The
    card's vocoder disc step runs K1 and K2 (its stages are 64 and 32 wide),
    the CPU's their plain versions."""
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.vae1d import VAEConfig
    from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram
    from maa3_tpu_torch.train import vae_gan, vocoder_gan
    from maa3_tpu_torch.train_vae import init_state as vae_state
    from maa3_tpu_torch.train_vocoder import init_state as voc_state
    vcfg = VAEConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1)
    g = torch.Generator().manual_seed(13)
    mels = [torch.randn(2, 80, 64, generator=g) for _ in range(2)]
    ae, disc = vae_gan.make_vae_gan_steps(vcfg, disc_start=0, r1_weight=0.1)
    _two_devices(torch, full_fp32, "VAE-GAN",
                 [vae_state(vcfg, torch.device(d), 1e-4, 1.0) for d in ("cpu", "cuda")],
                 [("ae step", ae, lambda s: s.vae_opt, lambda s: s.ae_parameters()),
                  ("disc step", disc, lambda s: s.disc_opt, lambda s: list(s.disc.parameters()))],
                 [lambda dev, it=it: (mels[it].to(dev), vae_gan.posterior_noise(vcfg, 2, 64, it))
                  for it in range(2)], 1e-4)
    gcfg = BigVGANConfig(upsample_rates=(16, 16), upsample_kernel_sizes=(32, 32),
                         upsample_initial_channel=128, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    wavs = [(torch.randn(2, 1024, generator=g) * 0.3).clamp(-1, 1) for _ in range(2)]

    def batch(dev, it):
        w = wavs[it].to(dev)
        return ({"wav": w, "mel": mel_spectrogram(w, MelConfig())},)

    gen, disc = vocoder_gan.make_vocoder_gan_steps(MelConfig())
    _two_devices(torch, full_fp32, "vocoder-GAN",
                 [voc_state(gcfg, torch.device(d), 2e-4) for d in ("cpu", "cuda")],
                 [("gen step", gen, lambda s: s.gen_opt, lambda s: list(s.gen.parameters())),
                  ("disc step", disc, lambda s: s.disc_opt, lambda s: s.disc_parameters())],
                 [lambda dev, it=it: batch(dev, it) for it in range(2)], 2e-4)


def _sync_ms(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def vae_gan_run(torch, full_fp32, mel_tsv, card):
    """Phase 13 (b): VAE-GAN at train_vae's defaults (VAE ch 384, batch 8,
    mel_len 624, PatchGAN ndf 64 x 3 layers) with disc_start 0, the CLI's
    loop over phase 12's mels for GAN_ITERS iterations: ms per ae and disc
    step, peak memory, finite losses, and the checkpoint the CLI writes;
    then the CLI itself for 2 iterations. Returns the loop's checkpoint."""
    import numpy as np
    from maa3_tpu_torch import train_vae
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.models.vae1d import VAEConfig
    from maa3_tpu_torch.native.io import NativeLoader
    from maa3_tpu_torch.train.vae_gan import (make_vae_gan_steps, posterior_noise,
                                              vae_gan_checkpoint)
    opt = train_vae.parse_args(["--tsv", mel_tsv])
    dev, cfg = torch.device("cuda"), VAEConfig(ch=opt.ch)
    paths = [r["mel_path"] for r in read_tsv(mel_tsv)]
    loader = NativeLoader(rows=80)
    state = train_vae.init_state(cfg, dev, opt.lr, opt.lr_multiplier)
    ae_step, disc_step = make_vae_gan_steps(cfg, kl_weight=opt.kl_weight,
                                            disc_weight=opt.disc_weight, disc_start=0)
    rng = np.random.RandomState(0)
    torch.cuda.reset_peak_memory_stats()
    times, metrics = [], []
    for it in range(GAN_ITERS):
        idx = rng.randint(0, len(paths), opt.batch_size)
        mel = torch.from_numpy(loader.load_batch([paths[i] for i in idx], opt.mel_len,
                                                 mode="tile")).to(dev)
        noise = posterior_noise(cfg, opt.batch_size, opt.mel_len, it)
        with full_fp32():
            m_ae, t_ae = _sync_ms(torch, lambda: ae_step(state, mel, noise))
            m_d, t_d = _sync_ms(torch, lambda: disc_step(state, mel, noise))
        times.append((t_ae, t_d))
        metrics.append({k: v.item() for k, v in {**m_ae, **m_d}.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_vae")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = train_vae.save(ckpt_dir, vae_gan_checkpoint(state), GAN_ITERS)
    require(all(np.isfinite(v) for m in metrics for v in m.values()),
            "VAE-GAN losses are finite")
    require(sorted(torch.load(path, weights_only=True)) == ["disc", "logvar", "vae"],
            "the VAE-GAN checkpoint holds vae, disc and logvar")
    tail = times[1:]
    log(f"VAE-GAN (VAE ch {opt.ch}, batch {opt.batch_size} x {opt.mel_len} frames, PatchGAN "
        f"ndf 64 x 3, disc_start 0, fp32): median ae step "
        f"{statistics.median(t for t, _ in tail):.1f} ms, disc step "
        f"{statistics.median(t for _, t in tail):.1f} ms (first iteration {times[0][0]:.1f} + "
        f"{times[0][1]:.1f} ms), peak {peak:.2f} GiB, on {card}; losses finite; "
        f"first {metrics[0]}, last {metrics[-1]}")
    cli = train_vae.main(["--tsv", mel_tsv, "--steps", "2", "--disc_start", "0",
                          "--ckpt_dir", os.path.join(ckpt_dir, "cli"), "--device", "cuda"])
    require(os.path.isfile(cli), "python -m maa3_tpu_torch.train_vae wrote its checkpoint")
    return path


def vocoder_gan_run(torch, full_fp32, k1, k2, card):
    """Phase 13 (c): vocoder GAN at train_vocoder's defaults (BigVGAN 1536,
    batch 8 x 32 frames, MPD (2, 3, 5, 7, 11), MRD of three resolutions),
    the CLI's loop over int16 wavs written from the seed for GAN_ITERS
    iterations: ms per gen and disc step, peak memory, K1 / K2 launches per
    step (72 / 37 per disc step, 0 / 0 per gen step), the disc step's fake
    wav from the kernels against the plain route at 1e-3; then the CLI
    itself for 2 iterations (K1 / K2 twice 72 / 37 in all)."""
    import numpy as np
    from maa3_tpu_torch import train_vocoder
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig, bigvgan_apply
    from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram
    from maa3_tpu_torch.train.vocoder_gan import make_vocoder_gan_steps
    tsv = write_wavs("wavs", GAN_WAVS)
    opt = train_vocoder.parse_args(["--tsv", tsv])
    dev = torch.device("cuda")
    cfg, mel_cfg = BigVGANConfig(upsample_initial_channel=opt.upsample_initial_channel), MelConfig()
    hop = mel_cfg.hop_size
    seg = opt.segment_frames * hop
    wavs = train_vocoder.read_wavs([r["audio_path"] for r in read_tsv(tsv)], seg + hop)
    require(len(wavs) == len(GAN_WAVS), "every written wav is read")
    state = train_vocoder.init_state(cfg, dev, opt.lr)
    gen_step, disc_step = make_vocoder_gan_steps(mel_cfg)
    rng = np.random.RandomState(0)
    torch.cuda.reset_peak_memory_stats()
    times, counts, metrics = [], [], []
    for it in range(GAN_ITERS):
        wav = torch.from_numpy(train_vocoder.draw_batch(rng, wavs, opt.batch_size, seg,
                                                        hop)).to(dev)
        with full_fp32():
            batch = {"mel": mel_spectrogram(wav, mel_cfg)[:, :, :opt.segment_frames],
                     "wav": wav}
            k1.launches = k2.launches = 0
            mg, t_g = _sync_ms(torch, lambda: gen_step(state, batch))
            n_g = (k1.launches, k2.launches)
            md, t_d = _sync_ms(torch, lambda: disc_step(state, batch))
        counts.append((n_g, (k1.launches - n_g[0], k2.launches - n_g[1])))
        times.append((t_g, t_d))
        metrics.append({k: v.item() for k, v in {**mg, **md}.items()})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for n_g, n_d in counts:
        require(n_g == (0, 0) and n_d == K1_K2_PER_VOCODE,
                f"vocoder GAN launches per step: gen {n_g} == (0, 0), disc {n_d} == "
                f"{K1_K2_PER_VOCODE}")
    require(all(np.isfinite(v) for m in metrics for v in m.values()),
            "vocoder GAN losses are finite")
    with torch.no_grad(), full_fp32():  # the disc step's fake wav: kernels vs plain
        fake = bigvgan_apply(state.gen, batch["mel"])
        plain = bigvgan_apply(state.gen, batch["mel"], kernels=False)
    err = (fake - plain).abs().max().item()
    require(err <= 1e-3 and tuple(fake.shape) == (opt.batch_size, seg),
            f"the disc step's fake wav through K1 / K2 vs the plain route: {err:.3e}")
    tail = times[1:]
    out = {"gen_ms": statistics.median(t for t, _ in tail),
           "disc_ms": statistics.median(t for _, t in tail), "peak_gib": peak,
           "disc_counts": counts[-1][1]}
    log(f"vocoder GAN (BigVGAN {opt.upsample_initial_channel}, batch {opt.batch_size} x "
        f"{opt.segment_frames} frames = {seg} samples, MPD + MRD, fp32): median gen step "
        f"{out['gen_ms']:.1f} ms, disc step {out['disc_ms']:.1f} ms (first iteration "
        f"{times[0][0]:.1f} + {times[0][1]:.1f} ms), peak {peak:.2f} GiB, on {card}; "
        f"K1 / K2 per gen step {counts[-1][0]}, per disc step {counts[-1][1]}; the disc "
        f"step's fake wav {tuple(fake.shape)} through the kernels vs the plain route max "
        f"|d| {err:.3e} (1e-3); first {metrics[0]}, last {metrics[-1]}")
    del state
    k1.launches = k2.launches = 0
    cli = train_vocoder.main(["--tsv", tsv, "--steps", "2", "--device", "cuda",
                              "--ckpt_dir", os.path.join(ROOT, "build", "chip_smoke_vocoder")])
    n = (k1.launches, k2.launches)
    require(os.path.isfile(cli) and n == tuple(2 * c for c in K1_K2_PER_VOCODE),
            f"python -m maa3_tpu_torch.train_vocoder: checkpoint and K1 / K2 {n}")
    return out


def mel_spec_run(torch, card):
    """Phase 13 (d): python -m maa3_tpu_torch.mel_spec over MEL_SPEC_CLIPS
    (16 clips of 10 s, a quarter at 22.05 kHz, a third stereo) in its
    default batch of 16, twice (cold, then warm): clips per second, and one
    clip's mel against the CPU's frontend at 1e-4 x max(1, max|cpu|)."""
    import numpy as np
    from maa3_tpu_torch import mel_spec
    from maa3_tpu_torch.ops.stft import MelConfig, mel_spectrogram
    tsv = write_wavs("clips", MEL_SPEC_CLIPS)
    out = os.path.join(ROOT, "build", "chip_smoke_clips", "mels")
    secs = []
    for _ in range(2):  # the first run imports scipy.signal and builds the bases
        t = time.perf_counter()
        done = mel_spec.main(["--tsv_path", tsv, "--save_path", out, "--device", "cuda",
                              "--out_tsv", os.path.join(out, "manifest.tsv")])
        secs.append(time.perf_counter() - t)
        require(done == len(MEL_SPEC_CLIPS), f"mel_spec wrote {done} mels")
    opt = mel_spec.parse_args(["--tsv_path", tsv, "--save_path", out])
    seg = (int(opt.duration * opt.audio_sample_rate / opt.hop_size) + 1) * opt.hop_size
    wav = mel_spec.fit_length(mel_spec.load_audio(
        os.path.join(ROOT, "build", "chip_smoke_clips", "w00.wav"), 16000), seg, 256, "pad")
    want = mel_spectrogram(torch.from_numpy(wav)[None], MelConfig())[0].numpy()
    got = np.load(os.path.join(out, "w00_mel.npy"))
    err = float(np.abs(got - want).max())
    require(got.shape == (80, seg // 256) and err <= 1e-4 * max(1.0, float(np.abs(want).max())),
            f"a mel_spec clip (22.05 kHz, stereo) against the CPU: {err:.3e}")
    log(f"mel_spec: {done} clips of 10 s (22.05 kHz resampled for "
        f"{sum(sr != 16000 for sr, _, _ in MEL_SPEC_CLIPS)}) in {secs[0]:.2f} s cold, "
        f"{secs[1]:.2f} s warm: {done / secs[1]:.1f} clips/s end to end (the host's wav "
        f"reading and resampling included), on {card}; clip w00 (22.05 kHz stereo) "
        f"{got.shape} vs the CPU max |d| {err:.3e}")


def vae_handoff(torch, config_path, vae_ckpt, mel_tsv):
    """Phase 13 (e): one step of the training CLI (XL config, DiT cut to
    depth 2, frozen conditioner, batch 2) with --vae_ckpt of (b)'s file:
    the trainer's frozen VAE (its last.pt's frozen section) equals the
    file's, tensor for tensor."""
    from maa3_tpu_torch.train import __main__ as train_cli
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_handoff")
    m = train_cli.main(["-b", config_path, "--vae_ckpt", vae_ckpt, "--max_steps", "1",
                        "--batch_size", "2", "--device", "cuda", "--ckpt_every", "0",
                        "--log_every", "1",
                        "--ckpt_dir", ckpt_dir, "model.params.unet_config.params.depth=2",
                        NO_COND,
                        f"data.params.train.params.dataset_cfg.dataset_name={mel_tsv}"])
    want = torch.load(vae_ckpt, weights_only=True)["vae"]
    frozen = torch.load(os.path.join(ckpt_dir, "last.pt"), weights_only=True,
                        mmap=True)["frozen"]["vae"]
    same = sorted(frozen) == sorted(want) and all(torch.equal(frozen[k], v)
                                                  for k, v in want.items())
    require(same and m["step"] == 1, "the trainer's frozen VAE equals the train_vae file's")
    log(f"hand-off: python -m maa3_tpu_torch.train --vae_ckpt (XL, depth 2, frozen "
        f"conditioner) took one step (loss {m['loss']:.4f}); its frozen VAE equals the "
        f"file's ({len(want)} tensors)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


# phase 14: int8 serving and video-to-audio with the MoE DiT
QUANT_MODES = ("int8", "int8:g128", "int8:now2", "int8:smooth", "int8:voc")
V2A_CLIPS, V2A_FRAMES = 4, 40       # feature files of 40 x 512 (4 fps x 10 s)
V2A_SAMPLES = 159744                # latent 312 -> mel 624 -> 10 s at 16 kHz
MOE_TRAIN = (16, 312)               # the video YAML's batch x (spec_crop_len 624 / 2)
SMALL_OVER = ["model.params.unet_config.params." + kv for kv in (
    "hidden_size=64", "depth=2", "num_heads=4", "context_dim=32", "multiple_of=32")] + [
    "model.params.first_stage_config.params.ddconfig." + kv for kv in (
        "ch=32", "ch_mult=[1, 2]", "num_res_blocks=1")]


def _within(got, want, what: str, rel: float = 1e-3) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs().max().item()
    require(err <= rel * max(1.0, want.abs().max().item()),
            f"{what}: max |cuda - cpu| {err:.3e}")
    return err


def quant_moe_small_reference(torch, system_mod, config_path, video_path, fa, full_fp32):
    """Phase 14 (a): fp32, the card against the CPU: the w8a8 product and
    convs (the same int8 codes; outputs within 1e-3 x max(1, |cpu|)); a small
    text system in int8 and int8:g32,voc and a small video MoE system, each
    card vs CPU; one MoE training step with flash forced (K3a, K4a) against
    the same step with dense attention on the card."""
    import copy
    from maa3_tpu_torch.models.bigvgan import BigVGANConfig
    from maa3_tpu_torch.models.bert import BertConfig
    from maa3_tpu_torch.models.clap import CLAPFLANConfig
    from maa3_tpu_torch.models.t5 import T5Config
    from maa3_tpu_torch.ops import conv, quant
    g = torch.Generator().manual_seed(14)
    for m, group in ((4, 0), (2496, 0), (8, 128), (2496, 128)):
        w = torch.randn(1152, 1152, generator=g) * 0.03
        x = torch.randn(m, 1152, generator=g) * (torch.rand(1152, generator=g) * 4)
        qc, qg = quant.quantize_weight_int8(w, group), quant.quantize_weight_int8(w.cuda(), group)
        require(torch.equal(qc.w_q, qg.w_q.cpu()), f"int8 codes (m {m}, group {group})")
        err = _within(quant.dense_w8a8(x.cuda(), qg), quant.dense_w8a8(x, qc),
                      f"dense_w8a8 m {m} group {group}")
        log(f"int8 reference: dense_w8a8 ({m}, 1152) x (1152, 1152) group {group}: codes "
            f"equal, max |cuda - cpu| {err:.2e}")
    for c, k, d in ((768, 3, 1), (384, 11, 5), (192, 7, 3)):
        w = torch.randn(c, c, k, generator=g) / (c * k) ** 0.5
        b = torch.randn(c, generator=g)
        x = torch.randn(2, c, 512, generator=g)
        qc, qg = conv.quantize_conv_int8(w, b), conv.quantize_conv_int8(w.cuda(), b.cuda())
        require(torch.equal(qc.w_q, qg.w_q.cpu()), f"conv int8 codes (C {c}, k {k})")
        for fn in (conv.conv1d_unfold_w8a8, conv.conv1d_tapgemm_w8a8):
            err = _within(fn(qg, x.cuda(), padding=(k * d - d) // 2, dilation=d),
                          fn(qc, x, padding=(k * d - d) // 2, dilation=d),
                          f"{fn.__name__} C {c} k {k} d {d}")
            log(f"int8 reference: {fn.__name__} C {c} k {k} d {d}: max |cuda - cpu| {err:.2e}")
    clap = CLAPFLANConfig(bert=BertConfig(hidden_size=32, num_layers=2, num_heads=4,
                                          intermediate_size=64),
                          t5=T5Config(d_model=32, d_kv=8, d_ff=48, num_layers=2,
                                      num_heads=4), d_proj=32)
    voc = BigVGANConfig(upsample_rates=(4, 2, 2), upsample_kernel_sizes=(8, 4, 4),
                        upsample_initial_channel=256)
    prompts = {"ori_caption": ["a dog barks", "rain on a tin roof"],
               "struct_caption": ["<dog barks& all>", "<rain& all>"]}
    empty = {"ori_caption": [""] * 2, "struct_caption": [""] * 2}
    x0 = torch.randn(2, 20, 24, generator=g)
    feat = torch.randn(2, 8, 512, generator=g)
    os.environ["MAA3_VOC_QUANT_MIN_CH"] = "64"   # the small vocoder's stages quantized
    try:
        for cfg, mode, c_in, u_in in ((config_path, "int8", prompts, empty),
                                      (config_path, "int8:g32,voc", prompts, empty),
                                      (video_path, None, feat, 0 * feat),
                                      (video_path, "int8", feat, 0 * feat)):
            sys_g = system_mod.MAA3System.from_config(
                [cfg], SMALL_OVER, seed=1, compute_dtype=torch.float32, device="cuda",
                clap_cfg=clap, voc_cfg=voc, unfreeze=True)
            sys_c = system_mod.MAA3System(
                sys_g.spec, *(copy.deepcopy(m).cpu() for m in
                              (sys_g.dit, sys_g.vae, sys_g.vocoder, sys_g.cond)),
                compute_dtype=torch.float32)
            outs = []
            for s in (sys_c, sys_g):
                s.set_serving_quant(mode)
                c = s.get_learned_conditioning(c_in)
                uc = s.get_learned_conditioning(u_in)
                z = s.sample_cfg(c, 4.5, uc, x0=x0.to(s.device), timesteps=6)
                outs.append((z.cpu(), s.vocode(s.decode_first_stage(z))))
            codes = [quant.quant_weights(s.serving_dit()) for s in (sys_c, sys_g)]
            for name, q in codes[0].items():
                require(torch.equal(q.w_q, codes[1][name].w_q.cpu()), f"serving codes {name}")
            err = _within(outs[1][0], outs[0][0], f"{cfg} {mode} latent")
            import numpy as np
            werr = float(np.abs(outs[1][1] - outs[0][1]).max())
            require(werr <= 1e-3, f"{cfg} {mode} wav: {werr:.3e}")
            log(f"int8 / MoE reference: {os.path.basename(cfg)} mode {mode}: "
                f"{len(codes[0])} int8 weights equal, latent max |cuda - cpu| {err:.2e}, "
                f"wav {werr:.2e}")
    finally:
        os.environ.pop("MAA3_VOC_QUANT_MIN_CH")
    # one MoE training step, flash forced vs dense, on the card
    from maa3_tpu_torch.train.loop import Trainer
    base = system_mod.MAA3System.from_config(
        [video_path], SMALL_OVER + ["model.params.scale_by_std=false"], seed=2,
        compute_dtype=torch.float32, device="cuda", voc_cfg=voc, unfreeze=True)
    raw = {"image": torch.randn(2, 80, 96, generator=g).numpy(),
           "video_feat": torch.randn(2, 6, 512, generator=g).numpy()}
    draws = {"noise": torch.randn(2, 20, 48, generator=g).cuda(),
             "t_int": torch.tensor([120, 870]).cuda(),
             "x0": torch.randn(2, 20, 48, generator=g).cuda()}
    res = {}
    for flash in (True, False):
        s = system_mod.MAA3System(base.spec, copy.deepcopy(base.dit), base.vae,
                                  base.vocoder, copy.deepcopy(base.cond),
                                  compute_dtype=torch.float32)
        s.dit.cfg = dataclasses.replace(s.dit.cfg, use_flash=flash)
        tr = Trainer(s, batch_size=2, lr_multiplier=1.0, warm_up_steps=0, ckpt_every=0,
                     ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_moe_ref"))
        reset_launches(fa)
        with full_fp32():
            m = tr.train_step(raw, draws=draws)
        res[flash] = ({k: v.item() for k, v in m.items()}, dict(fa.launches),
                      [(p.detach().clone(), p.grad.clone()) for p in tr.state.trainable_parameters()])
    require(res[True][1]["K3a"] == 2 and res[True][1]["K4a"] == 2
            and res[False][1] == {k: 0 for k in FLASH_KERNELS},
            f"MoE step launches: forced flash {res[True][1]}, dense {res[False][1]}")
    for k in ("loss", "grad_norm"):
        a, b = res[True][0][k], res[False][0][k]
        require(abs(a - b) <= 1e-4 * abs(b), f"MoE flash step {k}: {a} vs dense {b}")
    lr = base.spec.base_learning_rate  # lr_multiplier 1, no warm-up
    worst, n_free, n_all = 0.0, 0, 0
    for (pf, gf), (pd, gd) in zip(res[True][2], res[False][2]):
        free = (gf - gd).abs() > 0.25 * gd.abs()
        d = (pf - pd).abs() - free * (2 * lr)
        worst = max(worst, d.max().item() / max(1.0, pd.abs().max().item()))
        n_free, n_all = n_free + int(free.sum()), n_all + pd.numel()
    require(worst <= 1e-4 and n_free <= 0.01 * n_all,
            f"MoE flash step parameters vs dense ({worst:.2e}, {n_free} noise elements)")
    log(f"MoE reference: one training step with flash forced (K3a {res[True][1]['K3a']}, "
        f"K4a {res[True][1]['K4a']}) vs dense attention on the card: loss "
        f"{res[True][0]['loss']:.6f} / {res[False][0]['loss']:.6f}, parameters within "
        f"{worst:.2e} ({n_free} of {n_all} updates at gradient noise)")
    return res[True][1]


def int8_serving(torch, system_mod, config_path, k1, k2, card, profile=False):
    """Phase 14 (b): the XL system of phase 5 in bf16 and each int8 mode from
    the same weights and noise; then the ODE alone at batch 16, bf16 and
    int8 (with profile, one more of each under torch.profiler). Returns
    {mode: (K1, K2, K3a) launches per request}."""
    import numpy as np
    from maa3_tpu_torch.ops import flash_attention as fa, quant
    system = system_mod.MAA3System.from_config(
        [config_path], seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    caps = ["a dog barks in the distance", "rain falls on a tin roof",
            "a crowd cheers at a stadium", "an engine idles then revs up"]
    prompts = {"ori_caption": caps, "struct_caption": [f"<{p}& all>" for p in caps]}
    empty = {"ori_caption": [""] * B, "struct_caption": [""] * B}
    x0 = torch.randn(B, 20, LATENT, generator=torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    c, uc = system.get_learned_conditioning(prompts), system.get_learned_conditioning(empty)

    def request():
        times = {}
        s0 = time.perf_counter()
        cc = system.get_learned_conditioning(prompts)
        ucc = system.get_learned_conditioning(empty)
        z, times["ode"] = _sync_ms(torch, lambda: system.sample_cfg(cc, 5.0, ucc, x0=x0,
                                                                    timesteps=25))
        wav = system.vocode(system.decode_first_stage(z))
        torch.cuda.synchronize()
        times["end_to_end"] = (time.perf_counter() - s0) * 1e3
        return z, wav, times

    out, counts = {}, {}
    for mode in (None,) + QUANT_MODES:
        system.set_serving_quant(mode)
        if mode == "int8:smooth":
            _, ms = _sync_ms(torch, lambda: system.calibrate_smooth(c, uc, x0=x0, timesteps=25))
            log(f"int8 serving: calibrate_smooth (one 25-step ODE with stats) {ms:.1f} ms")
        _, ms = _sync_ms(torch, system.serving_dit)
        request()  # warm-up: the serving copies, cuBLAS handles
        k1.launches = k2.launches = fa.launches["K3a"] = 0
        n_mm = quant.int_mm_calls
        z, wav, times = request()
        counts[mode] = (k1.launches, k2.launches, fa.launches["K3a"])
        require(torch.isfinite(z).all() and np.isfinite(wav).all()
                and wav.shape == (B, 159744) and 0 < np.abs(wav).max() <= 1.0,
                f"int8 serving {mode}: outputs")
        require(counts[mode] == K1_K2_PER_VOCODE + (serve_k3a(XL_DEPTH),),
                f"int8 serving {mode}: K1/K2/K3a {counts[mode]} == {K1_K2_PER_VOCODE} + "
                f"{serve_k3a(XL_DEPTH)}")
        out[mode] = z.float()
        rel = (z.float() - out[None]).norm().item() / out[None].norm().item()
        mm = quant.int_mm_calls - n_mm
        require((mm > 0) == (mode is not None), f"int8 serving {mode}: {mm} int8 products")
        log(f"int8 serving ({card}) mode {mode or 'bf16'}: end to end "
            f"{times['end_to_end']:.2f} ms, ODE {times['ode']:.2f} ms, latent rel L2 vs "
            f"bf16 {rel:.3e}, _int_mm launches per request {mm}, K1 {counts[mode][0]} "
            f"K2 {counts[mode][1]} K3a {counts[mode][2]}, serving copy built in {ms:.0f} ms")
    c16, uc16 = c.repeat(4, 1, 1), uc.repeat(4, 1, 1)
    x16 = torch.randn(16, 20, LATENT, generator=torch.Generator(device="cuda").manual_seed(1),
                      device="cuda")
    for mode in (None, "int8"):
        system.set_serving_quant(mode)
        run = lambda: system.sample_cfg(c16, 5.0, uc16, x0=x16, timesteps=25)  # noqa: E731
        run()
        times = [_sync_ms(torch, run)[1] for _ in range(2)]
        log(f"int8 serving ({card}) batch 16 ODE, mode {mode or 'bf16'}: "
            f"{', '.join(f'{t:.1f}' for t in times)} ms")
        if profile:
            log(f"profile: batch 16 ODE, mode {mode or 'bf16'}")
            profile_run(torch, lambda _counted: run(), min(times))
    system.set_serving_quant(None)
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def write_video_files(name: str, clips: int, feat_frames: int, mel_frames: int,
                      with_split: bool = False) -> str:
    """Features (clips x (feat_frames, 512) .npz, plus empty_vid.npz) and GT
    mels ((80, mel_frames) .npy) from the seed under build/chip_smoke_<name>/:
    video2audio's feats/ and mels/, or with_split VideoSpecDataset's
    mel_maa2/npy/, cavp/ and Train.txt."""
    import numpy as np
    d = os.path.join(ROOT, "build", f"chip_smoke_{name}")
    shutil.rmtree(d, ignore_errors=True)
    feats = os.path.join(d, "cavp" if with_split else "feats")
    mels = os.path.join(d, "mel_maa2", "npy") if with_split else os.path.join(d, "mels")
    os.makedirs(feats)
    os.makedirs(mels)
    rng = np.random.RandomState(14)
    names = [f"clip{i:02d}" for i in range(clips)]
    for n in names:
        np.savez(os.path.join(feats, n + ".npz"),
                 feat=rng.randn(feat_frames, 512).astype(np.float32))
        np.save(os.path.join(mels, n + "_mel.npy"),
                (rng.randn(80, mel_frames) - 4.0).astype(np.float32))
    np.savez(os.path.join(feats, "empty_vid.npz"), feat=np.zeros((feat_frames, 512), np.float32))
    if with_split:
        with open(os.path.join(d, "Train.txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return d


def video2audio_run(torch, video_path, k1, k2, card):
    """Phase 14 (c): python -m maa3_tpu_torch.video2audio at the config's full
    width (MoE DiT 768 x 16 x 32 heads, 4 + 4 experts; XL VAE; BigVGAN 1536)
    over 4 feature files, plain and --inpaint over GT mels: one 10 s 16 kHz
    wav per clip, K1 / K2 72 / 37 per vocode, ms per clip."""
    import io
    import wave
    from maa3_tpu_torch import video2audio
    d = write_video_files("v2a", V2A_CLIPS, V2A_FRAMES, 625)
    per_vocode = {}
    for mode, extra in (("plain", []), ("inpaint", ["--inpaint", "--mel_gt_dir",
                                                     os.path.join(d, "mels")])):
        out = os.path.join(d, f"out_{mode}")
        k1.launches = k2.launches = 0
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            video2audio.main(["--feat_dir", os.path.join(d, "feats"), "--outdir", out,
                              "-b", video_path, *extra])
        wall = time.perf_counter() - t
        per_vocode[mode] = (k1.launches // V2A_CLIPS, k2.launches // V2A_CLIPS)
        require((k1.launches, k2.launches) == tuple(V2A_CLIPS * n for n in K1_K2_PER_VOCODE),
                f"video2audio {mode}: K1/K2 {k1.launches}/{k2.launches} over {V2A_CLIPS} vocodes")
        secs = [float(x) for x in re.findall(r"-> \S+\.wav \(([\d.]+) s\)", buf.getvalue())]
        require(sorted(os.listdir(out)) == [f"clip{i:02d}.wav" for i in range(V2A_CLIPS)]
                and len(secs) == V2A_CLIPS, f"video2audio {mode}: one wav per clip")
        for f in os.listdir(out):
            with wave.open(os.path.join(out, f)) as w:
                require((w.getframerate(), w.getnframes()) == (16000, V2A_SAMPLES),
                        f"video2audio {mode}: {f} is 10 s at 16 kHz")
        log(f"video2audio ({card}) {mode}: {V2A_CLIPS} clips in {wall:.2f} s with the "
            f"system's build; ms per clip {', '.join(f'{s * 1e3:.1f}' for s in secs)}; "
            f"K1 / K2 per vocode {per_vocode[mode]}")
    gc.collect()
    torch.cuda.empty_cache()
    return per_vocode


def moe_train_run(torch, system_mod, video_path, fa, card):
    """Phase 14 (d): the video MoE at full width and depth, bf16, batch 16 x
    latent 312 from VideoSpecDataset over files written from the seed
    (truncate 624 x 256 samples), one warm step and three timed."""
    from maa3_tpu_torch.data.video_dataset import VideoSpecDataset
    from maa3_tpu_torch.train.loop import Trainer
    bsz, lat = MOE_TRAIN
    d = write_video_files("moe_train", 2 * bsz, V2A_FRAMES, 700, with_split=True)
    ds = VideoSpecDataset("train", d, d, truncate=2 * lat * 256, drop=0.2, seed=0)
    system = system_mod.MAA3System.from_config(
        [video_path], seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    n_par = sum(p.numel() for p in system.dit.parameters())
    tr = Trainer(system, batch_size=bsz, warm_up_steps=0, ckpt_every=0, log_every=10 ** 6,
                 ckpt_dir=os.path.join(d, "ckpt"))
    start = [p.detach().clone() for p in tr.state.trainable_parameters()]
    batches = [ds.collater([ds[(i * bsz + j) % len(ds)] for j in range(bsz)]) for i in range(4)]
    require(batches[0]["image"].shape == (bsz, 80, 2 * lat), "MoE batch shape")
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i, raw in enumerate(batches):
        reset_launches(fa)
        m, ms = _sync_ms(torch, lambda: tr.train_step(raw, seed=0))
        loss = m["loss"].item()
        require(loss == loss and abs(loss) < float("inf"), f"MoE step {i} loss finite")
        steps.append((ms, loss, dict(fa.launches)))
    moved = max((p.detach() - s).abs().max().item()
                for p, s in zip(tr.state.trainable_parameters(), start))
    require(moved > 0, "MoE training moved the parameters")
    timed = [ms for ms, _, _ in steps[1:]]
    med = statistics.median(timed)
    log(f"MoE training ({card}): MoE DiT {n_par / 1e6:.1f} M parameters, batch {bsz} x "
        f"latent {lat}, bf16: warm step {steps[0][0]:.1f} ms, timed "
        f"{', '.join(f'{t:.1f}' for t in timed)} ms (median {med:.1f}), "
        f"{bsz * lat / med * 1e3:.0f} tokens/s, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, losses "
        f"{', '.join(f'{l:.4f}' for _, l, _ in steps)}, parameters moved up to "
        f"{moved:.2e}, flash launches {steps[-1][2]}")
    del tr, system
    gc.collect()
    torch.cuda.empty_cache()



# phase 15: evaluation (CLAP score, FD / KL over VGGishish and Melception,
# LPAPS, the classifier trainer and metrics, caption structuring)
EVAL_CLIPS = 8                      # 2 x the XL batch of 4, 10 s each
EVAL_CAPTIONS = ["a dog barks in the distance", "rain falls on a tin roof",
                 "a crowd cheers at a stadium", "an engine idles then revs up",
                 "birds sing while a stream flows", "a door slams followed by footsteps",
                 "thunder rolls as wind blows", "a phone rings, then a man speaks"]
MELCLF_LABELS = ("dog", "rain", "engine", "crowd")


def eval_small_reference(torch, full_fp32):
    """Phase 15 (a): the eval towers at full width, fp32 without TF32, the
    card against the CPU on the same weights (serving rule 1e-3 x max(1,
    max|cpu|)): Cnn14 on 2 x 5 s, the CLAP text tower, the CLAP score,
    VGGishish on (8, 80, 624) with running statistics and without, the
    Melception's logits, features and aux, LPAPS. Returns the card's
    CLAPScorer (full width, random towers)."""
    import numpy as np
    from maa3_tpu_torch.eval import lpaps
    from maa3_tpu_torch.eval.clap_score import CLAPScorer
    from maa3_tpu_torch.models import cnn14, melception, melclf
    g = torch.Generator().manual_seed(15)
    mel8 = torch.randn(8, 80, 624, generator=g) * 2.0 - 4.0
    mel4 = mel8[:4]
    wav = torch.randn(2, 5 * 44100, generator=g) * 0.3

    def with_stats(m):
        for name, buf in m.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=g) * 0.2
                      + (0.9 if name.endswith("var") else -0.1))
        return m

    clf = melclf.melclf_init_(melclf.MelClf(), g)
    clf_rs = with_stats(melclf.melclf_init_(melclf.MelClf(running_stats=True), g))
    runs = [
        ("Cnn14 2 x 5 s", cnn14.cnn14_init_(cnn14.Cnn14(), g),
         lambda m, w: tuple(cnn14.cnn14_apply(m, w).values()), (wav,)),
        ("VGGishish (8, 80, 624) batch statistics", clf,
         lambda m, x: melclf.melclf_apply(m, x, True), (mel8,)),
        ("VGGishish (8, 80, 624) running statistics", clf_rs,
         lambda m, x: melclf.melclf_apply(m, x, True), (mel8,)),
        ("Melception (4, 80, 624) logits, features, aux",
         melception.melception_init_(melception.Melception(), g),
         lambda m, x: melception.melception_apply(m, x, True, True), (mel4,)),
        ("LPAPS (4, 80, 624)", lpaps.lpaps_init_(lpaps.LPAPS(), g), lpaps.lpaps_apply,
         (mel4, mel4.flip(0)))]
    with torch.no_grad(), full_fp32():
        for what, model, fn, args in runs:
            want = fn(model, *args)
            got = fn(model.to("cuda"), *(a.to("cuda") for a in args))
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = [_within(gt, wt, what) for gt, wt in zip(got, want)]
            log(f"eval reference: {what}: max |cuda - cpu| "
                f"{', '.join(f'{e:.3e}' for e in errs)}")
            model.cpu()
    cpu = CLAPScorer.random_init(torch.Generator().manual_seed(1), device="cpu")
    card = CLAPScorer.random_init(torch.Generator().manual_seed(1), device="cuda")
    rng = np.random.RandomState(15)
    wavs = [(0.3 * rng.randn(160000)).astype(np.float32) for _ in range(2)]
    caps = EVAL_CAPTIONS[:4]
    for what, fn in (("CLAP text tower", lambda s: s.text_embeddings(caps)),
                     ("CLAP audio tower", lambda s: s.audio_embeddings(wavs[:2])),
                     ("CLAP score", lambda s: torch.from_numpy(s.score(wavs, caps[:2])))):
        log(f"eval reference: {what}: max |cuda - cpu| {_within(fn(card), fn(cpu), what):.3e}")
    return card


def eval_generate(torch, system_mod, config_path, k1, k2, d):
    """Phase 15 (b) 1-2: phase 5's XL system turns EVAL_CAPTIONS into 8 clips
    of 10 s (2 x batch 4); their int16 wavs <name>_0.wav, the manifest
    (name, ori_cap, audio_path) and the VAE's mels under d. Returns the
    manifest and the K1 / K2 launches of the two vocodes and the K3a
    launches of the two ODEs."""
    import numpy as np
    from scipy.io import wavfile
    from maa3_tpu_torch.ops import flash_attention as fa
    system = system_mod.MAA3System.from_config(
        [config_path], seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    for sub in ("wavs", "gen_mels"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1.launches = k2.launches = fa.launches["K3a"] = 0
    lines = ["name\tori_cap\taudio_path"]
    t = time.perf_counter()
    for b in range(0, EVAL_CLIPS, B):
        caps = EVAL_CAPTIONS[b:b + B]
        c = system.get_learned_conditioning({"ori_caption": caps, "struct_caption":
                                             [f"<{p}& all>" for p in caps]})
        uc = system.get_learned_conditioning({"ori_caption": [""] * B,
                                              "struct_caption": [""] * B})
        z = system.sample_cfg(c, 5.0, uc, gen, shape=(B, 20, LATENT), timesteps=25)
        mel = system.decode_first_stage(z)
        wav = system.vocode(mel)
        for i, (m, w) in enumerate(zip(mel.float().cpu().numpy(), wav)):
            name = f"clip{b + i:02d}"
            np.save(os.path.join(d, "gen_mels", f"{name}.npy"), m)
            path = os.path.join(d, "wavs", f"{name}_0.wav")
            wavfile.write(path, 16000, (np.clip(w, -1, 1) * 32767).astype(np.int16))
            lines.append(f"{name}\t{caps[i]}\t{path}")
    torch.cuda.synchronize()
    counts = (k1.launches, k2.launches, fa.launches["K3a"])
    want = tuple(2 * n for n in K1_K2_PER_VOCODE) + (serve_k3a(XL_DEPTH, 2),)
    require(counts == want, f"eval generation: K1/K2/K3a {counts} == {want} over 2 vocodes "
            f"and 2 ODEs")
    log(f"eval flow: {EVAL_CLIPS} clips of 10 s generated in "
        f"{time.perf_counter() - t:.2f} s (2 x batch {B}, 25 steps), K1 / K2 / K3a {counts}")
    tsv = os.path.join(d, "clips.tsv")
    with open(tsv, "w") as f:
        f.write("\n".join(lines) + "\n")
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return tsv, counts


def eval_flow(torch, system_mod, config_path, k1, k2, scorer, mel_tsv, card):
    """Phase 15 (b): generate (eval_generate), reference mels by mel_spec,
    then train_melclf (20 steps over phase 12's mels with labels, --norm,
    --val_tsv), predict_melclf, cal_fd_score with the trained VGGishish
    (--norm_stats) and a random Melception, cal_clap_score with random
    towers, structurize_captions; every file under build/. Logs ms per
    CLAP-scored clip, embeddings per second per backbone, ms per classifier
    step and peak memory. Returns the K1 / K2 launches of the generation and
    start_fd's handle of the VGGishish's FD, which main() finishes."""
    import io
    import numpy as np
    from maa3_tpu_torch import mel_spec, predict_melclf, train_melclf
    from maa3_tpu_torch.data.datasets import read_tsv
    d = os.path.join(ROOT, "build", "chip_smoke_eval")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    tsv, counts = eval_generate(torch, system_mod, config_path, k1, k2, d)
    torch.cuda.reset_peak_memory_stats()

    def quiet(fn, argv):
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        return out, time.perf_counter() - t, buf.getvalue()

    _, s, _ = quiet(mel_spec.main, ["--tsv_path", tsv, "--save_path",
                                    os.path.join(d, "ref_mels"), "--device", "cuda"])
    log(f"eval flow: mel_spec of the {EVAL_CLIPS} wavs (reference mels) {s:.2f} s")

    rows = list(enumerate(read_tsv(mel_tsv)))
    for part, sl in (("train", slice(0, 48)), ("val", slice(48, None))):
        with open(os.path.join(d, f"melclf_{part}.tsv"), "w") as f:
            f.write("mel_path\tlabel\n" + "".join(
                f"{r['mel_path']}\t{MELCLF_LABELS[i % 4]}\n" for i, r in rows[sl]))
    norm = os.path.join(d, "norm")
    res, s, out = quiet(train_melclf.main, [
        "--tsv", os.path.join(d, "melclf_train.tsv"), "--val_tsv",
        os.path.join(d, "melclf_val.tsv"), "--steps", "20", "--norm", "--norm_cache", norm,
        "--ckpt_dir", os.path.join(d, "melclf"), "--device", "cuda"])
    require(np.isfinite(res["losses"]).all() and res["val"] is not None
            and np.isfinite(list(res["val"].values())).all(), "train_melclf: finite")
    stats = [os.path.join(norm, f) for f in os.listdir(norm)]
    require(len(stats) == 1, f"train_melclf --norm: one statistics file in {norm}")
    step_ms = sorted(x * 1e3 for x in res["step_s"][1:])
    log(f"eval flow ({card}): train_melclf VGGishish, batch 16 x 624, 20 steps in "
        f"{s:.2f} s with the build; ms per step after the first: median "
        f"{statistics.median(step_ms):.2f} (min {step_ms[0]:.2f}, max {step_ms[-1]:.2f}); "
        f"first {res['step_s'][0] * 1e3:.1f}; losses {res['losses'][0]:.4f} -> "
        f"{res['losses'][-1]:.4f}; val {json.dumps({k: round(v, 4) for k, v in res['val'].items()})}")
    pred, s, _ = quiet(predict_melclf.main, [
        "--tsv", os.path.join(d, "melclf_val.tsv"), "--clf_ckpt", res["ckpt"],
        "--norm_stats", stats[0], "--device", "cuda"])
    require(np.isfinite([v for v in pred.values()]).all(), "predict_melclf: finite")
    log(f"eval flow: predict_melclf {s:.2f} s: {json.dumps(pred)}")

    dirs = ["--gen_dir", os.path.join(d, "gen_mels"), "--ref_dir", os.path.join(d, "ref_mels")]
    fd_dirs = [*dirs, "--device", "cuda"]
    # the VGGishish's FD (scipy's sqrtm of a 4096-d product on the host, 3-6
    # minutes) runs in a process of its own beside phases 16-18, all of it
    # on the host (--device cpu) so that the card and its memory stay this
    # process's; phase 18 waits for it (finish_fd) between its timings
    vgg = start_fd([*dirs, "--device", "cpu", "--backbone", "vggishish", "--clf_ckpt",
                    res["ckpt"], "--norm_stats", stats[0]],
                   os.path.join(d, "cal_fd_score_vggishish.log"))
    try:
        _eval_flow_rest(torch, d, tsv, fd_dirs, quiet, scorer, card)
    except BaseException:
        stop(vgg[0])
        raise
    return counts, vgg


def _eval_flow_rest(torch, d, tsv, fd_dirs, quiet, scorer, card):
    """Phase 15 (b) after the VGGishish's FD started: the Melception's FD,
    the warm embedding rates, cal_clap_score and structurize_captions."""
    import numpy as np
    from maa3_tpu_torch import cal_clap_score, cal_fd_score, structurize_captions
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.eval.classifier import embed, new_classifier
    from maa3_tpu_torch.pipeline import full_fp32
    fd, s, _ = quiet(cal_fd_score.main, [*fd_dirs, "--backbone", "melception"])
    check_fd("melception", fd, s)
    for backbone in ("vggishish", "melception"):
        model = new_classifier(backbone, 309).to("cuda").eval()
        mel16 = torch.randn(16, 80, 624, device="cuda") - 4.0
        with torch.no_grad(), full_fp32():
            embed(model, mel16)
            warm = [_sync_ms(torch, lambda: embed(model, mel16))[1] for _ in range(3)]
        del model
        log(f"eval flow ({card}): {backbone} warm batch 16: "
            f"{', '.join(f'{t:.2f}' for t in warm)} ms, "
            f"{16e3 / min(warm):.1f} embeddings per s")

    scores, s, _ = quiet(cal_clap_score.main, ["--wav_dir", os.path.join(d, "wavs"),
                                               "--tsv", tsv, "--device", "cuda"])
    require(len(scores) == EVAL_CLIPS and np.all(np.abs(scores) <= 1.0 + 1e-5),
            f"cal_clap_score: {scores}")
    from scipy.io import wavfile
    wavs = [wavfile.read(os.path.join(d, "wavs", f"clip{i:02d}_0.wav"))[1].astype(np.float32)
            / 32767 for i in range(EVAL_CLIPS)]
    scorer.score(wavs, EVAL_CAPTIONS)
    ms = [_sync_ms(torch, lambda: scorer.score(wavs, EVAL_CAPTIONS))[1] for _ in range(3)]
    log(f"eval flow ({card}): cal_clap_score (random towers) {s:.2f} s with the towers' "
        f"build, mean {np.mean(scores):.4f}; warm score of {EVAL_CLIPS} clips "
        f"{', '.join(f'{t:.1f}' for t in ms)} ms, {min(ms) / EVAL_CLIPS:.2f} ms per clip")

    out, s, _ = quiet(structurize_captions.main, ["--tsv_path", tsv, "--out",
                                                  os.path.join(d, "clips.struct.tsv")])
    struct = read_tsv(out)
    require(len(struct) == EVAL_CLIPS and all(r["caption"].startswith("<") for r in struct),
            "structurize_captions: a caption per row")
    log(f"eval flow: structurize_captions {s * 1e3:.1f} ms, e.g. {struct[7]['caption']!r}; "
        f"peak memory after the generation {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()


def stop(proc) -> None:
    """End a process chip_smoke started, if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def start_fd(argv, out_path: str):
    """python -m maa3_tpu_torch.cal_fd_score argv in a process of its own
    (4 BLAS threads), its output to out_path; returns (process, out_path,
    start time)."""
    threads = {k: "4" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    with open(out_path, "w") as out:
        p = subprocess.Popen([sys.executable, "-m", "maa3_tpu_torch.cal_fd_score", *argv],
                             cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
                             env=dict(os.environ, **threads))
    return p, out_path, time.perf_counter()


def check_fd(backbone: str, fd: dict, s: float) -> None:
    import numpy as np
    require(np.isfinite([fd["fd"], fd["kl"]]).all() and fd["n_gen"] == fd["n_ref"]
            == EVAL_CLIPS, f"cal_fd_score {backbone}: {fd}")
    log(f"eval flow: cal_fd_score {backbone}: fd {fd['fd']}, kl {fd['kl']}; "
        f"{s:.2f} s in all, {2 * EVAL_CLIPS} mels embedded in {fd['embed_s']:.3f} s "
        f"({2 * EVAL_CLIPS / fd['embed_s']:.1f} per s, the process's first batches), "
        f"FD on the host {fd['fd_s']:.2f} s")


def fd_state(started) -> str:
    return "running on the host" if started[0].poll() is None else "ended"


def finish_fd(started) -> None:
    """Wait for start_fd's process, then check and log its result as
    check_fd does."""
    import ast
    p, out_path, t = started
    p.wait(timeout=1200)
    with open(out_path) as f:
        out = f.read()
    lines = out.splitlines()
    result = [ln for ln in lines if ln.startswith("{'fd'")]
    timing = [re.search(r"embedded in ([0-9.]+) s, FD over \d+ dims in ([0-9.]+) s", ln)
              for ln in lines]
    timing = [m for m in timing if m]
    require(p.returncode == 0 and result and timing,
            f"cal_fd_score vggishish exit {p.returncode}: {out[-2000:]}")
    fd = dict(ast.literal_eval(result[-1]), embed_s=float(timing[-1].group(1)),
              fd_s=float(timing[-1].group(2)))
    check_fd("vggishish (its own process on the host, beside phases 16-18)", fd,
             time.perf_counter() - t)


# -- phase 16: XXL on the card through the parallel entry points -------------------

XXL_CAPTIONS = ["a dog barks in the distance", "rain falls on a tin roof",
                "a crowd cheers at a stadium", "an engine idles then revs up",
                "birds chirp at dawn", "a door creaks open",
                "thunder rolls over the hills", "a kettle whistles"]


def nccl_world_of_one(torch) -> str:
    """Phase 16's process group: NCCL at world size 1, in this process,
    through a FileStore under build/ (no port, no launcher)."""
    import torch.distributed as dist
    d = os.path.join(ROOT, "build", "chip_smoke_xxl")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "nccl_store")
    if os.path.exists(path):
        os.remove(path)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return d


def xxl_serve(torch, system_mod, xxl_path, k1, k2, card, mesh):
    """Phase 16 (a): the XXL system as its YAML writes it (random weights from
    the seed, zero-init gates made nonzero), served through shard_serving on
    the 1 x 1 mesh in bf16: 4 prompts x 10 s, 25 steps, guidance 5.0, with
    the K1 / K2 launches of its vocode and the K3a launches of its ODE."""
    import numpy as np
    from maa3_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    system = system_mod.MAA3System.from_config(
        [xxl_path], seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    system.shard_serving(mesh)
    n_dit = sum(p.numel() for p in system.dit.parameters())
    torch.cuda.synchronize()
    log(f"XXL serve: system built, DiT {n_dit / 1e6:.1f} M parameters "
        f"({system.dit.cfg.hidden_size} x {system.dit.cfg.depth} x "
        f"{system.dit.cfg.num_heads} heads of {system.dit.cfg.head_dim}), mesh "
        f"{mesh.shape}, {time.perf_counter() - t:.2f} s")
    caps = XXL_CAPTIONS[:B]
    prompts = system.captions(caps, [f"<{c}& all>" for c in caps])
    empty = system.captions([""] * B, [""] * B)

    def run():
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        s = time.perf_counter()
        c = system.get_learned_conditioning(prompts)
        uc = system.get_learned_conditioning(empty)
        torch.cuda.synchronize()
        s_ode = time.perf_counter()
        z = system.sample_cfg(c, 5.0, uc, gen, shape=(B, 20, LATENT), timesteps=25)
        torch.cuda.synchronize()
        ode = time.perf_counter() - s_ode
        wav = system.vocode(system.decode_first_stage(z))
        return z, wav, (time.perf_counter() - s) * 1e3, ode * 1e3

    run()  # warm-up: the serving copy, cuBLAS / cuDNN handles
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k2.launches = 0
    fa.launches["K3a"] = 0
    z, wav, e2e, ode = run()
    counts, k3a = (k1.launches, k2.launches), fa.launches["K3a"]
    want_k3a = serve_k3a(system.dit.cfg.depth)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(tuple(z.shape) == (B, 20, LATENT) and bool(torch.isfinite(z).all())
            and wav.shape == (B, 159744) and np.isfinite(wav).all()
            and 0 < np.abs(wav).max() <= 1.0, "XXL serve: finite outputs of the shapes")
    require(counts == K1_K2_PER_VOCODE, f"XXL serve: K1 / K2 {counts} == {K1_K2_PER_VOCODE}")
    require(k3a == want_k3a, f"XXL serve: the ODE's K3a launches {k3a} == {want_k3a}")
    log(f"XXL serve (4 x 10 s, 25 steps, bf16, 1 x 1 mesh over NCCL): end to end "
        f"{e2e:.1f} ms, ODE {ode:.1f} ms, peak {peak:.2f} GiB, K1 / K2 {counts}, K3a {k3a}; "
        f"{card}")
    del system
    gc.collect()
    torch.cuda.empty_cache()
    return {"e2e_ms": e2e, "ode_ms": ode, "peak_gib": peak, "counts": counts, "k3a": k3a}


def xxl_depth2_check(torch, system_mod, xxl_path, mesh, full_fp32):
    """Phase 16 (a): a depth-2 model of XXL width in fp32 on the card,
    sampled through shard_serving on the NCCL mesh and without it."""
    over = ["model.params.unet_config.params.depth=2"]
    s = system_mod.MAA3System.from_config([xxl_path], over, seed=0, device="cuda",
                                          compute_dtype=torch.float32, unfreeze=True,
                                          init_cond=False)
    g = torch.Generator(device="cuda").manual_seed(16)
    ctx = torch.randn(2, 154, 1024, generator=g, device="cuda")
    x0 = torch.randn(2, 20, LATENT, generator=g, device="cuda")
    with full_fp32():
        plain = s.sample_cfg(ctx, 5.0, torch.zeros_like(ctx), x0=x0, timesteps=4)
        s.shard_serving(mesh)
        sharded = s.sample_cfg(ctx, 5.0, torch.zeros_like(ctx), x0=x0, timesteps=4)
    require(torch.equal(plain, sharded), "XXL depth 2, fp32: shard_serving on the 1 x 1 "
            "NCCL mesh gives the unsharded latents")
    log("XXL depth 2, fp32: shard_serving on the 1 x 1 NCCL mesh equals the plain path")
    del s
    gc.collect()
    torch.cuda.empty_cache()


def xxl_train(torch, system_mod, xxl_path, fa, card, mesh, batch, remat=False,
              steps=3, check_ckpt=True):
    """Phase 16 (b): the XXL YAML's training (trainable CLAP+FLAN
    conditioner) through Trainer(n_model=1, fsdp=True) on the NCCL mesh,
    batch x latent XXL_TRAIN[1] (the flash route), bf16; a checkpoint
    through the gathered path, loaded back."""
    import numpy as np
    from maa3_tpu_torch.train.loop import Trainer
    latent = XXL_TRAIN[1]
    over = ["model.params.unet_config.params.remat=true"] if remat else []
    t = time.perf_counter()
    system = system_mod.MAA3System.from_config(
        [xxl_path], over, seed=0, compute_dtype=torch.bfloat16, device="cuda", unfreeze=True)
    d = os.path.join(ROOT, "build", "chip_smoke_xxl")
    trainer = Trainer(system, batch_size=batch, log_every=1, ckpt_every=0, ckpt_dir=d,
                      n_model=1, fsdp=True, mesh=mesh)
    require(not trainer.fsdp and not trainer.sharded and trainer.state.cond is not None,
            "XXL train: fsdp is a no-op on one data rank; the conditioner trains")
    n_dit = sum(p.numel() for p in system.dit.parameters())
    n_cond = sum(p.numel() for p in system.cond.parameters())
    log(f"XXL train {batch}x{latent}: system built, DiT {n_dit / 1e6:.1f} M + conditioner "
        f"{n_cond / 1e6:.1f} M trainable, remat {remat}, mesh {mesh.shape}, fsdp requested "
        f"(a no-op at data width 1, as in JAX), {time.perf_counter() - t:.2f} s")
    c = [XXL_CAPTIONS[i % len(XXL_CAPTIONS)] for i in range(batch)]
    raw = {"image": np.random.RandomState(16).randn(batch, 80, 2 * latent).astype(
               np.float32) - 4.0,
           "caption": {"ori_caption": c, "struct_caption": [f"<{x}& all>" for x in c]}}
    loader = itertools.repeat(raw)
    m = trainer.fit(loader, max_steps=1)  # warm-up: scale_by_std, cuBLAS, caches
    require(np.isfinite(m["loss"]), f"XXL warm-up loss finite: {m}")
    torch.cuda.reset_peak_memory_stats()
    results = _timed_steps(torch, fa, trainer, loader, steps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for ms, counts, m in results:
        require(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]),
                f"XXL step finite: {m}")
        log(f"XXL train {batch}x{latent} step {m['step']}: {ms:.1f} ms, "
            f"{batch * latent / ms * 1e3:.0f} tokens/s, loss {m['loss']:.4f}, grad norm "
            f"{m['grad_norm']:.4f}, launches {counts}")
    depth = system.dit.cfg.depth
    want = {"K3a": depth * (2 if remat else 1), "K3b": 0, "K4a": depth, "K4b": 0, "K4c": 0}
    for _, counts, _ in results:
        require(counts == want, f"XXL step launches {counts} == {want}")
    med = statistics.median(ms for ms, _, _ in results)
    log(f"XXL train {batch}x{latent}: median step {med:.1f} ms, "
        f"{batch * latent / med * 1e3:.0f} tokens/s, peak {peak:.2f} GiB; {card}")
    out = {"step_ms": med, "tokens_per_s": batch * latent / med * 1e3, "peak_gib": peak,
           "counts": results[-1][1], "batch": batch}
    if check_ckpt:
        t = time.perf_counter()
        path = trainer.save_checkpoint(tag="xxl")
        saved = time.perf_counter() - t
        payload = torch.load(path, map_location="cpu", weights_only=True)
        live = {k: m.state_dict() for k, m in trainer.state.trainable().items()}
        same = all(torch.equal(payload["params"][k][n], v.cpu())
                   for k, sd in live.items() for n, v in sd.items())
        require(same, "XXL checkpoint: the file holds the live parameters")
        with torch.no_grad():
            for p in trainer.state.trainable_parameters():
                p.zero_()
        t = time.perf_counter()
        trainer.restore_checkpoint(path)
        loaded = time.perf_counter() - t
        back = all(torch.equal(payload["params"][k][n], v.cpu())
                   for k, m in trainer.state.trainable().items()
                   for n, v in m.state_dict().items())
        require(back, "XXL checkpoint: restore_checkpoint gives the saved parameters")
        size = os.path.getsize(path) / 2 ** 30
        os.remove(path)
        del payload
        log(f"XXL checkpoint: {size:.2f} GiB written in {saved:.1f} s, loaded back in "
            f"{loaded:.1f} s, parameters equal")
        out.update(ckpt_gib=size, ckpt_save_s=saved, ckpt_load_s=loaded)
    trainer.close()
    del trainer, system
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _gloo_main(rank: int, world: int, d: str, task: str) -> None:
    """One of `world` spawned ranks on the one card: gloo over CUDA tensors;
    GLOO_TASKS[task](torch, rank)'s result written to d."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(d, "gloo_store"), world),
                            rank=rank, world_size=world)
    try:
        out = GLOO_TASKS[task](torch, rank)
        torch.save(out, os.path.join(d, f"gloo_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def gloo_ranks_one_card(torch, task: str, world: int = 2, timeout: float = 300) -> list:
    """GLOO_TASKS[task] on `world` spawned gloo ranks sharing the one card
    (NCCL puts no two ranks on one device; gloo carries every collective on
    CUDA tensors, and the pipeline's ring shift sends host copies); their
    results by rank. A rank that raises, or a run past `timeout`, fails the
    run."""
    import torch.multiprocessing as mp
    d = os.path.join(ROOT, "build", f"chip_smoke_gloo_{task}")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    ctx = mp.start_processes(_gloo_main, args=(world, d, task), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            require(time.monotonic() < deadline,
                    f"{world} gloo ranks ({task}) finished within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
    return [torch.load(os.path.join(d, f"gloo_{r}.pt"), weights_only=False)
            for r in range(world)]


def _xxl_two_rank_task(torch, rank: int) -> dict:
    """Phase 16 (c), one rank: a depth-2 XXL-width TP=2 serving sample and a
    DP=2 + FSDP step."""
    from maa3_tpu_torch import system as system_mod
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.pipeline import full_fp32
    with full_fp32():
        return {"serve": _two_rank_serve(torch, system_mod, pmesh.make_mesh(n_model=2)),
                "step": _two_rank_step(torch, system_mod, pmesh.make_mesh(n_model=1))}


def _xxl_depth2(torch, system_mod):
    over = ["model.params.unet_config.params.depth=2", NO_COND]
    return system_mod.MAA3System.from_config(
        [os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XXL.yaml")], over, seed=0,
        device="cuda", compute_dtype=torch.float32, unfreeze=True, init_cond=False)


def _two_rank_serve(torch, system_mod, mesh):
    s = _xxl_depth2(torch, system_mod)
    if mesh is not None:
        s.shard_serving(mesh)
    g = torch.Generator(device="cuda").manual_seed(16)
    ctx = torch.randn(2, 154, 1024, generator=g, device="cuda")
    x0 = torch.randn(2, 20, LATENT, generator=g, device="cuda")
    return s.sample_cfg(ctx, 5.0, torch.zeros_like(ctx), x0=x0, timesteps=4).cpu()


def _two_rank_step(torch, system_mod, mesh):
    import numpy as np
    from maa3_tpu_torch.train.loop import Trainer
    s = _xxl_depth2(torch, system_mod)
    d = os.path.join(ROOT, "build", "chip_smoke_xxl", f"gloo_{mesh.data_rank}")
    tr = Trainer(s, batch_size=4, warm_up_steps=0, log_every=100, ckpt_every=0,
                 ckpt_dir=d, fsdp=mesh.n_data > 1, fsdp_min_size=65536, mesh=mesh)
    rng = np.random.RandomState(16)
    raw = {"image": rng.randn(4, 80, 624).astype(np.float32) - 4.0,
           "context": rng.randn(4, 154, 1024).astype(np.float32)}
    m = tr.train_step(raw, seed=16)
    return {"params": {n: t.cpu() for n, t in tr._full_params()["dit"].items()},
            "loss": float(m["loss"]), "sharded": tr.sharded}


def two_ranks_one_card(torch, system_mod, full_fp32):
    """Phase 16 (c): two gloo ranks on the one card against one rank."""
    t = time.perf_counter()
    ranks = gloo_ranks_one_card(torch, "xxl")
    with full_fp32():
        one_z = _two_rank_serve(torch, system_mod, None)
        from maa3_tpu_torch.parallel import mesh as pmesh
        one = _two_rank_step(torch, system_mod, pmesh.Mesh())
    for r in ranks:
        _within(r["serve"], one_z, "gloo TP=2 serving vs one rank", rel=1e-3)
        require(r["step"]["sharded"], "the two-rank step is sharded (FSDP over data 2)")
        require(abs(r["step"]["loss"] - one["loss"]) <= 1e-4 * max(1.0, abs(one["loss"])),
                "gloo DP=2 + FSDP loss vs one rank")
        for n, p in r["step"]["params"].items():
            _within(p, one["params"][n], f"gloo DP=2 + FSDP step: {n}", rel=1e-4)
    log(f"two gloo ranks on the card: TP=2 serving and a DP=2 + FSDP step agree with "
        f"one rank, {time.perf_counter() - t:.2f} s")


def xxl_phase(torch, system_mod, k1, k2, fa, card, full_fp32, gloo=True):
    """Phase 16: XXL serving and training through the parallel entry points
    on an NCCL group of world size 1, then two gloo ranks on the card."""
    import torch.distributed as dist
    from maa3_tpu_torch.parallel import mesh as pmesh
    xxl_path = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XXL.yaml")
    nccl_world_of_one(torch)
    try:
        mesh = pmesh.make_mesh(n_model=1)
        require(mesh.shape == {"data": 1, "model": 1} and mesh.device_mesh is not None
                and dist.get_backend() == "nccl", "a 1 x 1 DeviceMesh over NCCL")
        serve = xxl_serve(torch, system_mod, xxl_path, k1, k2, card, mesh)
        xxl_depth2_check(torch, system_mod, xxl_path, mesh, full_fp32)
        train = xxl_train(torch, system_mod, xxl_path, fa, card, mesh, XXL_TRAIN[0])
    finally:
        dist.destroy_process_group()
    if gloo:
        two_ranks_one_card(torch, system_mod, full_fp32)
    return serve, train


def xxl_batch_probe(torch, system_mod, fa, card) -> None:
    """chip_smoke.py --xxl-batch-probe: the XXL step's time and peak at
    several batches, with and without remat (an out-of-memory step is
    reported and the next setting tried)."""
    import torch.distributed as dist
    from maa3_tpu_torch.parallel import mesh as pmesh
    xxl_path = os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XXL.yaml")
    nccl_world_of_one(torch)
    try:
        mesh = pmesh.make_mesh(n_model=1)
        for batch, remat in ((6, False), (8, False), (10, False), (12, True), (16, True)):
            try:
                r = xxl_train(torch, system_mod, xxl_path, fa, card, mesh, batch, remat,
                              steps=2, check_ckpt=False)
                log(f"XXL probe: batch {batch} remat {remat}: {r}")
            except torch.cuda.OutOfMemoryError as e:
                log(f"XXL probe: batch {batch} remat {remat}: out of memory ({str(e)[:120]})")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


# -- phase 17: pipeline and expert parallelism on two gloo ranks -------------------

PIPE_CHECK = (4, 1248, 4)   # (a): batch x latent (the flash route), depth
PIPE_XL = (6, 1248, 3)      # (b): batch x latent, n_micro (4 ticks of 2 rows)
EP_TRAIN = (16, 312)        # (c): the video YAML's batch x latent
EP_SEED = 17


def _pipe_system(torch, system_mod, depth, dtype):
    over = [NO_COND] + ([f"model.params.unet_config.params.depth={depth}"] if depth else [])
    return system_mod.MAA3System.from_config(
        [os.path.join(ROOT, "configs", "txt2audio-cfm-cfg-XL.yaml")], over, seed=0,
        device="cuda", compute_dtype=dtype, unfreeze=True, init_cond=False)


def _pipe_batch(batch: int, latent: int, seed: int) -> dict:
    import numpy as np
    rng = np.random.RandomState(seed)
    return {"image": rng.randn(batch, 80, 2 * latent).astype(np.float32) - 4.0,
            "context": rng.randn(batch, 154, 1024).astype(np.float32)}


def _stage_storage(dit) -> tuple:
    """(blocks with storage, GiB of the DiT's parameters) on this rank."""
    held = sum(1 for b in dit.blocks if b.attention.wo.weight.numel())
    return held, sum(p.numel() * p.element_size() for p in dit.parameters()) / 2 ** 30


def _pipe_check_step(torch, system_mod, mesh) -> dict:
    """Phase 17 (a): one fp32 step of the XL-width DiT at depth 4 (context
    given), Trainer(n_pipe=2, n_micro=2) on mesh, or one rank's step on a
    mesh of ones; the loss, the whole parameters and the flash launches."""
    from maa3_tpu_torch.ops import flash_attention as fa
    from maa3_tpu_torch.train.loop import Trainer
    batch, latent, depth = PIPE_CHECK
    s = _pipe_system(torch, system_mod, depth, torch.float32)
    n_pipe = mesh.n_pipe
    tr = Trainer(s, batch_size=batch, warm_up_steps=0, log_every=10 ** 6, ckpt_every=0,
                 ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_pipe", f"a{mesh.pipe_rank}"),
                 n_pipe=n_pipe, n_micro=2 if n_pipe > 1 else 1, mesh=mesh)
    reset_launches(fa)
    m = tr.train_step(_pipe_batch(batch, latent, EP_SEED), seed=EP_SEED)
    torch.cuda.synchronize()
    counts = dict(fa.launches)
    out = {"loss": float(m["loss"]), "counts": counts, "blocks": _stage_storage(s.dit)[0],
           "params": {n: t.cpu() for n, t in tr._full_params()["dit"].items()}}
    del tr, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pipe_xl_steps(torch, system_mod, mesh, steps: int = 3) -> dict:
    """Phase 17 (b): the XL YAML's DiT at full depth (14 blocks a stage),
    bf16, Trainer(n_pipe=2, n_micro=3) at 6 x 1248 with the context given:
    a warm-up step, then `steps` timed ones (ms, loss, flash launches) and
    the peak memory of this rank."""
    from maa3_tpu_torch.ops import flash_attention as fa
    from maa3_tpu_torch.train.loop import Trainer
    batch, latent, n_micro = PIPE_XL
    s = _pipe_system(torch, system_mod, None, torch.bfloat16)
    tr = Trainer(s, batch_size=batch, log_every=10 ** 6, ckpt_every=0,
                 ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_pipe", f"b{mesh.pipe_rank}"),
                 n_pipe=2, n_micro=n_micro, mesh=mesh)
    raw = _pipe_batch(batch, latent, 0)
    tr.train_step(raw)  # warm-up: cuBLAS, caches, the std rescale
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(steps):
        reset_launches(fa)
        m, ms = _sync_ms(torch, lambda: tr.train_step(raw))
        out.append((ms, float(m["loss"]), float(m["grad_norm"]), dict(fa.launches)))
    blocks, gib = _stage_storage(s.dit)
    res = {"steps": out, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "blocks": blocks, "param_gib": gib, "depth": s.dit.cfg.depth}
    del tr, s
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _pipe_task(torch, rank: int) -> dict:
    """Phase 17 (a) and (b), one of the two pipeline stages."""
    from maa3_tpu_torch import system as system_mod
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.pipeline import full_fp32
    mesh = pmesh.make_pipe_mesh(n_pipe=2)
    with full_fp32():
        check = _pipe_check_step(torch, system_mod, mesh)
    return {"mesh": mesh.shape, "check": check,
            "xl": _pipe_xl_steps(torch, system_mod, mesh)}


def _expert_bytes(dit) -> int:
    return sum(p.numel() * p.element_size() for n, p in dit.named_parameters()
               if "_experts." in n)


def _ep_latent(torch, system, mesh, seed: int = EP_SEED):
    """One 10 s window of video2audio's sampler (25 steps, guidance 4.5)
    through shard_serving over mesh (None: one device)."""
    import numpy as np
    from maa3_tpu_torch import video2audio
    opt = video2audio.parse_args(["--feat_dir", "-", "--seed", str(seed)])
    if mesh is not None:
        system.shard_serving(mesh)
    gen = video2audio.WindowSampler(system, opt)
    seg = np.random.RandomState(seed).randn(gen.truncate_frame, 512).astype(np.float32)
    return gen, seg, gen.latent(seg, 0, None)


def _ep_step(torch, system, mesh, batch: int, latent: int, seed: int = EP_SEED):
    """One Trainer step of the video system at batch x latent (the trainable
    video encoder as the YAML has it), expert-parallel over mesh (a mesh of
    ones: one rank); the trainer, the loss and the step's ms."""
    import numpy as np
    from maa3_tpu_torch.train.loop import Trainer
    n_exp = mesh.n_expert
    tr = Trainer(system, batch_size=batch, warm_up_steps=0, log_every=10 ** 6, ckpt_every=0,
                 ckpt_dir=os.path.join(ROOT, "build", "chip_smoke_ep", f"r{mesh.expert_rank}"),
                 n_expert=n_exp, mesh=mesh)
    rng = np.random.RandomState(seed)
    raw = {"image": rng.randn(batch, 80, 2 * latent).astype(np.float32) - 4.0,
           "video_feat": rng.randn(batch, V2A_FRAMES, 512).astype(np.float32)}
    return tr, raw


def _ep_check(torch, system_mod, mesh) -> dict:
    """Phase 17 (c) in fp32: the expert-parallel (or one rank's) 10 s latent
    and one training step's parameters."""
    video_path = os.path.join(ROOT, "configs", "video2audio-cfm-cfg-moe.yaml")
    s = system_mod.MAA3System.from_config([video_path], seed=0, device="cuda",
                                          compute_dtype=torch.float32, unfreeze=True)
    _, _, z = _ep_latent(torch, s, mesh if mesh.n_expert > 1 else None)
    tr, raw = _ep_step(torch, s, mesh, *EP_TRAIN)
    m = tr.train_step(raw, seed=EP_SEED)
    out = {"latent": z.cpu(), "loss": float(m["loss"]),
           "params": {n: t.cpu() for n, t in tr._full_params()["dit"].items()}}
    del tr, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ep_task(torch, rank: int) -> dict:
    """Phase 17 (c), one of the two expert ranks: the fp32 checks, then in
    bf16 a timed 10 s clip (latent, decode, vocode through K1 / K2) and
    timed training steps at 16 x 312, with the expert bytes this rank
    holds."""
    from maa3_tpu_torch import system as system_mod
    from maa3_tpu_torch.ops import pallas_aa_snake as k1, pallas_amp as k2
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.pipeline import full_fp32
    mesh = pmesh.make_moe_mesh(n_expert=2)
    with full_fp32():
        out = {"check": _ep_check(torch, system_mod, mesh), "mesh": mesh.shape}
    video_path = os.path.join(ROOT, "configs", "video2audio-cfm-cfg-moe.yaml")
    s = system_mod.MAA3System.from_config([video_path], seed=0, device="cuda",
                                          compute_dtype=torch.bfloat16, unfreeze=True)
    full_bytes = _expert_bytes(s.dit)
    gen, seg, _ = _ep_latent(torch, s, mesh)   # warm-up: the serving copy
    serve_bytes = _expert_bytes(s.serving_dit())
    clips = []
    for _ in range(3):
        k1.launches = k2.launches = 0
        wav, ms = _sync_ms(torch, lambda: s.vocode(torch.as_tensor(
            gen.mel(seg, 0, None)[None], device="cuda")))
        clips.append((ms, (k1.launches, k2.launches), wav.shape))
    tr, raw = _ep_step(torch, s, mesh, *EP_TRAIN)
    tr.train_step(raw, seed=0)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(3):
        m, ms = _sync_ms(torch, lambda: tr.train_step(raw, seed=i))
        steps.append((ms, float(m["loss"])))
    out.update(clips=clips, steps=steps, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               expert_bytes={"full_fp32": full_bytes, "serving_bf16": serve_bytes,
                             "trainer_fp32": _expert_bytes(tr.state.dit)})
    del tr, s
    gc.collect()
    torch.cuda.empty_cache()
    return out


GLOO_TASKS = {"xxl": _xxl_two_rank_task, "pipe": _pipe_task, "expert": _ep_task}


def _close(got, want, what: str, rel: float) -> float:
    """max |got - want| <= rel * max(1, max |want|), the error returned."""
    err = (got.float() - want.float()).abs().max().item()
    require(err <= rel * max(1.0, want.float().abs().max().item()),
            f"{what}: max |diff| {err:.3e}")
    return err


def parallel_phase(torch, system_mod, full_fp32, card, xl_peak: float) -> dict:
    """Phase 17: GPipe and expert parallelism on two gloo ranks sharing the
    card (two processes on one card over gloo: nothing here measures NCCL),
    each part held against one rank in this process."""
    from maa3_tpu_torch.parallel import mesh as pmesh
    t = time.perf_counter()
    pipe = gloo_ranks_one_card(torch, "pipe")
    # (a) the pipeline at XL width, depth 4, fp32, against one rank
    with full_fp32():
        one = _pipe_check_step(torch, system_mod, pmesh.Mesh())
    errs = []
    for rank, r in enumerate(pipe):
        c = r["check"]
        require(r["mesh"] == {"data": 1, "pipe": 2, "model": 1} and c["blocks"] == 2,
                f"pipe rank {rank}: a (1, 2, 1) mesh, two blocks stored")
        require(abs(c["loss"] - one["loss"]) <= 1e-4 * max(1.0, abs(one["loss"])),
                f"pipe rank {rank}: loss {c['loss']} vs one rank {one['loss']}")
        errs.append(max(_close(p, one["params"][n], f"pipe rank {rank}: {n}", 1e-4)
                        for n, p in c["params"].items()))
        # 3 ticks (2 microbatches, 2 stages) of the stage's 2 blocks, forward and backward
        require(c["counts"]["K3a"] == 6 and c["counts"]["K4a"] == 6,
                f"pipe rank {rank}: K3a / K4a {c['counts']} == 6 / 6 a step")
    log(f"phase 17 (a): Trainer(n_pipe=2, n_micro=2), XL width, depth 4, fp32, "
        f"{PIPE_CHECK[0]} x {PIPE_CHECK[1]}: loss {pipe[0]['check']['loss']:.6f} vs one rank "
        f"{one['loss']:.6f}; parameters max |diff| {max(errs):.2e}; K3a / K4a per stage "
        f"{[(r['check']['counts']['K3a'], r['check']['counts']['K4a']) for r in pipe]} "
        f"(one rank {one['counts']['K3a']} / {one['counts']['K4a']})")
    del one
    # (b) full XL, bf16
    batch, latent, n_micro = PIPE_XL
    xl = [r["xl"] for r in pipe]
    ticks = n_micro + 1
    for rank, x in enumerate(xl):
        per = x["depth"] // 2
        for ms, loss, gn, counts in x["steps"]:
            require(loss == loss and gn == gn, f"pipe XL rank {rank}: finite loss")
            require(counts["K3a"] == per * ticks and counts["K4a"] == per * ticks,
                    f"pipe XL rank {rank}: K3a / K4a {counts} == {per * ticks}")
    med = [statistics.median(ms for ms, _, _, _ in x["steps"]) for x in xl]
    log(f"phase 17 (b): XL depth {xl[0]['depth']} ({xl[0]['blocks']} blocks a stage), bf16, "
        f"{batch} x {latent}, n_micro {n_micro}, two processes on one card over gloo: step ms "
        f"{[[round(ms, 1) for ms, _, _, _ in x['steps']] for x in xl]} (median per rank "
        f"{[round(m, 1) for m in med]}), {batch * latent / max(med) * 1e3:.0f} tokens/s, "
        f"peak per rank {[round(x['peak_gib'], 2) for x in xl]} GiB (one rank's XL step "
        f"at 6 x 1248 with the frozen conditioner, phase 8: {xl_peak:.2f} GiB), DiT parameters "
        f"per rank {[round(x['param_gib'], 2) for x in xl]} GiB, losses "
        f"{[round(l, 4) for _, l, _, _ in xl[0]['steps']]}; {card}")
    # (c) expert parallelism of the video MoE
    ep = gloo_ranks_one_card(torch, "expert")
    with full_fp32():
        one = _ep_check(torch, system_mod, pmesh.Mesh(dim_names=("data", "model", "expert")))
    for rank, r in enumerate(ep):
        c = r["check"]
        require(r["mesh"] == {"data": 1, "model": 1, "expert": 2},
                f"expert rank {rank}: a (1, 1, 2) mesh")
        zerr = _close(c["latent"], one["latent"], f"expert rank {rank}: 10 s latent", 1e-3)
        require(abs(c["loss"] - one["loss"]) <= 1e-4 * max(1.0, abs(one["loss"])),
                f"expert rank {rank}: step loss {c['loss']} vs one rank {one['loss']}")
        perr = max(_close(p, one["params"][n], f"expert rank {rank}: {n}", 1e-4)
                   for n, p in c["params"].items())
        for ms, counts, shape in r["clips"]:
            require(counts == K1_K2_PER_VOCODE and shape == (1, V2A_SAMPLES),
                    f"expert rank {rank}: K1 / K2 {counts} per vocode, a 10 s wav")
        log(f"phase 17 (c) rank {rank}: fp32 latent max |diff| {zerr:.2e}, step loss "
            f"{c['loss']:.6f} (one rank {one['loss']:.6f}), parameters max |diff| "
            f"{perr:.2e}; bf16 ms per 10 s clip (25 steps, decode, vocode) "
            f"{[round(ms, 1) for ms, _, _ in r['clips']]}, K1 / K2 {r['clips'][-1][1]}; "
            f"bf16 step at {EP_TRAIN[0]} x {EP_TRAIN[1]} "
            f"{[round(ms, 1) for ms, _ in r['steps']]} ms, peak {r['peak_gib']:.2f} GiB; "
            f"expert weights {r['expert_bytes']['trainer_fp32'] / 2 ** 30:.3f} GiB fp32 "
            f"(of {r['expert_bytes']['full_fp32'] / 2 ** 30:.3f}), serving copy "
            f"{r['expert_bytes']['serving_bf16'] / 2 ** 30:.3f} GiB; {card}")
    log(f"phase 17: done, {time.perf_counter() - t:.2f} s")
    return {"pipe_xl": xl[0]["steps"][-1][3], "pipe_check": pipe[0]["check"]["counts"],
            "ep_vocode": ep[0]["clips"][-1][1]}


# -- phase 18: AudioLDM (the legacy 2-D UNet, DDIM / PLMS, 2-D VAE, HiFi-GAN) --------
AUDIOLDM_CHECK = (2, 4, 3.0)     # batch, DDIM / PLMS steps, CFG scale: card vs CPU
AUDIOLDM_TIME = (4, 200, 3.0)    # batch, DDIM steps (JAX's default), CFG scale: timed


def _audioldm_nonzero(torch, pipe, seed: int):
    """The UNet's zero-init leaves (each ResBlock's conv2, each transformer's
    proj_out, conv_out) drawn N(0, 0.02), so that every path contributes."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in pipe.unet.parameters():
            if not p.any():
                p.copy_(0.02 * torch.randn(p.shape, generator=g))


def _audioldm_stages(torch, pipe, cond, x_T, scale, steps, plms):
    """(latent, mel, wav) of pipe.generate_sample's stages from x_T; the
    unconditional embedding zeros, as generate_sample makes it."""
    from maa3_tpu_torch.diffusion.ddpm_loss import film_pool
    film_c = film_pool(cond)
    z = pipe.sample(x_T, film_c, torch.zeros_like(film_c), scale, steps, plms)
    mel = pipe.decode(z)
    return z, mel, pipe.vocode(mel)


def _audioldm_timed(torch, gpu, cond, n, steps, scale, card, label: str = ""):
    """One timed generate_sample (batch of cond, n candidates each) and the
    sampler alone from its x_T: ms per step, s per clip, peak GiB."""
    b = cond.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(21)
    x_T = torch.randn((b * n, 4, gpu.latent_f, gpu.latent_t), generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    wav, mel = gpu.generate_sample(cond, ddim_steps=steps, n_candidate_gen_per_text=n,
                                   unconditional_guidance_scale=scale, x_T=x_T)
    torch.cuda.synchronize()
    total = time.perf_counter() - t
    require(wav.shape == (b, 65536) and mel.shape == (b, 64, 256)
            and bool(torch.isfinite(wav).all()), f"AudioLDM clips {tuple(wav.shape)}")
    t = time.perf_counter()
    film = torch.zeros(b * n, 512, device="cuda")
    gpu.sample(x_T, film, film, scale, steps)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / steps
    out = dict(step_ms=step_ms, s_per_clip=total / b,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    log(f"AudioLDM batch {b}, n_candidate_gen_per_text {n} ({2 * b * n} UNet rows a step "
        f"with CFG), {steps} DDIM steps, fp32{label}: {step_ms:.2f} ms per step, "
        f"{total / b:.3f} s per clip ({total:.2f} s for {b}), peak "
        f"{out['peak_gib']:.2f} GiB; {card}")
    return out


def audioldm_phase(torch, k1, k2, card, fd):
    """Phase 18. Batch 4 is timed once with start_fd's process `fd` still
    on the host (if it is), then, after finish_fd waits for it, alone with
    each candidate count. Returns the timings alone."""
    import copy
    from maa3_tpu_torch.models.unet2d import UNet2DConfig
    from maa3_tpu_torch.models.vae2d import VAE2DConfig
    from maa3_tpu_torch.pipeline_audioldm import AudioLDMPipeline, hifigan_config
    t0 = time.perf_counter()
    try:
        AudioLDMPipeline.random_init(torch.Generator(device="cuda").manual_seed(18))
        raise RuntimeError("chip_smoke check failed: AudioLDM's default configs built")
    except ValueError as e:
        log(f"AudioLDM: JAX's default configs refused: {e}")
    voc_cfg = dataclasses.replace(hifigan_config(), num_mels=64)
    cpu = AudioLDMPipeline.random_init(torch.Generator().manual_seed(18),
                                       UNet2DConfig(film_dim=512), VAE2DConfig(), voc_cfg,
                                       device="cpu")
    _audioldm_nonzero(torch, cpu, 19)
    gpu = AudioLDMPipeline(*(copy.deepcopy(m).cuda() for m in (cpu.unet, cpu.vae, cpu.vocoder)),
                           cpu.schedule)
    counts = {k: sum(p.numel() for p in getattr(cpu, k).parameters()) / 1e6
              for k in ("unet", "vae", "vocoder")}
    log(f"AudioLDM: UNet2D / VAE2D / HiFi-GAN (BigVGAN 1536, lrelu, 64 mels) "
        f"{counts['unet']:.1f} / {counts['vae']:.1f} / {counts['vocoder']:.1f} M parameters")
    b, steps, scale = AUDIOLDM_CHECK
    g = torch.Generator().manual_seed(20)
    cond = torch.randn(b, 8, 512, generator=g)
    x_T = torch.randn(b, 4, gpu.latent_f, gpu.latent_t, generator=g)
    k1.launches = k2.launches = 0
    for plms in (False, True):
        t = time.perf_counter()
        want = _audioldm_stages(torch, cpu, cond, x_T, scale, steps, plms)
        cpu_s = time.perf_counter() - t
        got = _audioldm_stages(torch, gpu, cond.cuda(), x_T.cuda(), scale, steps, plms)
        errs = []
        for name, a, w in zip(("latent", "mel", "wav"), got, want):
            err = (a.cpu() - w).abs().max().item() / max(1.0, w.abs().max().item())
            require(bool(torch.isfinite(a).all()) and a.shape == w.shape and err <= 1e-3,
                    f"AudioLDM {'PLMS' if plms else 'DDIM'} {name} {tuple(a.shape)}: "
                    f"card vs CPU {err:.3e} of max(1, |ref|)")
            errs.append(f"{name} {tuple(a.shape)} {err:.2e}")
        log(f"AudioLDM {'PLMS' if plms else 'DDIM'} batch {b}, {steps} steps, CFG {scale}: "
            f"card vs CPU (of max(1, |ref|)) " + ", ".join(errs) + f"; CPU {cpu_s:.2f} s")
    require((k1.launches, k2.launches) == (0, 0),
            f"AudioLDM's lrelu vocoder launches neither K1 nor K2: {k1.launches, k2.launches}")
    del cpu
    b, steps, scale = AUDIOLDM_TIME
    cond = torch.randn(b, 8, 512, generator=g).cuda()
    gpu.generate_sample(cond, torch.Generator(device="cuda").manual_seed(0), ddim_steps=2,
                        unconditional_guidance_scale=scale)  # warm-up
    before = fd_state(fd)
    _audioldm_timed(torch, gpu, cond, 1, steps, scale, card, ", beside the FD process")
    log(f"AudioLDM: the VGGishish FD process was {before} when that timing began and "
        f"{fd_state(fd)} when it ended")
    finish_fd(fd)
    out = {n: _audioldm_timed(torch, gpu, cond, n, steps, scale, card, ", alone")
           for n in (1, 2)}
    del gpu
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 18: done, {time.perf_counter() - t0:.2f} s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    config_path = os.path.join(root, "configs", "txt2audio-cfm-cfg-XL.yaml")
    if not (os.path.isdir(os.path.join(root, "maa3_tpu_torch"))
            and os.path.isfile(config_path)):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)

    card = gpu_line()
    log(f"environment: {card}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from maa3_tpu_torch import cuda
    nvcc = subprocess.run([cuda.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    log(f"environment: {nvcc.splitlines()[-1]}")

    t = time.perf_counter()
    cuda.load()
    log(f"build: nvcc + ctypes, {cuda.build_info['seconds']:.2f} s compile, "
        f"{time.perf_counter() - t:.2f} s to load -> {cuda.build_info['path']}")
    kernel = ""
    for line in cuda.build_info["log"].splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = kernel_name(entry.group(1))
        elif "registers" in line or "spill" in line or "error" in line.lower():
            log(f"build: {kernel}: {line.strip()}")
    check_k1_spills(cuda.build_info["log"])
    check_sass(cuda.build_info["path"], cuda.nvcc_path())

    from maa3_tpu_torch import system as system_mod
    from maa3_tpu_torch.ops import pallas_aa_snake as k1, pallas_amp as k2
    from maa3_tpu_torch.pipeline import full_fp32

    if "--attn-crossover" in sys.argv[1:]:
        from maa3_tpu_torch.ops import flash_attention as fa
        attn_crossover(torch, fa)
        log("serving attention crossover: done (no result line)")
        return 3

    if "--xxl-batch-probe" in sys.argv[1:]:
        # the head-dim-48 flash check and the XXL step at several batches;
        # no result line
        from maa3_tpu_torch.ops import flash_attention as fa
        check_flash(torch, fa, full_fp32, [XXL_FLASH + (False, None)])
        xxl_batch_probe(torch, system_mod, fa, card)
        log("XXL batch probe: done (no result line)")
        return 3

    t = time.perf_counter()
    rows = check_kernels(torch, k1, k2, full_fp32)
    log(f"kernels: {len(rows)} shape checks passed, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    check_small_reference(torch, system_mod, config_path)
    log(f"reference: small system agrees, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    times, counts, serve_ode_k3a = main_path(torch, system_mod, config_path, k1, k2,
                                             profile="--profile" in sys.argv[1:])
    log(f"main path: done, {time.perf_counter() - t:.2f} s")

    from maa3_tpu_torch.ops import flash_attention as fa
    t = time.perf_counter()
    frows = check_flash(torch, fa, full_fp32)
    log(f"flash kernels: {len(frows)} checks passed, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    serve_attn = serve_attention(torch, fa, full_fp32)
    log(f"serving attention: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    long_ms = long_lq(torch, fa, full_fp32)
    log(f"long-Lq: auto runs K4a at every length, which "
        f"{'NO LONGER holds' if long_ms['split'] < long_ms['K4a'] else 'still holds'}: "
        f"the split is {'FASTER' if long_ms['split'] < long_ms['K4a'] else 'slower'} "
        f"than K4a at Lq {LONG_LQ[2]}, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    small_train_reference(torch, config_path, fa, full_fp32)
    log(f"train reference: small training agrees, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    with flash_bwd_mode("split"):
        small_train_cond_reference(torch, system_mod, config_path, fa)
    log(f"train+cond reference: agrees, checkpoint resumes exactly, "
        f"{time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    xl_steps, xl_peak, _ = train_path(torch, system_mod, config_path, fa, *XL_TRAIN,
                                      profile="--profile" in sys.argv[1:], measure_tf32=True)
    for _, c, _ in xl_steps:
        require(c == {"K3a": 28, "K3b": 0, "K4a": 28, "K4b": 0, "K4c": 0},
                f"XL training step launches {c} == K3a 28, K3b 0, K4a 28")
    log(f"train XL: done, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    # remat runs each block's forward again in the backward: 4 + 4 K3b, 4 K4a
    k3b_steps, _, _ = train_path(torch, system_mod, config_path, fa, *K3B_TRAIN,
                                 depth=4, remat=True, steps=2)
    for _, c, _ in k3b_steps:
        require(c == {"K3a": 0, "K3b": 8, "K4a": 4, "K4b": 0, "K4c": 0},
                f"K3b-route step launches {c} == K3a 0, K3b 8, K4a 4")
    log(f"train K3b route: done, {time.perf_counter() - t:.2f} s")

    cond_steps = {}
    for mode, want in ((None, {"K3a": 28, "K3b": 0, "K4a": 28, "K4b": 0, "K4c": 0}),
                       ("split", {"K3a": 28, "K3b": 0, "K4a": 0, "K4b": 28, "K4c": 28})):
        t = time.perf_counter()
        with flash_bwd_mode(mode):
            cond_steps[mode], peak, _ = train_path(
                torch, system_mod, config_path, fa, *XL_TRAIN, train_cond=True,
                profile="--profile" in sys.argv[1:])
        for _, c, _ in cond_steps[mode]:
            require(c == want, f"XL step with the trainable conditioner, "
                    f"MAA3_FLASH_BWD={mode}: launches {c} == {want}")
        tail = [ms for ms, _, _ in cond_steps[mode]][1:]
        log(f"train XL + conditioner, MAA3_FLASH_BWD={mode or '(unset): auto'}: "
            f"median of the timed steps after the first {statistics.median(tail):.1f} ms, "
            f"peak {peak:.2f} GiB, done, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    music_path = os.path.join(root, "configs", "txt2music-cfm-cfg.yaml")
    serve = serve_from_files(torch, system_mod, music_path, k1, k2)
    chunk_ms = ode_chunk_probe(torch, system_mod, config_path)
    amp2 = amp2_lrelu_vocoders(torch, k1, k2, full_fp32)
    log(f"serving from checkpoint files: done, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    tsv = write_mels()
    remat_sweep(torch, system_mod, config_path, fa)
    log(f"remat sweep: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    recipe = check_recipe(*recipe_run(torch, system_mod, config_path, fa, k1, k2, tsv))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"recipe: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    cached_latents(torch, system_mod, config_path, fa, tsv)
    log(f"cached latents: done, {time.perf_counter() - t:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    gan_small_reference(torch, full_fp32)
    log(f"GAN reference: small VAE-GAN and vocoder-GAN steps agree, "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    vae_ckpt = vae_gan_run(torch, full_fp32, tsv, card)
    log(f"VAE-GAN: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    voc_gan = vocoder_gan_run(torch, full_fp32, k1, k2, card)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"vocoder GAN: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    mel_spec_run(torch, card)
    vae_handoff(torch, config_path, vae_ckpt, tsv)
    log(f"mel_spec and the --vae_ckpt hand-off: done, {time.perf_counter() - t:.2f} s")

    video_path = os.path.join(root, "configs", "video2audio-cfm-cfg-moe.yaml")
    t = time.perf_counter()
    moe_flash = quant_moe_small_reference(torch, system_mod, config_path, video_path, fa,
                                          full_fp32)
    log(f"int8 / MoE reference: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    int8_counts = int8_serving(torch, system_mod, config_path, k1, k2, card,
                               profile="--profile" in sys.argv[1:])
    log(f"int8 serving: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    v2a_counts = video2audio_run(torch, video_path, k1, k2, card)
    log(f"video2audio: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    moe_train_run(torch, system_mod, video_path, fa, card)
    log(f"MoE training: done, {time.perf_counter() - t:.2f} s")

    t = time.perf_counter()
    scorer = eval_small_reference(torch, full_fp32)
    log(f"eval reference: done, {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    eval_counts, vgg_fd = eval_flow(torch, system_mod, config_path, k1, k2, scorer, tsv, card)
    del scorer
    log(f"eval flow: done, {time.perf_counter() - t:.2f} s")
    gc.collect()
    torch.cuda.empty_cache()

    try:
        log(f"XXL: the VGGishish FD process {fd_state(vgg_fd)}")
        t = time.perf_counter()
        xxl_serving, xxl_training = xxl_phase(torch, system_mod, k1, k2, fa, card, full_fp32)
        log(f"XXL: done, {time.perf_counter() - t:.2f} s")
        log(f"phase 17: the VGGishish FD process {fd_state(vgg_fd)}")
        par = parallel_phase(torch, system_mod, full_fp32, card, xl_peak)
        audioldm_phase(torch, k1, k2, card, vgg_fd)
    finally:
        stop(vgg_fd[0])

    kernels = []
    # launches, ms and the bound: phase 5's batch-4 XL vocode (bf16), as in
    # earlier runs; the other counted paths (phase 11's served requests, one
    # AMPBlock1 vocode per batch, and its AMPBlock2 vocoder; phase 12's audio
    # logger; phase 13's vocoder-GAN disc step; phase 15's two generation
    # vocodes, "eval"), each counted from 0, only
    # under launches_by_path, and the music and GAN shapes' phase 3 errors
    # under max_abs_err_by_path
    for i, (name, src, rep) in enumerate((
            ("K1 aa_snake_fused", "maa3_tpu_torch/csrc/aa_snake.cu",
             "maa3_tpu/ops/pallas_aa_snake.py:381"),
            ("K2 conv_snake_fused", "maa3_tpu_torch/csrc/conv_snake.cu",
             "maa3_tpu/ops/pallas_amp.py:165"))):
        by_path = {"xl_serving": counts[i], "music_server": serve["launches"][i],
                   "amp2_vocoder": amp2[i], "audio_logger": recipe["logger_counts"][i],
                   "vocoder_gan_disc_step": voc_gan["disc_counts"][i],
                   "eval": eval_counts[i], "xxl_serve": xxl_serving["counts"][i],
                   "video2audio_expert_parallel_per_vocode": par["ep_vocode"][i],
                   **{f"xl_serving_{m}": c[i] for m, c in int8_counts.items() if m},
                   **{f"video2audio_{m}_per_vocode": c[i] for m, c in v2a_counts.items()}}
        err = {path: max(r["err"] for r in rows if r["kernel"] == name[:2]
                         and r["path"] == path and r["dtype"] == dtype)
               for path, dtype in (("xl", "bfloat16"), ("music", "bfloat16"),
                                   ("gan", "float32"))}
        mine = [r for r in rows if r["kernel"] == name[:2] and r["path"] == "xl"
                and r["dtype"] == "bfloat16"]
        per_vocode = {key: sum(r[key] * r["launches"] for r in mine)
                      for key in ("ms", "plain_ms", "bound_ms", "bytes_ms",
                                  "ops_ms")}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[i], "max_abs_err": err["xl"],
            "ms": per_vocode["ms"], "plain_ms": per_vocode["plain_ms"],
            "bound_ms": per_vocode["bound_ms"],
            "bound_by": ("bytes" if per_vocode["bytes_ms"] >= per_vocode["ops_ms"]
                         else "operations"),
            "library_ms": None, "launches_by_path": by_path,
            "max_abs_err_by_path": err})
    # flash: per training step of the path that runs it (bf16), i.e. the
    # time at its main-path shape times its launches in one step
    xl_shape, k3b_shape = (6, 16, 1248, 72), (2, 16, 2048, 72)
    for name, src, rep, shape, cnt in (
            ("K3a flash_fwd (direct)", "maa3_tpu_torch/csrc/flash_fwd.cu",
             "maa3_tpu/ops/flash_attention.py:78", xl_shape, xl_steps[-1][1]["K3a"]),
            ("K3b flash_fwd (online)", "maa3_tpu_torch/csrc/flash_fwd.cu",
             "maa3_tpu/ops/flash_attention.py:118", k3b_shape, k3b_steps[-1][1]["K3b"]),
            ("K4a flash_bwd (fused)", "maa3_tpu_torch/csrc/flash_bwd.cu",
             "maa3_tpu/ops/flash_attention.py:224", xl_shape, xl_steps[-1][1]["K4a"]),
            ("K4b flash_bwd_dkv (split)", "maa3_tpu_torch/csrc/flash_bwd_split.cu",
             "maa3_tpu/ops/flash_attention.py:170", xl_shape,
             cond_steps["split"][-1][1]["K4b"]),
            ("K4c flash_bwd_dq (split)", "maa3_tpu_torch/csrc/flash_bwd_split.cu",
             "maa3_tpu/ops/flash_attention.py:299", xl_shape,
             cond_steps["split"][-1][1]["K4c"])):
        mine = [r for r in frows if r["kernel"] == name[:3] and r["dtype"] == "bfloat16"]
        r = next(r for r in mine if r["shape"] == shape)
        phase12 = recipe["micro_step_counts"].get(name[:3], 0)
        xxl_n = xxl_training["counts"].get(name[:3], 0)
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": cnt, "max_abs_err": max(x["err"] for x in mine),
            "ms": r["ms"] * cnt, "plain_ms": r["plain_ms"] * cnt,
            "bound_ms": r["bound_ms"] * cnt,
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": r["library_ms"] * cnt,
            "launches_by_path": {"main": cnt, "recipe_micro_step": phase12,
                                 "moe_forced_flash_step": moe_flash[name[:3]],
                                 "xxl_train": xxl_n,
                                 "pipe_stage_step_xl_depth4_fp32":
                                     par["pipe_check"].get(name[:3], 0),
                                 "pipe_stage_step_xl": par["pipe_xl"].get(name[:3], 0)}}
        if name[:3] == "K3a":  # the serving ODEs; phase 5's Euler step, profiled
            m = serve_attn
            entry["launches_by_path"].update(
                xl_serving_ode=serve_ode_k3a, xxl_serving_ode=xxl_serving["k3a"],
                music_server_3_batches=serve["k3a"], audio_logger=recipe["logger_counts"][2],
                eval=eval_counts[2],
                **{f"xl_serving_{mode}_ode": c[2] for mode, c in int8_counts.items() if mode})
            entry["xl_serving_step"] = {
                "shape": SERVE_STEP_ATTN, "launches": 2 * XL_DEPTH,
                "ms": XL_DEPTH * (m["k3a_self"] + m["k3a_cross"]),
                "layout_ms": XL_DEPTH * m["layout"],
                "dense_ms": XL_DEPTH * (m["dense_self"] + m["dense_cross"])}
        if xxl_n:  # phase 16's XXL step at head dim 48: per step, bf16
            x = next(r for r in mine if r["shape"] == XXL_FLASH)
            entry["xxl_train"] = {k: x[k] * xxl_n for k in ("ms", "plain_ms", "bound_ms",
                                                            "library_ms")}
            entry["xxl_train"]["max_abs_err"] = x["err"]
        kernels.append(entry)
    log(f"ODE chunk (XL, 25 steps, ms): " + "; ".join(
        f"batch {b} chunk {c}: {[round(x, 1) for x in v]}" for (b, c), v in chunk_ms.items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
