"""Text-to-audio server on the port (the flags of scripts/serve.py):

    python -m maa3_tpu_torch.serve -b configs/txt2music-cfm-cfg.yaml \\
        -r model.ckpt --vocoder-ckpt vocoder/ --port 8000 --warmup 1,8

    curl -X POST localhost:8000/generate -d '{"prompt": "a dog barks"}' -o dog.wav
    curl localhost:8000/healthz

Builds MAA3System.from_config on --device (cuda unless asked for cpu) from
the checkpoint (-r: a Lightning .ckpt of the reference or a .pt of the
port's Trainer) and the vocoder directory, runs the --warmup buckets, and
serves until interrupted (serving.AudioServer). --precision: bf16 (the
default; bf16 serving copy of the DiT, fp32 residual, bf16 vocoder), fp32
(fp32 throughout, without TF32), or fp32_highest, which names the JAX
package's six-pass fp32 matmul setting and is fp32 here: the card's fp32
path already runs without TF32. --fp32 is the deprecated alias of
--precision fp32. --quant selects int8 serving
(MAA3System.set_serving_quant) and composes with --precision bf16 only.

--n_model N serves tensor-parallel under torchrun (one process per GPU;
NCCL, gloo with --device cpu): every rank builds the same system and
shards its serving DiT (system.shard_serving over make_mesh(n_model=N),
the world split into world / N data ranks); rank 0 serves HTTP and the
other ranks sample each batch in lockstep (serving.follow):

    torchrun --nproc_per_node 2 -m maa3_tpu_torch.serve --n_model 2 ...

--trace_out PATH turns the program's spans on (maa3_tpu_torch/trace.py)
from start-up and writes them at shutdown to PATH as JSON lines (a rank
above 0 writes PATH.rank<k>).
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("-b", "--base", type=str, default="",
                   help="comma-separated config yamls")
    p.add_argument("-r", "--resume", type=str, default="",
                   help="Lightning .ckpt of the reference, or a .pt of the "
                        "port's Trainer")
    p.add_argument("--vocoder-ckpt", type=str, default="",
                   help="vocoder directory: config.json and generator.pt")
    p.add_argument("--tokenizer_dir", type=str, default="")
    p.add_argument("--fp32", action="store_true",
                   help="deprecated alias for --precision fp32")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32", "fp32_highest"],
                   help="bf16 (default), or fp32 without TF32 (fp32_highest "
                        "is the same on the card)")
    p.add_argument("--quant", type=str, default="",
                   help="int8 w8a8 per-step DiT GEMMs; composes with "
                        "--precision bf16 only")
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--window_ms", type=float, default=30.0)
    p.add_argument("--max_latent_len", type=int, default=None,
                   help="longest latent_len a request may ask for (default: "
                        "the config's own latent length)")
    p.add_argument("--warmup", type=str, default="1",
                   help="comma-separated batch buckets to run before accepting "
                        "traffic ('' to skip); e.g. 1,8")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel serving over n_model GPUs (under torchrun)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--trace_out", type=str, default="",
                   help="write the program's spans as JSON lines here at shutdown")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.parallel.mesh import distributed
    from maa3_tpu_torch import trace
    with distributed(opt.device) as device:
        if opt.trace_out:
            trace.enable(device)
        try:
            _serve(opt, device)
        finally:
            if opt.trace_out:
                trace.dump(opt.trace_out)


def _serve(opt, device):
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.serving import AudioServer, Lockstep, ServeConfig, follow
    from maa3_tpu_torch.system import MAA3System
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_paths = [c for c in opt.base.split(",") if c] or [
        os.path.join(root, "configs", "txt2audio-cfm-cfg.yaml")]
    precision = "fp32" if opt.fp32 else opt.precision
    if opt.quant and precision != "bf16":
        sys.exit("--quant int8 composes with --precision bf16 only")
    mesh = pmesh.make_mesh(n_model=opt.n_model)
    system = MAA3System.from_config(
        cfg_paths, seed=opt.seed, device=device,
        compute_dtype=torch.bfloat16 if precision == "bf16" else torch.float32,
        tokenizer_dir=opt.tokenizer_dir or None, ckpt_path=opt.resume or None,
        vocoder_dir=opt.vocoder_ckpt or None)
    if opt.quant:
        system.set_serving_quant(opt.quant)
    lockstep = None
    if pmesh.world_size() > 1:
        system.shard_serving(mesh)
        group = pmesh.control_group()
        if pmesh.rank() != 0:
            n = follow(system, group)
            print(f"rank {pmesh.rank()}: followed {n} batch(es)", flush=True)
            return
        lockstep = Lockstep(group)
    if not opt.resume:
        print("WARNING: no checkpoint given (-r); serving random weights")
    server = AudioServer(
        system,
        ServeConfig(max_batch=opt.max_batch, batch_window_ms=opt.window_ms,
                    default_steps=opt.steps, default_scale=opt.scale,
                    sample_rate=system.vocoder.cfg.sampling_rate, seed=opt.seed,
                    max_latent_len=opt.max_latent_len),
        host=opt.host, port=opt.port)
    if lockstep is not None:
        server.batcher.lockstep = lockstep
    try:
        if opt.warmup:
            buckets = [int(b) for b in opt.warmup.split(",") if b]
            print(f"warming up buckets {buckets}...", flush=True)
            server.batcher.warmup(buckets, steps=opt.steps)
        print(f"serving on http://{opt.host}:{server.port}  "
              "(POST /generate, GET /healthz, GET /stats)", flush=True)
        server.serve_forever()
    finally:
        if lockstep is not None:
            server.shutdown()  # releases the other ranks, whatever raised


if __name__ == "__main__":
    main()
