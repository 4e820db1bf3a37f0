"""Text-to-audio CLI on the port (the flags of scripts/txt2audio.py):

    python -m maa3_tpu_torch.txt2audio --prompt "a bird chirps" --outdir out \
        [-r model.ckpt] [--vocoder-ckpt vocoder/] [-b config.yaml]
    python -m maa3_tpu_torch.txt2audio --test-dataset test.tsv --batch_size 8 ...
    python -m maa3_tpu_torch.txt2audio --interactive ...

Builds MAA3System.from_config (weights from -r, a Lightning .ckpt of the
reference or a .pt of the port's Trainer, and from the vocoder directory;
random weights from --seed without -r), encodes the prompts and the empty
caption (as the config's conditioner takes them, MAA3System.captions), runs
the 25-step CFG ODE, decodes and vocodes, and writes 16-bit wavs plus
result.csv. --test-dataset reads a TSV's ori_cap, caption and name columns
and runs --batch_size prompts per launch (the ragged tail repeats its last
prompt, and the repeats are dropped); --interactive reads prompts from
stdin until an empty line or end of input. --n_iter is accepted, as the
JAX CLI accepts it, and unused. --quant selects int8 serving
(MAA3System.set_serving_quant: int8, int8:g128, int8:now2, int8:voc,
int8:smooth, calibrated on the first prompt's conditioning). --n_model N
serves tensor-parallel under torchrun (one process per GPU; NCCL, gloo with
--device cpu; system.shard_serving over make_mesh(n_model=N), the world
split into world / N data ranks, which split each launch's rows): every
rank runs the same prompts and seeds, and rank 0 decodes, vocodes and
writes the files (with --interactive it reads stdin and hands each prompt
to the other ranks):

    torchrun --nproc_per_node 2 -m maa3_tpu_torch.txt2audio --n_model 2 ...
"""

from __future__ import annotations

import argparse
import csv
import os
import time
import wave

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a bird chirps")
    p.add_argument("--test-dataset", type=str, default="none",
                   help="TSV manifest (ori_cap, caption, name) to generate for")
    p.add_argument("--outdir", type=str, default="outputs/txt2audio-samples")
    p.add_argument("--ddim_steps", type=int, default=25)
    p.add_argument("--steps", type=int, default=None, help="alias of --ddim_steps")
    p.add_argument("--n_iter", type=int, default=1, help="accepted, unused")
    p.add_argument("-H", type=int, default=20)
    p.add_argument("-W", type=int, default=312)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=1,
                   help="distinct testset prompts per ODE launch "
                        "(requires --n_samples 1)")
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("-r", "--resume", type=str, default="",
                   help="Lightning .ckpt of the reference, or a .pt of the "
                        "port's Trainer")
    p.add_argument("-b", "--base", type=str, default="",
                   help="comma-separated config yamls")
    p.add_argument("--vocoder-ckpt", type=str, default="",
                   help="vocoder directory: config.json and generator.pt")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tokenizer_dir", type=str, default="",
                   help="dir with bert/vocab.txt + t5/tokenizer.json "
                        "(default: $MAA3_TOKENIZER_DIR)")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--fp32", action="store_true",
                   help="run the DiT and vocoder in fp32 (parity mode)")
    p.add_argument("--quant", type=str, default="",
                   help="serving quantization: 'int8' runs the per-step DiT "
                        "GEMMs w8a8; variants int8:g128 / :now2 / :voc (the wide "
                        "vocoder convs too) / :smooth (SmoothQuant migration, "
                        "calibrated on the first prompt)")
    p.add_argument("--save_mel", action="store_true",
                   help="also write <name>_mel.npy next to each wav")
    p.add_argument("--interactive", action="store_true",
                   help="read prompts from stdin; an empty line ends")
    p.add_argument("--n_model", type=int, default=1,
                   help="tensor-parallel serving over n_model GPUs (under torchrun; "
                        "the world reshapes to (world / n_model, n_model))")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    pcm = (np.clip(wav, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _conditioning(system, prompts):
    return system.get_learned_conditioning(system.captions(
        [p["ori_caption"] for p in prompts], [p["struct_caption"] for p in prompts]))


def _read_prompt(main: bool) -> str:
    """The next stdin line on rank 0 ('' at the end), handed to every rank."""
    prompt = ""
    if main:
        try:
            prompt = input("> ").strip()
        except EOFError:
            pass
    from maa3_tpu_torch.parallel import mesh as pmesh
    if pmesh.world_size() > 1:
        import torch.distributed as dist
        box = [prompt]
        dist.broadcast_object_list(box, src=0)
        prompt = box[0]
    return prompt


def _interactive(system, opt, steps, gen, main: bool) -> None:
    """scripts/txt2audio.py:128-154: one prompt per line of stdin."""
    uc = _conditioning(system, [{"ori_caption": "", "struct_caption": ""}])
    if main:
        print("interactive mode: type a prompt (empty line to quit)")
    n = 0
    while True:
        prompt = _read_prompt(main)
        if not prompt:
            break
        t0 = time.perf_counter()
        c = _conditioning(system, [{"ori_caption": prompt,
                                    "struct_caption": f"<{prompt}& all>"}])
        z = system.sample_cfg(c, opt.scale, uc, gen, shape=(1, opt.H, opt.W),
                              timesteps=steps)
        if not main:
            continue
        wav = system.vocode(system.decode_first_stage(z))
        path = os.path.join(opt.outdir, f"interactive_{n}.wav")
        write_wav(path, wav[0], opt.sample_rate)
        print(f"{path}  ({time.perf_counter() - t0:.3f} s)", flush=True)
        n += 1


def main(argv=None):
    opt = parse_args(argv)
    from maa3_tpu_torch.parallel.mesh import distributed
    with distributed(opt.device) as device:
        _generate(opt, device)


def _generate(opt, device):
    from maa3_tpu_torch.data.datasets import read_tsv
    from maa3_tpu_torch.parallel import mesh as pmesh
    from maa3_tpu_torch.system import MAA3System
    steps = opt.steps or opt.ddim_steps
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_paths = [c for c in opt.base.split(",") if c] or [
        os.path.join(root, "configs", "txt2audio-cfm-cfg.yaml")]
    mesh = pmesh.make_mesh(n_model=opt.n_model)
    main = pmesh.rank() == 0
    system = MAA3System.from_config(
        cfg_paths, seed=opt.seed, device=device,
        compute_dtype=torch.float32 if opt.fp32 else torch.bfloat16,
        tokenizer_dir=opt.tokenizer_dir or None, ckpt_path=opt.resume or None,
        vocoder_dir=opt.vocoder_ckpt or None)
    if opt.quant:
        system.set_serving_quant(opt.quant)
    if pmesh.world_size() > 1:
        system.shard_serving(mesh)
    if not opt.resume and main:
        print("WARNING: no checkpoint given (-r); generating with random weights")
    if main:
        os.makedirs(opt.outdir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(opt.seed)
    if opt.interactive:
        _interactive(system, opt, steps, gen, main)
        return

    if opt.test_dataset != "none":
        prompts = [{"ori_caption": r["ori_cap"],
                    "struct_caption": r.get("caption", r["ori_cap"]),
                    "name": r.get("name", f"sample_{i}")}
                   for i, r in enumerate(read_tsv(opt.test_dataset))]
    else:
        prompts = [{"ori_caption": opt.prompt,
                    "struct_caption": f"<{opt.prompt}& all>", "name": "prompt"}]
    bs = max(1, opt.batch_size)
    if bs > 1 and opt.n_samples != 1:
        raise SystemExit("--batch_size > 1 requires --n_samples 1")
    per_launch = bs if bs > 1 else opt.n_samples
    uc = _conditioning(system, [{"ori_caption": "", "struct_caption": ""}] * per_launch)
    if opt.quant and "smooth" in opt.quant:
        # SmoothQuant: one calibration ODE on the first prompt's conditioning
        c0 = _conditioning(system, [prompts[0]] * per_launch)
        system.calibrate_smooth(c0, uc, timesteps=steps, scale=opt.scale)
    rows = []
    t0 = time.perf_counter()
    for chunk in (prompts[i:i + bs] for i in range(0, len(prompts), bs)):
        pad = bs - len(chunk) if bs > 1 else 0
        launch = (chunk + [chunk[-1]] * pad if bs > 1  # ragged tail: repeat, drop
                  else chunk * opt.n_samples)
        c = _conditioning(system, launch)
        z = system.sample_cfg(c, opt.scale, uc, gen, shape=(per_launch, opt.H, opt.W),
                              timesteps=steps)
        if not main:  # every rank samples (the collectives); rank 0 writes
            continue
        mel = system.decode_first_stage(z)
        wav = system.vocode(mel)
        for n in range(per_launch - pad):
            fname = f"{launch[n]['name']}_{n if bs == 1 else 0}.wav"
            path = os.path.join(opt.outdir, fname)
            write_wav(path, wav[n], opt.sample_rate)
            if opt.save_mel:
                np.save(path[:-4] + "_mel.npy", mel[n].float().cpu().numpy())
            rows.append({"caption": launch[n]["ori_caption"], "file": fname})
    if not main:
        return
    with open(os.path.join(opt.outdir, "result.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["caption", "file"])
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} wav(s), mel {tuple(mel.shape)}, "
          f"{time.perf_counter() - t0:.3f} s -> {opt.outdir}")


if __name__ == "__main__":
    main()
