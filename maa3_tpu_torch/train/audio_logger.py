"""AudioLogger: samples generated during training (counterpart of
maa3_tpu/train/audio_logger.py, main.py's ImageLogger/AudioLogger role).

Every `every_n_steps` steps the Trainer hands the logger the system with the
trained weights; it generates from fixed captions with the CFG ODE
(`sample_cfg` -> `decode_first_stage` -> `vocode`) and writes, under
<logdir>/audio/step_XXXXXXXX/, each sample's mel (`NN_mel.npy`), its caption
(`NN_caption.txt`), a 16 kHz int16 wav (`NN.wav`, scipy) and a mel figure
(`NN_mel.png`) when matplotlib imports. The conditioning is built with
`MAA3System.captions`, which gives each conditioner kind its captions (the
JAX logger passes the caption dict to every kind, ROADMAP §3).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch


class AudioLogger:
    def __init__(self, logdir: str, every_n_steps: int = 5000,
                 sample_rate: int = 16000, max_items: int = 8,
                 melvmin: float = -5.0, melvmax: float = 1.5,
                 steps: int = 25, guidance_scale: float = 5.0):
        self.logdir = os.path.join(logdir, "audio")
        self.every = every_n_steps
        self.sample_rate = sample_rate
        self.max_items = max_items
        self.melvmin, self.melvmax = melvmin, melvmax
        self.steps = steps
        self.scale = guidance_scale

    def should_log(self, step: int) -> bool:
        return self.every > 0 and step > 0 and step % self.every == 0

    def _save_mel_png(self, mel: np.ndarray, path: str) -> None:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.imshow(mel, origin="lower", aspect="auto", vmin=self.melvmin,
                  vmax=self.melvmax, cmap="magma")
        ax.set_xlabel("frames")
        ax.set_ylabel("mel")
        fig.tight_layout()
        fig.savefig(path, dpi=80)
        plt.close(fig)

    @torch.no_grad()
    def log_samples(self, system, step: int, captions: List[dict],
                    generator: Optional[torch.Generator] = None) -> str:
        """Generate from captions ({ori_caption, struct_caption} each) with the
        system's current weights, the noise drawn from `generator`, and write
        the files. Returns the output directory."""
        from scipy.io import wavfile

        outdir = os.path.join(self.logdir, f"step_{step:08d}")
        os.makedirs(outdir, exist_ok=True)
        captions = captions[: self.max_items]
        n = len(captions)
        uc = system.get_learned_conditioning(system.captions([""] * n, [""] * n))
        c = system.get_learned_conditioning(system.captions(
            [x["ori_caption"] for x in captions], [x["struct_caption"] for x in captions]))
        z = system.sample_cfg(c, self.scale, uc, generator, timesteps=self.steps)
        mel = system.decode_first_stage(z)
        wav = system.vocode(mel)
        mel = mel.float().cpu().numpy()
        for i, cap in enumerate(captions):
            stem = os.path.join(outdir, f"{i:02d}")
            np.save(stem + "_mel.npy", mel[i])
            self._save_mel_png(mel[i], stem + "_mel.png")
            with open(stem + "_caption.txt", "w") as f:
                f.write(cap["ori_caption"] + "\n")
            pcm = (np.clip(wav[i].reshape(-1), -1, 1) * 32767).astype(np.int16)
            wavfile.write(stem + ".wav", self.sample_rate, pcm)
        print(f"AudioLogger: wrote {n} samples -> {outdir}", flush=True)
        return outdir
