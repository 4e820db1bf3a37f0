"""CLAP score: the cosine of the audio and caption embeddings (counterpart
of maa3_tpu/eval/clap_score.py; wav_evaluation/models/CLAPWrapper.py and
cal_clap_score.py).

Audio: resampled to 44.1 kHz on the host, tiled or cropped from 0 to
`duration` (5 s), Cnn14 -> Projection(2048 -> 1024). Text: BERT, the [CLS]
token -> Projection(768 -> 1024). `CLAPModel` carries the keys of
CLAP_weights_2022.pth's `model` dict: audio_encoder.{base (Cnn14),
projection} and caption_encoder.{base (BERT), projection}; the file's
other keys (the BERT pooler, the torchlibrosa frontend's buffers, the
logit scale) are skipped and logged at import. The towers run in fp32
without TF32.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from maa3_tpu_torch.data.tokenizers import load_tokenizer
from maa3_tpu_torch.models.bert import Bert, BertConfig, _ns, bert_apply
from maa3_tpu_torch.models.clap import clap_flan_init_, projection_apply
from maa3_tpu_torch.models.cnn14 import Cnn14, Cnn14Config, cnn14_apply, cnn14_init_
from maa3_tpu_torch.pipeline import full_fp32


def _projection(d_in: int, d_out: int) -> nn.Module:
    return _ns(linear1=nn.Linear(d_in, d_out, bias=False),
               linear2=nn.Linear(d_out, d_out, bias=False),
               layer_norm=nn.LayerNorm(d_out))


class CLAPModel(nn.Module):
    def __init__(self, audio_cfg: Cnn14Config = Cnn14Config(),
                 bert_cfg: BertConfig = BertConfig(), d_proj: int = 1024):
        super().__init__()
        self.audio_encoder = _ns(base=Cnn14(audio_cfg),
                                 projection=_projection(audio_cfg.out_emb, d_proj))
        self.caption_encoder = _ns(base=Bert(bert_cfg),
                                   projection=_projection(bert_cfg.hidden_size, d_proj))


class CLAPScorer:
    def __init__(self, model: CLAPModel, tokenizer, duration: float = 5.0):
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.duration = duration

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def audio_cfg(self) -> Cnn14Config:
        return self.model.audio_encoder.base.cfg

    @classmethod
    def random_init(cls, generator: Optional[torch.Generator] = None,
                    tokenizer_dir: Optional[str] = None,
                    bert_cfg: BertConfig = BertConfig(), d_proj: int = 1024,
                    device="cuda") -> "CLAPScorer":
        """Random towers drawn on the CPU from `generator` (seed 0 when None):
        Cnn14 as cnn14_init_, the caption tower and both projections as the
        conditioners' clap_flan_init_."""
        generator = generator or torch.Generator().manual_seed(0)
        model = CLAPModel(Cnn14Config(), bert_cfg, d_proj)
        cnn14_init_(model.audio_encoder.base, generator)
        clap_flan_init_(model.audio_encoder.projection, generator)
        clap_flan_init_(model.caption_encoder, generator)
        return cls(model.to(device),
                   load_tokenizer(tokenizer_dir, "bert", max_length=100))

    @classmethod
    def from_torch_ckpt(cls, weights_path: str, tokenizer_dir: Optional[str] = None,
                        bert_cfg: BertConfig = BertConfig(), d_proj: int = 1024,
                        device="cuda") -> "CLAPScorer":
        """CLAP_weights_2022.pth ({'model': {audio_encoder.*, caption_encoder.*}})."""
        from maa3_tpu_torch.torch_import import clap_scorer_from_torch, load_torch_checkpoint
        model = clap_scorer_from_torch(load_torch_checkpoint(weights_path), bert_cfg, d_proj)
        return cls(model.to(device),
                   load_tokenizer(tokenizer_dir, "bert", max_length=100))

    def _prep_audio(self, wav: np.ndarray, sr: int) -> np.ndarray:
        """Resample to 44.1 kHz; tile, then crop from 0 to `duration`
        (CLAPWrapper.load_audio_into_tensor with the crop at 0)."""
        target_sr = self.audio_cfg.sample_rate
        if sr != target_sr:
            from scipy.signal import resample_poly
            g = math.gcd(sr, target_sr)
            wav = resample_poly(wav, target_sr // g, sr // g)
        need = int(self.duration * target_sr)
        if len(wav) < need:
            wav = np.tile(wav, int(np.ceil(need / max(len(wav), 1))))
        return wav[:need].astype(np.float32)

    @torch.no_grad()
    def audio_embeddings(self, wavs: List[np.ndarray], sr: int = 16000) -> torch.Tensor:
        batch = torch.from_numpy(np.stack([self._prep_audio(w, sr) for w in wavs]))
        enc = self.model.audio_encoder
        with full_fp32():
            out = cnn14_apply(enc.base, batch.to(self.device))
            return projection_apply(enc.projection, out["embedding"])

    @torch.no_grad()
    def text_embeddings(self, captions: List[str]) -> torch.Tensor:
        ids, mask = self.tokenizer(list(captions))
        enc = self.model.caption_encoder
        with full_fp32():
            h = bert_apply(enc.base, torch.from_numpy(ids).long().to(self.device),
                           torch.from_numpy(mask).to(self.device))
            return projection_apply(enc.projection, h[:, 0, :])  # [CLS]

    def score(self, wavs: List[np.ndarray], captions: List[str],
              sr: int = 16000) -> np.ndarray:
        """Per-pair cosine similarity (cal_clap_score.py's cosine path)."""
        a = self.audio_embeddings(wavs, sr)
        t = self.text_embeddings(captions)
        a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
        t = t / torch.linalg.norm(t, dim=-1, keepdim=True)
        return (a * t).sum(dim=-1).cpu().numpy()
