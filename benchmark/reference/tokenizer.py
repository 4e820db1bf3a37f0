"""The hash tokenizer the configurations assume (no tokenizer asset is in
the repository), frozen here so that the yardstick does not move with the
program: every lower-cased whitespace word becomes 1000 + md5(word) mod
(30522 - 1100), between 101 and 102, padded with 0 to 77 positions."""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

VOCAB, MAX_LEN = 30522, 77


def hash_tokens(texts: List[str], max_length: int = MAX_LEN) -> Tuple[np.ndarray, np.ndarray]:
    ids_all, mask_all = [], []
    for text in texts:
        ids = [101]
        for w in text.lower().split()[: max_length - 2]:
            ids.append(1000 + int(hashlib.md5(w.encode()).hexdigest(), 16) % (VOCAB - 1100))
        ids.append(102)
        mask = [1] * len(ids) + [0] * (max_length - len(ids))
        ids += [0] * (max_length - len(ids))
        ids_all.append(ids)
        mask_all.append(mask)
    return np.array(ids_all, np.int64), np.array(mask_all, np.int64)
