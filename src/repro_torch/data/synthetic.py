"""Stateless synthetic data (``repro.data.synthetic``): batch i is a pure
function of (seed, i), drawn in numpy from ``np.random.default_rng((seed,
i))``, so resuming at step i needs only the integer cursor.

The LM stream is a Zipf unigram mixture with injected local structure
(every other window of ``motif_len`` tokens repeats the one before), so a
model can lower its loss on it. The distributions are the reference's; its
bits are not (JAX draws with threefry), so parity tests feed JAX's batches
to both sides.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def zipf_probs(vocab: int, alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    return p / p.sum()


class SyntheticLM:
    """Deterministic, seekable synthetic corpus."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, alpha: float = 1.2, motif_len: int = 8):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.motif_len = motif_len
        self._p = zipf_probs(vocab, alpha)

    def batch_at(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        """Pure function of (seed, step) -> {'tokens', 'labels' (b, s)
        int64, 'mask' (b, s) f32} on ``device``; labels are the tokens
        shifted by one."""
        rng = np.random.default_rng((self.seed, step))
        b, s, m = self.global_batch, self.seq_len, self.motif_len
        base = rng.choice(self.vocab, size=(b, s + 1), p=self._p)
        # every other window (a fair coin per window) repeats the previous one
        n_win = (s + 1) // m
        rep = rng.random((b, n_win)) < 0.5
        toks = base[:, :n_win * m].reshape(b, n_win, m)
        prev = np.concatenate([toks[:, :1], toks[:, :-1]], axis=1)
        toks = np.where(rep[:, :, None], prev, toks).reshape(b, n_win * m)
        full = torch.from_numpy(np.concatenate([toks, base[:, n_win * m:]], axis=1))
        return {
            "tokens": full[:, :-1].to(device),
            "labels": full[:, 1:].to(device),
            "mask": torch.ones((b, s), dtype=torch.float32, device=device),
        }


class SyntheticClassification:
    """Synthetic sentiment-like task (the Table-3 analogue): the label
    decides which of two token populations (the lower or upper half of the
    vocabulary) dominates the sequence, 70 % against 30 %."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int = 0):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed

    def batch_at(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed + 77, step))
        b, s, v = self.batch, self.seq_len, self.vocab
        labels = (rng.random(b) < 0.5).astype(np.int64)
        lo = rng.integers(0, v // 2, (b, s))
        hi = rng.integers(v // 2, v, (b, s))
        bias = np.where(labels[:, None] == 1, 0.7, 0.3)
        toks = np.where(rng.random((b, s)) < bias, hi, lo)
        return {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labels).to(device)}
