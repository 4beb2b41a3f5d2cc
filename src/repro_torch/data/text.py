"""Byte-level corpus over local text files (``repro.data.text``), the
offline stand-in for Wikitext/PTB/BookCorpus. Stateless: batch i is a pure
function of (corpus bytes, seed, i) through strided window sampling in
numpy, so the port's batches equal the reference's bit for bit."""
from __future__ import annotations

import pathlib
from typing import Dict, Sequence

import numpy as np
import torch


class ByteCorpus:
    VOCAB = 256

    def __init__(self, paths: Sequence[str], seq_len: int, global_batch: int,
                 seed: int = 0, max_bytes: int = 32 * 1024 * 1024):
        """The bytes of ``paths`` in order: a directory contributes its
        ``*.py`` files, then its ``*.md`` files, each set sorted; reading
        stops once ``max_bytes`` are held."""
        buf = bytearray()
        for p in paths:
            path = pathlib.Path(p)
            if path.is_dir():
                files = sorted(path.rglob("*.py")) + sorted(path.rglob("*.md"))
            else:
                files = [path]
            for f in files:
                try:
                    buf += f.read_bytes()
                except OSError:
                    continue
                if len(buf) >= max_bytes:
                    break
        if len(buf) < (seq_len + 1) * 2:
            raise ValueError("corpus too small")
        self.data = np.frombuffer(bytes(buf), dtype=np.uint8)
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        """{'tokens', 'labels' (b, s) int64, 'mask' (b, s) f32} on
        ``device``: ``global_batch`` windows of ``seq_len + 1`` bytes at
        starts drawn from ``default_rng((seed << 32) ^ step)``; labels are
        the tokens shifted by one."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s = self.global_batch, self.seq_len
        starts = rng.integers(0, len(self.data) - s - 1, size=b)
        idx = starts[:, None] + np.arange(s + 1)[None]
        w = torch.from_numpy(self.data[idx].astype(np.int64))
        return {"tokens": w[:, :-1].to(device), "labels": w[:, 1:].to(device),
                "mask": torch.ones((b, s), dtype=torch.float32, device=device)}
