"""Config dataclasses of the port: its own copies of the fields of
``repro.configs.base.ModelConfig`` / ``RankConfig`` that the serving path
reads, with the same names and defaults."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class RankConfig:
    """DR-RL dynamic low-rank attention configuration.

    mode: 'off' (full rank), 'fixed' (``fixed_rank``), 'adaptive' (NER
    energy threshold, median over heads, snapped to the grid), 'drrl' (the
    agent's policy under the Eq. 9-11 guardrail) and, in serving, 'learned'
    (the same inference path with offline-trained params); the mode
    'random' is not ported yet."""
    mode: str = "off"
    realisation: str = "masked"
    rank_grid: Tuple[int, ...] = (16, 24, 32, 40, 48, 56, 64)
    fixed_rank: int = 32
    energy_threshold: float = 0.90     # Adaptive-SVD NER target
    static_rank: Optional[int] = None
    truncate_values: bool = False
    segment_len: int = 512             # segment-level adaptation period T
    # perturbation guardrail (Eq. 9-11)
    guardrail: bool = True
    epsilon0: float = 1.0
    anneal_lambda: float = 1e-3
    # reward (Eq. 13)
    alpha: float = 1.0
    beta: float = 0.3
    gamma: float = 0.1
    power_iters: int = 3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only 'dense' is ported
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 32768
    rank: RankConfig = field(default_factory=RankConfig)
    mrope: bool = False
    dtype: str = "float32"         # activation/compute dtype
    param_dtype: str = "float32"
    softmax_dtype: str = "float32"

    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
