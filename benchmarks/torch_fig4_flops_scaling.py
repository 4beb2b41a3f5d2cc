"""Fig. 4 on the PyTorch port (``benchmarks/fig4_flops_scaling.py``):
attention FLOPs vs sequence length for Full-Rank vs DR-RL (and fixed
low-rank). Validates the paper's headline claim:
  > 40% FLOPs reduction in long-sequence regimes (L > 4096).

Protocol: train the bench LM (spectra concentrate with training, mirroring
the paper's Fig. 3 layer-wise structure), roll out the rank policy on real
spectra, then evaluate the exact per-head cost model
  score term: 2 L^2 r   +  value term: 2 L^2 r_v
with r from the policy. Both the paper-faithful score-side truncation and
the score+value truncation (RankConfig.truncate_values, Eq. 5/10) are
reported.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.torch_common import bench_cfg, save_json, train_lm
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.models.attention import attention_flops

LENGTHS = (512, 1024, 2048, 4096, 8192, 16384, 32768)


def mean_rank(cfg: ModelConfig, params, L_run: int = 1024) -> float:
    """Mean rank the policy picks over 2 x ``L_run`` tokens (one unchunked
    forward on the parameters' device)."""
    data = SyntheticLM(cfg.vocab_size, L_run, 2, seed=9)
    with torch.no_grad():
        _, aux = tr.forward_dense(cfg, params,
                                  data.batch_at(0, device=params["embed"].device)["tokens"],
                                  collect_aux="ranks", rank_rng=prng.key(0))
    return float(np.mean(aux["layers"]["rank"].cpu().numpy()))


def flops_rows(cfg: ModelConfig, r_mean: float) -> list:
    """One row per length of ``LENGTHS``: full-rank, score-only and
    score+value attention FLOPs at mean rank ``r_mean``, fixed-rank FLOPs,
    and the two reductions in percent."""
    dh = cfg.resolved_head_dim()
    h = cfg.num_heads
    r_fixed = cfg.rank.fixed_rank
    rows = []
    for L in LENGTHS:
        full = attention_flops(L, L, h, dh, dh) * cfg.num_layers
        # paper-faithful: scores contracted at r, values at full d_v
        drrl_score = attention_flops(L, L, h, dh, dh, rank=r_mean) \
            * cfg.num_layers
        # +value truncation (truncate_values=True)
        drrl_qkv = 2.0 * h * (L * L * r_mean + L * L * r_mean) \
            * cfg.num_layers
        fixed = attention_flops(L, L, h, dh, dh, rank=r_fixed) * cfg.num_layers
        rows.append({
            "L": L, "full": full, "drrl_score": drrl_score,
            "drrl_qkv": drrl_qkv, "fixed": fixed,
            "reduction_score_pct": round(100 * (1 - drrl_score / full), 1),
            "reduction_qkv_pct": round(100 * (1 - drrl_qkv / full), 1),
        })
    return rows


def run(quick: bool = False, device="cuda") -> dict:
    cfg = bench_cfg("adaptive")
    trained = train_lm(bench_cfg("off"), steps=15 if quick else 60, device=device)
    dh = cfg.resolved_head_dim()
    r_mean = mean_rank(cfg, trained["params"], L_run=256 if quick else 1024)
    rows = flops_rows(cfg, r_mean)
    for row in rows:
        print(f"  L={row['L']:6d} full={row['full']:.3e} "
              f"score-only −{row['reduction_score_pct']:.1f}% "
              f"score+value −{row['reduction_qkv_pct']:.1f}%")
    out = {"rows": rows, "mean_rank": r_mean, "head_dim": dh,
           "claim_L4096_reduction_pct": rows[3]["reduction_qkv_pct"],
           "claim_paper": 41.5}
    print(f"  mean policy rank {r_mean:.1f}/{dh}; reduction at L=4096: "
          f"{out['claim_L4096_reduction_pct']}% (paper: 41.5%)")
    save_json("fig4", out)
    return out


if __name__ == "__main__":
    run()
