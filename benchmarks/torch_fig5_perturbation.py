"""Fig. 5 on the PyTorch port (``benchmarks/fig5_perturbation.py``):
perturbation-bound heatmap over rank transitions (r -> r') computed from
real attention spectra (Eq. 4 / Eq. 9), plus the trust-region mask at the
annealed threshold."""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.torch_common import bench_cfg, save_json
from repro_torch.configs.base import ModelConfig
from repro_torch.core import perturbation as pert
from repro_torch.core import prng
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.models import transformer as tr
from repro_torch.models.api import get_model


def heatmap(cfg: ModelConfig, params) -> dict:
    """The heatmap of ||A_r' - A_r||_F over ``cfg``'s rank grid from the
    layer-, batch- and head-averaged K spectrum of 2 x 256 tokens (one
    forward on the parameters' device), relative to ||K||_F, and the
    trust region at the annealed threshold of step 1000, as numpy arrays
    (:func:`run` rounds them to 4 decimals)."""
    data = SyntheticLM(cfg.vocab_size, 256, 2, seed=13)
    with torch.no_grad():
        _, aux = tr.forward_dense(cfg, params,
                                  data.batch_at(0, device=params["embed"].device)["tokens"],
                                  collect_aux="rl", rank_rng=prng.key(0))
    k_s2 = aux["layers"]["k_s2"].cpu().numpy()       # (L, b, h, d)
    s2 = k_s2.mean(axis=(0, 1, 2))                    # average spectrum
    grid = list(cfg.rank.rank_grid)
    heat = np.zeros((len(grid), len(grid)))
    for i, r in enumerate(grid):
        for j, r2 in enumerate(grid):
            heat[i, j] = float(pert.rank_transition_norm(
                torch.from_numpy(s2), r, r2))
    norm = float(np.sqrt(s2.sum()))          # ||K||_F scale
    rel = heat / norm
    # late-training annealed threshold (Eq. 11, t=1000): transitions whose
    # relative perturbation exceeds it are vetoed — the paper's Fig. 5
    # "high-cost top-left region"
    eps_rel = float(pert.annealed_threshold(1.0, 1e-3, 1000))
    return {"grid": grid, "heatmap": heat, "heatmap_rel": rel,
            "trust_region": rel <= eps_rel, "threshold_rel": eps_rel}


def run(quick: bool = False, device="cuda") -> dict:
    del quick  # one forward either way, as in the reference
    cfg = bench_cfg("adaptive")
    params = get_model(cfg).init(torch.Generator(device).manual_seed(0),
                                 device=device)
    hm = heatmap(cfg, params)
    out = {
        "grid": hm["grid"],
        "heatmap": hm["heatmap"].round(4).tolist(),
        "heatmap_rel": hm["heatmap_rel"].round(4).tolist(),
        "trust_region": hm["trust_region"].tolist(),
        "threshold_rel": hm["threshold_rel"],
    }
    print("  ||dA||_F heatmap (rows r -> cols r'):")
    for r, row in zip(hm["grid"], hm["heatmap"]):
        print(f"   r={r:3d}: " + " ".join(f"{v:7.2f}" for v in row))
    save_json("fig5", out)
    return out


if __name__ == "__main__":
    run()
