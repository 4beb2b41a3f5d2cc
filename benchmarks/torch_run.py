"""Benchmark harness of the PyTorch port — one run per paper table/figure
(``benchmarks/run.py``'s counterpart, which imports JAX).

Prints ``name,us_per_call,derived`` CSV (us_per_call = wall time of the
benchmark; derived = the headline number it reproduces), as the
reference's does, and writes each result to
``benchmarks/artifacts/torch_<name>.json``.

Usage:
    PYTHONPATH=src python -m benchmarks.torch_run [--quick] [--only table1]
    PYTHONPATH=src python -m benchmarks.torch_run --smoke --device cpu

``roofline`` reads the dry run's artifacts (``python -m
repro_torch.launch.dryrun``; ``no_dryrun_artifacts`` without them). The
reference's ``serve`` (the serving benchmark) is not ported here:
``--only serve`` names its ROADMAP item.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time

import numpy as np


def _timed(fn, *a, **kw):
    t0 = time.monotonic()
    out = fn(*a, **kw)
    return out, (time.monotonic() - t0) * 1e6


def _table1(res):
    drrl, full = res["drrl"], res["off"]
    return (f"drrl_ppl={drrl['ppl']};full_ppl={full['ppl']};"
            f"drrl_flops_frac={drrl['attn_flops_frac']}")


def _roofline(rows):
    if not rows:
        return "no_dryrun_artifacts"
    best = max(rows, key=lambda r: r["roofline_frac"])
    return (f"cells={len(rows)};best={best['arch']}/{best['cell']}"
            f"@{100 * best['roofline_frac']:.1f}%")


def _fig5(res):
    tr_frac = float(np.mean(np.asarray(res["trust_region"], dtype=float)))
    return f"trust_region_frac={tr_frac:.3f}"


# name -> (module with run(quick=, device=), its headline string)
BENCHES = {
    "table1": ("benchmarks.torch_table1_lm", _table1),
    "table2": ("benchmarks.torch_table2_ablation",
               lambda res: ";".join(f"{k}={v['ppl']}" for k, v in res.items())),
    "table3": ("benchmarks.torch_table3_downstream",
               lambda res: ";".join(f"{k}={v['accuracy']}" for k, v in res.items())),
    "fig2": ("benchmarks.torch_fig2_training",
             lambda res: (f"final_loss={res['lm_loss_curve'][-1]};"
                          f"final_reward={res['reward_curve'][-1]}")),
    "fig3": ("benchmarks.torch_fig3_rank_evolution",
             lambda res: (f"adaptive_layers={res['adaptive']['per_layer_mean_rank']};"
                          f"drrl_mean={res['drrl']['overall']}")),
    "fig4": ("benchmarks.torch_fig4_flops_scaling",
             lambda res: f"reduction_at_L4096={res['claim_L4096_reduction_pct']}%"),
    "fig5": ("benchmarks.torch_fig5_perturbation", _fig5),
    "roofline": ("benchmarks.torch_roofline", _roofline),
}
NOT_PORTED = {
    "serve": "the serving benchmark is the port's benchmark PR (ROADMAP item 15)",
}


def derived(name: str, res) -> str:
    """The CSV's ``derived`` string of benchmark ``name``'s result."""
    return BENCHES[name][1](res)


def bench(name: str, quick: bool = False, device="cuda"):
    """Run benchmark ``name`` on ``device``: (result, wall us, derived)."""
    run = importlib.import_module(BENCHES[name][0]).run
    res, us = _timed(run, quick=quick, device=device)
    return res, us, derived(name, res)


def bench_smoke(quick=False, device="cuda"):
    """CI canary: one train step + one eval batch + the FLOPs probe at tiny
    scale, through the same shared-harness code paths every table/figure
    uses — so import or API rot in benchmarks/ fails CI in seconds."""
    del quick  # always minimal
    from benchmarks.torch_common import (attn_flops_fraction, bench_cfg, eval_ppl,
                                         train_lm)
    t0 = time.monotonic()
    cfg = bench_cfg("fixed")
    out = train_lm(cfg, steps=1, device=device)
    ppl = eval_ppl(cfg, out["params"], out["fns"], n_batches=1)
    frac = attn_flops_fraction(cfg, out["params"])
    us = (time.monotonic() - t0) * 1e6
    if not (np.isfinite(ppl) and 0.0 < frac <= 1.0):
        raise RuntimeError(f"smoke: ppl {ppl}, attention FLOPs fraction {frac}")
    return us, f"ppl={ppl:.2f};attn_flops_frac={frac:.3f};steps=1"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None, choices=[*BENCHES, *NOT_PORTED])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, one step — CI canary for the harness")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        print("name,us_per_call,derived")
        us, d = bench_smoke(device=args.device)
        print(f"smoke,{us:.0f},{d}", flush=True)
        return
    if args.only in NOT_PORTED:
        sys.exit(f"{args.only}: not ported: {NOT_PORTED[args.only]}")
    names = [args.only] if args.only else list(BENCHES)
    print("name,us_per_call,derived")
    for name in names:
        print(f"# running {name} ...", flush=True)
        _, us, d = bench(name, quick=args.quick, device=args.device)
        print(f"{name},{us:.0f},{d}", flush=True)
    if not args.only:
        for name, why in NOT_PORTED.items():
            print(f"# {name}: not ported: {why}", flush=True)


if __name__ == "__main__":
    main()
