"""Forensics of one dry-run cell of the port (``benchmarks/hlo_forensics.py``'s
counterpart): trace the cell (``repro_torch.launch.dryrun.trace_cell``) and
print its largest collectives, each with its kind, mesh axis and the
``repro_torch`` source line that dispatched it, its largest ops by output
bytes, with op name and source line, and the ops that access the most
bytes summed over their calls. There is no HLO: the port's program is
the eager step, so the lines name the Python that dispatched each op (in
the backward pass, the autograd node too). The counts' second line gives
this rank's argument and temporary bytes and the three roofline terms
(``benchmarks.torch_roofline.analyse``, one H100's published peaks).

``--remat`` overrides the config's ``remat`` (none | full | dots), as the
reference's does: the port checkpoints each layer of the step with
``torch.utils.checkpoint`` (``models.common.remat_layer``), so the counts
include the backward's recompute.

Usage:
  PYTHONPATH=src python -m benchmarks.torch_forensics --arch qwen2.5-14b \\
      --cell train_4k [--layers 2] [--remat dots] [--sharding fsdp] [--topk 15] \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.models.common import REMAT_MODES


def overrides_of(arch: str, layers=None, sharding=None, remat=None) -> dict:
    """The reference's ``--layers`` / ``--remat`` / ``--sharding`` overrides."""
    out = {}
    if layers:
        out["num_layers"] = layers
        if get_config(arch).num_encoder_layers:
            out["num_encoder_layers"] = layers
    if remat:
        out["remat"] = remat
    if sharding:
        out["sharding"] = sharding
    return out


def report(rec: dict, topk: int) -> str:
    from benchmarks.torch_roofline import analyse
    terms = analyse(rec)
    mem = rec["memory"]
    lines = [f"flops={rec['flops']:.4e}  bytes={rec['bytes_accessed']:.4e}  "
             f"coll={rec['collectives']['total']:.4e}  (per device, {rec['devices']} "
             f"ranks, fake {rec['device']} tensors)",
             f"arguments={mem['argument_bytes'] / 2 ** 30:.2f} GiB  "
             f"temporaries={mem['temp_bytes'] / 2 ** 30:.2f} GiB  roofline "
             f"compute={terms['compute_s']:.4g} s memory={terms['memory_s']:.4g} s "
             f"collective={terms['collective_s']:.4g} s ({terms['dominant']})",
             f"\n== top {topk} collectives (per-device result bytes) =="]
    for b, kind, axis, src in rec["top_collectives"]:
        lines.append(f"  {b / 1e9:9.3f} GB  {kind:16s} over {axis:6s} {src}")
    lines.append(f"\n== top {topk} ops by output bytes ==")
    for b, op, src in rec["top_ops"]:
        lines.append(f"  {b / 1e9:9.3f} GB  {op:36s} {src}")
    lines.append(f"\n== top {topk} ops by bytes accessed over all their calls ==")
    for op, b in rec["bytes_by_op"].items():
        lines.append(f"  {b / 1e9:11.3f} GB  {op}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, default=None, help="override layer count")
    ap.add_argument("--remat", default=None, choices=REMAT_MODES)
    ap.add_argument("--sharding", default=None)
    ap.add_argument("--topk", type=int, default=15)
    ap.add_argument("--static-rank", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.launch import dryrun
    dryrun.require_device(args.device)
    cell = next(c for c in SHAPE_CELLS if c.name == args.cell)
    rec = dryrun.trace_cell(args.arch, cell, args.mesh, static_rank=args.static_rank,
                            overrides=overrides_of(args.arch, args.layers, args.sharding,
                                                   args.remat),
                            device=args.device, topk=args.topk)
    rec.update(arch=args.arch, cell=args.cell, mesh=args.mesh)
    print(report(rec, args.topk))


if __name__ == "__main__":
    main()
