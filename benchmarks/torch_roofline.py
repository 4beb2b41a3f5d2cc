"""Roofline analysis of the port (``benchmarks/roofline.py``'s counterpart):
the three roofline terms per (arch x shape x mesh) from the port's dry-run
artifacts (``repro_torch.launch.dryrun``), priced on one NVIDIA H100.

  compute    = FLOPs_per_device / peak of the cell's compute dtype
               [989e12 bf16 tensor cores; 67e12 f32: TF32 is off for matmuls]
  memory     = bytes_per_device / 3.35e12        [HBM bw / card]
  collective = collective_bytes_per_device / 450e9  [NVLink bw / card, each way]

The artifacts count one rank's eager, unfused program (their ``counts``
line): the FLOPs are matmul, convolution and attention only, the bytes
each op's inputs and outputs. A 16-wide mesh axis spans two 8-card hosts,
so the collective term is a lower bound there. MODEL_FLOPS = 6 N D (dense)
/ 6 N_active D (MoE) for train cells, 2 N D for a single forward
(prefill), 2 N_active per generated token for decode, as the reference's.

Usage: PYTHONPATH=src python -m benchmarks.torch_roofline [--mesh single] [--csv | --markdown]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.mesh import (CARD, HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32)

ART = pathlib.Path(__file__).resolve().parent / "artifacts" / "dryrun_torch"

# peak FLOP/s of a cell's compute dtype (ModelConfig.dtype)
PEAKS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}

_CACHE = {}


def _counts(arch: str):
    if arch not in _CACHE:
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        _CACHE[arch] = (cfg.n_params(), cfg.n_active_params(), cfg)
    return _CACHE[arch]


def model_flops(arch: str, cell: str, devices: int) -> float:
    """Global useful model FLOPs for this cell (forward+backward for train)."""
    n, na, cfg = _counts(arch)
    non_emb = na - cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    seq, batch = {"train_4k": (4096, 256), "prefill_32k": (32768, 32),
                  "decode_32k": (32768, 128), "long_500k": (524288, 1)}[cell]
    if cell == "train_4k":
        return 6.0 * non_emb * seq * batch
    if cell == "prefill_32k":
        return 2.0 * non_emb * seq * batch
    # decode: one token per sequence
    return 2.0 * non_emb * 1 * batch


def analyse(rec: dict, peak=None, hbm=HBM_BW, link=NVLINK_BW) -> dict:
    """The three terms of one artifact and the reference's derived ratios.
    ``peak`` defaults to the peak of the arch's compute dtype."""
    if peak is None:
        peak = PEAKS[_counts(rec["arch"])[2].dtype]
    dev = rec["devices"]
    comp = rec["flops"] / peak
    mem = rec["bytes_accessed"] / hbm
    coll = rec["collectives"]["total"] / link
    dominant = max((comp, "compute"), (mem, "memory"), (coll, "collective"))[1]
    mf = model_flops(rec["arch"], rec["cell"], dev)
    global_flops = rec["flops"] * dev
    useful = mf / global_flops if global_flops else 0.0
    bound = max(comp, mem, coll)
    # roofline fraction: useful model FLOP/s achievable vs peak, assuming the
    # dominant term sets the step time
    mfu_bound = (mf / dev / peak) / bound if bound else 0.0
    return {
        "arch": rec["arch"], "cell": rec["cell"], "mesh": rec["mesh"],
        "compute_s": comp, "memory_s": mem, "collective_s": coll,
        "dominant": dominant, "model_flops": mf,
        "useful_ratio": useful, "roofline_frac": mfu_bound,
        "flops_dev": rec["flops"], "bytes_dev": rec["bytes_accessed"],
        "coll_dev": rec["collectives"]["total"],
    }


def load_all(mesh: str = "single", tag: str = ""):
    """Analyse the ok artifacts of ``mesh`` (those tagged ``tag``, else
    the untagged ones)."""
    recs = {}
    for f in sorted(ART.glob(f"*__{mesh}{tag}.json")):
        if not tag and len(f.stem.split("__")) != 3:
            continue
        rec = json.loads(f.read_text())
        if rec.get("ok"):
            recs[(rec["arch"], rec["cell"])] = rec
    return [analyse(r) for _, r in sorted(recs.items())]


def header() -> str:
    return (f"{CARD}: bf16 {PEAK_FLOPS_BF16 / 1e12:g} TFLOP/s, f32 "
            f"{PEAK_FLOPS_F32 / 1e12:g} TFLOP/s, HBM {HBM_BW / 1e12:g} TB/s, NVLink "
            f"{NVLINK_BW / 1e9:g} GB/s each way")


def fmt_table(rows) -> str:
    hdr = (f"{'arch':22s} {'cell':12s} {'compute':>10s} {'memory':>10s} "
           f"{'collect':>10s} {'dominant':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [header(), hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['arch']:22s} {r['cell']:12s} {r['compute_s']:.3e} "
            f"{r['memory_s']:.3e} {r['collective_s']:.3e} "
            f"{r['dominant']:>10s} {r['useful_ratio']:6.2f} "
            f"{100 * r['roofline_frac']:6.1f}%")
    return "\n".join(lines)


def markdown(meshes=("single", "multi")) -> str:
    """One markdown row per arch x cell of the plain artifacts, each column
    "single / multi": ok or the error, the counts per device, argument and
    temporary GiB, the three terms and the dominant one."""
    by_cell: dict = {}
    for mesh in meshes:
        for f in sorted(ART.glob(f"*__{mesh}.json")):
            if len(f.stem.split("__")) == 3:
                rec = json.loads(f.read_text())
                by_cell.setdefault((rec["arch"], rec["cell"]), {})[mesh] = rec

    def cols(rec):
        if rec is None:
            return ["not run"] + [""] * 9
        if not rec.get("ok"):
            return [rec["error"][:120]] + [""] * 9
        a, mem = analyse(rec), rec["memory"]
        return ["ok", f"{rec['flops']:.3e}", f"{rec['bytes_accessed']:.3e}",
                f"{rec['collectives']['total']:.3e}", f"{mem['argument_bytes'] / 2 ** 30:.2f}",
                f"{mem['temp_bytes'] / 2 ** 30:.1f}", f"{a['compute_s']:.3g}",
                f"{a['memory_s']:.3g}", f"{a['collective_s']:.3g}", a["dominant"]]
    lines = [f"{header()}; each column {' / '.join(meshes)}.", "",
             "| arch | cell | ok | FLOPs | bytes | collective B | args GiB | temp GiB | "
             "compute s | memory s | collective s | dominant |",
             "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, cell), recs in sorted(by_cell.items()):
        parts = zip(*(cols(recs.get(m)) for m in meshes))
        lines.append(f"| {arch} | {cell} | " + " | ".join(" / ".join(p) for p in parts) + " |")
    return "\n".join(lines)


def run(quick=False, device=None):
    """``torch_run``'s entry: the rows of the single-mesh artifacts (the
    counts were made by the dry run; nothing runs on ``device``)."""
    del quick, device
    return load_all("single")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--tag", default="")
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--markdown", action="store_true",
                    help="every plain artifact of both meshes, failed ones too, "
                         "with memory (the table in PERF.md)")
    args = ap.parse_args(argv)
    if args.markdown:
        print(markdown())
        return
    rows = load_all(args.mesh, args.tag)
    if args.csv:
        print(f"# {header()}")
        print("arch,cell,mesh,compute_s,memory_s,collective_s,dominant,"
              "useful_ratio,roofline_frac")
        for r in rows:
            print(f"{r['arch']},{r['cell']},{r['mesh']},{r['compute_s']:.6e},"
                  f"{r['memory_s']:.6e},{r['collective_s']:.6e},"
                  f"{r['dominant']},{r['useful_ratio']:.4f},"
                  f"{r['roofline_frac']:.4f}")
    else:
        print(fmt_table(rows))


if __name__ == "__main__":
    main()
