"""Perf hillclimb of the port (``benchmarks/hillclimb.py``'s
counterpart): run the reference's named config variants of a cell through
the full-depth dry run (``repro_torch.launch.dryrun.run_cell``) and print
the three roofline terms of each (``benchmarks.torch_roofline``, one
H100's published peaks), beside the first variant that ran.

The variants and their names are the reference's. A variant that sets
config fields the port does not have is printed as not ported, with each
field and the reason, and is not run: run without the field it would be
the baseline, printed as if its hypothesis had been tested. Each run
writes an artifact tagged with the variant's name.

Usage:
  PYTHONPATH=src python -m benchmarks.torch_hillclimb --cell qwen-train \\
      [--only v1_bf16_scores] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import SHAPE_CELLS, ModelConfig

# the reference's fields that the port's ModelConfig lacks, and why
NOT_PORTED = {
    "seq_shard_attn": "the reference reads it only for GSPMD constraints on the "
                      "score tensors; the port's step runs the model on gathered "
                      "plain tensors (ROADMAP item 19)",
    "scan_layers": "the port's layers run as a Python loop; there is no scan "
                   "(ROADMAP item 19)",
}

# what each variant tests; the port's own numbers are what the run prints
CELLS = {
    "qwen-train": {
        "arch": "qwen2.5-14b", "cell": "train_4k",
        "variants": [
            ("v0_baseline", {},
             "the port's sharded step: every param gathered whole, full-rank "
             "attention, f32 softmax"),
            ("v1_bf16_scores", {"softmax_dtype": "bfloat16"},
             "H1: the largest tensors are the (b, h, s, s) score and softmax "
             "chains; keeping them in bf16 halves their bytes => memory term down"),
            ("v2_seqshard", {"softmax_dtype": "bfloat16", "seq_shard_attn": True},
             "H2: sharding the score tensors over the query sequence and "
             "'model' divides them further => memory and collective terms down"),
            ("v3_remat_none", {"softmax_dtype": "bfloat16",
                               "seq_shard_attn": True, "remat": "none"},
             "H3: storing activations instead of recomputing them trades memory "
             "capacity for fewer bytes and FLOPs"),
            ("v4_rank64", {"softmax_dtype": "bfloat16", "seq_shard_attn": True},
             "H4: the DR-RL static bucket r = 64 halves the score contraction "
             "(128 -> 64) => compute term of the scores down", 64),
            ("v5_seqshard_f32", {"seq_shard_attn": True},
             "H5 (isolation): sequence-sharded scores with the f32 softmax"),
            ("v7_best", {"seq_shard_attn": True, "remat": "none"},
             "the confirmed wins combined: sequence-sharded scores + stored "
             "activations"),
            ("v6_sharded_ce", {"seq_shard_attn": True},
             "H6: a cross-entropy over the vocab-sharded logits that stays "
             "local => memory and collective terms down"),
        ],
    },
    "qwen-prefill": {
        "arch": "qwen2.5-14b", "cell": "prefill_32k",
        "variants": [
            ("v0_full", {"seq_shard_attn": True},
             "full-rank prefill at L = 32k with sequence-sharded scores; "
             "attention dominates the FLOPs here (the paper's long-sequence "
             "regime)"),
            ("v1_rank64", {"seq_shard_attn": True},
             "H-paper: the DR-RL serving bucket r = 64 halves the score "
             "contraction => fewer prefill FLOPs", 64),
            ("v2_rank32", {"seq_shard_attn": True},
             "H-paper: the aggressive bucket r = 32 (the paper's fixed-rank "
             "baseline) => a quarter of the score contraction", 32),
        ],
    },
    "qwen-decode": {
        "arch": "qwen2.5-14b", "cell": "decode_32k",
        "variants": [
            ("v0_baseline", {},
             "baseline: GQA kv = 8 cannot shard heads over model = 16; every "
             "rank keeps its rows' whole KV cache"),
            ("v1_splitkv", {"cache_seq_shard": True},
             "H1: the cache's sequence dim over 'model' (split-KV decode). The "
             "port's decode has no split-KV attention, so its step gathers the "
             "sequence back first: this prices that gather"),
            ("v2_splitkv_bf16", {"cache_seq_shard": True,
                                 "softmax_dtype": "bfloat16"},
             "H2: + bf16 scores on the 32k decode score row"),
            ("v3_splitkv_attn", {"cache_seq_shard": True,
                                 "softmax_dtype": "bfloat16"},
             "H3: attention consuming the sequence-sharded cache, so the "
             "partial-softmax combine is the only cross-shard op (the port has "
             "no such attention: this runs the same program as v2)"),
        ],
    },
    "deepseek-train": {
        "arch": "deepseek-v3-671b", "cell": "train_4k",
        "variants": [
            ("v0_baseline", {},
             "baseline: MLA + 256-expert MoE in the port's sharded step"),
            ("v1_bf16_scores", {"softmax_dtype": "bfloat16"},
             "H1: bf16 score chains => memory term down"),
            ("v2_remat_dots", {"remat": "dots"},
             "H2: saving the matmul outputs instead of recomputing every expert "
             "matmul in the backward => compute and bytes down"),
            ("v3_seqshard", {"remat": "dots", "seq_shard_attn": True},
             "H3: + sequence-sharded scores"),
            ("v5_moe_bf16", {"remat": "dots", "seq_shard_attn": True},
             "H5: the MoE combine in bf16 rather than promoted to f32 by the "
             "gates => memory down"),
            ("v4_sharded_ce", {"remat": "dots", "seq_shard_attn": True},
             "H4: a cross-entropy that keeps the vocab-sharded logits local "
             "(MTP included) => memory and collective terms down"),
        ],
    },
}


def unported(overrides: dict) -> list:
    """The overrides that name a field the port's ModelConfig lacks."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return [k for k in overrides if k not in fields]


def run_variant(arch, cell_name, overrides, static_rank=None, tag="", device="cuda"):
    """``run_cell`` with this variant's config overrides, its artifact
    tagged ``tag``."""
    from repro_torch.launch import dryrun
    cell = next(c for c in SHAPE_CELLS if c.name == cell_name)
    return dryrun.run_cell(arch, cell, "single", static_rank=static_rank,
                           tag=tag, overrides=overrides, device=device)


def terms(rec):
    from benchmarks.torch_roofline import analyse
    a = analyse(rec)
    return a["compute_s"], a["memory_s"], a["collective_s"]


def climb(name: str, only=None, device="cuda") -> list:
    """Print (and return) one line per variant of CELLS[name]."""
    spec = CELLS[name]
    out = [f"=== hillclimb {name}: {spec['arch']} x {spec['cell']} ==="]
    print(out[0], flush=True)
    base = None
    for entry in spec["variants"]:
        vname, ov, hyp = entry[0], entry[1], entry[2]
        static_rank = entry[3] if len(entry) > 3 else None
        if only and vname != only:
            continue
        missing = unported(ov)
        if missing:
            line = f"  {vname:16s} not ported: " + "; ".join(
                f"{f}, {NOT_PORTED[f]}" for f in missing)
        else:
            rec = run_variant(spec["arch"], spec["cell"], ov, static_rank=static_rank,
                              tag=f"__{vname}", device=device)
            if not rec.get("ok"):
                line = f"  {vname:16s} FAILED {rec.get('error')}"
            else:
                c, m, x = terms(rec)
                line = f"  {vname:16s} compute={c:9.3e} memory={m:9.3e} coll={x:9.3e}"
                if base:
                    bc, bm, bx = base
                    line += (f"   vs {base_name}: comp {c / bc:5.2f}x mem {m / bm:5.2f}x "
                             f"coll {x / bx:5.2f}x")
                else:
                    base, base_name = (c, m, x), vname
        for text in (line, f"      {hyp}"):
            print(text, flush=True)
            out.append(text)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS))
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors: cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.launch import dryrun
    dryrun.require_device(args.device)
    climb(args.cell, args.only, args.device)


if __name__ == "__main__":
    main()
