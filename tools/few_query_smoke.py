"""The few-query route's checks of ``chip_smoke.py`` alone, on an NVIDIA GPU:
phase 2 (flash_decode against its plain version, contiguous and on cache
views) and phase 21a's one-query calls of zamba2's and qwen2-vl's
dense-cache decodes (``chip_smoke.check_one_query``: the routed call, the
call site's former lowrank_flash on copies, the plain version, SDPA and
the bound).

    python3 tools/few_query_smoke.py [--other CHECKOUT [--ab]]

``--other`` names a checkout of another commit (a ``git archive`` of it):
flash_decode's outputs and probabilities at phase 2's contiguous cases
(``chip_smoke.decode_cases``, their seeds) from that checkout's kernels
must equal this checkout's bitwise, f32 and bf16. ``--ab`` then times
flash_decode at phase 5's four f32 shapes and phase 20a's five bf16 ones,
with and without probabilities (``chip_smoke.time_ms``), in the order
other, this, this, other, and prints each shape's two medians. Each
checkout's kernels are built and run in a subprocess of its own that
imports that checkout's ``repro_torch``. Exits non-zero without a CUDA
device or when a check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import checkouts  # noqa: E402

ROOT = checkouts.ROOT


def ab_shapes(cs) -> list:
    """(label, case, dtype): phase 5's f32 shapes, phase 20a's bf16 ones."""
    f32 = (("drrl-paper decode", cs.MAIN_DECODE), ("drrl-paper chunk", cs.MAIN_CHUNK),
           ("drrl-paper draft", cs.MAIN_DRAFT), ("drrl-paper verify", cs.MAIN_VERIFY))
    return ([(label, case, torch.float32) for label, case in f32]
            + [(label, cs.FAMILY_DECODE[label], torch.bfloat16)
               for label in cs.FAMILY_DECODE_TIMED])


def ab_labels(cs) -> list:
    """``ab_shapes``' labels, each without and with probabilities."""
    return [f"{label}, {str(dtype)[6:]}, {'with' if probs else 'no'} probs"
            for label, _, dtype in ab_shapes(cs) for probs in (False, True)]


def emit(mode: str, src: str, path: str) -> None:
    """Through the flash_decode of the ``repro_torch`` under ``src``:
    'outputs', phase 2's contiguous cases, (out, probs) per case; 'times',
    ms per call at ``ab_shapes`` without and with probabilities. Saved to
    ``path``."""
    cs = checkouts.import_chip_smoke(src)
    for name in ("decode_attn", "decode_attn_bf16"):
        cs.build.build([name])
        for line in cs.ptxas_summary(cs.build.build_log.get(name, (0, ""))[1]):
            print(f"  ptxas ({src}): {line}", flush=True)
    res = []
    if mode == "outputs":
        for i, (case, dtype) in enumerate(cs.decode_cases()):
            args, kw = cs.make_inputs(case, dtype, seed=i)
            o, p = cs.decode_attn.flash_decode(*args, **kw)
            res.append((o.cpu(), p.cpu()))
    else:
        for label, case, dtype in ab_shapes(cs):
            for probs in (False, True):
                (q, k, v, kl), kw = cs.make_inputs(case, dtype, seed=7, return_probs=probs)
                res.append(cs.time_ms(lambda: cs.decode_attn.flash_decode(q, k, v, kl, **kw)))
    torch.save(res, path)


def compare(other: str) -> dict:
    """Both checkouts' outputs and probabilities at the contiguous cases."""
    import chip_smoke as cs
    cases = cs.decode_cases()
    n32 = sum(dt == torch.float32 for _, dt in cases)
    res = checkouts.bitwise(__file__, "outputs", other,
                            [(case[:7], str(dtype)[6:]) for case, dtype in cases],
                            f"flash_decode's outputs and probabilities at phase 2's contiguous "
                            f"cases ({n32} f32, {len(cases) - n32} bf16)")
    return {**res, "f32": n32}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of another commit to hold phase 2's "
                                    "contiguous cases to, bitwise")
    ap.add_argument("--ab", action="store_true", help="with --other: time flash_decode "
                                                      "on both checkouts, alternating")
    ap.add_argument("--emit", nargs=3, metavar=("MODE", "SRC", "PATH"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("few_query_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.emit:
        emit(*args.emit)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    sources = ["decode_attn", "decode_attn_bf16", "lowrank_flash", "lowrank_flash_bf16"]
    secs = cs.build.build(sources)
    for name in sources:
        cs.log(f"  built {name}.cu in {secs[name]:.1f} s")
        if name.startswith("decode_attn"):
            for line in cs.ptxas_summary(cs.build.build_log.get(name, (0, ""))[1]):
                cs.log("  ptxas: " + line)
    t0 = time.perf_counter()
    cs.phase("[2] flash_decode vs its plain version, contiguous and on cache views")
    err = cs.check_kernel()
    cs.phase("[21a] the decodes' one-query calls through the route")
    times = {label: cs.check_one_query(label, case, 520 + i, card)
             for i, (label, case) in enumerate(cs.RECURRENT_DECODE.items())}
    bitwise = times_ab = None
    if args.other:
        cs.phase("[2] the contiguous cases against the other checkout's build")
        bitwise = compare(args.other)
        if args.ab:
            cs.phase("flash_decode's times, the other checkout against this one")
            times_ab = checkouts.ab(__file__, args.other, ab_labels(cs), card)
    cs.log("few-query numbers: " + cs.json.dumps({
        "max_abs_err_f32": err, "one_query": times, "bitwise": bitwise, "ab": times_ab,
        "card": card, "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
