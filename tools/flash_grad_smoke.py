"""The flash branch's backward on an NVIDIA GPU, the checks of
``chip_smoke.py`` that cover it, alone: phase 6's backward cases
(``chip_smoke.check_flash_bwd``: the kernel forward's log-sum-exp, the
backward kernel against its plain version, one and 16 queries with grad,
two runs bitwise), phase 12's autograd guard (``check_grad_guard``), phase
9's backward times at drrl-paper's two training shapes
(``time_flash_bwd``) and 17g, drrl-paper's LM step with
``loss(chunked=True)`` at 2 x 4096 (``check_chunked_training``).

    python3 tools/flash_grad_smoke.py [--bf16] [--other CHECKOUT [--ab]]

``--bf16`` runs the bf16 backward's checks instead: phase 6's bf16 cases
(``check_flash_bwd_bf16``), the guard, phase 9's bf16 backward times at
qwen2.5-14b's and qwen2-vl-7b's training shapes and 20h, qwen2.5-14b's LM
step in bf16 with ``loss(chunked=True)`` at 2 x 4096 on 2 layers of seeded
full-width weights (``check_qwen_bf16_training``).

``--other`` names a checkout of another commit (a ``git archive`` of it):
``lowrank_flash``'s outputs at phase 6's cases (f32 and bf16, their seeds;
out without and with its log-sum-exp, and the log-sum-exp) from that
checkout's kernels must equal this checkout's bitwise, and each kernel
source whose build name (a hash of the source, its headers and the nvcc
flags) equals the other checkout's is named: its library is built from the
same input. ``--ab`` then holds this checkout's backward gradients (dq, dk,
dv) at phase 9's two drrl-paper shapes to the other checkout's within
``chip_smoke.BWD_TOL`` times each gradient's largest magnitude (the two
kernels sum in other orders), and times the f32 forward, without its
log-sum-exp, and the backward at those shapes (``chip_smoke.time_ms``) in
the order other, this, this, other, and prints each one's times. With
``--bf16``, ``--ab`` does the same for the bf16 backward at phase 9's three
bf16 shapes: the gradients within phase 6's bf16 tolerance of the other
checkout's (``chip_smoke.grads_close_bf16``) and the backward's times
alone. Each checkout's kernels are built and run in a subprocess of its own
that imports that checkout's ``repro_torch`` (``tools/checkouts.py``).
Exits non-zero without a CUDA device or when a check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import checkouts  # noqa: E402

ROOT = checkouts.ROOT


def output_cases(cs) -> list:
    """(case, dtype, seed): phase 6's flash cases and drrl-paper's two
    shapes, f32 and bf16."""
    return [(case, dtype, 100 + i)
            for i, case in enumerate(cs.FLASH_CASES + [cs.PATH_MASKED, cs.PATH_STATIC])
            for dtype in (torch.float32, torch.bfloat16)]


def time_shapes(cs, bf16=False) -> list:
    """(label, case): phase 9's f32 shapes, or with ``bf16`` its bf16 ones."""
    if bf16:
        return [("qwen2.5-14b off r=dv=128", cs.QWEN_TRAIN),
                ("qwen2.5-14b static r=32, dv=128", cs.QWEN_TRAIN_STATIC),
                ("qwen2-vl-7b r=dv=128", cs.VL_TRAIN)]
    return [("masked r=64, dv=64", cs.PATH_MASKED), ("static r=32, dv=64", cs.PATH_STATIC)]


def ab_labels(cs, bf16=False) -> list:
    """What 'times' measures, in its order: the f32 forward, then the
    backward, at each of ``time_shapes``; 'times_bf16' the bf16 backward at
    each bf16 shape."""
    if bf16:
        return [f"bf16 backward {label}" for label, _ in time_shapes(cs, bf16)]
    return [f"{kind} {label}" for kind in ("forward", "backward")
            for label, _ in time_shapes(cs)]


def bwd_call(cs, case, dtype=torch.float32):
    """The backward kernel at ``case`` on phase 9's inputs (seed 9) in
    ``dtype``, as a function of no arguments."""
    lf = cs.lowrank_flash
    (q, k, v, do), kw = cs.bwd_inputs(case, seed=9, dtype=dtype)
    out, lse = lf.lowrank_flash(q, k, v, return_lse=True, **kw)
    return lambda: lf.lowrank_flash_bwd(q, k, v, out, lse, do, **kw)


def emit(mode: str, src: str, path: str) -> None:
    """Through the kernels of the ``repro_torch`` under ``src``: 'outputs',
    lowrank_flash's (out, out with lse, lse) at ``output_cases``; 'grads'
    ('grads_bf16'), the f32 (bf16) backward's (dq, dk, dv) at
    ``time_shapes``; 'times' ('times_bf16'), ms per call at ``ab_labels``.
    Saved to ``path``."""
    cs = checkouts.import_chip_smoke(src)
    bf16 = mode.endswith("_bf16")
    dtype = torch.bfloat16 if bf16 else torch.float32
    cs.build.build(["lowrank_flash", "lowrank_flash_bf16", "lowrank_flash_bwd"]
                   + (["lowrank_flash_bwd_bf16"] if bf16 else []))
    res = []
    if mode == "outputs":
        for case, case_dtype, seed in output_cases(cs):
            args, kw = cs.flash_inputs(case, case_dtype, seed=seed)
            out = cs.lowrank_flash.lowrank_flash(*args, **kw)
            with_lse, lse = cs.lowrank_flash.lowrank_flash(*args, return_lse=True, **kw)
            res.append((out.cpu(), with_lse.cpu(), lse.cpu()))
    elif mode.startswith("grads"):
        for _, case in time_shapes(cs, bf16):
            res.append(tuple(g.cpu() for g in bwd_call(cs, case, dtype)()))
            cs.free_memory()
    elif bf16:
        for _, case in time_shapes(cs, bf16):
            res.append(cs.time_ms(bwd_call(cs, case, dtype), n=15))
            cs.free_memory()
    else:
        for _, case in time_shapes(cs):
            (q, k, v), kw = cs.flash_inputs(case, torch.float32, seed=9)
            res.append(cs.time_ms(lambda: cs.lowrank_flash.lowrank_flash(q, k, v, **kw), n=15))
        for _, case in time_shapes(cs):
            res.append(cs.time_ms(bwd_call(cs, case), n=15))
    torch.save(res, path)


def grads_ab(cs, other: str, bf16=False) -> dict:
    """This checkout's backward gradients at ``time_shapes`` against the
    other checkout's: f32 each within BWD_TOL x the other's largest
    magnitude, bf16 within phase 6's bf16 tolerance of the other's."""
    this, that = checkouts.run_trees(__file__, "grads_bf16" if bf16 else "grads",
                                     [("this", ROOT), ("other", other)])
    res = {}
    for (label, _), mine, theirs in zip(time_shapes(cs, bf16), this, that):
        what = f"{label}, this checkout against the other's"
        if bf16:
            res[label] = cs.grads_close_bf16(mine, theirs, what)
            cs.log(f"  bf16 backward {label}: max|this-other| {res[label]['max_abs_err']:.3g} "
                   f"({res[label]['max_err_over_tol']:.3g} of the tolerance "
                   f"{cs.BWD_BF16_ATOL:g} x max|other| + {cs.BWD_BF16_RTOL:g} |other|)")
        else:
            res[label] = cs.grads_close(mine, theirs, what)
            cs.log(f"  backward {label}: max|this-other| {res[label]['max_abs_err']:.3g} "
                   f"({res[label]['max_scaled_err']:.3g} of the largest |grad|; tol "
                   f"{cs.BWD_TOL:g})")
    return res


def same_builds(cs, other: str) -> list:
    """The kernel sources whose build name (a hash of the source, every
    header it includes and the nvcc flags) is the same in the other
    checkout: each library is built from the same input there."""
    here = cs.build.CSRC
    names = sorted(p.stem for p in here.glob("*.cu"))
    mine = {name: cs.build.library_path(name).name for name in names}
    try:
        cs.build.CSRC = Path(other) / "src" / "repro_torch" / "kernels" / "csrc"
        theirs = {name: cs.build.library_path(name).name for name in names
                  if (cs.build.CSRC / f"{name}.cu").is_file()}
    finally:
        cs.build.CSRC = here
    same = [name for name in names if theirs.get(name) == mine[name]]
    cs.log(f"  built from the same source, headers and flags as the other checkout: "
           f"{', '.join(same) or 'none'}; rebuilt: "
           f"{', '.join(n for n in names if n not in same) or 'none'}")
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout of another commit to hold lowrank_flash's "
                                    "outputs to, bitwise")
    ap.add_argument("--ab", action="store_true", help="with --other: hold the backward's "
                                                      "gradients to the other checkout's and "
                                                      "time the f32 forward and backward "
                                                      "(with --bf16: the bf16 backward) on "
                                                      "both, alternating")
    ap.add_argument("--bf16", action="store_true", help="the bf16 backward's checks, times "
                                                        "and 20h instead of the f32 ones")
    ap.add_argument("--emit", nargs=3, metavar=("MODE", "SRC", "PATH"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_grad_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.emit:
        emit(*args.emit)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    t0 = time.perf_counter()
    sources = ["lowrank_flash", "lowrank_flash_bf16", "lowrank_flash_bwd",
               "lowrank_flash_bwd_bf16"]
    secs = cs.build.build(sources)
    shown = ("lowrank_flash_bwd_bf16",) if args.bf16 else ("lowrank_flash", "lowrank_flash_bwd")
    for name in sources:
        cs.log(f"  built {name}.cu in {secs[name]:.1f} s")
        if name in shown:
            for line in cs.ptxas_summary(cs.build.build_log.get(name, (0, ""))[1]):
                cs.log("  ptxas: " + line)
    if args.bf16:
        cs.log(f"  sass: lowrank_flash_bwd_bf16.cu holds "
               f"{cs.sass_count('lowrank_flash_bwd_bf16', 'HGMMA')} HGMMA (wgmma) instructions")
        cs.check_bwd_bf16_build(secs["lowrank_flash_bwd_bf16"])
        cs.phase("[6] the bf16 backward kernel against its plain version")
        err = cs.check_flash_bwd_bf16()
        cs.check_grad_guard()
        cs.phase("[9] the bf16 backward's times at qwen2.5-14b's and qwen2-vl-7b's shapes")
        times = {label: cs.time_flash_bwd(case, label, card, torch.bfloat16)
                 for label, case in (("qwen2.5-14b off r=dv=128", cs.QWEN_TRAIN),
                                     ("qwen2.5-14b static r=32, dv=128", cs.QWEN_TRAIN_STATIC),
                                     ("qwen2-vl-7b r=dv=128", cs.VL_TRAIN))}
        cs.free_memory()
        cs.phase("[20h] qwen2.5-14b's LM step in bf16 with loss(chunked=True)")
        chunked = cs.check_qwen_bf16_training(cs.family_params(cs.qwen_train_cfg("off")), card)
    else:
        cs.phase("[6] the backward kernel against its plain version")
        err = cs.check_flash_bwd()
        cs.check_grad_guard()
        cs.phase("[9] the backward's times at drrl-paper's training shapes")
        times = {"masked": cs.time_flash_bwd(cs.PATH_MASKED, "masked r=64, dv=64", card),
                 "static": cs.time_flash_bwd(cs.PATH_STATIC, "static r=32, dv=64", card)}
        cs.phase("[17g] drrl-paper's LM step with loss(chunked=True)")
        paper = cs.get_config("drrl-paper")
        agent = cs.drrl.init_agent(torch.Generator(device=cs.DEV).manual_seed(7), paper.rank,
                                   paper.d_model, device=cs.DEV)
        chunked = cs.check_chunked_training(paper, agent, card)
    bitwise = times_ab = grads = same = None
    if args.other:
        cs.phase("[6] lowrank_flash's outputs against the other checkout's build")
        same = same_builds(cs, os.path.abspath(args.other))
        cases = output_cases(cs)
        n32 = sum(dt == torch.float32 for _, dt, _ in cases)
        bitwise = checkouts.bitwise(
            __file__, "outputs", args.other,
            [(case, str(dtype)[6:]) for case, dtype, _ in cases],
            f"lowrank_flash at phase 6's cases ({n32} f32, {len(cases) - n32} bf16; out "
            f"without and with lse, and lse; the few-query ones called on lowrank_flash "
            f"directly, not through the route)")
        if args.ab:
            kind = "bf16 backward's" if args.bf16 else "backward's"
            cs.phase(f"[6] the {kind} gradients against the other checkout's build")
            grads = grads_ab(cs, os.path.abspath(args.other), args.bf16)
            cs.phase("[9] the bf16 backward's times, the other checkout against this one"
                     if args.bf16 else
                     "[9] the f32 forward's and backward's times, the other checkout "
                     "against this one")
            times_ab = checkouts.ab(__file__, args.other, ab_labels(cs, args.bf16), card,
                                    "times_bf16" if args.bf16 else "times")
    cs.log("flash-grad numbers: " + cs.json.dumps({
        "backward_max_err": err, "backward_times": times, "chunked_training": chunked,
        "bitwise": bitwise, "same_builds": same, "backward_against_other": grads,
        "ab": times_ab, "card": card,
        "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
