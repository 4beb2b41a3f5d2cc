"""Design alternatives of the bf16 backward kernel
(``src/repro_torch/kernels/csrc/lowrank_flash_bwd_bf16.cu``), measured
beside it on one NVIDIA GPU: the evidence for its accumulation and its ring
depth.

    python3 tools/bwd_bf16_variants.py [--only NAME ...]

Each variant is the committed source with one edit applied as text (each
edit asserts that its anchor is there, so a source that moved on fails
loudly rather than measuring something else), built with ``nvcc`` and
``build.NVCC_FLAGS`` into ``src/repro_torch/_build/`` and called through
the same C entry point:

* ``tensor_core_sums``: dv, dk and dq summed on the tensor cores'
  accumulators across all tiles (no per-tile partial and f32 join), the
  choice of FlashAttention-3 and cuDNN;
* ``ring2``, ``ring4``: a K/V (dQ) or Q/dout (dK/dV) ring of 2 or 4 stages
  in place of 3 (4 only where shared memory allows, r + dv <= 256).

For every case of phase 6 (``chip_smoke.BWD_BF16_CASES`` and
``BWD_BF16_LONG``, their seeds) each build's largest error over phase 6's
tolerance against ``lowrank_flash_bwd_plain`` is printed (over 1 misses),
and then each build's backward time at phase 9's three bf16 shapes
(``chip_smoke.time_ms``: CUDA events, median of 15, L2 flushed), in the
order committed, variants, variants reversed, committed. Exits non-zero
without a CUDA device or when a build fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TENSOR_CORE_SUMS = '''{
  constexpr int kSB = slab_bytes(W);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = make_desc(y + 16 * kk * kSB, kBT * kSB, 8 * kSB, kSB);
    wgmma_rs<W>(acc, lo[kk], db, 1);
    wgmma_rs<W>(acc, hi[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs(acc);
  fence_regs(hi);
  fence_regs(lo);
}
'''


def tensor_core_sums(src: str) -> str:
    """col_product's body: the tile's products into acc itself."""
    head = "__device__ __forceinline__ void col_product("
    i = src.index(head)
    i = src.index("{", i)
    j = src.index("\n}\n", i) + 3
    return src[:i] + TENSOR_CORE_SUMS + src[j:]


def ring(stages_of: str):
    def edit(src: str) -> str:
        old = "constexpr int kStages = 3;"
        assert src.count(old) == 1, "the ring depth moved"
        src = src.replace(old, "template <int KR, int DV>\nconstexpr int kStagesOf = "
                          f"{stages_of};")
        src = src.replace("struct Smem {\n", "struct Smem {\n  static constexpr int kStages = "
                          "kStagesOf<KR, DV>;\n")
        old = "  using L = Smem<KR, DV>;\n"
        assert src.count(old) == 2, "the kernels' layouts moved"
        return src.replace(old, old + "  constexpr int kStages = L::kStages;\n")
    return edit


VARIANTS = {
    "tensor_core_sums": tensor_core_sums,
    "ring2": ring("2"),
    "ring4": ring("KR + DV > 256 ? 3 : 4"),
}


def entry(path: str):
    fn = ctypes.CDLL(path).lowrank_flash_bwd_bf16_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def call(fn, q, k, v, o, lse, do, *, scale, causal, q_offset):
    b, hq, sq, r = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), dsum.data_ptr(),
             b, hq, hkv, sq, skv, r, dv, q_offset, int(causal), float(scale),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"variant launch failed: CUDA error {err}")
    return dq, dk, dvv


def over_tol(cs, got, want) -> float:
    """The largest error over phase 6's bf16 tolerance of (dq, dk, dv)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all().item():
            return float("inf")
        lim = cs.BWD_BF16_ATOL * w.abs().max().item() + cs.BWD_BF16_RTOL * w.abs()
        worst = max(worst, ((g - w).abs() / lim).max().item())
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", choices=sorted(VARIANTS), help="these variants alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    build, lf = cs.build, cs.lowrank_flash
    names = args.only or list(VARIANTS)
    src = (build.CSRC / "lowrank_flash_bwd_bf16.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        path = build.BUILD_DIR / f"variant_{name}.cu"
        path.write_text(VARIANTS[name](src))
        lib = build.BUILD_DIR / f"libvariant_{name}.so"
        procs[name] = (subprocess.Popen([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                         "-o", str(lib), str(path)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    t0 = time.perf_counter()
    build.build(["lowrank_flash_bf16", "lowrank_flash_bwd_bf16"])
    fns = {"committed": lambda *a, **kw: lf.lowrank_flash_bwd(*a, **kw)}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
        spills = [line for line in cs.ptxas_summary(log)
                  if int(re.search(r"(\d+) bytes spill stores", line).group(1))]
        cs.log(f"  built {name} in {time.perf_counter() - t0:.1f} s; ptxas spills: "
               f"{spills or 'none'}")
        fn = entry(str(lib))
        fns[name] = lambda *a, fn=fn, **kw: call(fn, *a, **kw)
    res = {"card": card, "over_tol": {}, "ms": {}}
    for i, case in enumerate(cs.BWD_BF16_CASES + [cs.BWD_BF16_LONG]):
        (q, k, v, do), kw = cs.bwd_inputs(case, 340 + i, torch.bfloat16)
        out, lse = lf.lowrank_flash(q, k, v, return_lse=True, **kw)
        want = lf.lowrank_flash_bwd_plain(q, k, v, out, lse, do, **kw)
        over = {name: over_tol(cs, fn(q, k, v, out, lse, do, **kw), want)
                for name, fn in fns.items()}
        res["over_tol"][str(case)] = over
        cs.log(f"  {case}: error over the tolerance "
               + ", ".join(f"{name} {x:.4f}" for name, x in over.items()))
        del q, k, v, do, out, lse, want
        cs.free_memory()
    order = list(fns) + list(fns)[::-1]
    for label, case in (("qwen2.5-14b off r=dv=128", cs.QWEN_TRAIN),
                        ("qwen2.5-14b static r=32, dv=128", cs.QWEN_TRAIN_STATIC),
                        ("qwen2-vl-7b r=dv=128", cs.VL_TRAIN)):
        (q, k, v, do), kw = cs.bwd_inputs(case, 9, torch.bfloat16)
        out, lse = lf.lowrank_flash(q, k, v, return_lse=True, **kw)
        ms = {}
        for name in order:
            fn = fns[name]
            ms.setdefault(name, []).append(
                cs.time_ms(lambda: fn(q, k, v, out, lse, do, **kw), n=15))
        res["ms"][label] = ms
        cs.log(f"  {label}: " + ", ".join(f"{name} {t[0]:.4f} / {t[1]:.4f} ms"
                                          for name, t in ms.items()) + f" [{card}]")
        del q, k, v, do, out, lse
        cs.free_memory()
    cs.log("variants numbers: " + json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
