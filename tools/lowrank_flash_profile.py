"""Where the time of one ``lowrank_flash`` call goes on an NVIDIA GPU, how
close its split-TF32 products come to float64, and the tensor cores' rate
for the instructions its kernels issue.

    python3 tools/lowrank_flash_profile.py

At ``chip_smoke.py``'s forward shapes (``PATH_MASKED``, r = 64, and
``PATH_STATIC``, r = 32; b = 2, 12 heads, 4096 tokens, causal, f32) and at
qwen2.5-14b's in bf16 (2 x 4096, 40/8 heads, r = dv = 128): the device
time per call (torch.profiler, mean of 10 calls, L2 flushed before each)
of the kernel, of its plain version and of
``scaled_dot_product_attention``, in turns (kernel, SDPA, SDPA, kernel),
with the device kernels' names; the share is of the f32 kernel's three
TF32 passes, or of the bf16 kernel's three bf16 passes.
Then, on ``chip_smoke.TF32_CASE`` (q and k x 4) and at
``PATH_MASKED``, the largest error against the same attention in float64:
of the kernel, of the plain version in f32 and of the plain version with
TF32 products. Last, the tensor cores' rate for the instructions the
kernels issue (``tools/mma_tf32_peak.cu``: no memory traffic):
``mma.sync.m16n8k8`` with TF32 inputs (the f32 kernel),
``mma.sync.m16n8k16`` with bf16 inputs and ``wgmma.m64n128k16`` with bf16
inputs (the bf16 kernel's instruction), at 1 to 4 blocks of 128 to 512
threads per SM, and the best of each. Needs a CUDA device; builds the
kernels on first use.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import build, lowrank_flash  # noqa: E402

def attention_f64(q, k, v, *, scale, causal, q_offset):
    """The kernel's function in float64 (the plain version's steps)."""
    n_rep = q.shape[1] // k.shape[1]
    kr = k.double().repeat_interleave(n_rep, dim=1)
    vr = v.double().repeat_interleave(n_rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kr) * scale
    if causal:
        q_pos = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        k_pos = torch.arange(k.shape[2], device=q.device)[None, :]
        s = s.masked_fill(k_pos > q_pos, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vr)


def errors(case, label, card, q_k_scale=1.0):
    (q, k, v), kw = cs.flash_inputs(case, torch.float32, seed=200)
    q, k = q_k_scale * q, q_k_scale * k
    want = attention_f64(q, k, v, **kw)
    out = {"kernel": lowrank_flash.lowrank_flash(q, k, v, **kw)}
    out["plain f32"] = lowrank_flash.lowrank_flash_plain(q, k, v, **kw)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out["plain TF32"] = lowrank_flash.lowrank_flash_plain(q, k, v, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    errs = ", ".join(f"{name} {(o.double() - want).abs().max().item():.3g}"
                     for name, o in out.items())
    print(f"{label} {case}: max |out - float64|: {errs} [{card}]")


# (C entry point, label, flops per warp per round): mma.sync runs 8
# independent m16n8k8 (TF32) or m16n8k16 (bf16) products per round; wgmma a
# warpgroup's 16 m64n128k16 products, a quarter of them per warp
PEAKS = (("mma_peak_launch", "mma.sync m16n8k8 TF32", 8 * 2 * 16 * 8 * 8, 2048),
         ("mma_bf16_peak_launch", "mma.sync m16n8k16 bf16", 8 * 2 * 16 * 8 * 16, 2048),
         ("wgmma_bf16_peak_launch", "wgmma m64n128k16 bf16", 16 * 2 * 64 * 128 * 16 // 4, 512))


def mma_peak(card):
    """TFLOP/s of each tensor-core instruction the kernels issue
    (tools/mma_tf32_peak.cu), CUDA events around one launch of blocks x
    threads threads."""
    src = os.path.join(ROOT, "tools", "mma_tf32_peak.cu")
    lib_path = build.BUILD_DIR / "libmma_tf32_peak.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path), src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    best = {}
    for entry, label, flops_per_warp, iters in PEAKS:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int

        def launch(blocks, threads, n, out):
            err = fn(blocks, threads, n, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{entry} failed: CUDA error {err}")

        for threads in (128, 256, 512):
            for per_sm in (1, 2, 4):
                blocks = sms * per_sm
                out = torch.empty(blocks * threads, device="cuda")
                launch(blocks, threads, 16, out)     # warm-up
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                launch(blocks, threads, iters, out)
                e1.record()
                e1.synchronize()
                flops = blocks * (threads // 32) * iters * flops_per_warp
                rate = flops / e0.elapsed_time(e1) / 1e9
                best[label] = max(best.get(label, 0.0), rate)
                print(f"{label}: {threads} threads x {per_sm} blocks per SM: "
                      f"{rate:.1f} TFLOP/s [{card}]")
    print("best: " + ", ".join(f"{k} {v:.1f} TFLOP/s" for k, v in best.items()) + f" [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("lowrank_flash_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card()
    print(card)
    build.build(["lowrank_flash", "lowrank_flash_bf16"])
    qwen = cs.FAMILY_FLASH[cs.QWEN_FLASH]
    for case, label, dtype in ((cs.PATH_MASKED, "r=64", torch.float32),
                               (cs.PATH_STATIC, "r=32", torch.float32),
                               (qwen, "qwen2.5-14b bf16 r=dv=128", torch.bfloat16)):
        (q, k, v), kw = cs.flash_inputs(case, dtype, seed=9)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, scale=kw["scale"], enable_gqa=True)

        bound_tc, _, extra = cs.flash_bound_ms(case, dtype)
        if dtype == torch.bfloat16:       # the bf16 kernel's own passes
            bound_tc = extra["bound_bf16_passes_ms"]
        def kernel():
            return lowrank_flash.lowrank_flash(q, k, v, **kw)

        runs = [("kernel", kernel), ("sdpa", sdpa), ("sdpa", sdpa), ("kernel", kernel)]
        runs.append(("plain", lambda: lowrank_flash.lowrank_flash_plain(q, k, v, **kw)))
        for name, fn in runs:
            per = cs.kernel_us(fn)
            ms = sum(per.values()) / 1e3
            print(f"{label} {name}: {ms:.4f} ms per call on the device "
                  f"({bound_tc / ms:.1%} of the tensor-core bound {bound_tc:.4f} ms) [{card}]")
            for kname, us in sorted(per.items(), key=lambda kv: -kv[1])[:4]:
                print(f"    {us:9.2f} us  {kname[:100]}")
    errors(cs.TF32_CASE, "q, k x 4", card, q_k_scale=4.0)
    errors(cs.PATH_MASKED, "forward r=64", card)
    mma_peak(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
