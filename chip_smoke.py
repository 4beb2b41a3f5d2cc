"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (one line each, plus detail lines):
  1. card and build: the card's name and power limit (nvidia-smi), then
     the CUDA kernel built from src/repro_torch/kernels/csrc with nvcc;
  2. the flash-decode kernel against its plain PyTorch version on the card,
     at the CPU tests' shapes and at the serving path's shapes;
  3. full-width serving of the drrl-paper model (12 layers, d_model 768,
     seeded random weights) through ``repro_torch.serve.Engine`` with the
     kernel on: adaptive rank, again with the factor cache, again in fixed
     mode; a reduced model served on the card with the kernel and on the
     CPU without it must give identical greedy tokens;
  4. one full-width mixed engine step with the kernel and with the plain
     attention on the same inputs: logits must agree;
  5. times at the serving shapes: kernel, plain version, one PyTorch
     library call for the same attention, and the kernel's bound; then
     the adaptive serving run under torch.profiler, device time by kernel.

Exits non-zero, printing no result, when no CUDA device is present or any
phase fails. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import RankConfig  # noqa: E402
from repro_torch.kernels import build, decode_attn  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import decode_step_paged  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LOGIT_TOL = 1e-3               # f32 engine step, kernel vs plain attention
GRID = (16, 24, 32, 40, 48, 56, 64)
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ints(x):
    return None if x is None else torch.tensor(x, dtype=torch.int32, device=DEV)


# -- phase 2 ---------------------------------------------------------------

# b, hq, hkv, C, M, r, dv, kv_len, q_start, q_lens
CHECK_CASES = [
    (2, 4, 2, 1, 128, 16, 32, (100, 100), None, None),
    (1, 8, 8, 1, 256, 64, 64, (256,), None, None),
    (2, 2, 1, 1, 64, 8, 16, (1, 1), None, None),
    (1, 4, 1, 1, 96, 128, 128, (50,), None, None),
    (1, 8, 2, 1, 37, 24, 16, (30,), None, None),
    (2, 6, 3, 1, 65, 40, 48, (33, 65), None, None),
    (4, 4, 2, 1, 96, 16, 32, (1, 17, 96, 40), None, None),
    (4, 4, 2, 6, 96, 16, 32, (6, 23, 35, 65), (0, 17, 29, 64), None),
    (3, 6, 3, 5, 70, 24, 16, (5, 42, 4), (0, 40, 3), None),
    (2, 4, 4, 7, 40, 40, 8, (7, 37), (0, 30), None),
    (3, 4, 2, 6, 64, 24, 16, (6, 12, 50), (0, 10, 50), (6, 2, 0)),
]
# the serving path's shapes (drrl-paper full width, 8 slots, 2048 positions)
MAIN_DECODE = (8, 12, 12, 1, 2048, 64, 64, (2048, 1, 700, 1500, 2047, 64, 1024, 333),
               None, None)
MAIN_CHUNK = (8, 12, 12, 128, 2048, 64, 64,
              (128, 2048, 300, 1000, 129, 700, 1500, 64),
              (0, 1920, 172, 872, 1, 572, 1372, 63), None)


def make_inputs(case, dtype, seed):
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, hq, C, r), generator=g, device=DEV).to(dtype)
    k = torch.randn((b, hkv, M, r), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, M, dv), generator=g, device=DEV).to(dtype)
    if C == 1:
        q = q[:, :, 0]
    return (q, k, v, ints(kl)), dict(scale=r ** -0.5, return_probs=True,
                                     q_start=ints(qs), q_lens=ints(ql))


def check_kernel() -> float:
    worst = 0.0
    cases = [(c, dt) for c in CHECK_CASES for dt in (torch.float32, torch.bfloat16)]
    cases += [(MAIN_DECODE, torch.float32), (MAIN_CHUNK, torch.float32)]
    for i, (case, dtype) in enumerate(cases):
        args, kw = make_inputs(case, dtype, seed=i)
        o, p = decode_attn.flash_decode(*args, **kw)
        torch.cuda.synchronize()
        ro, rp = decode_attn.flash_decode_plain(*args, **kw)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_p = (p - rp).abs().max().item()
        tol = TOL[dtype]
        bad_o = ((o.float() - ro.float()).abs() > tol + tol * ro.float().abs()).any().item()
        bad_p = ((p - rp).abs() > tol + tol * rp.abs()).any().item()
        zeros = torch.equal(p == 0, rp == 0) if dtype == torch.float32 else True
        if bad_o or bad_p or not zeros:
            raise AssertionError(f"flash_decode disagrees with its plain version at "
                                 f"{case[:7]} {dtype}: out {err_o:.3g}, probs "
                                 f"{err_p:.3g} (tol {tol}), zero pattern {zeros}")
        if dtype == torch.float32:
            worst = max(worst, err_o, err_p)
        log(f"  {str(dtype)[6:]:8s} b,hq,hkv,C,M,r,dv={case[:7]}: max|out-plain| "
            f"{err_o:.3g}, max|probs-plain| {err_p:.3g} (tol {tol})")
    return worst


# -- phase 3 ---------------------------------------------------------------

def serve(cfg, params, *, n_req=8, max_new=64, seed=1, **knobs):
    rng = np.random.default_rng(seed)
    eng = Engine(cfg, params, device=DEV, config=EngineConfig(**knobs))
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(256, 1537, n_req)]
    hs = [eng.submit(p, SamplingParams(max_new=max_new), arrival=2 * i)
          for i, p in enumerate(prompts)]
    reset_launches()
    eng.warmup()
    eng.run()
    launches = decode_attn.LAUNCHES["flash_decode"]
    outs = [h.result() for h in hs]
    return eng, outs, launches


def check_serving(cfg, params, label, card_name, **knobs):
    knobs = dict(n_slots=8, max_len=2048, page_size=16, prefill_chunk=128,
                 use_kernel=True, **knobs)
    eng, outs, launches = serve(cfg, params, **knobs)
    st = eng.stats
    n_req = len(outs)
    for i, o in enumerate(outs):
        assert o.shape == (64,), f"request {i} returned {o.shape} tokens"
        assert ((o >= 0) & (o < cfg.vocab_size)).all(), f"request {i}: bad token ids"
    # every attention of every fused step, warmup's two steps included
    n_steps = st["steps"] + st["warmup_steps"]
    want = cfg.num_layers * n_steps
    assert launches == want, f"{launches} kernel launches, expected {want}"
    ranks = {int(r) for step in eng.ranks_per_step() for r in step if r >= 0}
    assert ranks and ranks <= set(GRID), f"ranks {ranks} outside the grid"
    assert st["decides"] >= 2 * n_req, f"{st['decides']} decisions for {n_req} requests"
    tok_s = st["tokens_decoded"] / st["decode_s"]
    ms_step = 1e3 * st["decode_s"] / st["steps"]
    log(f"  {label}: {n_req} requests x 64 tokens, {st['steps']} fused steps "
        f"({st['mixed_steps']} mixed), {st['decides']} decisions, ranks "
        f"{sorted(ranks)}, kernel launches {launches} = {cfg.num_layers} layers "
        f"x {n_steps} steps (warmup's 2 included); {tok_s:.1f} decoded tokens/s, "
        f"{ms_step:.2f} ms/step [{card_name}]")
    return outs, launches, st


def check_small_reference():
    """Reduced drrl-paper: the card with the kernel vs the CPU without it."""
    cfg = get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    knobs = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
                 max_new_cap=12, prefill_chunk=8)
    outs = {}
    for device, use_kernel in ((DEV, True), ("cpu", False)):
        rng = np.random.default_rng(0)
        eng = Engine(cfg, params, device=device,
                     config=EngineConfig(use_kernel=use_kernel, **knobs))
        hs = [eng.submit(rng.integers(0, 256, int(n)), SamplingParams(max_new=12),
                         arrival=2 * i) for i, n in enumerate(rng.integers(8, 33, 6))]
        eng.run()
        outs[device] = ([h.result() for h in hs], eng.ranks_per_step())
    (tok_gpu, rk_gpu), (tok_cpu, rk_cpu) = outs[DEV], outs["cpu"]
    for a, b in zip(tok_gpu, tok_cpu):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rk_gpu, rk_cpu):
        np.testing.assert_array_equal(a, b)
    log(f"  reduced model: 6 requests, GPU kernel tokens and ranks == CPU plain "
        f"tokens and ranks ({len(rk_gpu)} steps)")


# -- phase 4 ---------------------------------------------------------------

def check_engine_step(cfg, params):
    """One full-width mixed step: 3 rows prefilling a 128-token chunk, 4
    rows decoding at their own lengths and ranks, 1 idle row."""
    g = torch.Generator(device=DEV).manual_seed(3)
    ns, ps, M, C = 8, 16, 2048, 128
    L, h, d = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    pps = M // ps
    pool_k = torch.randn((L, ns * pps + 1, ps, h, d), generator=g, device=DEV)
    pool_v = torch.randn((L, ns * pps + 1, ps, h, d), generator=g, device=DEV)
    page_table = torch.arange(1, ns * pps + 1, device=DEV).reshape(ns, pps)
    page_table[7] = 0
    lens = torch.tensor([0, 512, 1800, 7, 300, 1024, 2000, 0], device=DEV)
    active = torch.tensor([True] * 7 + [False], device=DEV)
    prefill = torch.tensor([True, True, True] + [False] * 5, device=DEV)
    q_lens = torch.where(prefill, torch.full_like(lens, C), torch.ones_like(lens))
    tokens = torch.randint(0, cfg.vocab_size, (ns, C), generator=g, device=DEV)
    basis = torch.linalg.qr(torch.randn((L, ns, h, d, d), generator=g, device=DEV))[0]
    ranks = torch.tensor([64, 64, 64, 16, 32, 48, 64, 64], device=DEV)
    mass = torch.zeros((L, ns, M, h), device=DEV)
    logits = {}
    for use_kernel in (True, False):
        lg, _ = decode_step_paged(cfg, params, pool_k.clone(), pool_v.clone(),
                                  page_table, tokens, slot_lens=lens,
                                  slot_ranks=ranks, basis=basis, active=active,
                                  use_kernel=use_kernel, mass_pool=mass.clone(),
                                  q_lens=q_lens, prefill_rows=prefill)
        logits[use_kernel] = lg[active]
    a, b = logits[True], logits[False]
    assert torch.isfinite(a).all() and a.shape == (7, 1, cfg.vocab_size)
    err = (a - b).abs().max().item()
    rel = err / b.abs().max().item()
    assert err <= LOGIT_TOL * max(1.0, b.abs().max().item()), \
        f"engine step: kernel vs plain attention logits differ by {err}"
    same = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    log(f"  full-width mixed step: max|logits(kernel) - logits(plain)| {err:.3g} "
        f"(relative {rel:.3g}, tol {LOGIT_TOL}), greedy agreement {same:.3f}")


# -- phase 5 ---------------------------------------------------------------

def time_ms(fn, n=25) -> float:
    """Median of n individually event-timed calls after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(case) -> tuple:
    """Least time for the work these inputs need: bytes (q, the K/V rows
    up to each row's kv_len, out, probs) over HBM bandwidth, and the f32
    operations (2 (r + dv) per visible query-key pair) over the f32 peak."""
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    kl = np.minimum(np.asarray(kl), M)
    qs = np.asarray(kl) - C if qs is None else np.asarray(qs)
    ql = np.full(b, C) if ql is None else np.asarray(ql)
    nbytes = 4 * (b * hq * C * r + hkv * kl.sum() * (r + dv)
                  + b * hq * C * dv + b * hq * C * M) + 12 * b
    j = np.arange(C)[None, :]
    vis = np.clip(np.minimum(kl[:, None], qs[:, None] + j + 1), 0, None) * (j < ql[:, None])
    flops = 2 * (r + dv) * hq * vis.sum()
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(case, q, k, v):
    """scaled_dot_product_attention on the same q/k/v and masks (no probs)."""
    import torch.nn.functional as F
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    q4 = q if q.dim() == 4 else q[:, :, None]
    klt = torch.tensor(kl, device=DEV)
    qst = klt - C if qs is None else torch.tensor(qs, device=DEV)
    pos = torch.arange(M, device=DEV)
    j = torch.arange(C, device=DEV)
    mask = ((pos[None, None, :] <= qst[:, None, None] + j[None, :, None])
            & (pos < klt[:, None, None]))[:, None]
    return lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask,
                                                  scale=r ** -0.5)


def time_kernel(case, card_name):
    (q, k, v, kl), kw = make_inputs(case, torch.float32, seed=7)
    ms = time_ms(lambda: decode_attn.flash_decode(q, k, v, kl, **kw))
    plain_ms = time_ms(lambda: decode_attn.flash_decode_plain(q, k, v, kl, **kw))
    lib_ms = time_ms(library_call(case, q, k, v))
    bnd, by = bound_ms(case)
    log(f"  flash_decode C={case[3]} (b=8, hq=hkv=12, r=dv=64, M=2048, f32, probs): "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
        f"bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of bound [{card_name}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)


# CUPTI's own buffer handling, reported beside the kernels: not device work
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")
# device time by layer, first match wins (lower-case substrings of kernel names)
LAYERS = (("flash_decode kernel", ("flash_decode_kernel",)),
          ("decision eigh (cuSOLVER)", ("syev", "jacobi", "rotate_batch", "cusolver",
                                        "sytrd", "ormtr")),
          ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv")),
          ("copies", ("memcpy", "memset")))


def profile_serving(cfg, params, card_name, plain_wall_s):
    """Where the time of a serving run goes on the card: the adaptive run
    of phase 3 again, device activity only under torch.profiler, its
    kernels' device time summed by layer. The idle share is taken against
    both the profiled wall time and ``plain_wall_s``, the same run's wall
    time without the profiler (tracing slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    eng = Engine(cfg, params, device=DEV, config=EngineConfig(
        n_slots=8, max_len=2048, page_size=16, prefill_chunk=128, use_kernel=True))
    for i, n in enumerate(rng.integers(256, 1537, 8)):
        eng.submit(rng.integers(0, cfg.vocab_size, int(n)),
                   SamplingParams(max_new=64), arrival=2 * i)
    eng.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        wall_us = 1e6 * (time.perf_counter() - t0)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0.0)

    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and dev_us(e) > 0 and e.key not in PROFILER_OVERHEAD]
    busy = sum(dev_us(e) for e in kern)
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    st = eng.stats
    plain_us = 1e6 * plain_wall_s
    log(f"  profiled serving run: {st['steps']} steps ({st['mixed_steps']} mixed, "
        f"{st['decides']} decisions), device busy {busy / 1e3:.1f} ms; wall "
        f"{wall_us / 1e3:.1f} ms profiled (idle {1 - busy / wall_us:.1%}), "
        f"{plain_us / 1e3:.1f} ms unprofiled (idle {1 - busy / plain_us:.1%}) "
        f"[{card_name}]")
    by_layer = {name: 0.0 for name, _ in LAYERS}
    by_layer["other (elementwise, gather, reduce)"] = 0.0
    for e in kern:
        low = e.key.lower()
        name = next((n for n, pats in LAYERS if any(p in low for p in pats)),
                    "other (elementwise, gather, reduce)")
        by_layer[name] += dev_us(e)
    for name, us in sorted(by_layer.items(), key=lambda kv: -kv[1]):
        log(f"    {us / 1e3:9.2f} ms {us / busy:6.1%}  {name}")
    log(f"  per decision: {by_layer['decision eigh (cuSOLVER)'] / 1e3 / st['decides']:.2f} "
        f"ms of eigh; per fused step: {by_layer['flash_decode kernel'] / 1e3 / st['steps']:.2f} "
        f"ms of flash_decode, {busy / 1e3 / st['steps']:.2f} ms of device work")
    log("  top kernels:")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / busy:6.1%} "
            f"x{e.count:<6d} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    log(card_name)
    log(f"[1/5] card and build: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    secs = build.build(["decode_attn"])
    log(f"  built decode_attn.cu in {secs['decode_attn']:.1f} s")
    for line in build.build_log.get("decode_attn", (0, ""))[1].splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:" + line.split(":", 1)[-1])

    log("[2/5] flash_decode kernel vs its plain version on the card")
    max_err = check_kernel()

    log("[3/5] full-width drrl-paper serving through Engine, kernel on")
    cfg = get_config("drrl-paper").with_(
        rank=RankConfig(mode="adaptive", rank_grid=GRID, segment_len=32))
    t0 = time.perf_counter()
    params = get_model(cfg).init(torch.Generator(device=DEV).manual_seed(0), device=DEV)
    log(f"  seeded init of {sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M "
        f"parameters in {time.perf_counter() - t0:.1f} s")
    outs, launches, st_adaptive = check_serving(cfg, params, "adaptive", card_name)
    outs_f, _, _ = check_serving(cfg, params, "adaptive, factor cache", card_name,
                                 factor_cache=True)
    agree = np.mean([np.mean(a == b) for a, b in zip(outs, outs_f)])
    log(f"  factor cache vs dense K read: {agree:.3f} of greedy tokens equal")
    fixed = cfg.with_(rank=RankConfig(mode="fixed", rank_grid=GRID, fixed_rank=32,
                                      segment_len=32))
    check_serving(fixed, params, "fixed rank 32", card_name)
    check_small_reference()

    log("[4/5] full-width engine step: kernel vs plain attention")
    check_engine_step(cfg, params)

    log("[5/5] times at the serving shapes")
    t_dec = time_kernel(MAIN_DECODE, card_name)
    time_kernel(MAIN_CHUNK, card_name)
    profile_serving(cfg, params, card_name, st_adaptive["decode_s"])
    print(json.dumps({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
        "replaces": "src/repro/kernels/decode_attn.py:122",
        "launches": launches, "max_abs_err": max_err, **t_dec}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
