"""Drive the PyTorch port's serving and forward paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (one line each, plus detail lines):
  1. card and build: the card's name and power limit (nvidia-smi), then
     both CUDA kernels built from src/repro_torch/kernels/csrc, one nvcc
     per source, started together;
  2. the flash-decode kernel against its plain PyTorch version on the card,
     f32 (2e-5, and the exact zero pattern of the probabilities) and bf16
     (two bf16 steps of each output element): the CPU tests' shapes, cases
     at the key splits the kernel's host plan picks on this card, and the
     serving path's shapes;
  3. full-width serving of the drrl-paper model (12 layers, d_model 768,
     seeded random weights) through ``repro_torch.serve.Engine`` with the
     kernel on: adaptive rank, again with the factor cache, again in fixed
     mode; a reduced model served on the card with the kernel and on the
     CPU without it must give identical greedy tokens;
  4. one full-width mixed engine step with the kernel and with the plain
     attention on the same inputs: logits must agree;
  5. times at the serving shapes, L2 flushed before each timed call:
     kernel and plain version with and without probabilities, one PyTorch
     library call for the same attention (no probabilities), and the
     kernel's bound for each; then the adaptive serving run under
     torch.profiler, device time by kernel;
  6. the lowrank_flash kernel against its plain version on the card, f32
     (2e-5) and bf16 (two bf16 steps of each element): the CPU tests' six
     cases, the q_offset case, and the forward path's shapes (b = 2, 12
     heads, 4096 tokens, causal; r = dv = 64 masked, r = 32 / dv = 64
     static);
  7. the full-width cache-free forward ``forward_dense(chunked=True)`` at
     2 x 4096 tokens, adaptive/masked with fidelity and fixed/static:
     kernel launches (12 per attention call site), logits and ranks against
     the same forward through the kernel's plain version, and a reduced
     model on the card against the CPU;
  8. one-shot serving (``prefill_chunk=None``) of phase 3's adaptive
     workload: greedy tokens equal to the chunked run's;
  9. times of lowrank_flash at both forward shapes (kernel, plain version,
     ``scaled_dot_product_attention`` and the backend it picked, bound),
     and each forward's wall time and device time by layer.

Exits non-zero, printing no result, when no CUDA device is present or any
phase fails. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
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
from repro_torch.kernels import build, decode_attn, lowrank_flash, ops  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import decode_step_paged, forward_dense  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
TOL = 2e-5                     # f32 kernel vs plain version
# each kernel and its plain version both stay in f32 up to the one rounding
# of the output, so in bf16 they may differ by one bf16 step (at most 2^-7 of
# the value): hold them to two steps, relative to each element
BF16_REL = 2 ** -6
LOGIT_TOL = 1e-3               # f32 engine step / forward, kernel vs plain attention
GRID = (16, 24, 32, 40, 48, 56, 64)
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas=-v report: its
    (mangled) name and template arguments, registers, spills."""
    out, name, spill = [], "?", ""
    for line in log.splitlines():
        if "entry function" in line:
            m = re.search(r"((?:flash_decode|lowrank_flash)_kernel\w*?)I(\w*?)E+v", line)
            name = f"{m.group(1)}<{m.group(2)}>" if m else line.split("'")[1][:60]
        elif "spill stores" in line:
            spill = line.split(":", 1)[-1].strip()
        elif "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
    return out


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


def split_cases():
    """Cases at the key splits that ``decode_attn.split_plan`` picks on this
    card: kv_len equal to a split's size, one less and one more, rows of
    kv_len 1 and M, a GQA group of 4, and chunks in which some queries see
    no key of a whole split, on the decode path (C = 8) and the chunk path
    (C = 80, two query tiles)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def split(b, hq, hkv, C, M):
        return decode_attn.split_plan(b, hq, hkv, C, M, sms)[1]

    L = split(6, 8, 8, 1, 2048)
    G = split(4, 16, 4, 1, 1024)
    D = split(3, 4, 2, 8, 1024)
    K = split(3, 4, 2, 80, 1024)
    return [
        (6, 8, 8, 1, 2048, 64, 64, (L, L - 1, L + 1, 1, 2048, min(2 * L + 3, 2048)),
         None, None),
        (4, 16, 4, 1, 1024, 64, 64, (G, G - 1, G + 1, 1024), None, None),
        (3, 4, 2, 8, 1024, 40, 24, (D + 4, D + 8, 8), (D - 4, D, 0), (8, 8, 5)),
        (3, 4, 2, 80, 1024, 32, 48, (K + 40, min(2 * K + 80, 1024), 80),
         (K - 40, min(2 * K, 944), 0), (80, 80, 70)),
    ]


def make_inputs(case, dtype, seed, return_probs=True):
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, hq, C, r), generator=g, device=DEV).to(dtype)
    k = torch.randn((b, hkv, M, r), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, M, dv), generator=g, device=DEV).to(dtype)
    if C == 1:
        q = q[:, :, 0]
    return (q, k, v, ints(kl)), dict(scale=r ** -0.5, return_probs=return_probs,
                                     q_start=ints(qs), q_lens=ints(ql))


def check_kernel() -> float:
    """Every case in f32 and bf16. Outputs: f32 within 2e-5 + 2e-5 |plain|,
    bf16 within 2e-5 + two bf16 steps of |plain|. Probabilities are f32 on
    both sides, computed in f32 from the same inputs: 2e-5 + 2e-5 |plain|
    in both types, and in f32 the plain version's exact zero pattern."""
    worst = 0.0
    cases = [(c, dt) for c in CHECK_CASES + split_cases() + [MAIN_DECODE, MAIN_CHUNK]
             for dt in (torch.float32, torch.bfloat16)]
    for i, (case, dtype) in enumerate(cases):
        args, kw = make_inputs(case, dtype, seed=i)
        o, p = decode_attn.flash_decode(*args, **kw)
        torch.cuda.synchronize()
        ro, rp = decode_attn.flash_decode_plain(*args, **kw)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_p = (p - rp).abs().max().item()
        rel = TOL if dtype == torch.float32 else BF16_REL
        bad_o = ((o.float() - ro.float()).abs() > TOL + rel * ro.float().abs()).any().item()
        bad_p = ((p - rp).abs() > TOL + TOL * rp.abs()).any().item()
        zeros = torch.equal(p == 0, rp == 0) if dtype == torch.float32 else True
        finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(p).all())
        if bad_o or bad_p or not zeros or not finite:
            raise AssertionError(f"flash_decode disagrees with its plain version at "
                                 f"{case} {dtype}: out {err_o:.3g} (tol {TOL:g} + "
                                 f"{rel:.3g}*|plain|), probs {err_p:.3g}, zero pattern "
                                 f"{zeros}, finite {finite}")
        if dtype == torch.float32:
            worst = max(worst, err_o, err_p)
        log(f"  {str(dtype)[6:]:8s} b,hq,hkv,C,M,r,dv={case[:7]} kv_len={case[7]}: "
            f"max|out-plain| {err_o:.3g} (tol {TOL:g} + {rel:.3g}*|plain|), "
            f"max|probs-plain| {err_p:.3g}")
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

_FLUSH = []


def flush_l2() -> None:
    """Evict the 50 MB L2 before a timed call, outside its event pair: write
    a 256 MB buffer, then read another one, so that the written lines are
    written back here and not inside the timed call. Then hold the device
    for about half a millisecond, so that the host has queued the whole
    timed call before its first event fires: the events time the device,
    not the wrapper's host-side launch overhead."""
    if not _FLUSH:
        _FLUSH.extend(torch.empty(64 << 20, device=DEV) for _ in range(2))
    _FLUSH[0].zero_()
    _FLUSH[1].sum()
    torch.cuda._sleep(1_000_000)


def time_ms(fn, n=25) -> float:
    """Median of n individually event-timed calls after warm-up, each on a
    cold L2 (the serving caller's K/V do not stay in L2 between layers)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        flush_l2()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound_ms(case, probs=True) -> tuple:
    """Least time for the work these inputs need: bytes (q, the K/V rows
    up to each row's kv_len, out, and probs when asked for) over HBM
    bandwidth, and the f32 operations (2 (r + dv) per visible query-key
    pair) over the f32 peak."""
    b, hq, hkv, C, M, r, dv, kl, qs, ql = case
    kl = np.minimum(np.asarray(kl), M)
    qs = np.asarray(kl) - C if qs is None else np.asarray(qs)
    ql = np.full(b, C) if ql is None else np.asarray(ql)
    nbytes = 4 * (b * hq * C * r + hkv * kl.sum() * (r + dv)
                  + b * hq * C * dv + (b * hq * C * M if probs else 0)) + 12 * b
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
    """The kernel and its plain version without probabilities (the library
    call's output) and with them (the serving path's call), SDPA, bounds.
    The first five keys are the no-probabilities numbers."""
    res = {}
    for probs in (False, True):
        (q, k, v, kl), kw = make_inputs(case, torch.float32, seed=7, return_probs=probs)
        ms = time_ms(lambda: decode_attn.flash_decode(q, k, v, kl, **kw))
        plain_ms = time_ms(lambda: decode_attn.flash_decode_plain(q, k, v, kl, **kw))
        bnd, by = bound_ms(case, probs)
        if not probs:
            lib_ms = time_ms(library_call(case, q, k, v))
            res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                       bound_by=by)
        else:
            res.update(ms_probs=ms, plain_ms_probs=plain_ms, bound_ms_probs=bnd)
        log(f"  flash_decode C={case[3]} (b=8, hq=hkv=12, r=dv=64, M=2048, f32, "
            f"{'with' if probs else 'no'} probs, L2 flushed): kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bnd:.4f} ms ({by}), {bnd / ms:.1%} of bound"
            + ("" if probs else f", sdpa (no probs) {lib_ms:.4f} ms") + f" [{card_name}]")
    return res


# CUPTI's own buffer handling, reported beside the kernels: not device work
PROFILER_OVERHEAD = ("Buffer Flush", "Activity Buffer Request")
# device time by layer, first match wins (lower-case substrings of kernel names)
LAYERS = (("flash_decode kernel", ("flash_decode_kernel",)),
          ("lowrank_flash kernel", ("lowrank_flash_kernel",)),
          ("eigh (cuSOLVER)", ("syev", "jacobi", "rotate_batch", "cusolver",
                               "sytrd", "ormtr")),
          ("matrix products (cuBLAS)", ("gemm", "xmma", "cutlass", "gemv")),
          ("copies", ("memcpy", "memset")))
OTHER = "other (elementwise, gather, reduce)"


def dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)


def device_kernels(prof):
    """The profile's device kernels (CUPTI's own buffer work left out)."""
    from torch.autograd import DeviceType
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and dev_us(e) > 0 and e.key not in PROFILER_OVERHEAD]
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    return kern


def by_layer(kern) -> dict:
    """Device microseconds summed by LAYERS, the rest under OTHER."""
    out = {name: 0.0 for name, _ in LAYERS}
    out[OTHER] = 0.0
    for e in kern:
        low = e.key.lower()
        name = next((n for n, pats in LAYERS if any(p in low for p in pats)), OTHER)
        out[name] += dev_us(e)
    return out


def log_layers(layers: dict, busy: float) -> None:
    for name, us in sorted(layers.items(), key=lambda kv: -kv[1]):
        if us > 0:
            log(f"    {us / 1e3:9.2f} ms {us / busy:6.1%}  {name}")


def profile_serving(cfg, params, card_name, plain_wall_s):
    """Where the time of a serving run goes on the card: the adaptive run
    of phase 3 again, device activity only under torch.profiler, its
    kernels' device time summed by layer. The idle share is taken against
    both the profiled wall time and ``plain_wall_s``, the same run's wall
    time without the profiler (tracing slows the host)."""
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

    kern = device_kernels(prof)
    busy = sum(dev_us(e) for e in kern)
    st = eng.stats
    plain_us = 1e6 * plain_wall_s
    log(f"  profiled serving run: {st['steps']} steps ({st['mixed_steps']} mixed, "
        f"{st['decides']} decisions), device busy {busy / 1e3:.1f} ms; wall "
        f"{wall_us / 1e3:.1f} ms profiled (idle {1 - busy / wall_us:.1%}), "
        f"{plain_us / 1e3:.1f} ms unprofiled (idle {1 - busy / plain_us:.1%}) "
        f"[{card_name}]")
    layers = by_layer(kern)
    log_layers(layers, busy)
    log(f"  per decision: {layers['eigh (cuSOLVER)'] / 1e3 / st['decides']:.2f} "
        f"ms of eigh; per fused step: {layers['flash_decode kernel'] / 1e3 / st['steps']:.2f} "
        f"ms of flash_decode, {busy / 1e3 / st['steps']:.2f} ms of device work")
    log("  top kernels:")
    for e in sorted(kern, key=dev_us, reverse=True)[:12]:
        log(f"    {dev_us(e) / 1e3:9.2f} ms {dev_us(e) / busy:6.1%} "
            f"x{e.count:<6d} {e.key[:90]}")


# -- phase 6 ---------------------------------------------------------------

# tests/test_torch_flash.py:FLASH_CASES plus the q_offset case and the
# forward path's shapes: b, hq, hkv, sq, skv, r, dv, causal, q_offset
FLASH_CASES = [
    (2, 4, 2, 64, 64, 16, 32, True, 0),
    (1, 4, 4, 128, 128, 64, 64, True, 0),
    (2, 2, 1, 48, 96, 8, 16, False, 0),
    (1, 8, 2, 37, 37, 24, 16, True, 0),
    (1, 2, 2, 16, 16, 128, 128, True, 0),
    (2, 6, 3, 33, 65, 40, 48, True, 0),
    (1, 2, 2, 4, 32, 16, 16, True, 28),
]
PATH_MASKED = (2, 12, 12, 4096, 4096, 64, 64, True, 0)   # adaptive/masked: r = dh
PATH_STATIC = (2, 12, 12, 4096, 4096, 32, 64, True, 0)   # static_rank 32


def flash_inputs(case, dtype, seed):
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    g = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((b, hq, sq, r), generator=g, device=DEV).to(dtype)
    k = torch.randn((b, hkv, skv, r), generator=g, device=DEV).to(dtype)
    v = torch.randn((b, hkv, skv, dv), generator=g, device=DEV).to(dtype)
    return (q, k, v), dict(scale=r ** -0.5, causal=causal, q_offset=off)


def check_flash() -> float:
    worst = 0.0
    for i, case in enumerate(FLASH_CASES + [PATH_MASKED, PATH_STATIC]):
        for dtype in (torch.float32, torch.bfloat16):
            args, kw = flash_inputs(case, dtype, seed=100 + i)
            o = lowrank_flash.lowrank_flash(*args, **kw)
            torch.cuda.synchronize()
            ro = lowrank_flash.lowrank_flash_plain(*args, **kw)
            diff = (o.float() - ro.float()).abs()
            err = diff.max().item()
            atol = TOL
            rtol = atol if dtype == torch.float32 else BF16_REL
            tol = f"{atol:g} + {rtol:.3g}*|plain|"
            if (diff > atol + rtol * ro.float().abs()).any().item():
                raise AssertionError(f"lowrank_flash disagrees with its plain version "
                                     f"at {case} {dtype}: {err:.3g} (tol {tol})")
            if dtype == torch.float32:
                worst = max(worst, err)
            log(f"  {str(dtype)[6:]:8s} b,hq,hkv,sq,skv,r,dv,causal,q_offset={case}: "
                f"max|out-plain| {err:.3g} (tol {tol})")
    return worst


# -- phase 7 ---------------------------------------------------------------

@contextlib.contextmanager
def plain_flash():
    """Route the model's flash branch through the kernel's plain version
    (on the card) for a reference run; the port itself has no such switch."""
    kernel = ops.flash_attention
    ops.flash_attention = lowrank_flash.lowrank_flash_plain
    try:
        yield
    finally:
        ops.flash_attention = kernel


def forward_cfg(cfg, mode, realisation):
    return cfg.with_(rank=RankConfig(mode=mode, realisation=realisation,
                                     rank_grid=GRID, fixed_rank=32, static_rank=32,
                                     segment_len=32))


# (rank mode, realisation, compute_fidelity)
FORWARDS = (("adaptive", "masked", True), ("fixed", "static", False))


def run_forward(cfg, params, tokens, fid):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, aux = forward_dense(cfg, params, tokens, chunked=True,
                                collect_aux="ranks", compute_fidelity=fid)
    torch.cuda.synchronize()
    return logits, aux["layers"], time.perf_counter() - t0


def check_forward(cfg_base, params, card_name) -> int:
    """The full-width 2 x 4096 forward in both realisations; returns the
    kernel's launches over both runs."""
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg_base.vocab_size, (2, 4096), generator=g, device=DEV)
    total = 0
    for mode, real, fid in FORWARDS:
        cfg = forward_cfg(cfg_base, mode, real)
        reset_launches()
        logits, aux, wall = run_forward(cfg, params, tokens, fid)
        launches = lowrank_flash.LAUNCHES["lowrank_flash"]
        want = cfg.num_layers * (2 if fid else 1)
        assert launches == want, f"{launches} lowrank_flash launches, expected {want}"
        total += launches
        assert logits.shape == (*tokens.shape, cfg.vocab_size) and torch.isfinite(logits).all()
        with plain_flash():
            logits_p, aux_p, wall_p = run_forward(cfg, params, tokens, fid)
        assert lowrank_flash.LAUNCHES["lowrank_flash"] == launches
        err = (logits - logits_p).abs().max().item()
        top = logits_p.abs().max().item()
        assert err <= LOGIT_TOL * max(1.0, top), \
            f"forward {mode}/{real}: kernel vs plain logits differ by {err}"
        assert torch.equal(aux["rank"], aux_p["rank"]), f"forward {mode}/{real}: ranks differ"
        ranks = sorted(set(aux["rank"].flatten().tolist()))
        line = (f"  {mode}/{real}{' + fidelity' if fid else ''}: {launches} lowrank_flash "
                f"launches = {cfg.num_layers} layers x {want // cfg.num_layers}; "
                f"max|logits - plain| {err:.3g} (max |logit| {top:.3g}, tol {LOGIT_TOL}), "
                f"ranks identical {ranks}")
        if fid:
            f_err = (aux["fidelity"] - aux_p["fidelity"]).abs().max().item()
            line += (f", fidelity {aux['fidelity'].mean().item():.4f} "
                     f"(|kernel - plain| {f_err:.3g})")
        log(line + f"; wall {wall * 1e3:.1f} ms kernel, {wall_p * 1e3:.1f} ms plain "
            f"(first calls) [{card_name}]")
    check_forward_reference()
    return total


def check_forward_reference():
    """Reduced drrl-paper at 1040 tokens (flash branch taken): the card with
    the kernel vs the CPU with the plain version."""
    base = get_config("drrl-paper", reduced=True)
    params = get_model(base).init(torch.Generator().manual_seed(0), device="cpu")
    params_dev = _to(params, DEV)
    tokens = torch.randint(0, base.vocab_size, (2, 1040),
                           generator=torch.Generator().manual_seed(6))
    for mode, real in (("adaptive", "masked"), ("fixed", "static")):
        cfg = base.with_(rank=RankConfig(mode=mode, realisation=real, rank_grid=(4, 8, 12, 16),
                                         fixed_rank=8, static_rank=8, segment_len=8))
        out = {}
        for dev, p in ((DEV, params_dev), ("cpu", params)):
            lg, aux = forward_dense(cfg, p, tokens.to(dev), chunked=True,
                                    collect_aux="ranks", compute_fidelity=True)
            out[dev] = (lg.cpu(), aux["layers"]["rank"].cpu(), aux["layers"]["fidelity"].cpu())
        (lg, rk, fd), (lg_c, rk_c, fd_c) = out[DEV], out["cpu"]
        err = (lg - lg_c).abs().max().item()
        assert err <= 1e-4, f"reduced forward {mode}/{real}: card vs CPU logits differ by {err}"
        assert torch.equal(rk, rk_c), f"reduced forward {mode}/{real}: ranks differ"
        assert (fd - fd_c).abs().max().item() <= 1e-5
        log(f"  reduced model, 2 x 1040 tokens, {mode}/{real}: card kernel vs CPU plain "
            f"max|logits| diff {err:.3g} (tol 1e-4), ranks and fidelity equal")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# -- phase 8 ---------------------------------------------------------------

def check_oneshot(cfg, params, chunked_outs, card_name):
    """Phase 3's adaptive workload with one-shot prefill: the tokens of the
    chunked run, request by request."""
    eng, outs, launches = serve(cfg, params, n_slots=8, max_len=2048, page_size=16,
                                prefill_chunk=None, use_kernel=True)
    st = eng.stats
    n_steps = st["steps"] + st["warmup_steps"]
    assert launches == cfg.num_layers * n_steps, f"{launches} flash_decode launches"
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0   # prefill needs probabilities
    assert st["mixed_steps"] == 0 and st["prefills"] == len(outs)
    for i, (a, b) in enumerate(zip(outs, chunked_outs)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}: one-shot != chunked")
    log(f"  one-shot: {len(outs)} requests x 64 tokens equal to the chunked run's; "
        f"{st['steps']} decode steps, {st['prefills']} prefills in "
        f"{st['prefill_s'] * 1e3:.1f} ms ({st['stall_s'] * 1e3:.1f} ms of decode stall), "
        f"{st['tokens_decoded'] / st['decode_s']:.1f} decoded tokens/s, flash_decode "
        f"launches {launches} [{card_name}]")


# -- phase 9 ---------------------------------------------------------------

def flash_bound_ms(case) -> tuple:
    """Least time for the work: q, k, v and out once over HBM bandwidth, and
    the f32 operations (2 (r + dv) per visible query-key pair) over the f32
    peak; returns (ms, what binds)."""
    b, hq, hkv, sq, skv, r, dv, causal, off = case
    n_bytes = 4 * (b * hq * sq * r + b * hkv * skv * (r + dv) + b * hq * sq * dv)
    i = np.arange(sq)
    pairs = np.minimum(skv, off + i + 1).sum() if causal else sq * skv
    flops = 2.0 * b * hq * pairs * (r + dv)
    t_bytes, t_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_backend(q, k, v, scale) -> str:
    """The backend ``scaled_dot_product_attention`` picks for these inputs
    (PyTorch's own dispatch decision, the one the call below takes)."""
    from torch.nn.attention import SDPBackend
    choice = torch._fused_sdp_choice(q, k, v, is_causal=True, scale=scale,
                                     enable_gqa=True)
    return SDPBackend(choice).name


def time_flash(case, label, card_name) -> dict:
    import torch.nn.functional as F
    (q, k, v), kw = flash_inputs(case, torch.float32, seed=9)
    ms = time_ms(lambda: lowrank_flash.lowrank_flash(q, k, v, **kw), n=15)
    plain_ms = time_ms(lambda: lowrank_flash.lowrank_flash_plain(q, k, v, **kw), n=15)

    def lib():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=kw["scale"],
                                              enable_gqa=True)
    lib_ms = time_ms(lib, n=15)
    backend = sdpa_backend(q, k, v, kw["scale"])
    bnd, by = flash_bound_ms(case)
    log(f"  lowrank_flash {label} (b=2, hq=hkv=12, sq=skv=4096, causal, f32): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa ({backend}) {lib_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}), {bnd / ms:.1%} of bound [{card_name}]")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd, bound_by=by)


def profile_forwards(cfg_base, params, card_name) -> None:
    """Each forward of phase 7 again: wall time unprofiled (median of 3),
    then one run under torch.profiler, device time by layer."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=DEV).manual_seed(5)
    tokens = torch.randint(0, cfg_base.vocab_size, (2, 4096), generator=g, device=DEV)
    for mode, real, fid in FORWARDS:
        cfg = forward_cfg(cfg_base, mode, real)
        wall = statistics.median(run_forward(cfg, params, tokens, fid)[2] for _ in range(3))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_forward(cfg, params, tokens, fid)
        kern = device_kernels(prof)
        busy = sum(dev_us(e) for e in kern)
        log(f"  forward {mode}/{real}{' + fidelity' if fid else ''}, 2 x 4096 tokens: wall "
            f"{wall * 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"(idle {1 - busy / (wall * 1e6):.1%}) [{card_name}]")
        log_layers(by_layer(kern), busy)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_name = card()
    log(card_name)
    log(f"[1/9] card and build: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    sources = ["decode_attn", "lowrank_flash"]
    secs = build.build(sources)
    for name in sources:
        log(f"  built {name}.cu in {secs[name]:.1f} s")
        for line in ptxas_summary(build.build_log.get(name, (0, ""))[1]):
            log("  ptxas: " + line)

    log("[2/9] flash_decode kernel vs its plain version on the card")
    max_err = check_kernel()

    log("[3/9] full-width drrl-paper serving through Engine, kernel on")
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

    log("[4/9] full-width engine step: kernel vs plain attention")
    check_engine_step(cfg, params)

    log("[5/9] times at the serving shapes")
    t_dec = time_kernel(MAIN_DECODE, card_name)
    t_chunk = time_kernel(MAIN_CHUNK, card_name)
    profile_serving(cfg, params, card_name, st_adaptive["decode_s"])

    log("[6/9] lowrank_flash kernel vs its plain version on the card")
    flash_err = check_flash()

    log("[7/9] full-width forward_dense(chunked=True), 2 x 4096 tokens")
    flash_launches = check_forward(cfg, params, card_name)

    log("[8/9] one-shot serving (prefill_chunk=None) vs the chunked run")
    check_oneshot(cfg, params, outs, card_name)

    log("[9/9] lowrank_flash times at the forward shapes; the forwards by layer")
    t_flash = time_flash(PATH_MASKED, "masked r=64, dv=64", card_name)
    time_flash(PATH_STATIC, "static r=32, dv=64", card_name)
    profile_forwards(cfg, params, card_name)

    print(json.dumps({"kernels": [
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attn.cu",
         "replaces": "src/repro/kernels/decode_attn.py:122",
         "launches": launches, "max_abs_err": max_err, **t_dec,
         "chunk": t_chunk},
        {"name": "lowrank_flash", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/lowrank_flash.cu",
         "replaces": "src/repro/kernels/lowrank_flash.py:82",
         "launches": flash_launches, "max_abs_err": flash_err, **t_flash}]}))
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
