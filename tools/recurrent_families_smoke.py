"""Phase 21 of ``chip_smoke.py`` alone: the remaining model families at full
width on an NVIDIA GPU.

    python3 tools/recurrent_families_smoke.py              # 21a-f
    python3 tools/recurrent_families_smoke.py --profile    # where the time goes
    python3 tools/recurrent_families_smoke.py --profile --decodes-only

Builds the lowrank_flash and flash_decode kernels, f32 and bf16 (the ptxas
lines of the lowrank_flash instantiations phase 21 runs are printed) and
runs
``chip_smoke.check_recurrent_families``:
(a) lowrank_flash at zamba2's r = dv = 112 (32/32 heads), seamless's 16/16
heads of 64 and qwen2-vl's 28/4 of 128 against its plain version, f32 and
bf16, timed beside its bound and SDPA; (b) zamba2-7b at full width and
depth, forward, prefill and decode; (c) rwkv6-1.6b, forward, decode and one
layer's wkv6 scan against the naive recurrence; (d) seamless-m4t-medium,
encode, forward and decode; (e) qwen2-vl-7b with M-RoPE, forward and
decode; (f) the four reduced models, card against CPU. ``--profile``
instead runs, in bf16 at full width, zamba2-7b's 2 x 4096 forward in 'off'
and 16 of its decode steps after a 4064-token prefill, rwkv6-1.6b's 1 x
4096 forward and 32 decode steps, seamless's forward, qwen2-vl-7b's
forward and 16 of its decode steps after a 2048-token prompt, each once
unprofiled (wall) and once under torch.profiler (device activity only),
and prints device busy, idle against the unprofiled wall and the device
time by layer; ``--decodes-only`` profiles the zamba2 and qwen2-vl decodes
alone. Exits non-zero without a CUDA device or when a check fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def profiled(label, fn, card, steps=1):
    """fn() once unprofiled (wall), then under torch.profiler (device
    activity only): busy, idle against the unprofiled wall, by layer."""
    from torch.profiler import ProfilerActivity, profile
    _, wall = cs.timed(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, torch.no_grad():
        fn()
        torch.cuda.synchronize()
    kern = cs.raw_device_kernels(prof)
    busy = sum(cs.dev_us(e) for e in kern)
    layers = cs.by_layer(kern)
    cs.log(f"  {label}: wall {1e3 * wall:.1f} ms ({1e3 * wall / steps:.2f} ms per step), "
           f"device busy {busy / 1e3:.1f} ms (idle {1 - busy / 1e6 / wall:.1%}), "
           f"{sum(e.count for e in kern)} device kernels [{card}]")
    cs.log_layers(layers, busy)
    return {"wall_ms": 1e3 * wall, "busy_ms": busy / 1e3, "steps": steps,
            "by_layer_ms": {k: v / 1e3 for k, v in layers.items()}}


def profile_families(card, decodes_only=False) -> dict:
    """The bf16 forwards and decodes of phase 21, profiled (with
    ``decodes_only``, zamba2's and qwen2-vl's decodes alone)."""
    from repro_torch.models import encdec, rwkv_lm, zamba2
    out = {}
    g = torch.Generator(device=cs.DEV).manual_seed(5)
    zc = cs.get_config("zamba2-7b")
    zp = cs.family_params(zc)
    tok = torch.randint(0, zc.vocab_size, (2, 4096), generator=g, device=cs.DEV)
    if not decodes_only:
        out["zamba2 forward"] = profiled("zamba2-7b forward_zamba off, 2 x 4096", lambda:
                                         zamba2.forward_zamba(zc, zp, tok, chunked=True), card)
    fns = cs.get_model(zc)
    with torch.no_grad():
        _, cache = fns.decode_step(zp, fns.init_cache(2, 4096, device=cs.DEV),
                                   tok[:, :4064], chunked=True)

    def zamba_steps(n=16):
        c = dict(cache, len=4064)      # the same 16 positions each time
        for i in range(n):
            _, c = fns.decode_step(zp, c, tok[:, 4064 + i:4065 + i], chunked=True)
    out["zamba2 decode"] = profiled("zamba2-7b 16 decode steps after 4064 tokens",
                                    zamba_steps, card, steps=16)
    del zp, cache
    cs.free_memory()
    if decodes_only:
        return {**out, **profile_vlm(card, g, decode_only=True)}
    rc = cs.get_config("rwkv6-1.6b")
    rp = cs.family_params(rc)
    tok = torch.randint(0, rc.vocab_size, (1, 4096), generator=g, device=cs.DEV)
    out["rwkv6 forward"] = profiled("rwkv6-1.6b forward_rwkv, 1 x 4096",
                                    lambda: rwkv_lm.forward_rwkv(rc, rp, tok), card)
    rf = cs.get_model(rc)
    with torch.no_grad():
        _, state = rf.decode_step(rp, rf.init_cache(1, 0, device=cs.DEV), tok[:, :4064])

    def rwkv_steps(n=32):
        st = state
        for i in range(n):
            _, st = rf.decode_step(rp, st, tok[:, 4064 + i:4065 + i])
    out["rwkv6 decode"] = profiled("rwkv6-1.6b 32 decode steps", rwkv_steps, card,
                                   steps=32)
    del rp, state
    cs.free_memory()
    sc = cs.get_config("seamless-m4t-medium")
    sp = cs.family_params(sc)
    frames = torch.randn((2, 1024, sc.d_model), generator=g, device=cs.DEV).to(
        torch.bfloat16)
    tok = torch.randint(0, sc.vocab_size, (2, 2048), generator=g, device=cs.DEV)
    out["seamless forward"] = profiled(
        "seamless forward_encdec, 2 x 2048 over 2 x 1024 frames",
        lambda: encdec.forward_encdec(sc, sp, frames, tok, chunked=True), card)
    del sp
    cs.free_memory()
    return {**out, **profile_vlm(card, g)}


def profile_vlm(card, g, decode_only=False) -> dict:
    """qwen2-vl-7b's forward (unless ``decode_only``) and 16 decode steps
    after a 2048-token prompt (phase 21e's), profiled."""
    out = {}
    qc = cs.get_config("qwen2-vl-7b")
    qp = cs.family_params(qc)
    patches = torch.randn((2, 256, qc.d_model), generator=g, device=cs.DEV).to(
        torch.bfloat16)
    text = torch.randint(0, qc.vocab_size, (2, 3840), generator=g, device=cs.DEV)
    pos = cs.vlm_positions(2, 256, 3840, cs.VLM_GRID, cs.DEV)
    if not decode_only:
        out["qwen2-vl forward"] = profiled(
            "qwen2-vl-7b forward_dense, 2 x (256 + 3840)",
            lambda: cs.forward_dense(qc, qp, text, positions=pos, extra_embeddings=patches,
                                     chunked=True), card)
    fns = cs.get_model(qc)
    n = cs.VLM_PROMPT
    with torch.no_grad():
        _, cache = fns.decode_step(qp, fns.init_cache(2, n + cs.VLM_DECODE_STEPS,
                                                      device=cs.DEV),
                                   text[:, :n], chunked=True)

    def vlm_steps(steps=cs.VLM_DECODE_STEPS):
        c = dict(cache, len=n)         # the same positions each time
        for i in range(steps):
            _, c = fns.decode_step(qp, c, text[:, n + i:n + i + 1], chunked=True)
    out["qwen2-vl decode"] = profiled(
        f"qwen2-vl-7b {cs.VLM_DECODE_STEPS} decode steps after {n} tokens", vlm_steps, card,
        steps=cs.VLM_DECODE_STEPS)
    del qp, cache
    cs.free_memory()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile the bf16 forwards and decodes instead")
    ap.add_argument("--decodes-only", action="store_true",
                    help="with --profile: zamba2's and qwen2-vl's decodes alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("recurrent_families_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    secs = cs.build.build(["lowrank_flash", "lowrank_flash_bf16", "decode_attn",
                           "decode_attn_bf16"])
    cs.log("built " + ", ".join(f"{k} in {v:.1f} s" for k, v in secs.items()))
    t0 = time.perf_counter()
    if args.profile:
        cs.log("profiles " + cs.json.dumps(profile_families(card, args.decodes_only)))
    else:
        cs.phase("[21/21] the remaining families at full width")
        cs.check_recurrent_families(card)
    cs.log(f"phase 21 in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
