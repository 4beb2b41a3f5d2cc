"""Phase 20 of ``chip_smoke.py`` alone: the dense configs and the MoE family
at full width on an NVIDIA GPU.

    python3 tools/families_smoke.py              # 20a-g
    python3 tools/families_smoke.py --profile    # where serving's time goes

Builds both kernels (lowrank_flash's f32 and bf16 sources; one nvcc per
source, started together; the ptxas lines of the instantiations phase 20
runs are printed) and runs
``chip_smoke.check_families``: (a) both kernels at the
new shapes against their plain versions, timed; (b) qwen2.5-14b served at
full width and depth; (e) its chunked forward; (c) granite served, with its
capacity drops and a guarded steady run; (d) internlm2, phi3 and
deepseek-coder cut in depth; (f) DeepSeek-V3 with MLA and MTP; (g) the
reduced models, card against CPU. ``--profile`` instead serves qwen2.5-14b
(full depth, 'off' and 'adaptive') and granite ('adaptive') once each under
torch.profiler (device activity only) and prints their device time by
layer beside the unprofiled wall. Exits non-zero without a CUDA device or
when a check fails.
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


def profile_family_serving(cfg, params, label, card):
    """Phase 3's workload on ``cfg`` served twice: unprofiled (wall), then
    under torch.profiler (device activity only): device busy, idle against
    the unprofiled wall, time by layer, per step and per decision."""
    from torch.profiler import ProfilerActivity, profile
    st = cs.serve_family(cfg, params, label, card)[1]
    wall_us = 1e6 * st["decode_s"]
    prompts, arrivals = cs.phase3_workload(cfg.vocab_size)
    eng = cs.Engine(cfg, params, device=cs.DEV, config=cs.EngineConfig(
        n_slots=8, max_len=2048, page_size=16, prefill_chunk=128, use_kernel=True))
    for p, a in zip(prompts, arrivals):
        eng.submit(p, cs.SamplingParams(max_new=64), arrival=a)
    eng.warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run()
        torch.cuda.synchronize()
    kern = cs.raw_device_kernels(prof)
    busy = sum(cs.dev_us(e) for e in kern)
    st = eng.stats
    cs.log(f"  {label} profiled: {st['steps']} steps ({st['mixed_steps']} mixed, "
           f"{st['decides']} decisions); device busy {busy / 1e3:.1f} ms, unprofiled wall "
           f"{wall_us / 1e3:.1f} ms (idle {1 - busy / wall_us:.1%}); per step "
           f"{busy / 1e3 / st['steps']:.2f} ms of device work [{card}]")
    layers = cs.by_layer(kern)
    cs.log_layers(layers, busy)
    if st["decides"]:
        cs.log(f"  per decision: {layers['eigh (cuSOLVER)'] / 1e3 / st['decides']:.2f} ms "
               f"of eigh")
    cs.log("  top kernels:")
    for e in sorted(kern, key=cs.dev_us, reverse=True)[:8]:
        cs.log(f"    {cs.dev_us(e) / 1e3:9.2f} ms {cs.dev_us(e) / busy:6.1%} "
               f"x{e.count:<7d} {e.key[:90]}")
    return {"busy_ms": busy / 1e3, "wall_ms": wall_us / 1e3, "steps": st["steps"],
            "decides": st["decides"], "by_layer_ms": {k: v / 1e3 for k, v in layers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile qwen2.5-14b and granite serving instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("families_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card()
    cs.log(card)
    secs = cs.build.build(["decode_attn", "decode_attn_bf16", "lowrank_flash",
                           "lowrank_flash_bf16"])
    cs.log("built " + ", ".join(f"{k} in {v:.1f} s" for k, v in secs.items()))
    t0 = time.perf_counter()
    if args.profile:
        out = {}
        qwen = cs.get_config("qwen2.5-14b")
        params = cs.family_params(qwen)
        for mode in ("off", "adaptive"):
            out[f"qwen2.5-14b {mode}"] = profile_family_serving(
                cs.family_rank(qwen, mode), params, f"qwen2.5-14b {mode}", card)
        del params
        cs.free_memory()
        granite = cs.get_config("granite-moe-3b-a800m")
        cfg = granite.with_(rank=cs.RankConfig(mode="adaptive",
                                               rank_grid=granite.rank.rank_grid,
                                               segment_len=32))
        out["granite adaptive"] = profile_family_serving(
            cfg, cs.family_params(granite), "granite adaptive", card)
        cs.log("profiles " + cs.json.dumps(out))
    else:
        cs.phase("[20/20] the dense configs and the MoE family")
        cs.check_families(card)
    cs.log(f"phase 20 in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
