"""Where the time of one ``flash_decode`` call goes on an NVIDIA GPU.

    python3 tools/flash_decode_profile.py

At ``chip_smoke.py``'s serving shapes (``MAIN_DECODE``, C = 1, and
``MAIN_CHUNK``, C = 128), with and without probabilities, and for several
values of ``decode_attn.BLOCKS_PER_SM`` (the key split's target): the
device time of each kernel the call launches, by name (torch.profiler,
mean of 10 calls, L2 flushed before each), and the host time one call
takes to queue its work. Needs a CUDA device; builds the kernel on first
use, as the port does.
"""
from __future__ import annotations

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch.kernels import decode_attn  # noqa: E402

SWEEP = (4, 8, 16)


def host_us(fn, n=200) -> float:
    """Host microseconds per call to queue fn's work (no sync inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"{card}, {sms} SMs")
    default = decode_attn.BLOCKS_PER_SM
    for case in (cs.MAIN_DECODE, cs.MAIN_CHUNK):
        b, hq, hkv, C, M = case[:5]
        for probs in (False, True):
            (q, k, v, kl), kw = cs.make_inputs(case, torch.float32, seed=7,
                                               return_probs=probs)

            def call():
                return decode_attn.flash_decode(q, k, v, kl, **kw)

            for bps in SWEEP:
                decode_attn.BLOCKS_PER_SM = bps
                plan = decode_attn.split_plan(b, hq, hkv, C, M, sms)
                per = cs.kernel_us(call)
                print(f"C={C} {'with' if probs else 'no'} probs, BLOCKS_PER_SM={bps} "
                      f"{plan}: device {sum(per.values()):.2f} us [{card}]")
                for name, us in sorted(per.items(), key=lambda kv: -kv[1]):
                    print(f"    {us:8.2f} us  {name[:100]}")
            decode_attn.BLOCKS_PER_SM = default
            print(f"  host: {host_us(call):.1f} us per call to queue its work "
                  f"(BLOCKS_PER_SM={default}) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
