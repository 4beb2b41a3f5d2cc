"""Shared-prefix KV reuse on the PyTorch port (repro_torch.serve.prefix):
many users behind one system prompt.

Every request carries the same system prefix plus a short unique user
tail. With ``EngineConfig(prefix_cache=True)`` the first stream prefills
the full prompt and caches it in the radix tree; every later stream
shares those pages (refcounted, zero attention re-run over the prefix),
rehydrates its attention-mass row from the tree's snapshot, and chunk-
prefills only its own tail — token-for-token identical to cold
admission, which this example asserts against a cache-off engine.

    PYTHONPATH=src python examples/serve_prefix_torch.py --tokens 24              # on the GPU
    PYTHONPATH=src python examples/serve_prefix_torch.py --tokens 24 --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--system-len", type=int, default=32)
    ap.add_argument("--user-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--mode", default="adaptive",
                    choices=["adaptive", "fixed", "off"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode=args.mode, rank_grid=(4, 8, 12, 16),
                                    fixed_rank=8, segment_len=16))
    dev = args.device
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)

    rnd = np.random.default_rng(1)
    system = rnd.integers(0, cfg.vocab_size, args.system_len)
    prompts = [np.concatenate([system,
                               rnd.integers(0, cfg.vocab_size,
                                            args.user_len)]).astype(np.int32)
               for _ in range(args.streams)]
    max_len = args.system_len + args.user_len + args.tokens + 8
    # arrivals spaced past the first prefill so the tree is populated
    # before the followers arrive (page_size-multiple chunks give a reuse
    # point at every page)
    gap = -(-(args.system_len + args.user_len) // 16) + 2

    def serve(prefix_cache):
        eng = Engine(cfg, params, device=dev, config=EngineConfig(
            n_slots=args.streams, max_len=max_len, segment_len=16,
            max_new_cap=args.tokens, prefill_chunk=16, page_size=16,
            prefix_cache=prefix_cache, use_kernel=True))
        # two passes: the first also warms the admission-time paths
        # (snapshot slices, rehydration, CoW) that warmup() cannot reach;
        # the quoted TTFTs come from the warm second pass, whose hit
        # pattern is identical (reset clears the tree)
        for rep in range(2):
            if rep:
                eng.reset()
            handles = [eng.submit(p, SamplingParams(max_new=args.tokens),
                                  arrival=gap * i)
                       for i, p in enumerate(prompts)]
            eng.warmup()
            eng.run()
        return eng, handles

    eng, handles = serve(True)
    eng_cold, handles_cold = serve(False)

    s = eng.stats
    for h, hc in zip(handles, handles_cold):
        assert np.array_equal(h.result(), hc.result()), \
            f"rid {h.rid}: prefix-hit decode diverged from cold admission"
    eng.core.cache.check_refs(eng.core.prefix.all_pages())

    n = args.streams
    print(f"{n} streams sharing a {args.system_len}-token system prompt; "
          f"token parity with the cache-off engine verified")
    print(f"  hits/misses      : {s['prefix_hits']}/{s['prefix_misses']}  "
          f"(reused {s['prefix_reused_tokens']} tokens, "
          f"{s['prefix_cow']} CoW pages)")
    print(f"  prefill tok/req  : {s['prefill_tokens'] / n:.1f} cached vs "
          f"{eng_cold.stats['prefill_tokens'] / n:.1f} cold "
          f"({eng_cold.stats['prefill_tokens'] / max(s['prefill_tokens'], 1):.1f}x cut)")
    for h, hc in zip(handles, handles_cold):
        tag = "hit " if eng.core.request_prefix_hit.get(h.rid) else "cold"
        print(f"  rid {h.rid} [{tag}]: TTFT {h.ttft_s * 1e3:6.1f} ms cached "
              f"vs {hc.ttft_s * 1e3:6.1f} ms cache-off; first tokens "
              f"{h.result()[:5].tolist()}")


if __name__ == "__main__":
    main()
