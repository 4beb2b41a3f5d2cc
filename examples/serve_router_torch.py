"""Async front door + multi-replica router on the PyTorch port
(repro_torch.serve.frontend).

A 2-replica fleet behind one ``Router.submit()``: each replica runs a
background stepping thread (FrontEnd), so callers just iterate their
handles — sync (``for tok in h.tokens()``) or async
(``async for tok in h``) — while the fleet decodes continuously.

The workload is shared-system-prompt traffic in groups: one leader per
group warms a replica's radix tree, then a shuffled burst of follow-ups
arrives. Prefix-affinity dispatch probes every replica's tree and lands
each follow-up where its prefix is already cached; the same burst under
round-robin sprays groups across the fleet and re-prefills. The example
prints both dispatch policies' hit-rates and asserts affinity wins.

    PYTHONPATH=src python examples/serve_router_torch.py --groups 2 --per-group 4              # on the GPU
    PYTHONPATH=src python examples/serve_router_torch.py --groups 2 --per-group 4 --device cpu
"""
import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.serve import EngineConfig, FleetConfig, Router, SamplingParams


def build_workload(args, vocab):
    rnd = np.random.default_rng(7)
    groups = [rnd.integers(0, vocab, args.system_len)
              for _ in range(args.groups)]
    tails = [[rnd.integers(0, vocab, args.user_len)
              for _ in range(args.per_group)] for _ in groups]
    prompts = [[np.concatenate([g, t]).astype(np.int32) for t in ts]
               for g, ts in zip(groups, tails)]
    order = [(g, j) for j in range(1, args.per_group)
             for g in range(args.groups)]
    return prompts, [order[k] for k in rnd.permutation(len(order))]


def drive(router, prompts, order, max_new):
    sp = SamplingParams(max_new=max_new)
    t0 = time.perf_counter()
    leaders = [router.submit(ps[0], sp) for ps in prompts]
    for h in leaders:
        h.result()                       # one warm replica per group
    burst = [router.submit(prompts[g][j], sp) for g, j in order]

    async def consume():                 # async consumption, all at once
        return await asyncio.gather(
            *[asyncio.to_thread(lambda h=h: [t for t in h.tokens()])
              for h in burst])

    outs = asyncio.run(consume())
    assert router.drain(60.0), "the fleet did not drain within 60 s"
    wall = time.perf_counter() - t0
    st = router.stats()
    return outs, wall, st


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--per-group", type=int, default=4)
    ap.add_argument("--system-len", type=int, default=32)
    ap.add_argument("--user-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16),
                                    segment_len=8))
    dev = args.device
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    prompts, order = build_workload(args, cfg.vocab_size)

    ecfg = EngineConfig(
        n_slots=2, max_len=args.system_len + args.user_len + args.tokens + 8,
        page_size=16, segment_len=8, max_new_cap=args.tokens,
        prefill_chunk=16, prefix_cache=True, use_kernel=True)

    results = {}
    for routing in ("affinity", "round_robin"):
        fleet = FleetConfig(engine=ecfg, n_replicas=args.replicas,
                            routing=routing, affinity_min_tokens=16,
                            idle_poll_s=0.005)
        with Router(cfg, params, fleet=fleet, device=dev) as router:
            outs, wall, st = drive(router, prompts, order, args.tokens)
            agg = st["aggregate"]
            results[routing] = (outs, agg)
            print(f"{routing:>12}: hit_rate {agg['hit_rate']:.2f}  "
                  f"tokens {agg['tokens_decoded']}  wall {wall * 1e3:.0f} ms  "
                  f"routed {st['routed']}  kinds {st['route_kinds']}")

    # routing must never change the decode: token parity across policies
    for a, b in zip(results["affinity"][0], results["round_robin"][0]):
        assert a == b, "routing changed decoded tokens"
    aff, rr = results["affinity"][1], results["round_robin"][1]
    assert aff["hit_rate"] > rr["hit_rate"], \
        f"affinity {aff['hit_rate']:.2f} <= round-robin {rr['hit_rate']:.2f}"
    print(f"affinity reused {aff['hit_rate']:.0%} of prompts from a warm "
          f"replica (round-robin: {rr['hit_rate']:.0%}); tokens identical")


if __name__ == "__main__":
    main()
