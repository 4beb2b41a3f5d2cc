"""Streaming serving on the PyTorch port through the request/response API
(repro_torch.serve.api): submit returns a RequestHandle, tokens arrive
incrementally while chunked prefill interleaves new prompts into the fused
decode step, so admission never stalls the streams already decoding.

    PYTHONPATH=src python examples/serve_stream_torch.py --tokens 48              # on the GPU
    PYTHONPATH=src python examples/serve_stream_torch.py --tokens 48 --device cpu
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
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=48)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--mode", default="adaptive",
                    choices=["adaptive", "fixed", "off"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = args.device
    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode=args.mode, rank_grid=(4, 8, 12, 16),
                                    fixed_rank=8, segment_len=16))
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)

    eng = Engine(cfg, params, device=dev, config=EngineConfig(
        n_slots=args.streams,
        max_len=args.prompt_len + args.tokens + 8,
        segment_len=16, max_new_cap=args.tokens,
        prefill_chunk=args.chunk, use_kernel=True))
    rnd = np.random.default_rng(1)
    prompts = [rnd.integers(0, cfg.vocab_size, args.prompt_len)
               for _ in range(args.streams)]

    # stream 0: greedy, consumed incrementally through the handle's iterator;
    # the rest: seeded temperature sampling, staggered arrivals, finished in
    # the background by the same step loop
    h0 = eng.submit(prompts[0], SamplingParams(max_new=args.tokens))
    rest = [eng.submit(p, SamplingParams(max_new=args.tokens,
                                         temperature=0.8, top_k=16,
                                         seed=100 + i),
                       arrival=2 * (i + 1))
            for i, p in enumerate(prompts[1:])]
    eng.warmup()

    got = []
    for tok in h0.tokens():          # drives eng.step() under the hood
        got.append(tok)
        if len(got) <= 5 or len(got) % 16 == 0:
            print(f"stream 0 token[{len(got) - 1:3d}] = {tok}")
    eng.run()                        # drain the sampled streams

    s = eng.stats
    tps = s["tokens_decoded"] / max(s["decode_s"], 1e-9)
    print(f"\n{args.streams} streams x {args.tokens} tokens at "
          f"{tps:.1f} tok/s (compile {s['compile_s']:.2f}s excluded); "
          f"chunked prefill: {s['mixed_steps']} mixed steps, "
          f"stall {s['stall_s'] * 1e3:.1f} ms")
    for h in [h0] + rest:
        assert h.done and len(h.result()) == args.tokens
        print(f"  rid {h.rid}: TTFT {h.ttft_s * 1e3:7.1f} ms  "
              f"temp {h.params.temperature}  first tokens "
              f"{h.result()[:6].tolist()}")


if __name__ == "__main__":
    main()
