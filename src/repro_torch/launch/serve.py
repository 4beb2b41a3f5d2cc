"""Serving CLI of the port (``repro.launch.serve``):

    PYTHONPATH=src python -m repro_torch.launch.serve              # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Serves ``--batch`` random prompts of ``--prompt-len`` tokens, greedy, for
``--tokens`` tokens each through ``serve.api.Engine`` with chunked prefill
(``--chunk``, 0 = one-shot) and prints decoded tokens/s, the first steps'
per-slot ranks and each request's TTFT. As in the reference, ``--reduced``
is always on (a store_true flag whose default is True), so the CLI serves
the reduced config. ``--arch`` takes every id of the config registry:
DeepSeek-V3, Zamba2, RWKV6, the encoder-decoder and Qwen2-VL (M-RoPE)
have no paged step, so the engine refuses them, as the reference's does.
Every fused step runs ``flash_decode`` (the CUDA kernel on
the card, its plain version on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.api import get_model
from repro_torch.serve.api import AdaptiveServer, Engine, EngineConfig, SamplingParams

__all__ = ["AdaptiveServer", "main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="drrl-paper")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prefill chunk size (0 = one-shot prefill)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = args.device
    cfg = get_config(args.arch, reduced=args.reduced)
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    policy = None
    if cfg.rank.mode == "drrl":
        from repro_torch.core.drrl import init_agent
        policy = init_agent(torch.Generator(dev).manual_seed(7), cfg.rank,
                            cfg.d_model, device=dev)
    eng = Engine(cfg, params, policy, device=dev, config=EngineConfig(
        n_slots=args.batch, max_len=args.prompt_len + args.tokens + 8,
        segment_len=16, max_new_cap=args.tokens,
        prefill_chunk=args.chunk or None, use_kernel=True,
        sampling=False))      # greedy-only CLI
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    handles = [eng.submit(prompts[i], SamplingParams(max_new=args.tokens))
               for i in range(args.batch)]
    eng.warmup()
    eng.run()
    s = eng.stats
    tps = s["tokens_decoded"] / max(s["decode_s"], 1e-9)
    ranks = eng.core.ranks_per_step()
    print(f"decoded ({args.batch}, {args.tokens}) at {tps:.1f} tok/s "
          f"(compile {s['compile_s']:.2f}s, prefill {s['prefill_s']:.2f}s, "
          f"mixed steps {s['mixed_steps']}); "
          f"per-slot rank schedule: {[r.tolist() for r in ranks[:8]]}...")
    print(f"TTFT per request: "
          f"{['%.3fs' % h.ttft_s for h in handles if h.ttft_s is not None]}")


if __name__ == "__main__":
    main()
