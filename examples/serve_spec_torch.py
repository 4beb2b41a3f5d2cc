"""Low-rank self-speculative decoding on the PyTorch port
(repro_torch.serve.spec): the factor cache as a free draft model.

With ``EngineConfig(speculative=True)`` each fused step drafts
``draft_k`` tokens ahead reading only the factor cache at roughly
``draft_rank_frac`` of each stream's live rank, then verifies all of
them in ONE chunked step at the full current rank and accepts the
longest matching prefix. Speculation is exact — greedy and seeded
streams are token-identical to plain decode, which this example asserts
— so the accept rate is pure speedup: every accepted draft is a decode
step the engine never had to dispatch.

    PYTHONPATH=src python examples/serve_spec_torch.py --tokens 24              # on the GPU
    PYTHONPATH=src python examples/serve_spec_torch.py --tokens 24 --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--draft-k", type=int, default=4)
    ap.add_argument("--draft-rank-frac", type=float, default=0.25)
    ap.add_argument("--mode", default="adaptive",
                    choices=["adaptive", "fixed", "off"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode=args.mode, rank_grid=(4, 8, 12, 16),
                                    fixed_rank=8, segment_len=8))
    dev = args.device
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)

    rnd = np.random.default_rng(1)
    prompts = [rnd.integers(0, cfg.vocab_size,
                            args.prompt_len).astype(np.int32)
               for _ in range(args.streams)]
    max_len = args.prompt_len + args.tokens + 8

    def serve(speculative):
        # greedy-only executable: this demo quotes wall clocks, and at toy
        # scale the sampling machinery (drafted + verified positions all
        # draw) would dominate the step; seeded sampling works identically
        # (see tests/test_torch_spec.py for the parity proof)
        eng = Engine(cfg, params, device=dev, config=EngineConfig(
            n_slots=args.streams, max_len=max_len, segment_len=8,
            max_new_cap=args.tokens, prefill_chunk=8, page_size=8,
            speculative=speculative, draft_k=args.draft_k,
            draft_rank_frac=args.draft_rank_frac, sampling=False,
            use_kernel=True))
        # two passes: the first also warms the allocator and the paths
        # warmup() cannot reach; the quoted wall clock is the warm pass
        for rep in range(2):
            if rep:
                eng.reset()
            handles = [eng.submit(p, SamplingParams(max_new=args.tokens))
                       for p in prompts]
            eng.warmup()
            t0 = time.perf_counter()
            eng.run()
            if dev != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return eng, handles, wall

    eng, handles, wall_spec = serve(True)
    eng_plain, handles_plain, wall_plain = serve(False)

    for h, hp in zip(handles, handles_plain):
        assert np.array_equal(h.result(), hp.result()), \
            f"rid {h.rid}: speculative decode diverged from plain decode"

    s = eng.stats
    accept_rate = s["spec_accepted"] / max(s["spec_drafted"], 1)
    mean_run = (s["spec_tokens"]
                / max(s["spec_tokens"] - s["spec_accepted"], 1))
    print(f"{args.streams} streams x {args.tokens} tokens, "
          f"draft_k={args.draft_k}, "
          f"draft_rank_frac={args.draft_rank_frac} ({args.mode} mode)")
    print(f"  exact: all streams token-identical to plain decode")
    print(f"  accept rate      : {accept_rate:.2f} "
          f"({s['spec_accepted']}/{s['spec_drafted']} drafts)")
    print(f"  mean accepted run: {mean_run:.2f} tokens per fused step "
          f"(max {args.draft_k + 1})")
    print(f"  fused steps      : {s['steps']} speculative vs "
          f"{eng_plain.stats['steps']} plain")
    # wall clock is informational at this scale: the draft's rank cut
    # saves attention/KV reads, which a toy model barely has, so the win
    # here is the fused-dispatch reduction above
    print(f"  wall clock       : {wall_spec:.2f}s speculative vs "
          f"{wall_plain:.2f}s plain "
          f"({wall_plain / max(wall_spec, 1e-9):.2f}x)")
    first = handles[0]
    print(f"  accept runs rid 0: {eng.accept_lens()[first.rid]}")


if __name__ == "__main__":
    main()
