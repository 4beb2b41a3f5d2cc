"""Close the loop on the paper's RL agent against serving traffic, on the
PyTorch port: record traces -> train the rank policy offline -> serve with
it.

Three acts, one script:

1. **Record** — the deterministic workload suite (repro_torch.serve.workloads)
   is served under the adaptive spectral heuristic with
   ``EngineConfig(record_traces=...)``: every per-segment rank decision
   lands in a versioned npz trace (features + outcomes).
2. **Train**  — repro_torch.train.serve_policy rebuilds the Eq. 6 policy
   features from the trace bit-compatibly with serving-time inference
   and trains the Transformer policy net: BC warm start, BC to the
   constrained reward oracle, then PPO. The offline replay evaluation
   prints learned vs adaptive vs oracle on the Eq. 13 reward.
3. **Serve**  — the trained checkpoint loads straight into an engine in
   rank mode ``learned``: the policy net runs on the device inside each
   segment decision.

    PYTHONPATH=src python examples/serve_learned_torch.py --tokens 12              # on the GPU
    PYTHONPATH=src python examples/serve_learned_torch.py --tokens 12 --device cpu
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.serve import ServeEngine
from repro_torch.serve.traces import TraceReader, TraceRecorder
from repro_torch.serve.workloads import build, make_workload, workload_names
from repro_torch.train.serve_policy import load_policy, train_serve_policy


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=5,
                    help="requests per workload scenario")
    ap.add_argument("--tokens", type=int, default=12,
                    help="decode budget per request")
    ap.add_argument("--bc-steps", type=int, default=60)
    ap.add_argument("--ppo-steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--work-dir", default=None,
                    help="keep traces + checkpoint here (default: temp)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    grid = (4, 8, 12, 16)
    cfg = get_config("drrl-paper", reduced=True)
    acfg = cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=grid,
                                     segment_len=8))
    lcfg = cfg.with_(rank=RankConfig(mode="learned", rank_grid=grid,
                                     segment_len=8))
    dev = args.device
    params = get_model(acfg).init(torch.Generator(dev).manual_seed(0), device=dev)
    specs = [make_workload(n, seed=args.seed, n_requests=args.requests,
                           max_new=args.tokens, vocab=cfg.vocab_size,
                           max_prompt=40) for n in workload_names()]

    def serve_suite(run_cfg, policy_params, recorder):
        total = 0
        for spec in specs:
            eng = ServeEngine(run_cfg, params, policy_params, n_slots=4,
                              max_len=96, page_size=16, segment_len=8,
                              max_new_cap=args.tokens, prefill_chunk=8,
                              record_traces=recorder, use_kernel=True,
                              device=dev, **spec.engine_overrides)
            for r in build(spec):
                eng.submit(r)
            outs = eng.run()
            assert all(0 < len(v) <= args.tokens for v in outs.values()), \
                f"{spec.name}: invalid streams"
            total += len(outs)
        recorder.flush()
        return total

    with tempfile.TemporaryDirectory() as tmp:
        base = args.work_dir or tmp
        adir, ldir, pdir = (f"{base}/trace_adaptive",
                            f"{base}/trace_learned", f"{base}/policy")

        n = serve_suite(acfg, None,
                        TraceRecorder(adir, acfg, scenario="suite"))
        print(f"recorded   : {n} requests over {workload_names()} -> "
              f"{len(TraceReader(adir))} decision records")

        _, history = train_serve_policy(
            adir, acfg.rank, out_dir=pdir,
            bc_steps=args.bc_steps, ppo_steps=args.ppo_steps, device=dev)
        ev = history["eval"]
        print(f"trained    : picked {ev['picked']} "
              f"(bc {args.bc_steps} steps, ppo {args.ppo_steps} steps)")
        for name in ("adaptive", "learned", "oracle"):
            e = ev[name]
            print(f"  {name:9s}: reward {e['reward']:+.4f}  "
                  f"mean rank {e['mean_rank']:.2f}  "
                  f"agreement {e['agreement']:.3f}  "
                  f"read frac {e['read_frac']:.3f}")

        pol = load_policy(pdir, device=dev)
        n = serve_suite(lcfg, pol,
                        TraceRecorder(ldir, lcfg, scenario="suite"))
        kept = TraceReader(ldir).records["chosen_rank"]
        print(f"served     : {n} requests with mode='learned' "
              f"(mean kept rank {float(np.mean(kept)):.2f}) — valid "
              f"streams, policy net on the device in each decision")


if __name__ == "__main__":
    main()
