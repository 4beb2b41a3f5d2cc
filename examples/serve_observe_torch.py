"""Observability tour on the PyTorch port (repro_torch.obs): metrics, span
traces, flight dumps.

Drives one speculative, prefix-cached engine through a mixed workload —
chunked prefills, speculative accept runs, and a mid-flight
cancellation — with span/phase tracing ON, then renders every export
surface:

* a Chrome trace-event JSON (open in Perfetto / chrome://tracing):
  per-request async spans (admission -> first token -> finish), instant
  events for prefill chunks, rank decisions and speculative accepts,
  and the per-step phase timeline (schedule/admit/decide/dispatch/
  fetch/deliver);
* the Prometheus text exposition and the JSON metrics snapshot;
* the rank-telemetry report (per-layer kept-rank series, Eq. 9 veto
  fires, basis refreshes, factor-read bytes/token);
* a flight-recorder dump, forced here so the artifact shape is on show.

The trace document is validated against the trace-event schema and
round-tripped through JSON before anything is written, and the obs run
is asserted token-identical to a plain run of the same workload.

    PYTHONPATH=src python examples/serve_observe_torch.py --out-dir obs_out              # on the GPU
    PYTHONPATH=src python examples/serve_observe_torch.py --out-dir obs_out --device cpu
"""
import argparse
import json
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.obs import validate_chrome_trace
from repro_torch.serve import Engine, EngineConfig, SamplingParams


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=20)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--out-dir", default="obs_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_config("drrl-paper", reduced=True)
    cfg = cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16),
                                    fixed_rank=8, segment_len=8))
    dev = args.device
    params = get_model(cfg).init(torch.Generator(dev).manual_seed(0), device=dev)

    rnd = np.random.default_rng(1)
    prompts = [rnd.integers(0, cfg.vocab_size, args.prompt_len)
               .astype(np.int32) for _ in range(args.streams)]
    max_len = args.prompt_len + args.tokens + 8
    os.makedirs(args.out_dir, exist_ok=True)

    def serve(obs_trace, flight_dir=None):
        eng = Engine(cfg, params, device=dev, config=EngineConfig(
            n_slots=args.streams, max_len=max_len, segment_len=8,
            max_new_cap=args.tokens, prefill_chunk=8, page_size=8,
            speculative=True, draft_k=3,
            sampling=False, obs_trace=obs_trace, flight_dir=flight_dir,
            use_kernel=True))
        eng.warmup()
        hs = [eng.submit(p, SamplingParams(max_new=args.tokens))
              for p in prompts]
        # cancel the last stream a few steps in: the span trace shows an
        # admitted request ending with reason "cancel"
        for _ in range(4):
            eng.step()
        cancelled = hs[-1].cancel()
        outs = {h.rid: h.result() for h in hs[:-1]}
        return eng, outs, cancelled

    # parity: the traced run must decode the exact same tokens
    _, plain_outs, _ = serve(False)
    eng, outs, cancelled = serve(True, flight_dir=args.out_dir)
    assert cancelled, "cancellation did not land"
    assert all(np.array_equal(plain_outs[r], outs[r]) for r in outs), \
        "token streams diverged with observability enabled"

    # -- Chrome trace: validate, round-trip, write ----------------------
    doc = eng.obs.chrome_trace()
    errs = validate_chrome_trace(doc)
    assert not errs, f"trace schema violations: {errs[:5]}"
    doc = json.loads(json.dumps(doc))          # round-trip before writing
    trace_path = os.path.join(args.out_dir, "serve_trace.json")
    with open(trace_path, "w") as f:
        json.dump(doc, f)
    phases = sorted({e["name"] for e in doc["traceEvents"]
                     if e.get("cat") == "phase"})
    spans = sum(e["ph"] == "b" for e in doc["traceEvents"])
    print(f"chrome trace : {len(doc['traceEvents'])} events "
          f"({spans} request spans; phases: {', '.join(phases)}) "
          f"-> {trace_path}")

    # -- metrics: snapshot + Prometheus ---------------------------------
    snap = eng.obs.snapshot()
    snap_path = os.path.join(args.out_dir, "metrics.json")
    with open(snap_path, "w") as f:
        json.dump(snap, f, indent=2, default=str)
    prom_path = os.path.join(args.out_dir, "metrics.prom")
    with open(prom_path, "w") as f:
        f.write(eng.obs.prometheus())
    m = snap["metrics"]
    print(f"metrics      : {len(m)} series -> {snap_path}, {prom_path}")
    print(f"  admitted {m['requests.admitted']} finished "
          f"{m['requests.finished']} cancelled {m['requests.cancelled']}; "
          f"ttft samples {m['serve.ttft_s']['count']}, accept runs "
          f"{m['serve.accept_len']['count']} "
          f"(mean {m['serve.accept_len']['mean']:.2f} tok/step)")

    # -- rank telemetry -------------------------------------------------
    tel = eng.obs.rank_telemetry(eng.core)
    tel_path = os.path.join(args.out_dir, "rank_telemetry.json")
    with open(tel_path, "w") as f:
        json.dump(tel, f, indent=2)
    print(f"rank         : {tel['decisions']} decisions over "
          f"{tel['steps_recorded']} steps; mean kept rank "
          f"{tel['mean_kept_rank']:.2f}, {tel['rank_switches']} switches, "
          f"{tel['veto_fires']} veto fires -> {tel_path}")

    # -- flight recorder: force a dump so the artifact shape is visible -
    dump_path = eng.obs.flight_dump("example_dump")
    with open(dump_path) as f:
        dump = json.load(f)
    kinds = sorted({e["kind"] for e in dump["events"]})
    print(f"flight       : {dump['events_recorded']} events recorded "
          f"(kinds: {', '.join(kinds)}) -> {dump_path}")


if __name__ == "__main__":
    main()
