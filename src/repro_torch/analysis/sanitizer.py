"""Runtime sanitizer lane: sync-guard + build-count checks on the port's
serving engine.

Two dynamic invariants the static pass (repro_torch.analysis.rules)
cannot prove are enforced here by actually running the serve workload on
a CUDA device:

* **sync guard** — once warm, every fused step executes under
  ``torch.cuda.set_sync_debug_mode("error")``: any operation inside the
  step that makes the host wait for the device (``.item()``, a ``.cpu()``
  copy, ``nonzero``, a host tensor copied to the device from pageable
  memory) raises immediately instead of costing a hidden sync per token.
  The guard wraps the step callables only, and their arguments are
  evaluated outside it — the engine's sanctioned per-step token or
  accept fetch (an explicit transfer after the call) stays legal, and
  control-plane phases (admission, warmup, decisions, reset) stay
  unguarded.  The mode is process-wide, so a scenario runs with no
  stepping thread.

* **build counting** — the port runs eagerly, so what it can build at
  run time is a kernel library (``kernels/build.py`` compiles a CUDA
  source with nvcc and loads it with ctypes) or a ``torch._dynamo``
  graph.  The warm phase (construction + warmup + first full run) may
  build freely; the steady phase then replays a *shape-identical*
  workload — same (prompt_len, max_new) multiset, different token
  content, seeds and sampling mixes — through the reset engine and
  asserts **zero** new builds.

Scenarios (the JAX package's four, with its workloads and engine knobs):

* ``mixed_sampling`` — adaptive ranks, chunked prefill, greedy + top-k +
  nucleus rows in the same batch;
* ``speculative``   — self-speculative draft/verify with adaptive ranks;
* ``learned_policy`` — rank mode ``learned`` with an untrained policy
  network (the check is about syncs and builds, not reward);
* ``observability`` — ``mixed_sampling`` with span/phase tracing on and
  every exporter rendered inside the steady region.

Every engine runs the ``flash_decode`` kernel (``use_kernel=True``); the
result counts its launches inside the guarded steady phase.

Run::

    PYTHONPATH=src python -m repro_torch.analysis.sanitizer [--json]

on the reduced drrl-paper (``run_scenario(name, reduced=False)`` serves it
at full width: 12 x 768, vocabulary 50257).  Exit status is non-zero if any
scenario builds in steady state, trips the sync guard, or guards no step.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np

__all__ = ["CompileCounter", "guard_steps", "run_scenario", "main"]

SCENARIOS = ("mixed_sampling", "speculative", "learned_policy",
             "observability")
STEP_NAMES = ("_step", "_step_mixed", "_step_spec")


def _dynamo_graphs() -> int:
    """Graphs torch._dynamo compiled in this process so far (0 where
    dynamo is unavailable)."""
    try:
        from torch._dynamo.utils import counters
    except Exception:  # a build without dynamo compiles no graph
        return 0
    return int(counters["stats"]["unique_graphs"])


class CompileCounter:
    """Count what an eager port builds at run time while attached: each
    CUDA source ``kernels/build.py`` compiles, each kernel library it
    loads (its ``_libs``), and each graph ``torch._dynamo`` compiles.

    ``count`` and ``messages`` are read at any time; ``messages[i]``
    describes the ``i``-th build, in order.
    """

    def __init__(self) -> None:
        self.messages: list[str] = []
        self._libs: set[str] = set()
        self._graphs = 0
        self._attached = False

    @property
    def count(self) -> int:
        self._poll()
        return len(self.messages)

    def _poll(self) -> None:
        if not self._attached:
            return
        from repro_torch.kernels import build
        for name in sorted(set(build._libs) - self._libs):
            self.messages.append(f"loaded kernel library {name}")
            self._libs.add(name)
        graphs = _dynamo_graphs()
        for i in range(self._graphs, graphs):
            self.messages.append(f"torch._dynamo graph {i + 1}")
        self._graphs = graphs

    @contextlib.contextmanager
    def attached(self):
        from repro_torch.kernels import build

        real_build = build.build

        def counted(names):
            secs = real_build(names)
            for name, s in secs.items():
                if s > 0.0:
                    self.messages.append(f"nvcc built {name}.cu "
                                         f"({s:.1f} s)")
            return secs

        self._libs = set(build._libs)
        self._graphs = _dynamo_graphs()
        self._attached = True
        build.build = counted
        try:
            yield self
        finally:
            self._poll()
            self._attached = False
            build.build = real_build


def guard_steps(eng) -> dict:
    """Wrap the engine's fused-step callables so each call runs under
    ``torch.cuda.set_sync_debug_mode("error")``, restoring the previous
    mode after it.  Arguments are evaluated at the call site — *outside*
    the guard — so only the step's own work is policed, which is exactly
    the per-token hot path.  Returns the live count of guarded calls per
    callable."""
    import torch

    calls = {}

    def _guarded(name, fn):
        def wrapper(*args, **kwargs):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                calls[name] += 1
        return wrapper

    for name in STEP_NAMES:
        fn = getattr(eng, name, None)
        if fn is not None:
            calls[name] = 0
            setattr(eng, name, _guarded(name, fn))
    return calls


def _workload(n_requests: int, max_new: int, *, seed: int,
              sampling: bool) -> list[dict]:
    """Mixed prompt lengths; shape layout is seed-independent so two
    workloads with different seeds are shape-identical."""
    rnd = np.random.default_rng(seed)
    lens = [8, 12, 16, 24, 12, 16, 8, 24][:n_requests]
    out = []
    for i, ln in enumerate(lens):
        req = dict(rid=i, tokens=rnd.integers(0, 256, ln).astype(np.int32),
                   max_new=max_new, arrival=2 * i)
        if sampling:
            # greedy / top-k / nucleus rows interleaved in one batch
            kind = i % 3
            if kind == 1:
                req.update(temperature=0.8, top_k=8, seed=int(seed + i))
            elif kind == 2:
                req.update(temperature=0.9, top_p=0.9, seed=int(seed + i))
        out.append(req)
    return out


def scenario_engine(name: str, *, reduced: bool = True, device="cuda",
                    max_new: int = 12):
    """The scenario's ServeEngine: drrl-paper (reduced, or at full width)
    in rank mode ``adaptive`` (``learned`` for ``learned_policy``) on its
    own rank grid with 8-token segments, seeded weights, the JAX
    package's engine knobs, and the flash_decode kernel on."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import RankConfig
    from repro_torch.models.api import get_model
    from repro_torch.serve import ServeEngine

    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; one of {SCENARIOS}")
    mode = "learned" if name == "learned_policy" else "adaptive"
    base = get_config("drrl-paper", reduced=reduced)
    grid = tuple(base.rank.rank_grid)
    cfg = base.with_(rank=RankConfig(mode=mode, rank_grid=grid,
                                     segment_len=8))
    params = get_model(cfg).init(
        torch.Generator(device=device).manual_seed(0), device=device)

    policy_params = None
    if mode == "learned":
        # untrained policy net: what the step runs and syncs is decided
        # by shapes and structure, not by the weights
        from repro_torch.core.drrl import feat_dims
        from repro_torch.core.policy import init_policy
        policy_params = init_policy(
            torch.Generator(device=device).manual_seed(1),
            feat_dims(cfg.rank), len(grid), device=device)

    sampling = name in ("mixed_sampling", "observability")
    kwargs = dict(n_slots=4, max_len=64, page_size=16, segment_len=8,
                  max_new_cap=max_new, prefill_chunk=8, use_kernel=True)
    if sampling:
        kwargs.update(sampling=True, nucleus=True)
    elif name == "speculative":
        kwargs.update(speculative=True, draft_k=3, draft_rank_frac=0.25)
    if name == "observability":
        kwargs.update(obs_trace=True)
    return ServeEngine(cfg, params, policy_params, device=device, **kwargs)


def _require_cuda(device) -> None:
    import torch

    if torch.device(device).type != "cuda":
        raise RuntimeError(
            f"the runtime sanitizer runs on a CUDA device, got {device!r}: "
            "torch.cuda.set_sync_debug_mode polices CUDA work only")


def run_scenario(name: str, *, reduced: bool = True, device="cuda",
                 n_requests: int = 6, max_new: int = 12) -> dict:
    """Warm-then-steady run of one scenario on a CUDA device; returns the
    count dict.  Raises on any other device: the sync guard polices CUDA
    work only, so nothing would be checked."""
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.serve import Request

    _require_cuda(device)
    sampling = name in ("mixed_sampling", "observability")
    counter = CompileCounter()
    with counter.attached():
        eng = scenario_engine(name, reduced=reduced, device=device,
                              max_new=max_new)

        # warm phase: builds are free here
        for w in _workload(n_requests, max_new, seed=0, sampling=sampling):
            eng.submit(Request(**w))
        eng.warmup()
        eng.run()
        warm = counter.count

        # steady phase: same shapes, different content/seeds/sampling
        # rows — and the fused step now runs under the sync guard
        eng.reset()
        calls = guard_steps(eng)
        for w in _workload(n_requests, max_new, seed=7, sampling=sampling):
            eng.submit(Request(**w))
        ops.reset_launches()
        eng.run()
        launches = decode_attn.LAUNCHES["flash_decode"]
        if name == "observability":
            # the export/read side must be as quiet as the hooks: render
            # every exporter inside the counted steady region (the one
            # device read — rank_telemetry's veto fetch — is a plain
            # copy, never a build)
            eng.obs.snapshot()
            eng.obs.prometheus()
            eng.obs.chrome_trace()
            eng.obs.rank_telemetry(eng)
        steady = counter.count - warm

    guarded = sum(calls.values())
    return {
        "scenario": name,
        "warm_executables": warm,
        "steady_new_executables": steady,
        "transfer_guard": "sync_debug:error",
        "ok": steady == 0 and guarded > 0 and launches > 0,
        "steady_compiles": counter.messages[warm:],
        "guarded_steps": guarded,
        "guarded_by_step": calls,
        "flash_decode_launches": launches,
        "steps": eng.stats["steps"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve-engine runtime sanitizer: sync guard + "
                    "zero-steady-state-build check")
    ap.add_argument("--json", action="store_true",
                    help="emit the result dict as JSON on stdout")
    ap.add_argument("--scenario", choices=list(SCENARIOS), action="append",
                    help="run only the named scenario(s); default all")
    args = ap.parse_args(argv)

    scenarios = args.scenario or list(SCENARIOS)
    results = []
    failed = False
    for name in scenarios:
        try:
            res = run_scenario(name)
        except Exception as e:  # the sync guard raises mid-step
            res = {"scenario": name, "ok": False, "error": repr(e)}
        results.append(res)
        failed = failed or not res["ok"]

    out = {"ok": not failed, "scenarios": results}
    if args.json:
        print(json.dumps(out, indent=2))
    else:
        for r in results:
            status = "ok" if r["ok"] else "FAIL"
            detail = (f"warm {r.get('warm_executables', '?')} builds, "
                      f"steady +{r.get('steady_new_executables', '?')}, "
                      f"{r.get('guarded_steps', '?')} guarded steps, "
                      f"{r.get('flash_decode_launches', '?')} flash_decode "
                      f"launches" if "error" not in r else r["error"])
            print(f"{r['scenario']:16s} {status}  {detail}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
