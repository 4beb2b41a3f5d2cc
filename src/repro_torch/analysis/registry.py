"""Port-specific knowledge feeding the generic rule visitors.

Everything the AST cannot see on its own lives here, in one reviewed
place: the step-loop entry points and control-plane stops (R1), the
helpers whose call synchronizes the device (R1), the capture roots and
their host parameters (R1, R2), the dynamic attribute hops the call
graph needs (``self.fns.decode_step_paged`` is a model-registry lookup,
``self.core.step`` a composition edge, ``self._step`` the engine's bound
step body), the shared-state -> owning-lock map (R3), and the donation
rules the port keeps from the JAX engine (R4).

Every path suffix starts at ``repro_torch/``, so no entry here ever
binds to a file of the JAX package.

Rules also honour *inline* declarations so fixtures and future classes
can self-register without editing this file:

* ``_inv_locks_ = {"attr": ("lockname", ...)}`` class attribute — R3;
* literal ``donate_argnums`` tuples on wrapper bindings — R4 (picked up
  by the indexer, no registry entry needed).
"""
from __future__ import annotations

from dataclasses import dataclass, field

_ENGINE = "repro_torch/serve/engine.py"
_API = "repro_torch/serve/api.py"
_FRONT = "repro_torch/serve/frontend.py"
_POLICY = "repro_torch/serve/policy.py"
_OBS = "repro_torch/obs/core.py"
_TRACES = "repro_torch/serve/traces.py"

# --------------------------------------------------------------------------
# R1 — host-sync: step-loop entry points, control-plane stops, dynamic hops
# --------------------------------------------------------------------------

# (path suffix, qualname): the host-side fused-step loop.  The graph is
# built by reachability from these — not a hardcoded file list.
HOST_ENTRIES: tuple[tuple[str, str], ...] = (
    (_ENGINE, "ServeEngine.step"),
    (_ENGINE, "ServeEngine.run"),
    (_API, "Engine.step"),
    (_API, "Engine.run"),
    (_FRONT, "FrontEnd._loop"),
)

# Control-plane boundaries the host-sync rule does not cross, with the
# reason each is exempt (admission and warmup legitimately block).
HOST_STOPS: dict[tuple[str, str], str] = {
    (_ENGINE, "ServeEngine._admit"):
        "admission/prefill is control-plane; its one-shot prefill sync is "
        "measured separately as prefill_s and never runs between decode "
        "dispatches of live slots",
    (_ENGINE, "ServeEngine.warmup"):
        "warmup exists to absorb kernel builds and syncs before serving",
    (_ENGINE, "ServeEngine.reset"):
        "reset tears the serving state down; latency is irrelevant",
    (_API, "Engine.warmup"):
        "warmup exists to absorb kernel builds and syncs before serving",
    (_API, "Engine.reset"):
        "reset tears the serving state down; latency is irrelevant",
}

# Helpers whose call synchronizes the device.  R1 flags each call site
# (each has its own cadence, so each carries its own pragma) and does not
# scan the helper's body.
SYNC_HELPERS: dict[tuple[str, str], str] = {
    (_ENGINE, "ServeEngine._sync_device"):
        "torch.cuda.synchronize on the engine's device",
}

# Dynamic attribute hops: ``self.<a>.<b>(...)`` edges the resolver
# cannot derive.  Keyed by the last one or two dotted parts.
ATTR_TARGETS: dict[str, tuple[str, str]] = {
    # model-registry indirection: the fused step's decode body
    "fns.decode_step_paged": ("repro_torch/models/transformer.py",
                              "decode_step_paged"),
    # the engine's step bodies and decision, bound in __init__
    "_step": (_ENGINE, "ServeEngine._step_impl"),
    "_step_mixed": (_ENGINE, "ServeEngine._step_mixed_impl"),
    "_step_spec": (_ENGINE, "ServeEngine._step_spec_impl"),
    "_decide": (_POLICY, "make_decide_fn.<locals>.decide"),
    "_drift": (_POLICY, "basis_drift"),
    # composition edges across the serving layers
    "core.step": (_ENGINE, "ServeEngine.step"),
    "core.run": (_ENGINE, "ServeEngine.run"),
    "core._sync_device": (_ENGINE, "ServeEngine._sync_device"),
    "engine.step": (_API, "Engine.step"),
    # trace-recorder hooks off the step loop (engine.trace is None unless
    # record_traces is set)
    "trace.on_decision": (_TRACES, "TraceRecorder.on_decision"),
    "trace.on_step": (_TRACES, "TraceRecorder.on_step"),
    "trace.on_evict": (_TRACES, "TraceRecorder.on_evict"),
    # observability hooks off the step loop (always constructed; pure
    # host Python — see repro_torch.obs.core's module docstring)
    "obs.step_phases": (_OBS, "Observability.step_phases"),
    "obs.stats_view": (_OBS, "Observability.stats_view"),
    "obs.reset_run": (_OBS, "Observability.reset_run"),
    "obs.on_admit": (_OBS, "Observability.on_admit"),
    "obs.on_first_token": (_OBS, "Observability.on_first_token"),
    "obs.on_finish": (_OBS, "Observability.on_finish"),
    "obs.on_decide": (_OBS, "Observability.on_decide"),
    "obs.on_drift": (_OBS, "Observability.on_drift"),
    "obs.on_prefill_chunk": (_OBS, "Observability.on_prefill_chunk"),
    "obs.on_spec_accept": (_OBS, "Observability.on_spec_accept"),
    "obs.on_token_latency": (_OBS, "Observability.on_token_latency"),
    "obs.set_prefix_size": (_OBS, "Observability.set_prefix_size"),
    "obs.record_event": (_OBS, "Observability.record_event"),
    "obs.flight_dump": (_OBS, "Observability.flight_dump"),
    "obs.rank_telemetry": (_OBS, "Observability.rank_telemetry"),
}

# --------------------------------------------------------------------------
# R1/R2 — capture roots: the bodies a CUDA graph would capture
# --------------------------------------------------------------------------

# (path suffix, qualname) -> the parameters that are host values by
# contract (the analogue of jax.jit's static_argnames).  Every other
# parameter is a device tensor: coercing it with int()/float()/bool()
# syncs, and a shape taken from it cannot be captured.  A shape taken
# from a host parameter needs one capture per value (R2 says so too).
CAPTURE_ROOTS: dict[tuple[str, str], tuple[str, ...]] = {
    (_ENGINE, "ServeEngine._step_impl"): (),
    (_ENGINE, "ServeEngine._step_mixed_impl"): (),
    (_ENGINE, "ServeEngine._step_spec_impl"): ("n_q_max",),
    (_POLICY, "make_decide_fn.<locals>.decide"): ("slot", "has_rank", "t"),
}


# --------------------------------------------------------------------------
# R3 — lock discipline
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LockRule:
    """Shared attributes of one class and the lock(s) that own them.

    * ``locks``: any-of — a mutation under any listed lock is fine;
    * ``attrs``: ``self.<attr>`` chains whose stores must hold a lock;
    * ``mutator_methods``: method names that count as mutation when
      called on a registered attr (``self.cache.allocate(...)``);
    * ``assume_held``: methods whose bodies run with the lock held —
      every intra-class call site is checked to actually hold it;
    * ``external``: methods whose mutations are serialised by
      something outside this class; the justification is mandatory
      and rendered in the report.
    """

    path_suffix: str
    cls: str
    locks: tuple[str, ...]
    attrs: tuple[str, ...]
    mutator_methods: tuple[str, ...] = ()
    assume_held: tuple[str, ...] = ()
    external: dict[str, str] = field(default_factory=dict)


_STEP_LOOP_WHY = (
    "step-loop method: the stepping thread is the sole driver by "
    "contract, serialised against submit/cancel by "
    "repro_torch.serve.api.Engine._step_lock (and FrontEnd's single thread)"
)

LOCK_RULES: tuple[LockRule, ...] = (
    LockRule(
        path_suffix=_ENGINE,
        cls="ServeEngine",
        locks=("_lock",),
        attrs=("sched", "cache", "prefix", "_hits", "_snaps",
               "_spectra_pending", "last_emitted", "request_first_tok_t"),
        mutator_methods=(
            # scheduler
            "submit", "cancel_pending", "evict", "admit",
            # paged KV cache
            "allocate", "release", "retain", "unref", "copy_page",
            "write_prefill",
            # prefix radix tree (match/touch_path move the LRU clock)
            "insert", "evict_lru", "touch_path", "match",
        ),
        assume_held=("_admit_locked", "_can_allocate", "_apply_prefix_hit"),
        external={
            "step": _STEP_LOOP_WHY,
            "_adopt_pools": _STEP_LOOP_WHY,
            "_step_live_spec": _STEP_LOOP_WHY,
            "_evict_finished": _STEP_LOOP_WHY,
            "_maybe_decide": _STEP_LOOP_WHY,
            "_maybe_snapshot": _STEP_LOOP_WHY,
            "_insert_prefix": _STEP_LOOP_WHY,
            "_stamp_first_token": _STEP_LOOP_WHY,
            "_check_drift": _STEP_LOOP_WHY,
            "_sync_control": _STEP_LOOP_WHY,
            "warmup": _STEP_LOOP_WHY,
            "run": _STEP_LOOP_WHY,
            "_reset_state": "called from __init__ and from reset() "
                            "(which holds _lock)",
        },
    ),
    LockRule(
        path_suffix=_API,
        cls="Engine",
        locks=("_submit_lock", "_step_lock"),
        attrs=("_handles", "_next_rid", "_streaming", "_finished_seen"),
    ),
    LockRule(
        path_suffix=_API,
        cls="RequestHandle",
        locks=("_cv",),
        attrs=("_toks", "_result", "ttft_s", "done_s", "cancelled",
               "_stopped"),
    ),
    LockRule(
        path_suffix=_FRONT,
        cls="Router",
        locks=("_lock",),
        attrs=("_rr", "routed", "route_kinds"),
        assume_held=("_pick",),
    ),
    LockRule(
        path_suffix=_FRONT,
        cls="FrontEnd",
        locks=("_idle_cv",),
        attrs=("_error",),
        external={
            "_loop": "the stepping thread is the sole writer; readers "
                     "(_raise_if_dead) tolerate one poll of staleness",
        },
    ),
)


# --------------------------------------------------------------------------
# R4 — donation safety
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DonationRule:
    """Calls through ``self.<binding>``/``<binding>`` donate the listed
    positional args.  The port's steps update these buffers in place,
    which is the JAX engine's donation contract without the copy: the
    caller adopts the returned buffers in the calling statement and never
    reads the old references."""

    path_suffix: str
    bindings: tuple[str, ...]
    positions: tuple[int, ...]


DONATION_RULES: tuple[DonationRule, ...] = (
    # the fused steps write the k/v/kt/mass pools and out_buf in place
    DonationRule(_ENGINE, ("_step", "_step_mixed", "_step_spec"),
                 (1, 2, 3, 4, 11)),
    # the decision rewrites kt_pool, basis and spectra in place
    DonationRule(_ENGINE, ("_decide",), (2, 6, 7)),
)

# Calls that adopt/overwrite donated buffers: a call to the method
# counts as reassignment of the listed expressions.
DONATION_REASSIGNERS: dict[str, tuple[str, ...]] = {
    "_adopt_pools": ("self.cache.k_pool", "self.cache.v_pool",
                     "self.cache.kt_pool", "self.cache.mass_pool"),
}
