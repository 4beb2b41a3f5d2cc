"""Continuous-batching serving engine of the port (``repro.serve.engine.
ServeEngine``).

One engine = one slot-paged KV cache + one scheduler + two fused steps:

  * a slot-indexed **segment decision** (serve.policy) that re-picks a
    boundary slot's rank bucket from its live softmax-weighted layer-0 K
    spectra, refreshes its per-layer eigenbasis and (in factor form)
    re-projects its K factors;
  * ONE fused **decode step** over all slots (models.transformer.
    decode_step_paged) with per-row kv_len, per-row rank, in-graph
    attention-mass accumulation and token selection (greedy, or with
    ``sampling`` seeded temperature / top-k / top-p draws whose gumbel
    noise is JAX's threefry bits, ``core.prng``); prompts are
    consumed ``prefill_chunk`` tokens at a time inside the **mixed** form
    of that step, alongside the live decode rows. With
    ``prefill_chunk=None`` a prompt is instead prefilled in one shot at
    admission (a full-rank ``forward_dense`` over its length bucket that
    also captures the per-layer K/V and the prompt's attention mass), and
    only the plain decode step runs.

With ``speculative=True`` a step with decode rows runs the **speculative**
form instead (``_step_spec_impl``, ``serve.spec``): ``draft_k`` cheap
single-token drafts at a narrow per-row draft rank, then one chunked
verify block per row at the slot's rank, the longest prefix of drafts
equal to the verify's own targets accepted; tokens are plain decode's.
With ``prefix_cache=True`` finished prompts stay in a radix tree
(``serve.prefix``): an admission whose prompt starts with a cached prefix
shares its pages (refcounted, a partly filled tail page copied),
re-seeds the slot's attention-mass row from the prefix's snapshot and
prefills from the reuse point on; tokens are a cold admission's.

Lengths, ranks and tokens stay on the device between steps; the host
fetches token values only when a live request carries an ``eos_id`` or a
streaming consumer is attached, and, in a speculative step, the accepted
run of every row. With ``drift_threshold`` set, each step that decodes
also fetches one (n_slots,) drift vector (``_check_drift``).

Every engine carries a ``repro_torch.obs.Observability`` bundle: the stats
dict is a view over its metrics registry, and the step loop calls its
host-only hooks (admission, first token, decisions, drift, prefill chunks,
accept runs, finishes) and, with ``obs_trace``, records each step's phases.
With ``record_traces`` a ``serve.traces.TraceRecorder`` gets each
decision's spectra and rank (one fetch per decision) and each step's
outcome.

Unlike JAX, PyTorch updates the step's buffers in place: the pools, the
output buffer and the decision's basis / spectra / factors are written
where they lie. The JAX engine donates exactly these buffers to its
steps (engine.py:218, policy.py:102), so nothing else holds their old
values, and the engine adopts each step's returned pools right after the
call, as the JAX engine does. What must outlive a later in-place write is
cloned: the prefix tree's mass snapshots and spectra. A speculative
step's draft factor appends go into the live kt pool's first ``r_cap``
columns (the JAX engine appends them to a transient copy): the verify
pass writes every one of those positions again before it reads them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models.api import get_model
from repro_torch.models.transformer import forward_dense
from repro_torch.obs import NULL_PHASES, Observability
from repro_torch.serve import spec as spec_mod
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.policy import basis_drift, draft_ranks, make_decide_fn
from repro_torch.serve.prefix import MatchResult, PrefixCache
from repro_torch.serve.scheduler import Request, Scheduler, prefill_buckets
from repro_torch.serve.traces import TraceRecorder


def params_to(params, device):
    """The parameter tree (nested dicts and lists) with every tensor on
    ``device``."""
    return tu.tree_map(lambda x: x.to(device), params)


class ServeEngine:
    """Continuous-batching decode over ``n_slots`` concurrent streams."""

    # cadence of recovery-probe spec steps while eff_k is collapsed to 0
    _DRAFT_PROBE_EVERY = 8
    # EWMA smoothing for the adaptive-draft accept-fraction signal
    _DRAFT_EWMA_ALPHA = 0.4

    def __init__(self, cfg: ModelConfig, params, policy_params=None, *,
                 n_slots: int = 4, max_len: int = 256, page_size: int = 16,
                 segment_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_new_cap: int = 256, use_kernel: bool = False,
                 drift_threshold: Optional[float] = None,
                 time_per_token: bool = False,
                 factor_cache: Optional[bool] = None,
                 prefill_chunk: Optional[int] = None,
                 sampling: bool = False, nucleus: bool = False,
                 top_k_cap: int = 64,
                 prefix_cache: bool = False,
                 prefix_pages: Optional[int] = None,
                 speculative: bool = False, draft_k: int = 4,
                 draft_rank_frac: float = 0.25,
                 snapshot_every: int = 1,
                 adaptive_draft: bool = False,
                 draft_shrink_below: float = 0.35,
                 draft_grow_above: float = 0.6,
                 record_traces=None,
                 obs_trace: bool = False, flight_dir: Optional[str] = None,
                 flight_capacity: int = 256, device="cuda"):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.policy = (None if policy_params is None
                       else params_to(policy_params, self.device))
        self.seg = int(segment_len or cfg.rank.segment_len)
        self.n_slots = n_slots
        self.max_new_cap = max_new_cap
        self.use_kernel = use_kernel
        self.drift_threshold = drift_threshold
        self.time_per_token = time_per_token
        self.chunk = prefill_chunk
        if prefix_cache and prefill_chunk is None:
            # exact mass snapshots are taken where chunked prefill pauses;
            # one-shot prefill has no such points
            raise ValueError("prefix_cache requires chunked prefill "
                             "(prefill_chunk is None)")
        # speculative self-drafting (serve.spec): the verify pass is the
        # chunked-query step, whose width covers the prefill chunk and the
        # draft run
        self.speculative = bool(speculative)
        self.draft_k = int(draft_k)
        self.draft_rank_frac = float(draft_rank_frac)
        self.snapshot_every = int(snapshot_every)
        if self.speculative and self.chunk is None:
            raise ValueError("speculative decode requires chunked prefill "
                             "(the verify pass is the chunked-query step)")
        if self.speculative and self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        if not 0.0 < self.draft_rank_frac <= 1.0:
            raise ValueError(f"draft_rank_frac must be in (0, 1], got "
                             f"{draft_rank_frac}")
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, got "
                             f"{snapshot_every}")
        # adaptive draft length: an EWMA of the accept fraction drives an
        # effective draft length eff_k in [0, draft_k]. Intermediate values
        # only shorten the accept caps; at eff_k == 0 decode rides the mixed
        # step (no drafts), with a probe spec step every
        # _DRAFT_PROBE_EVERY steps so a recovered stream grows eff_k back
        self.adaptive_draft = bool(adaptive_draft)
        self.draft_shrink_below = float(draft_shrink_below)
        self.draft_grow_above = float(draft_grow_above)
        if self.adaptive_draft and not self.speculative:
            raise ValueError("adaptive_draft requires speculative=True")
        # a TraceRecorder may be shared by engines served one after another
        # (one dataset over a workload suite); a path gets its own recorder
        self.trace = None
        if record_traces:
            self.trace = (record_traces
                          if isinstance(record_traces, TraceRecorder)
                          else TraceRecorder(record_traces, cfg))
        # the metrics registry is always on (the stats below live in it);
        # span/phase tracing and flight dumps are opt-in
        self.obs = Observability(trace=obs_trace, flight_dir=flight_dir,
                                 flight_capacity=flight_capacity)
        self.spec_chunk = (max(self.chunk, self.draft_k + 1)
                           if self.speculative else None)
        # sampling=True runs the temperature / top-k / gumbel tail in the
        # fused step; greedy rows stay bitwise the argmax either way.
        # nucleus=True adds the top-p cut (a full-vocab softmax and sort per
        # step), so engines that never serve top_p < 1 leave it off
        self.sampling = sampling
        self.nucleus = bool(nucleus)
        if self.nucleus and not sampling:
            raise ValueError("nucleus (top-p) requires sampling=True")
        self.top_k_cap = int(top_k_cap)
        # a prefix cache grows the pool by ``prefix_pages`` (default: one
        # more slot-set) so cached prefixes do not starve admissions
        pps = -(-max_len // page_size)
        n_pages = None
        if prefix_cache:
            extra = n_slots * pps if prefix_pages is None else prefix_pages
            n_pages = n_slots * pps + 1 + extra
        self.cache = PagedKVCache(cfg, n_slots, max_len, page_size,
                                  n_pages=n_pages,
                                  factored=factor_cache, device=self.device)
        # static draft width: the basis and kt pool are sliced to r_cap
        # columns for the drafts (fewer bytes read); per-row draft ranks
        # stay within [grid floor, r_cap]
        self._draft_cap = None
        self._grid_lo = None
        if self.speculative and self.cache.rank_on:
            g_lo = int(cfg.rank.rank_grid[0])
            want = int(np.ceil(self.cache.r_keep * self.draft_rank_frac))
            self._draft_cap = min(max(g_lo, want, 1), self.cache.r_keep)
            self._grid_lo = g_lo
        self.prefix = PrefixCache(self.cache) if prefix_cache else None
        # submit() and admission may run on different threads; one lock
        # covers both critical sections
        self._lock = threading.Lock()
        self._buckets = tuple(buckets) if buckets else prefill_buckets(max_len)
        self.sched = Scheduler(n_slots, self._buckets)
        self.fns = get_model(cfg)
        if self.fns.decode_step_paged is None:
            raise ValueError(f"family {cfg.family!r} has no paged decode step")
        # one-shot prefill runs the full-rank forward of the prompt
        self._pf_cfg = cfg.with_(rank=cfg.rank.__class__(mode="off"))
        self._decide = (make_decide_fn(cfg, self.policy)
                        if cfg.rank.mode != "off" else None)
        self._step = self._step_impl
        self._step_mixed = (self._step_mixed_impl if self.chunk is not None
                            else None)
        self._step_spec = self._step_spec_impl if self.speculative else None
        self._drift = basis_drift if drift_threshold is not None else None
        self._reset_state()

    def _reset_state(self):
        ns, dev = self.n_slots, self.device
        self.tokens = torch.zeros((ns, 1), dtype=torch.long, device=dev)
        # +1 scratch row: dead lanes park their garbage writes there
        self.out_buf = torch.zeros((ns + 1, self.max_new_cap),
                                   dtype=torch.long, device=dev)
        self.has_rank = np.zeros((ns,), bool)
        self.force_decide = np.zeros((ns,), bool)
        self.now = 0
        # device-resident control state: pushed only on admission/eviction
        # events (dirty flag), never per step; lens advances on the device
        self._dirty = True
        self._pt_dev = None
        self._active_dev = None
        self._plen_dev = None
        self._lens_dev = None
        # per-slot sampling state (host mirrors; device copies pushed with
        # the control sync on admission)
        self._temp = np.zeros((ns,), np.float32)
        self._topk = np.zeros((ns,), np.int32)
        self._topp = np.ones((ns,), np.float32)
        self._seed = np.zeros((ns,), np.uint32)
        self._temp_dev = self._topk_dev = self._topp_dev = None
        self._seed_dev = None
        self._eos_dev = None
        self.prompt_buf = torch.zeros((ns, self.cache.max_len),
                                      dtype=torch.long, device=dev)
        # prefix-cache bookkeeping: the hit looked up at allocation time
        # (applied when the placement lands), the per-slot mass snapshots
        # taken during chunked prefill, and the inserted nodes waiting for
        # their layer-0 spectra (taken at the slot's first decision)
        self._hits: Dict[int, MatchResult] = {}
        self._snaps: Dict[int, Dict[int, Optional[torch.Tensor]]] = {}
        self._spectra_pending: Dict[int, object] = {}
        self.request_prefix_hit: Dict[int, bool] = {}
        # the stats dict as a view over the obs registry (the JAX engine's
        # keys); re-binding zeroes the backing metrics
        self.stats = self.obs.stats_view(
            {"compile_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
             "steps": 0, "tokens_decoded": 0, "prefills": 0, "decides": 0,
             "mixed_steps": 0, "stall_s": 0.0, "prefill_tokens": 0,
             "prefix_hits": 0, "prefix_misses": 0,
             "prefix_reused_tokens": 0, "prefix_cow": 0,
             "prefix_evictions": 0, "spec_steps": 0, "spec_drafted": 0,
             "spec_accepted": 0, "spec_tokens": 0,
             "eff_draft_k": self.draft_k if self.speculative else 0})
        self.obs.reset_run()
        # fused steps run by warmup() (value-neutral, counted apart from
        # stats['steps'])
        self.warmup_steps = 0
        # each decision's Eq. 9 veto flag, a device bool banked unfetched:
        # obs.rank_telemetry() reads them all at export time
        self._veto_pending: List[torch.Tensor] = []
        if self.trace is not None:
            # a reset ends every live stream: close their outcome windows
            for slot in range(ns):
                self.trace.on_evict(slot)
        # adaptive-draft controller state (host only)
        self._eff_k = self.draft_k if self.speculative else 0
        self._accept_ewma = 1.0
        self._probe_i = 0
        # rid -> accepted run length of every speculative step the request
        # decoded in (harvested at eviction and cancel)
        self.request_accept_lens: Dict[int, List[int]] = {}
        self.rank_history: List[Tuple[int, torch.Tensor, np.ndarray]] = []
        self.token_latencies: List[float] = []
        self.first_token_s: List[float] = []
        self.request_first_tok_t: Dict[int, float] = {}
        # (rid, out_index, token) triples of the last step, filled only
        # when the step synced token values (streaming consumers)
        self.last_emitted: List[Tuple[int, int, int]] = []
        self._stream_sync = False

    def reset(self):
        """Clear all serving state, every cached prefix included, but keep
        the engine's configuration."""
        with self._lock:
            cfg, c = self.cfg, self.cache
            self.cache = PagedKVCache(cfg, self.n_slots, c.max_len,
                                      c.page_size, n_pages=c.n_pages,
                                      factored=c.factored, device=self.device)
            if self.prefix is not None:
                self.prefix = PrefixCache(self.cache)
            self.sched = Scheduler(self.n_slots, self._buckets)
            self._reset_state()

    # -- request plane ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request (thread-safe)."""
        if req.max_new > self.max_new_cap:
            raise ValueError(f"max_new {req.max_new} > engine cap "
                             f"{self.max_new_cap}")
        if (self.cache.pages_needed(len(req.tokens) + req.max_new)
                > self.cache.pages_per_slot):
            raise ValueError(
                f"request needs {len(req.tokens) + req.max_new} cache "
                f"positions but a slot holds only {self.cache.max_len}")
        if ((req.temperature > 0 or req.top_k > 0 or req.top_p < 1.0)
                and not self.sampling):
            raise ValueError("request asks for sampling but the engine was "
                             "built with sampling=False (greedy only)")
        if req.top_p < 1.0 and not self.nucleus:
            raise ValueError("request asks for top_p but the engine was "
                             "built with nucleus=False (the top-p cut is a "
                             "full-vocab sort per step; build the engine "
                             "with nucleus=True)")
        if req.top_k > self.top_k_cap:
            raise ValueError(f"top_k {req.top_k} > engine top_k_cap "
                             f"{self.top_k_cap}")
        with self._lock:
            self.sched.submit(req)

    def cancel(self, rid: int) -> bool:
        """Abort a request: a queued one is dropped, an admitted one
        (decoding or mid-prefill) is evicted and its pages released (pages
        shared with the prefix tree or another slot stay); its output so
        far joins ``sched.finished``. Returns False when ``rid``
        is not live (finished, cancelled or never submitted). A caller
        driving the step loop on another thread serialises this against
        step() (``serve.api.Engine.cancel`` holds the step lock)."""
        with self._lock:
            if self.sched.cancel_pending(rid):
                return True
            for i, st in enumerate(self.sched.slots):
                if st.active and st.req.rid == rid:
                    outputs = self.out_buf[i, :st.n_out].tolist()
                    if st.accept_lens:
                        self.request_accept_lens[rid] = list(st.accept_lens)
                    if self.trace is not None:
                        self.trace.on_evict(i)
                    self.obs.on_finish(rid, i, st.n_out, "cancel")
                    self.sched.evict(i, self.cache.release, outputs)
                    # a mid-prefill cancel leaves no prefix insertion and no
                    # pending spectra capture for this slot
                    self._hits.pop(i, None)
                    self._snaps.pop(i, None)
                    self._spectra_pending.pop(i, None)
                    self._dirty = True
                    return True
        return False

    @property
    def depth(self) -> int:
        """Queued + admitted requests (the router's load signal)."""
        with self._lock:
            return self.sched.depth()

    def prefix_probe(self, tokens) -> int:
        """Longest cached-prefix length this engine could reuse for
        ``tokens`` now (0 without a prefix cache); read-only."""
        if self.prefix is None:
            return 0
        with self._lock:
            return self.prefix.probe(tokens)

    def _adopt_pools(self, pools) -> None:
        """Take the fused step's returned pools as the cache's pools (the
        same tensors, updated in place)."""
        self.cache.k_pool, self.cache.v_pool = pools["k"], pools["v"]
        if "kt" in pools:
            self.cache.kt_pool = pools["kt"]
        if "mass" in pools:
            self.cache.mass_pool = pools["mass"]

    def warmup(self) -> float:
        """Run every fused step the engine dispatches once on all-inactive
        lanes (writes land on the scratch page / rows, so the run is
        value-neutral; a speculative engine runs the mixed and the
        speculative step, never the plain one) and one decision on the
        empty slot 0, which the admission-time decision overwrites before
        any read. Builds the CUDA kernel on first use; the elapsed time
        lands in stats['compile_s']."""
        t0 = time.perf_counter()
        ns = self.n_slots
        self._sync_control()
        if self._decide is not None:
            (self.cache.ranks, self.cache.basis, self.cache.spectra,
             self.cache.kt_pool, _veto) = self._decide(
                self.cache.k_pool, self.cache.mass_pool, self.cache.kt_pool,
                self._pt_dev, self._lens_dev, self.cache.ranks,
                self.cache.basis, self.cache.spectra, 0, False, 0)
        idle = torch.zeros((ns,), dtype=torch.bool, device=self.device)
        runs = ([] if self.speculative else [(self._step, ())]) + (
            [(self._step_mixed, (self.prompt_buf,))]
            if self._step_mixed is not None else [])
        for fn, extra in runs:
            pools, tok, ob, _ = fn(
                self.params, self.cache.k_pool, self.cache.v_pool,
                self.cache.kt_pool, self.cache.mass_pool,
                self._pt_dev, self.tokens, self._lens_dev,
                self.cache.ranks, self.cache.basis, idle, self.out_buf,
                self._plen_dev, self._temp_dev, self._topk_dev,
                self._topp_dev, self._seed_dev, *extra)
            self._adopt_pools(pools)
            self.out_buf = ob
            self.warmup_steps += 1
        if self.speculative:
            dev = self.device
            pools, tok, ob, _, _, _, _ = self._step_spec(
                self.params, self.cache.k_pool, self.cache.v_pool,
                self.cache.kt_pool, self.cache.mass_pool,
                self._pt_dev, self.tokens, self._lens_dev,
                self.cache.ranks, self.cache.basis, idle, self.out_buf,
                self._plen_dev, self._temp_dev, self._topk_dev,
                self._topp_dev, self._seed_dev, self.prompt_buf,
                self.cache.spectra,
                torch.ones((ns,), dtype=torch.long, device=dev),
                torch.full((ns,), -1, dtype=torch.long, device=dev), 1)
            self._adopt_pools(pools)
            self.out_buf = ob
            self.warmup_steps += 1
        self._sync_device()
        dt = time.perf_counter() - t0
        self.stats["compile_s"] += dt
        return dt

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- data plane ------------------------------------------------------

    def _prefill(self, params, tokens, q_len: int):
        """Full-rank prefill over the padded bucket that also captures the
        per-layer k/v and, when the rank path reads the mass pool, the
        prompt's per-key attention mass off the forward's own softmax chain
        (queries beyond ``q_len`` are padding and excluded from the mass)."""
        with_mass = self.cache.rank_on
        logits, aux = forward_dense(self._pf_cfg, params, tokens,
                                    collect_aux="rl", collect_qkv=True,
                                    collect_mass=with_mass, mass_q_len=q_len)
        qkv = aux["layers"]["qkv"]
        return logits, qkv["k"], qkv["v"], aux["layers"]["mass"] if with_mass else None

    def _select_token(self, logits, out_pos, temps, topks, topps, seeds):
        """Next token per row from (ns, V) logits. ``out_pos`` is each
        row's output index (0 = first generated token): the gumbel noise
        is keyed by ``fold_in(key(seed), out_pos)``, so a stream's draws
        are a pure function of its request, whatever the batching,
        admission mode or chunking, and are the JAX engine's bits. Greedy
        rows (temperature 0) take the plain argmax (first index of the
        max, as ``jnp.argmax``).

        Filter order as the reference: top-k on the logits (ties at the
        k-th value all stay), temperature scale, then with ``nucleus`` the
        top-p cut (the smallest probability-sorted set whose mass reaches
        ``top_p``; probability ties at the cut all stay; ``top_p == 1``
        rows bypass it), then ``argmax(scaled + gumbel)``."""
        greedy = torch.argmax(logits, dim=-1)
        if not self.sampling:
            return greedy
        ns, V = logits.shape
        kcap = min(self.top_k_cap, V)
        kth = torch.topk(logits, kcap, dim=-1).values          # (ns, kcap)
        sel = (topks.long() - 1).clamp(0, kcap - 1)
        thr = kth.gather(1, sel[:, None])
        # infinities as Python scalars: torch.where takes them without a
        # host-to-device copy (which would sync inside the step)
        neg_inf = float("-inf")
        masked = torch.where((topks[:, None] > 0) & (logits < thr), neg_inf,
                             logits)
        scaled = masked / temps.clamp_min(1e-6)[:, None]
        if self.nucleus:
            # keep tokens whose probability is >= the smallest probability
            # still inside the top_p mass (sorted-cumsum rule)
            pr = torch.softmax(scaled, dim=-1)
            srt = torch.sort(pr, dim=-1, descending=True).values
            cum = torch.cumsum(srt, dim=-1)
            keep = (cum - srt) < topps[:, None]   # mass before token < p
            p_min = torch.where(keep, srt, -neg_inf).amin(dim=-1, keepdim=True)
            scaled = torch.where((topps[:, None] < 1.0) & (pr < p_min),
                                 neg_inf, scaled)
        keys = prng.fold_in(prng.key(seeds), out_pos)
        g = prng.gumbel(keys, (V,))
        sampled = torch.argmax(scaled + g, dim=-1)
        return torch.where(temps > 0, sampled, greedy)

    def _select1(self, logits, req: Request):
        """Token 0 of a one-shot admission from the prompt's last logits
        (V,): the fused step's selection at output index 0, so a stream
        draws the same whether token 0 comes from a chunk or a one-shot
        prefill."""
        if not (self.sampling and (req.temperature > 0 or req.top_k > 0
                                   or req.top_p < 1.0)):
            return torch.argmax(logits)
        dev = logits.device
        return self._select_token(
            logits[None], torch.zeros((1,), dtype=torch.long, device=dev),
            torch.tensor([req.temperature], dtype=torch.float32, device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            torch.tensor([int(np.uint32(req.seed))], device=dev))[0]

    def _step_impl(self, params, pool_k, pool_v, kt_pool, mass_pool,
                   page_table, tokens, lens, ranks, basis, active, out_buf,
                   prompt_lens, temps, topks, topps, seeds):
        ns = tokens.shape[0]
        off = self.cfg.rank.mode == "off"
        logits, pools = self.fns.decode_step_paged(
            params, pool_k, pool_v, page_table, tokens,
            slot_lens=lens, slot_ranks=None if off else ranks,
            basis=None if off else basis, active=active,
            use_kernel=self.use_kernel,
            kt_pool=None if off else kt_pool,
            mass_pool=None if off else mass_pool)
        out_idx = torch.where(active, torch.clamp(lens - prompt_lens + 1,
                                                  max=self.max_new_cap - 1),
                              torch.zeros_like(lens))
        tok = self._select_token(logits[:, 0], out_idx,
                                 temps, topks, topps, seeds)[:, None]
        tok = torch.where(active[:, None], tok, tokens)
        row = torch.where(active, torch.arange(ns, device=lens.device),
                          torch.full_like(lens, ns))    # dead -> scratch row
        out_buf[row, out_idx] = tok[:, 0]
        lens = lens + active.to(lens.dtype)
        return pools, tok, out_buf, lens

    def _step_mixed_impl(self, params, pool_k, pool_v, kt_pool, mass_pool,
                         page_table, tokens, lens, ranks, basis, active,
                         out_buf, prompt_lens, temps, topks, topps, seeds,
                         prompt_buf):
        """One mixed fused step: live decode rows advance one token while
        mid-prefill rows consume the next ``chunk`` tokens of their prompt
        from the device-resident ``prompt_buf``."""
        ns, C = tokens.shape[0], self.chunk
        off = self.cfg.rank.mode == "off"
        is_pf = active & (lens < prompt_lens)
        q_lens = torch.where(is_pf, torch.clamp(prompt_lens - lens, max=C),
                             torch.ones_like(lens))
        idx = torch.clamp(lens[:, None] + torch.arange(C, device=lens.device),
                          0, prompt_buf.shape[1] - 1)
        chunk_toks = prompt_buf.gather(1, idx)
        toks_in = torch.where(is_pf[:, None], chunk_toks, tokens.expand(ns, C))
        logits, pools = self.fns.decode_step_paged(
            params, pool_k, pool_v, page_table, toks_in,
            slot_lens=lens, q_lens=q_lens, prefill_rows=is_pf,
            slot_ranks=None if off else ranks,
            basis=None if off else basis, active=active,
            use_kernel=self.use_kernel,
            kt_pool=None if off else kt_pool,
            mass_pool=None if off else mass_pool)
        lens_after = lens + torch.where(active, q_lens, torch.zeros_like(lens))
        finishing = is_pf & (lens_after >= prompt_lens)
        emit = active & (finishing | ~is_pf)
        out_idx = torch.where(emit, torch.clamp(lens_after - prompt_lens, 0,
                                                self.max_new_cap - 1),
                              torch.zeros_like(lens))
        tok = self._select_token(logits[:, 0], out_idx,
                                 temps, topks, topps, seeds)[:, None]
        tok = torch.where(emit[:, None], tok, tokens)
        row = torch.where(emit, torch.arange(ns, device=lens.device),
                          torch.full_like(lens, ns))    # no-emit -> scratch
        out_buf[row, out_idx] = tok[:, 0]
        return pools, tok, out_buf, lens_after

    def _step_spec_impl(self, params, pool_k, pool_v, kt_pool, mass_pool,
                        page_table, tokens, lens, ranks, basis, active,
                        out_buf, prompt_lens, temps, topks, topps, seeds,
                        prompt_buf, spectra, caps, eos_ids, n_q_max):
        """One speculative step (``serve.spec``): ``draft_k`` single-token
        forwards at a per-row draft rank over the basis / factor pool sliced
        to ``r_cap`` columns, then ONE chunked verify block per row at the
        slot's current rank, longest-prefix accept with EOS / budget /
        segment-boundary caps (``caps``, host-computed), and a logical
        rollback: ``lens`` advances past accepted tokens only. Mid-prefill
        rows ride along as in the mixed step. The verify's per-query mass
        is added for accepted queries only, in query order; ``n_q_max`` (a
        host int) bounds the queries any row applies.

        Returns (pools, tok, out_buf, lens_after, accepts, n_emit,
        emitted): ``accepts`` (ns,) the accepted run per speculative row (0
        elsewhere), ``n_emit`` (ns,) tokens emitted per row, ``emitted``
        (ns, draft_k + 1) their values (column 0 is token 0 for a row
        finishing its prompt)."""
        ns = tokens.shape[0]
        dev = lens.device
        off = self.cfg.rank.mode == "off"
        k_d = self.draft_k
        Cd = k_d + 1
        C = self.spec_chunk
        cap = self.max_new_cap
        is_pf = active & (lens < prompt_lens)
        spec_rows = active & ~is_pf
        base_out = torch.clamp(lens - prompt_lens + 1, 0, cap - 1)

        # -- draft: k_d cheap forwards. Their K/V writes and factor appends
        # land at positions [lens, lens + k_d), inside the verify's write
        # range, which writes them again before it reads them; the mass
        # pool is not touched
        if off:
            d_ranks = d_basis = d_kt = None
        else:
            d_ranks = draft_ranks(ranks, spectra, frac=self.draft_rank_frac,
                                  grid_lo=self._grid_lo, r_cap=self._draft_cap)
            d_basis = basis[..., :self._draft_cap]
            d_kt = None if kt_pool is None else kt_pool[..., :self._draft_cap]
        d_tok = tokens
        drafts = []
        for i in range(k_d):
            dlg, _ = self.fns.decode_step_paged(
                params, pool_k, pool_v, page_table, d_tok,
                slot_lens=lens + i, slot_ranks=d_ranks, basis=d_basis,
                active=spec_rows, use_kernel=self.use_kernel,
                kt_pool=d_kt, mass_pool=None)
            opos = torch.clamp(base_out + i, max=cap - 1)
            d_tok = self._select_token(dlg[:, 0], opos,
                                       temps, topks, topps, seeds)[:, None]
            drafts.append(d_tok[:, 0])
        drafts = torch.stack(drafts, dim=1)                   # (ns, k_d)

        # -- verify: one causal chunk [t_0, d_1 .. d_k] per speculative row
        # (the next prompt chunk for mid-prefill rows) at the slot's
        # current rank: the read plain decode would have done
        q_lens = torch.where(is_pf, torch.clamp(prompt_lens - lens, max=C),
                             torch.full_like(lens, Cd))
        idx = torch.clamp(lens[:, None] + torch.arange(C, device=dev),
                          0, prompt_buf.shape[1] - 1)
        chunk_toks = prompt_buf.gather(1, idx)
        spec_toks = torch.cat([tokens, drafts], dim=1)          # (ns, Cd)
        if C > Cd:
            spec_toks = F.pad(spec_toks, (0, C - Cd))
        toks_in = torch.where(is_pf[:, None], chunk_toks, spec_toks)
        defer = (not off) and (mass_pool is not None)
        logits, pools = self.fns.decode_step_paged(
            params, pool_k, pool_v, page_table, toks_in,
            slot_lens=lens, q_lens=q_lens, prefill_rows=is_pf,
            slot_ranks=None if off else ranks,
            basis=None if off else basis, active=active,
            use_kernel=self.use_kernel,
            kt_pool=None if off else kt_pool,
            mass_pool=None, return_all_logits=True, mass_defer=defer)
        # targets with plain decode's (seed, output position) fold. Only
        # columns [0, Cd) and a finishing prefill row's last query are
        # read, so only those are drawn: column Cd holds the latter, at
        # output index 0 (the mixed step's fold for token 0)
        cols = torch.cat([torch.arange(Cd, device=dev).expand(ns, Cd),
                          (q_lens - 1)[:, None]], dim=1)      # (ns, Cd + 1)
        V = logits.shape[-1]
        lg = logits.gather(1, cols[:, :, None].expand(ns, Cd + 1, V))
        opos = torch.clamp(base_out[:, None] + torch.arange(Cd, device=dev),
                           max=cap - 1)
        opos = torch.cat([torch.where(is_pf[:, None], torch.zeros_like(opos),
                                      opos), torch.zeros_like(opos[:, :1])], 1)
        rep = lambda x: x.repeat_interleave(Cd + 1)  # noqa: E731
        g = self._select_token(lg.reshape(ns * (Cd + 1), V), opos.reshape(-1),
                               rep(temps), rep(topks), rep(topps),
                               rep(seeds)).reshape(ns, Cd + 1)
        tgt, fin_tok = g[:, :Cd], g[:, Cd:]

        a = spec_mod.accept_counts(drafts, tgt)
        a = spec_mod.clamp_to_eos(a, tgt, eos_ids)
        a = torch.minimum(a, caps)
        a = torch.where(spec_rows, a, torch.zeros_like(a))

        lens_after = lens + torch.where(is_pf, q_lens, torch.zeros_like(lens)) + a
        finishing = is_pf & (lens_after >= prompt_lens)
        n_emit = a + finishing.long()
        src = torch.where(finishing[:, None], fin_tok.expand(ns, Cd), tgt)
        emit_ok = torch.arange(Cd, device=dev)[None, :] < n_emit[:, None]
        rows = torch.where(emit_ok, torch.arange(ns, device=dev)[:, None],
                           torch.full_like(emit_ok, ns, dtype=torch.long))
        col0 = torch.where(finishing, torch.zeros_like(base_out), base_out)
        out_cols = torch.clamp(col0[:, None] + torch.arange(Cd, device=dev),
                               0, cap - 1)
        out_buf[rows, out_cols] = src
        last = src.gather(1, torch.clamp(n_emit - 1, 0, Cd - 1)[:, None])
        tok = torch.where(n_emit[:, None] > 0, last, tokens)

        if defer:
            contrib = pools.pop("mass_q")
            n_q = torch.where(spec_rows, a,
                              torch.where(is_pf, q_lens, torch.zeros_like(a)))
            pools["mass"] = spec_mod.apply_deferred_mass(
                mass_pool, contrib[:, :, :n_q_max], lens, n_q)  # inv-ok-torch[R2]: the accept loop's width; a host int (1 .. spec_chunk) that bounds the queries any row applies, so a captured spec step needs one graph per value (ROADMAP item 21(c))
        return pools, tok, out_buf, lens_after, a, n_emit, src

    def _sync_control(self) -> None:
        """Push host control state to the device after admission/eviction;
        the steady-state loop reuses these tensors without any transfer."""
        if not self._dirty:
            return
        dev = self.device
        self._pt_dev = torch.as_tensor(self.cache.page_table, device=dev).long()
        self._active_dev = torch.as_tensor(
            np.array([s.active for s in self.sched.slots]), device=dev)
        self._plen_dev = torch.as_tensor(
            np.array([s.prompt_len if s.active else 0
                      for s in self.sched.slots], np.int64), device=dev)
        self._lens_dev = torch.as_tensor(self.cache.lens, device=dev).long()
        self._temp_dev = torch.as_tensor(self._temp, device=dev)
        self._topk_dev = torch.as_tensor(self._topk, device=dev)
        self._topp_dev = torch.as_tensor(self._topp, device=dev)
        self._seed_dev = torch.as_tensor(self._seed.astype(np.int64), device=dev)
        self._eos_dev = torch.as_tensor(
            np.array([s.req.eos_id
                      if (s.active and s.req.eos_id is not None) else -1
                      for s in self.sched.slots], np.int64), device=dev)
        self._dirty = False

    def _can_allocate(self, slot: int, total_len: int) -> bool:
        """The scheduler's page-reservation hook for the head of the queue.
        With a prefix cache its prompt is matched first: a hit's shared
        pages become the slot's leading page-table entries (ref + 1, no
        prefill over them), under pool pressure the tree evicts LRU leaves
        (the matched path is pinned), and the hit is kept for the placement
        that follows."""
        if self.prefix is None:
            return self.cache.allocate(slot, total_len)
        req = self.sched.pending[0]
        hit = self.prefix.match(req.tokens)
        # a partly filled shared tail page is copied, not shared: the slot
        # appends into it from the reuse point, so its replacement comes
        # from the free list
        shared = hit.pages[:-1] if hit.cow_src is not None else hit.pages
        shortfall = (self.cache.pages_needed(total_len) - len(shared)
                     - self.cache.free_pages)
        if shortfall > 0:
            # counts PAGES freed from the tree
            self.stats["prefix_evictions"] += self.prefix.evict_lru(
                shortfall, protect=hit.nodes)
        if not self.cache.allocate(slot, total_len, prefix_pages=shared):
            return False
        # LRU recency advances only for a committed hit
        if hit.reuse_len > 0:
            self.prefix.touch_path(hit.nodes)
        self._hits[slot] = hit
        return True

    def _apply_prefix_hit(self, slot: int, req: Request) -> int:
        """Apply a prefix hit at admission: copy the shared tail page if it
        is partly filled, mark the matched tokens prefilled, and re-seed
        the slot's mass row (and, as a warm start the first decision
        overwrites, its spectra) from the snapshot, so the first decision
        is a cold admission's. Returns the number of reused tokens."""
        hit = self._hits.pop(slot, None)
        st = self.sched.slots[slot]
        m = 0 if hit is None else hit.reuse_len
        if hit is not None:
            self.request_prefix_hit[req.rid] = m > 0
            self.stats["prefix_hits" if m > 0 else "prefix_misses"] += 1
            self.stats["prefix_reused_tokens"] += m
        if m > 0:
            if hit.cow_src is not None:
                dst = int(self.cache.page_table[slot,
                                                m // self.cache.page_size])
                self.cache.copy_page(dst, hit.cow_src)
                self.stats["prefix_cow"] += 1
            st.prefilled = m
            self.cache.lens[slot] = m
            if hit.spectra is not None and self.cache.spectra is not None:
                self.cache.spectra[slot] = hit.spectra
        if m > 0 and hit.mass is not None and self.cache.mass_pool is not None:
            # the snapshot is exact: queries [0, m) over positions [0, m).
            # Cells past m need no zeroing: the fused step resets each cell
            # the step its position is appended
            self.cache.mass_pool[:, slot, :m] = hit.mass
        return m

    def _admit(self) -> List[int]:
        with self._lock:
            return self._admit_locked()

    def _admit_locked(self) -> List[int]:
        """Chunked admission stages each placed prompt on the device (the
        mixed fused steps consume it, so admission does no model work);
        one-shot admission prefills the prompt and emits its token 0."""
        placed = self.sched.admit(self.now, self._can_allocate)
        any_other_live = self.sched.n_live() > len(placed)
        for slot, req, bucket in placed:
            st = self.sched.slots[slot]
            st.admit_s = time.perf_counter()
            # a recycled slot must not inherit its previous occupant's
            # rank state: first decision is veto-free, fresh clock
            self.has_rank[slot] = False
            self.force_decide[slot] = False
            self._spectra_pending.pop(slot, None)
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._seed[slot] = np.uint32(req.seed)
            if self.chunk is not None:
                buf = np.zeros((self.cache.max_len,), np.int64)
                buf[:len(req.tokens)] = req.tokens
                self.prompt_buf[slot] = torch.as_tensor(buf, device=self.device)
                # a prefix hit enters chunked prefill at its reuse point
                m = self._apply_prefix_hit(slot, req)
                self._snaps[slot] = {}
                self.stats["prefill_tokens"] += st.prompt_len - m
                self.obs.on_admit(req.rid, slot, st.prompt_len, reused=m,
                                  queued=len(self.sched.pending),
                                  live=self.sched.n_live())
                continue
            self.obs.on_admit(req.rid, slot, st.prompt_len,
                              queued=len(self.sched.pending),
                              live=self.sched.n_live())
            t0 = time.perf_counter()
            s = len(req.tokens)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :s] = req.tokens
            logits, k_l, v_l, mass_l = self._prefill(
                self.params, torch.as_tensor(padded, device=self.device), s)
            tok0 = self._select1(logits[0, s - 1], req)
            mass = (None if mass_l is None
                    else mass_l[:, 0].transpose(1, 2)[:, :s])  # (L, s, hkv)
            self.cache.write_prefill(slot, k_l[:, 0, :s], v_l[:, 0, :s],
                                     mass_layers=mass)
            self.tokens[slot, 0] = tok0
            self.out_buf[slot, 0] = tok0
            st.prefilled = s
            if req.eos_id is not None:
                st.last_tok = int(tok0)
            if self._stream_sync:
                # token 0 is emitted outside the fused step: a streaming
                # consumer must still see it in order
                self.last_emitted.append((req.rid, 0, int(tok0)))
            self._sync_device()
            dt = time.perf_counter() - t0
            self.stats["prefill_s"] += dt
            self.stats["prefill_tokens"] += s
            if any_other_live:
                # blocking admission: this prefill ran while other streams
                # had decode work pending (the stall chunked mode removes)
                self.stats["stall_s"] += dt
            self._stamp_first_token(slot, st, time.perf_counter(), dt)
        if placed:
            self._dirty = True
        return [slot for slot, _, _ in placed]

    def _stamp_first_token(self, i: int, st, now_t: float,
                           ttft_s: float) -> None:
        st.n_out = 1                              # token 0 emitted
        st.latencies.append(ttft_s)               # first-token latency
        self.stats["prefills"] += 1
        self.request_first_tok_t[st.req.rid] = now_t
        self.obs.on_first_token(st.req.rid, i, ttft_s)

    def _maybe_decide(self) -> None:
        if self._decide is None:
            return
        # mid-prefill slots are excluded: their prompt mass / K run is
        # still incomplete, and decode_i == 0 stays a boundary
        active = np.array([s.active and not s.mid_prefill
                           for s in self.sched.slots])
        at_seg = np.array([s.decode_i % self.seg == 0
                           for s in self.sched.slots])
        boundary = active & (at_seg | self.force_decide)
        if not boundary.any():
            return
        self._sync_control()
        # one decision per boundary crossing: streams hit boundaries on
        # their own staggered clocks
        for i in np.nonzero(boundary)[0]:
            st = self.sched.slots[i]
            first = not self.has_rank[i]
            forced = bool(self.force_decide[i])
            (self.cache.ranks, self.cache.basis, self.cache.spectra,
             self.cache.kt_pool, vetoed) = self._decide(
                self.cache.k_pool, self.cache.mass_pool, self.cache.kt_pool,
                self._pt_dev, self._lens_dev, self.cache.ranks,
                self.cache.basis, self.cache.spectra, int(i),
                bool(self.has_rank[i]), st.t)
            self._veto_pending.append(vetoed)
            st.t += 1
            self.stats["decides"] += 1
            self.obs.on_decide(int(i), st.t - 1, forced=forced)
            if self.trace is not None:
                # one fetch per decision: the slot's fresh layer-0 spectra
                # and rank, copied out (the next decision rewrites the
                # spectra in place)
                sp = self.cache.spectra[i]
                host = torch.cat([sp.reshape(-1).float(),  # inv-ok-torch[R1]: trace recording only (record_traces), once per decision: the decide cadence, never per decode step
                                  self.cache.ranks[i:i + 1].float()]).cpu()
                self.trace.on_decision(
                    int(i), st.req.rid, st.t - 1, int(self.cache.lens[i]),
                    int(host[-1]), host[:-1].reshape(sp.shape).numpy(),  # inv-ok-torch[R1]: a view of the host copy fetched above, no device read
                    has_prev=not first)
            if first:
                # the slot's first decision is its prompt's: keep its
                # layer-0 spectra on the cached prefix node (a warm start
                # for later hits; the pool's row is rewritten in place)
                node = self._spectra_pending.pop(i, None)
                if node is not None:
                    node.snap_spectra = self.cache.spectra[i].clone()
        self.has_rank |= boundary
        self.force_decide &= ~boundary

    def _check_drift(self, live: List[int]) -> None:
        """Early re-decision trigger: the newest K token's layer-0 residual
        energy outside each live slot's stored basis; ``force_decide`` is
        set where it exceeds ``drift_threshold`` (the next step's
        ``_maybe_decide`` re-decides there). One (n_slots,) fetch."""
        ns, ps = self.n_slots, self.cache.page_size
        pos = np.maximum(self.cache.lens - 1, 0)
        phys = self.cache.page_table[np.arange(ns), pos // ps]
        dev = self.device
        k_tok = self.cache.k_pool[0][torch.as_tensor(phys, device=dev).long(),
                                     torch.as_tensor(pos % ps, device=dev)]
        drift = self._drift(k_tok, self.cache.basis[0],  # inv-ok-torch[R1]: drift_threshold only: one (n_slots,) fetch per step that decodes, as the reference's code runs it
                            self.cache.ranks).cpu().numpy()
        for i in live:
            if self.has_rank[i] and drift[i] > self.drift_threshold:
                self.force_decide[i] = True
                self.obs.on_drift(int(i), float(drift[i]))

    def _maybe_snapshot(self, i: int, st, done_pf: bool) -> None:
        """Keep a cumulative-mass snapshot for the prefix cache: the pool
        row holds queries [0, prefilled) and nothing more, since chunked
        prefill paused here. Every ``snapshot_every``-th page boundary is
        kept, and the prompt end. The snapshot is a clone: later steps add
        to the pool in place."""
        if self.prefix is None:
            return
        ps = self.cache.page_size
        at_page = st.prefilled % ps == 0
        kept = at_page and (st.prefilled // ps) % self.snapshot_every == 0
        if done_pf or kept:
            self._snaps[i][st.prefilled] = (
                None if self.cache.mass_pool is None else
                self.cache.mass_pool[:, i, :st.prefilled].clone())

    def _insert_prefix(self, i: int, st) -> None:
        """Publish a finished prompt's pages and snapshots to the radix
        tree; the node waits for its spectra until the next decision."""
        if self.prefix is None:
            return
        n_pg = self.cache.pages_needed(st.prompt_len)
        node = self.prefix.insert(
            st.req.tokens,
            [int(p) for p in self.cache.page_table[i, :n_pg]],
            self._snaps.pop(i, {}))
        if node is not None and self._decide is not None:
            self._spectra_pending[i] = node
        # once per finished prompt; pages counted as distinct physical ids
        self.obs.set_prefix_size(
            self.prefix.n_nodes, len(set(self.prefix.all_pages())))

    def _step_live_spec(self, live: List[int], ph=NULL_PHASES) -> None:
        """Host side of one speculative iteration (the fused body is
        ``_step_spec_impl``; ``ph`` is the step's phase recorder). Decode
        rows advance by their accepted run ``a`` (1 .. draft_k + 1); the
        per-step fetch of the accepted runs is the token stream; the host caps each row's run so that max_new and
        (with a rank mode) segment boundaries fall at the token counts
        plain decode hits, and rank decisions see plain decode's clocks."""
        slots = self.sched.slots
        mid = [i for i in live if slots[i].mid_prefill]
        decoding = [i for i in live if not slots[i].mid_prefill]
        q_host = {i: min(self.spec_chunk, slots[i].prompt_len
                         - slots[i].prefilled) for i in mid}
        t0 = time.perf_counter()
        with ph("decide"):
            self._maybe_decide()
        if self.cache.factored and decoding:
            assert all(self.has_rank[i] for i in decoding), \
                "factored slot would read unseeded kt rows"
        ps = self.cache.page_size
        for i in decoding:
            # speculative writes start at lens >= prompt_len, past every
            # page shared with another slot (a partly filled shared tail
            # page was copied at admission): a rollback never rewinds into
            # shared state. The slot's own partly filled prompt tail page,
            # which the tree keeps once the prompt is inserted, holds shared
            # content below prompt_len only, so the floor stops there while
            # no other slot maps that page (the reference's floor counts the
            # whole page, and its assert fires on such a prompt)
            floor = self.cache.shared_floor(i)
            plen = slots[i].prompt_len
            tail = self.cache.page_table[i, plen // ps]
            if floor > plen and (self.cache.page_table == tail).sum() == 1:
                floor = plen
            assert self.cache.lens[i] >= floor, \
                f"slot {i}: speculative write below shared-page floor"
        with ph("dispatch"):
            self._sync_control()
            active_dec = np.array([s.active and not s.mid_prefill
                                   for s in self.sched.slots])
            self.rank_history.append(
                (self.stats["steps"], self.cache.ranks, active_dec))
            # adaptive draft: the cap honours the current effective draft
            # length (>= 1 here: a collapsed engine reaches this path only on
            # recovery-probe steps)
            k_eff = max(self._eff_k, 1) if self.adaptive_draft else self.draft_k
            caps = np.ones((self.n_slots,), np.int64)
            for i in decoding:
                st = slots[i]
                c = min(k_eff + 1, st.req.max_new - st.n_out)
                if self._decide is not None:
                    c = min(c, self.seg - st.decode_i % self.seg)
                caps[i] = max(c, 1)
            n_q_max = max([int(caps[i]) for i in decoding]
                          + list(q_host.values()))
            pools, tok, ob, lens, acc, n_emit, emitted = self._step_spec(
                self.params, self.cache.k_pool, self.cache.v_pool,
                self.cache.kt_pool, self.cache.mass_pool,
                self._pt_dev, self.tokens, self._lens_dev, self.cache.ranks,
                self.cache.basis, self._active_dev, self.out_buf,
                self._plen_dev, self._temp_dev, self._topk_dev,
                self._topp_dev, self._seed_dev, self.prompt_buf,
                self.cache.spectra, torch.as_tensor(caps, device=self.device),
                self._eos_dev, n_q_max)
            self._adopt_pools(pools)
            self.tokens, self.out_buf, self._lens_dev = tok, ob, lens
        with ph("fetch"):
            # the step's one host sync: the accepted runs and their tokens
            host = torch.cat([acc[:, None], emitted], dim=1).tolist()  # inv-ok-torch[R1]: the one sanctioned per-step sync of a speculative step: the accept/emission fetch doubles as the streaming emit
        dt = time.perf_counter() - t0 if self.time_per_token else None
        now_t = time.perf_counter()
        with ph("deliver"):
            for i in live:
                st = slots[i]
                if i in q_host:                       # mid-prefill row
                    q = q_host[i]
                    st.prefilled += q
                    self.cache.lens[i] += q           # host mirror of _lens_dev
                    done_pf = st.prefilled == st.prompt_len
                    self._maybe_snapshot(i, st, done_pf)
                    self.obs.on_prefill_chunk(i, st.req.rid, q, st.prefilled)
                    if done_pf:
                        self._stamp_first_token(i, st, now_t, now_t - st.admit_s)
                        st.last_tok = host[i][1]
                        self.last_emitted.append((st.req.rid, 0, host[i][1]))
                        self._insert_prefix(i, st)
                    continue
                a = host[i][0]
                base = st.n_out
                st.decode_i += a
                st.n_out += a
                self.cache.lens[i] += a               # host mirror of _lens_dev
                st.accept_lens.append(a)
                self.obs.on_spec_accept(i, a, int(caps[i]) - 1)
                if self.trace is not None:
                    self.trace.on_step(i, a, dt, accepted=a - 1,
                                       drafted=int(caps[i]) - 1)
                st.last_tok = host[i][a]
                self.last_emitted.extend(
                    (st.req.rid, base + t, host[i][1 + t]) for t in range(a))
                if dt is not None:
                    st.latencies.extend([dt / a] * a)
                    for _ in range(a):
                        self.obs.on_token_latency(dt / a)
        self.stats["steps"] += 1
        if decoding:
            tot, n_acc, n_drafted = spec_mod.host_accept_stats(
                [h[0] for h in host], caps, decoding, self.draft_k)
            self.stats["spec_steps"] += 1
            self.stats["tokens_decoded"] += tot
            self.stats["spec_tokens"] += tot
            self.stats["spec_accepted"] += n_acc
            self.stats["spec_drafted"] += n_drafted
        if self.adaptive_draft and decoding:
            denom = sum(int(caps[i]) - 1 for i in decoding)
            if denom > 0:
                num = sum(host[i][0] - 1 for i in decoding)
                al = self._DRAFT_EWMA_ALPHA
                self._accept_ewma = ((1.0 - al) * self._accept_ewma
                                     + al * num / denom)
                if self._accept_ewma < self.draft_shrink_below:
                    self._eff_k //= 2
                elif self._accept_ewma > self.draft_grow_above:
                    self._eff_k = min(self.draft_k, max(1, self._eff_k) * 2)
                self.stats["eff_draft_k"] = self._eff_k
        if mid:
            self.stats["mixed_steps"] += 1
        if self._drift is not None and decoding:
            self._check_drift(decoding)
        self._evict_finished()

    def _evict_finished(self) -> None:
        for i, st in enumerate(self.sched.slots):
            if st.active and self.sched.should_evict(i):
                outputs = self.out_buf[i, :st.n_out].tolist()  # inv-ok-torch[R1]: one-shot fetch of a finished request's output at eviction, not per step
                if st.latencies:
                    self.first_token_s.append(st.latencies[0])
                    self.token_latencies.extend(st.latencies[1:])
                if st.accept_lens:
                    self.request_accept_lens[st.req.rid] = list(st.accept_lens)
                if self.trace is not None:
                    self.trace.on_evict(i)
                reason = ("eos" if (st.req.eos_id is not None
                                    and st.last_tok == st.req.eos_id)
                          else "max_new")
                self.obs.on_finish(st.req.rid, i, st.n_out, reason)
                self.sched.evict(i, self.cache.release, outputs)
                self._dirty = True

    def step(self) -> None:
        """One engine iteration: admit -> decide -> fused step -> evict.
        With ``obs_trace`` each phase (admit, schedule, decide, dispatch,
        fetch, deliver) is a span and a histogram sample."""
        self.last_emitted = []
        ph = self.obs.step_phases(self.stats["steps"])
        with ph("admit"):
            self._admit()
        with ph("schedule"):
            self._evict_finished()
            live = [i for i, s in enumerate(self.sched.slots) if s.active]
        if live and self.speculative and any(
                not self.sched.slots[i].mid_prefill for i in live):
            # a row has a token to extend; pure-prefill steps take the mixed
            # step instead (drafts there would be dead forwards)
            spec_now = True
            if self.adaptive_draft and self._eff_k == 0:
                # collapsed draft length: decode rides the mixed step, with
                # a probe spec step every _DRAFT_PROBE_EVERY iterations
                spec_now = self._probe_i % self._DRAFT_PROBE_EVERY == 0
                self._probe_i += 1
            if spec_now:
                self._step_live_spec(live, ph)
                live = []
        if live:
            slots = self.sched.slots
            mid = [i for i in live if slots[i].mid_prefill]
            decoding = [i for i in live if not slots[i].mid_prefill]
            # chunk consumed per slot this step (host mirror of the mixed
            # step's q_lens)
            q_host = {i: min(self.chunk, slots[i].prompt_len
                             - slots[i].prefilled) for i in mid}
            finishing = [i for i in mid
                         if slots[i].prefilled + q_host[i]
                         == slots[i].prompt_len]
            t0 = time.perf_counter()
            with ph("decide"):
                self._maybe_decide()
            if self.cache.factored and decoding:
                # a factored slot's kt rows are only consistent after its
                # first decision re-projects them (decode_i == 0 is always
                # a boundary); mid-prefill rows read dense K
                assert all(self.has_rank[i] for i in decoding), \
                    "factored slot would read unseeded kt rows"
            with ph("dispatch"):
                self._sync_control()
                active_dec = np.array([s.active and not s.mid_prefill
                                       for s in self.sched.slots])
                self.rank_history.append(
                    (self.stats["steps"], self.cache.ranks, active_dec))
                # a speculative engine's decode-only steps ride the mixed
                # step (q_lens == 1), as the reference's do
                use_mixed = bool(mid) or self.speculative
                step_fn = self._step_mixed if use_mixed else self._step
                extra = (self.prompt_buf,) if use_mixed else ()
                pools, tok, ob, lens = step_fn(
                    self.params, self.cache.k_pool, self.cache.v_pool,
                    self.cache.kt_pool, self.cache.mass_pool,
                    self._pt_dev, self.tokens, self._lens_dev,
                    self.cache.ranks, self.cache.basis, self._active_dev,
                    self.out_buf, self._plen_dev, self._temp_dev,
                    self._topk_dev, self._topp_dev, self._seed_dev, *extra)
                self._adopt_pools(pools)
                self.tokens, self.out_buf, self._lens_dev = tok, ob, lens
                dt = None
                if self.time_per_token:
                    self._sync_device()  # inv-ok-torch[R1]: opt-in timing mode (time_per_token) deliberately syncs to attribute per-step latency
                    dt = time.perf_counter() - t0
            emitting = decoding + finishing
            # the one host sync of a step, taken only when EOS detection or
            # a streaming consumer needs this step's token values
            need_tok = (self._stream_sync and emitting) or any(
                slots[i].req.eos_id is not None for i in emitting)
            with ph("fetch"):
                tok_host = tok[:, 0].tolist() if need_tok else None  # inv-ok-torch[R1]: the plain path's one sanctioned per-step sync, taken only when EOS detection or a streaming consumer needs this step's token
            now_t = time.perf_counter()
            with ph("deliver"):
                for i in live:
                    st = slots[i]
                    if i in q_host:               # mid-prefill row
                        q = q_host[i]
                        st.prefilled += q
                        self.cache.lens[i] += q   # host mirror of _lens_dev
                        done_pf = st.prefilled == st.prompt_len
                        self._maybe_snapshot(i, st, done_pf)
                        self.obs.on_prefill_chunk(i, st.req.rid, q,
                                                  st.prefilled)
                        if done_pf:
                            self._stamp_first_token(i, st, now_t,
                                                    now_t - st.admit_s)
                            if tok_host is not None:
                                st.last_tok = tok_host[i]
                            self._insert_prefix(i, st)
                        continue
                    st.decode_i += 1
                    st.n_out += 1
                    self.cache.lens[i] += 1       # host mirror of _lens_dev
                    if self.trace is not None:
                        self.trace.on_step(i, 1, dt)
                    if tok_host is not None:
                        st.last_tok = tok_host[i]
                    if dt is not None:
                        st.latencies.append(dt)
                        self.obs.on_token_latency(dt)
                if tok_host is not None:
                    self.last_emitted.extend(
                        (slots[i].req.rid, slots[i].n_out - 1, tok_host[i])
                        for i in emitting)
            self.stats["steps"] += 1
            self.stats["tokens_decoded"] += len(decoding)
            if mid:
                self.stats["mixed_steps"] += 1
            if self._drift is not None and decoding:
                self._check_drift(decoding)
            self._evict_finished()
        self.now += 1

    def run(self, max_steps: Optional[int] = None) -> Dict:
        """Drive the loop until every request finished. Returns
        {rid: np.ndarray of generated tokens}. The run's wall time, less
        the one-shot prefill that accrued during it, accrues into
        ``stats['decode_s']``."""
        p0 = self.stats["prefill_s"]
        t0 = time.perf_counter()
        steps = 0
        while not self.sched.done():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._sync_device()  # inv-ok-torch[R1]: end-of-run drain before the wall clock is read
        self.stats["decode_s"] += max(
            time.perf_counter() - t0 - (self.stats["prefill_s"] - p0), 0.0)
        return self.results()

    def results(self) -> Dict[int, np.ndarray]:
        return {req.rid: np.asarray(out, np.int32)
                for req, out in self.sched.finished}

    def ranks_per_step(self) -> List[np.ndarray]:
        """Host copy of the per-step (ranks, active) record; -1 marks dead
        lanes, mid-prefill lanes and full-rank decode (rank mode 'off')."""
        if self.cfg.rank.mode == "off":
            return [np.full(a.shape, -1) for _, _, a in self.rank_history]
        return [np.where(a, r.cpu().numpy(), -1)
                for _, r, a in self.rank_history]
