"""Continuous-batching serving engine of the port (``repro.serve.engine.
ServeEngine``, the greedy path).

One engine = one slot-paged KV cache + one scheduler + two fused steps:

  * a slot-indexed **segment decision** (serve.policy) that re-picks a
    boundary slot's rank bucket from its live softmax-weighted layer-0 K
    spectra, refreshes its per-layer eigenbasis and (in factor form)
    re-projects its K factors;
  * ONE fused **decode step** over all slots (models.transformer.
    decode_step_paged) with per-row kv_len, per-row rank, in-graph
    attention-mass accumulation and greedy selection; prompts are
    consumed ``prefill_chunk`` tokens at a time inside the **mixed** form
    of that step, alongside the live decode rows. With
    ``prefill_chunk=None`` a prompt is instead prefilled in one shot at
    admission (a full-rank ``forward_dense`` over its length bucket that
    also captures the per-layer K/V and the prompt's attention mass), and
    only the plain decode step runs.

Lengths, ranks and tokens stay on the device between steps; the host
fetches token values only when a live request carries an ``eos_id`` or a
streaming consumer is attached.

Unlike JAX, PyTorch updates the step's buffers in place: the pools, the
output buffer and the decision's basis / spectra / factors are written
where they lie. The JAX engine donates exactly these buffers to its
steps (engine.py:218, policy.py:102), so nothing else holds their old
values, and the engine adopts each step's returned pools right after the
call, as the JAX engine does.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig
from repro_torch.models.api import get_model
from repro_torch.models.transformer import forward_dense
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.policy import make_decide_fn
from repro_torch.serve.scheduler import Request, Scheduler, prefill_buckets


def params_to(params, device):
    """The parameter tree (nested dicts and lists) with every tensor on
    ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


class ServeEngine:
    """Continuous-batching decode over ``n_slots`` concurrent streams."""

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
                 prefix_cache: bool = False, speculative: bool = False,
                 record_traces: Optional[str] = None,
                 obs_trace: bool = False, flight_dir: Optional[str] = None,
                 device="cuda"):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        for flag, what, item in (
                (speculative, "speculative decoding", "item 12"),
                (prefix_cache, "the prefix cache", "item 13"),
                (drift_threshold is not None, "the drift trigger",
                 "item 7: basis_drift"),
                (record_traces, "serving traces", "item 14"),
                (obs_trace, "repro.obs tracing", "item 14"),
                (flight_dir, "the flight recorder", "item 14"),
                (nucleus, "nucleus sampling", "item 8: sampling")):
            if flag:
                raise not_ported(what, item)
        self.device = torch.device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.policy = (None if policy_params is None
                       else params_to(policy_params, self.device))
        self.seg = int(segment_len or cfg.rank.segment_len)
        self.n_slots = n_slots
        self.max_new_cap = max_new_cap
        self.use_kernel = use_kernel
        self.time_per_token = time_per_token
        self.chunk = prefill_chunk
        # ``sampling`` needs no state: greedy rows are bitwise the argmax
        # with or without sampling compiled in (JAX engine.py:534), so both
        # settings serve greedy
        self.cache = PagedKVCache(cfg, n_slots, max_len, page_size,
                                  factored=factor_cache, device=self.device)
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
        self.prompt_buf = torch.zeros((ns, self.cache.max_len),
                                      dtype=torch.long, device=dev)
        self.stats: Dict[str, float] = {
            "compile_s": 0.0, "prefill_s": 0.0, "decode_s": 0.0,
            "steps": 0, "tokens_decoded": 0, "prefills": 0, "decides": 0,
            "mixed_steps": 0, "stall_s": 0.0, "prefill_tokens": 0,
            "warmup_steps": 0}
        self.rank_history: List[Tuple[int, torch.Tensor, np.ndarray]] = []
        self.token_latencies: List[float] = []
        self.first_token_s: List[float] = []
        self.request_first_tok_t: Dict[int, float] = {}
        # (rid, out_index, token) triples of the last step, filled only
        # when the step synced token values (streaming consumers)
        self.last_emitted: List[Tuple[int, int, int]] = []
        self._stream_sync = False

    def reset(self):
        """Clear all serving state but keep the engine's configuration."""
        with self._lock:
            cfg, c = self.cfg, self.cache
            self.cache = PagedKVCache(cfg, self.n_slots, c.max_len,
                                      c.page_size, n_pages=c.n_pages,
                                      factored=c.factored, device=self.device)
            self.sched = Scheduler(self.n_slots, self._buckets)
            self._reset_state()

    # -- request plane ---------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a greedy request (thread-safe)."""
        if req.max_new > self.max_new_cap:
            raise ValueError(f"max_new {req.max_new} > engine cap "
                             f"{self.max_new_cap}")
        if (self.cache.pages_needed(len(req.tokens) + req.max_new)
                > self.cache.pages_per_slot):
            raise ValueError(
                f"request needs {len(req.tokens) + req.max_new} cache "
                f"positions but a slot holds only {self.cache.max_len}")
        if req.temperature > 0 or req.top_k > 0 or req.top_p < 1.0:
            raise not_ported("sampling (temperature / top_k / top_p)",
                             "item 8: _select_token")
        with self._lock:
            self.sched.submit(req)

    def _adopt_pools(self, pools) -> None:
        """Take the fused step's returned pools as the cache's pools (the
        same tensors, updated in place)."""
        self.cache.k_pool, self.cache.v_pool = pools["k"], pools["v"]
        if "kt" in pools:
            self.cache.kt_pool = pools["kt"]
        if "mass" in pools:
            self.cache.mass_pool = pools["mass"]

    def warmup(self) -> float:
        """Run every fused step once on all-inactive lanes (writes land on
        the scratch page / rows, so the run is value-neutral) and one
        decision on the empty slot 0, which the admission-time decision
        overwrites before any read. Builds the CUDA kernel on first use;
        the elapsed time lands in stats['compile_s']."""
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
        runs = [(self._step, ())] + (
            [(self._step_mixed, (self.prompt_buf,))]
            if self._step_mixed is not None else [])
        for fn, extra in runs:
            pools, tok, ob, _ = fn(
                self.params, self.cache.k_pool, self.cache.v_pool,
                self.cache.kt_pool, self.cache.mass_pool,
                self._pt_dev, self.tokens, self._lens_dev,
                self.cache.ranks, self.cache.basis, idle, self.out_buf,
                self._plen_dev, *extra)
            self._adopt_pools(pools)
            self.out_buf = ob
            self.stats["warmup_steps"] += 1
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

    def _select_token(self, logits):
        """Greedy next token per row from (ns, V) logits (first index of
        the max, as ``jnp.argmax``)."""
        return torch.argmax(logits, dim=-1)

    def _step_impl(self, params, pool_k, pool_v, kt_pool, mass_pool,
                   page_table, tokens, lens, ranks, basis, active, out_buf,
                   prompt_lens):
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
        tok = self._select_token(logits[:, 0])[:, None]
        tok = torch.where(active[:, None], tok, tokens)
        row = torch.where(active, torch.arange(ns, device=lens.device),
                          torch.full_like(lens, ns))    # dead -> scratch row
        out_buf[row, out_idx] = tok[:, 0]
        lens = lens + active.to(lens.dtype)
        return pools, tok, out_buf, lens

    def _step_mixed_impl(self, params, pool_k, pool_v, kt_pool, mass_pool,
                         page_table, tokens, lens, ranks, basis, active,
                         out_buf, prompt_lens, prompt_buf):
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
        tok = self._select_token(logits[:, 0])[:, None]
        tok = torch.where(emit[:, None], tok, tokens)
        row = torch.where(emit, torch.arange(ns, device=lens.device),
                          torch.full_like(lens, ns))    # no-emit -> scratch
        out_buf[row, out_idx] = tok[:, 0]
        return pools, tok, out_buf, lens_after

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
        self._dirty = False

    def _admit(self) -> List[int]:
        with self._lock:
            return self._admit_locked()

    def _admit_locked(self) -> List[int]:
        """Chunked admission stages each placed prompt on the device (the
        mixed fused steps consume it, so admission does no model work);
        one-shot admission prefills the prompt and emits its token 0."""
        placed = self.sched.admit(self.now, self.cache.allocate)
        any_other_live = self.sched.n_live() > len(placed)
        for slot, req, bucket in placed:
            st = self.sched.slots[slot]
            st.admit_s = time.perf_counter()
            # a recycled slot must not inherit its previous occupant's
            # rank state: first decision is veto-free, fresh clock
            self.has_rank[slot] = False
            self.force_decide[slot] = False
            if self.chunk is not None:
                buf = np.zeros((self.cache.max_len,), np.int64)
                buf[:len(req.tokens)] = req.tokens
                self.prompt_buf[slot] = torch.as_tensor(buf, device=self.device)
                self.stats["prefill_tokens"] += st.prompt_len
                continue
            t0 = time.perf_counter()
            s = len(req.tokens)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :s] = req.tokens
            logits, k_l, v_l, mass_l = self._prefill(
                self.params, torch.as_tensor(padded, device=self.device), s)
            tok0 = self._select_token(logits[0, s - 1])
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
            (self.cache.ranks, self.cache.basis, self.cache.spectra,
             self.cache.kt_pool, _vetoed) = self._decide(
                self.cache.k_pool, self.cache.mass_pool, self.cache.kt_pool,
                self._pt_dev, self._lens_dev, self.cache.ranks,
                self.cache.basis, self.cache.spectra, int(i),
                bool(self.has_rank[i]), st.t)
            st.t += 1
            self.stats["decides"] += 1
        self.has_rank |= boundary
        self.force_decide &= ~boundary

    def _evict_finished(self) -> None:
        for i, st in enumerate(self.sched.slots):
            if st.active and self.sched.should_evict(i):
                outputs = self.out_buf[i, :st.n_out].tolist()
                if st.latencies:
                    self.first_token_s.append(st.latencies[0])
                    self.token_latencies.extend(st.latencies[1:])
                self.sched.evict(i, self.cache.release, outputs)
                self._dirty = True

    def step(self) -> None:
        """One engine iteration: admit -> decide -> fused step -> evict."""
        self.last_emitted = []
        self._admit()
        self._evict_finished()
        live = [i for i, s in enumerate(self.sched.slots) if s.active]
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
            self._maybe_decide()
            if self.cache.factored and decoding:
                # a factored slot's kt rows are only consistent after its
                # first decision re-projects them (decode_i == 0 is always
                # a boundary); mid-prefill rows read dense K
                assert all(self.has_rank[i] for i in decoding), \
                    "factored slot would read unseeded kt rows"
            self._sync_control()
            active_dec = np.array([s.active and not s.mid_prefill
                                   for s in self.sched.slots])
            self.rank_history.append(
                (self.stats["steps"], self.cache.ranks, active_dec))
            step_fn = self._step_mixed if mid else self._step
            extra = (self.prompt_buf,) if mid else ()
            pools, tok, ob, lens = step_fn(
                self.params, self.cache.k_pool, self.cache.v_pool,
                self.cache.kt_pool, self.cache.mass_pool,
                self._pt_dev, self.tokens, self._lens_dev,
                self.cache.ranks, self.cache.basis, self._active_dev,
                self.out_buf, self._plen_dev, *extra)
            self._adopt_pools(pools)
            self.tokens, self.out_buf, self._lens_dev = tok, ob, lens
            dt = None
            if self.time_per_token:
                self._sync_device()
                dt = time.perf_counter() - t0
            emitting = decoding + finishing
            # the one host sync of a step, taken only when EOS detection or
            # a streaming consumer needs this step's token values
            need_tok = (self._stream_sync and emitting) or any(
                slots[i].req.eos_id is not None for i in emitting)
            tok_host = tok[:, 0].tolist() if need_tok else None
            now_t = time.perf_counter()
            for i in live:
                st = slots[i]
                if i in q_host:                   # mid-prefill row
                    st.prefilled += q_host[i]
                    self.cache.lens[i] += q_host[i]   # host mirror of _lens_dev
                    if st.prefilled == st.prompt_len:
                        self._stamp_first_token(i, st, now_t, now_t - st.admit_s)
                        if tok_host is not None:
                            st.last_tok = tok_host[i]
                    continue
                st.decode_i += 1
                st.n_out += 1
                self.cache.lens[i] += 1           # host mirror of _lens_dev
                if tok_host is not None:
                    st.last_tok = tok_host[i]
                if dt is not None:
                    st.latencies.append(dt)
            if tok_host is not None:
                self.last_emitted.extend(
                    (slots[i].req.rid, slots[i].n_out - 1, tok_host[i])
                    for i in emitting)
            self.stats["steps"] += 1
            self.stats["tokens_decoded"] += len(decoding)
            if mid:
                self.stats["mixed_steps"] += 1
            self._evict_finished()
        self.now += 1

    def run(self, max_steps: Optional[int] = None) -> Dict:
        """Drive the loop until every request finished. Returns
        {rid: np.ndarray of generated tokens}."""
        t0 = time.perf_counter()
        steps = 0
        while not self.sched.done():
            self.step()
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        self._sync_device()
        self.stats["decode_s"] += time.perf_counter() - t0
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
