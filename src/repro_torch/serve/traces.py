"""Serving-trace recorder + replay reader of the port (``repro.serve.traces``;
the same on-disk format, so a trace written by either package reads in the
other).

With ``EngineConfig(record_traces=dir)`` the engine hooks a
:class:`TraceRecorder` into its per-segment rank-decision path. One trace
**record** is one (slot, segment) decision and its outcome:

* **decision features** — the slot's mass-weighted layer-0 spectra at the
  decision, the previous segment's spectra (the Eq. 9 "before" side), the
  kv length, the previous and chosen rank buckets, the segment clock and
  the layer index. These are exactly the inputs ``serve.policy.decide()``
  consumed, so the offline trainer (repro_torch.train.serve_policy) can rebuild
  the policy-net features bit-compatibly with serving-time inference.
* **outcomes** — accumulated until the slot's next decision (or its
  eviction): tokens decoded in the segment, summed step latency (0 when
  the engine runs without ``time_per_token``), speculative accept stats,
  the factor-read bytes/token implied by the chosen rank, and a
  mass-weighted agreement proxy (head-mean retained spectral energy at
  the chosen rank — the serving-time stand-in for the fidelity term of
  the Eq. 13 reward).

Recording costs one small host fetch per *decision* (segment cadence,
never per token): the spectra/rank the decide call just wrote back. The
step loop's sync-free discipline is untouched — outcome accumulation
reuses numbers the host already has (the accept fetch, the host lens
mirror, eviction-time latencies).

On-disk format (versioned; readers reject unknown versions):

    <dir>/manifest.json             {"version": 1, "dh": ..., ...}
    <dir>/shard_0000.npz            column arrays, ``shard_size`` records
    <dir>/shard_0001.npz            ...

:class:`TraceReader` concatenates the shards back into column arrays.
Round-tripping is exact (tests/test_torch_traces.py).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

__all__ = ["TRACE_SCHEMA_VERSION", "TraceRecorder", "TraceReader"]

TRACE_SCHEMA_VERSION = 1

# column name -> (dtype, per-record shape suffix); spectra columns get
# their (hkv, dh) suffix from the model config at write time
_SCALAR_COLUMNS = {
    "rid": np.int32, "slot": np.int32, "seg_t": np.int32,
    "kv_len": np.int32, "layer_id": np.int32, "prev_rank": np.int32,
    "chosen_rank": np.int32, "has_prev": np.bool_,
    "n_tokens": np.int32, "latency_s": np.float32,
    "spec_accepted": np.int32, "spec_drafted": np.int32,
    "read_bytes_per_token": np.float32, "agreement": np.float32,
}


class _OpenRecord:
    """A decision whose outcome window is still accumulating."""

    __slots__ = ("fields", "s2", "prev_s2")

    def __init__(self, fields: Dict, s2: np.ndarray, prev_s2: np.ndarray):
        self.fields = fields
        self.s2 = s2
        self.prev_s2 = prev_s2


class TraceRecorder:
    """Collects per-segment decision records and writes npz shards.

    The engine owns exactly one recorder (``ServeEngine.trace``) and
    calls ``on_decision`` / ``on_step`` / ``on_evict`` from its step
    loop; callers call :meth:`flush` once serving is done to commit the
    tail shard and the manifest. Not thread-safe on its own — the step
    loop is the sole caller by the engine's threading contract."""

    def __init__(self, directory, cfg, *, shard_size: int = 512,
                 scenario: Optional[str] = None):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.shard_size = int(shard_size)
        if self.shard_size < 1:
            raise ValueError(f"shard_size must be >= 1, got {shard_size}")
        self.scenario = scenario
        self._open: Dict[int, _OpenRecord] = {}     # slot -> open record
        self._last: Dict[int, tuple] = {}   # slot -> (s2, rank) of last dec
        self._closed: List[_OpenRecord] = []
        self._shards: List[str] = []
        self._n_records = 0
        self._dh = cfg.resolved_head_dim()
        self._hkv = cfg.num_kv_heads
        self._g_hi = int(cfg.rank.rank_grid[-1])

    # -- engine hooks ----------------------------------------------------

    def on_decision(self, slot: int, rid: int, seg_t: int, kv_len: int,
                    chosen_rank: int, s2: np.ndarray, *,
                    has_prev: bool, layer_id: int = 0) -> None:
        """A decide() call just rewrote ``slot``'s rank/spectra. Closes
        the slot's previous record (its outcome window ends here) and
        opens the new one. ``s2`` is the slot's freshly written layer-0
        spectra (hkv, dh); the previous segment's spectra/rank come from
        the recorder's own last record for this slot — decide() is the
        only spectra writer, so this mirrors the device-side "before"
        state exactly. A first decision (``has_prev=False``) mirrors
        decide()'s fresh-slot semantics: prev_s2 = s2, prev_rank =
        r_max, veto off."""
        self._close(slot)
        s2 = np.asarray(s2, np.float32)
        prev = self._last.get(slot)
        if has_prev and prev is not None:
            prev_s2, prev_rank = prev
        else:
            prev_s2, prev_rank = s2, self._g_hi
        tot = np.maximum(s2.sum(axis=-1), 1e-30)
        kept = s2[:, :int(chosen_rank)].sum(axis=-1)
        agreement = float(np.mean(kept / tot))
        # factor-read bytes per decode token at the decision state:
        # every layer reads kv_len rows of r-column fp32 factors per head
        read_bpt = float(self.cfg.num_layers * int(kv_len)
                         * self._hkv * int(chosen_rank) * 4)
        self._open[slot] = _OpenRecord(
            dict(rid=int(rid), slot=int(slot), seg_t=int(seg_t),
                 kv_len=int(kv_len), layer_id=int(layer_id),
                 prev_rank=int(prev_rank), chosen_rank=int(chosen_rank),
                 has_prev=bool(has_prev and prev is not None),
                 n_tokens=0, latency_s=0.0, spec_accepted=0,
                 spec_drafted=0, read_bytes_per_token=read_bpt,
                 agreement=agreement),
            s2, np.asarray(prev_s2, np.float32))
        self._last[slot] = (s2, int(chosen_rank))

    def on_step(self, slot: int, n_tokens: int, dt: Optional[float],
                accepted: int = 0, drafted: int = 0) -> None:
        """Accumulate one step's outcome into the slot's open window."""
        rec = self._open.get(slot)
        if rec is None:
            return
        f = rec.fields
        f["n_tokens"] += int(n_tokens)
        if dt is not None:
            f["latency_s"] += float(dt)
        f["spec_accepted"] += int(accepted)
        f["spec_drafted"] += int(drafted)

    def on_evict(self, slot: int) -> None:
        """The slot's stream ended: close its outcome window and forget
        its previous-segment state (the next occupant starts fresh)."""
        self._close(slot)
        self._last.pop(slot, None)

    # -- persistence -----------------------------------------------------

    def _close(self, slot: int) -> None:
        rec = self._open.pop(slot, None)
        if rec is None:
            return
        self._closed.append(rec)
        self._n_records += 1
        if len(self._closed) >= self.shard_size:
            self._write_shard()

    def _write_shard(self) -> None:
        if not self._closed:
            return
        cols = {name: np.array([r.fields[name] for r in self._closed],
                               dtype)
                for name, dtype in _SCALAR_COLUMNS.items()}
        cols["s2"] = np.stack([r.s2 for r in self._closed])
        cols["prev_s2"] = np.stack([r.prev_s2 for r in self._closed])
        fname = f"shard_{len(self._shards):04d}.npz"
        np.savez_compressed(self.dir / fname, **cols)
        self._shards.append(fname)
        self._closed = []

    def flush(self) -> dict:
        """Close every open window, write the tail shard and the
        manifest. Idempotent; returns the manifest dict."""
        for slot in list(self._open):
            self._close(slot)
        self._write_shard()
        manifest = {
            "version": TRACE_SCHEMA_VERSION,
            "scenario": self.scenario,
            "n_records": self._n_records,
            "shards": list(self._shards),
            "dh": int(self._dh),
            "hkv": int(self._hkv),
            "num_layers": int(self.cfg.num_layers),
            "rank_grid": [int(r) for r in self.cfg.rank.rank_grid],
        }
        (self.dir / "manifest.json").write_text(json.dumps(manifest))
        return manifest


class TraceReader:
    """Replay a recorded trace directory back into column arrays.

    Validates the schema version (unknown versions are rejected — the
    format is versioned precisely so stale readers fail loudly) and
    concatenates all shards. ``records[name]`` is the full column;
    spectra columns are (N, hkv, dh)."""

    def __init__(self, directory):
        self.dir = pathlib.Path(directory)
        mpath = self.dir / "manifest.json"
        if not mpath.exists():
            raise FileNotFoundError(f"no trace manifest in {self.dir}")
        self.manifest = json.loads(mpath.read_text())
        version = self.manifest.get("version")
        if version != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace schema version {version!r} is not supported "
                f"(reader supports {TRACE_SCHEMA_VERSION})")
        parts: List[Dict[str, np.ndarray]] = []
        for fname in self.manifest["shards"]:
            with np.load(self.dir / fname) as z:
                parts.append({k: z[k] for k in z.files})
        if parts:
            self.records = {k: np.concatenate([p[k] for p in parts])
                            for k in parts[0]}
        else:
            self.records = {}

    def __len__(self) -> int:
        return int(self.manifest["n_records"])
