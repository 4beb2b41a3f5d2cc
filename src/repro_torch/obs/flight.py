"""Flight recorder of the port (``repro.obs.flight``): a bounded ring of recent engine events, dumped to
disk on failure so a stranded fleet is debuggable after the fact.

The ring is always on — recording is one ``deque.append`` of a small
dict (capacity-bounded, oldest events evicted), cheap enough to leave
enabled in production. Dumping only happens when a dump *directory* was
configured (``EngineConfig(flight_dir=...)``) or an explicit path is
passed, and is triggered from three places:

* ``FrontEnd``'s stepping thread catching a step exception (the moment
  every outstanding handle is about to be aborted with ``EngineStopped``),
* ``FrontEnd.shutdown()`` (normal teardown — the last-breath state),
* ``repro_torch.serve.api.Engine.reset()`` when it strands unfinished handles.

A dump is pure host Python over already-host data: the event ring plus a
registry snapshot. It never touches the device, so it is safe to call from an
exception handler in any thread.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Any, Deque, Dict, Optional

FLIGHT_SCHEMA_VERSION = 1


class FlightRecorder:
    """Bounded event ring + crash-dump writer for one engine."""

    def __init__(self, capacity: int = 256,
                 directory: Optional[str] = None, name: str = "engine"):
        if capacity < 1:
            raise ValueError(f"flight capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.directory = directory
        self.name = name
        self.events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self.n_recorded = 0
        self.n_dumps = 0
        self._t0 = time.perf_counter()

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event. ``fields`` must be JSON-serialisable (the
        engine passes ints/floats/strings only)."""
        ev = {"t_s": round(time.perf_counter() - self._t0, 6), "kind": kind}
        ev.update(fields)
        self.events.append(ev)
        self.n_recorded += 1

    def dump(self, reason: str, *, metrics: Optional[Dict[str, Any]] = None,
             error: Optional[BaseException] = None,
             path: Optional[str] = None) -> Optional[str]:
        """Write the ring (plus a metrics snapshot) to disk. Returns the
        path written, or None when no directory/path is configured.
        Never raises: a crash dump failing must not mask the crash."""
        if path is None:
            if not self.directory:
                return None
            fname = (f"flight_{self.name}_{self.n_dumps:03d}"
                     f"_pid{os.getpid()}.json")
            path = os.path.join(self.directory, fname)
        doc = {
            "schema": FLIGHT_SCHEMA_VERSION,
            "reason": reason,
            "error": repr(error) if error is not None else None,
            "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "engine": self.name,
            "events_recorded": self.n_recorded,
            "events": list(self.events),
            "metrics": metrics or {},
        }
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=str)
        except OSError:
            return None
        self.n_dumps += 1
        return path
