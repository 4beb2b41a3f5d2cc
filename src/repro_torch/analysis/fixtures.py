"""Seeded violation fixtures for the port's invariant checker selftest.

One synthetic PyTorch module per rule, each containing at least one
*seeded* violation (marked with a ``# seeded[R#]`` comment on the
offending line) next to a clean twin that must NOT fire.  The selftest
(``tools/check_invariants_torch.py --selftest`` and
tests/test_torch_analysis.py) writes these to a temp dir, runs the full
static pass with the fixture registry below, and asserts the found
(rule, line) set matches the seeded set exactly — both directions:
every seeded line fires, and nothing unseeded does.

The fixtures are strings, never modules, so neither this checker nor
the JAX package's ever scans a seeded violation as code.  The marker
comment is *not* pragma syntax, so it never suppresses the finding it
labels.
"""
from __future__ import annotations

import os
import re
import tempfile
from types import SimpleNamespace

from repro_torch.analysis.registry import DonationRule, LockRule
from repro_torch.analysis.report import run_static

SEED_RE = re.compile(r"#\s*seeded\[(R[1-5])\]")

FIXTURES: dict[str, str] = {
    # R1: host syncs reachable from a registered step-loop entry point,
    # and the stricter forms inside a capture root.
    "fix_r1.py": '''\
import numpy as np
import torch


class Engine:
    def step(self):
        x = self._compute()
        torch.cuda.synchronize()  # seeded[R1]
        host = np.asarray(self._buf())  # seeded[R1]
        n = x.item() + host.sum()  # seeded[R1]
        toks = x.tolist()  # seeded[R1]
        arr = x.cpu().numpy()  # seeded[R1]
        back = x.to("cpu")  # seeded[R1]
        self._drain()  # seeded[R1]
        return self._step_impl(x, 3), n, toks, arr, back

    def warmup(self):
        # registered stop: syncing here is control-plane, not flagged
        torch.cuda.synchronize()
        return self._compute().tolist()

    def _drain(self):
        # a registered sync helper: its call sites are the findings
        torch.cuda.synchronize()

    def _compute(self):
        return torch.zeros(())

    def _buf(self):
        return torch.zeros((4,))

    def _step_impl(self, x, n):
        # a capture root whose n is a host value
        k = int(n)
        lo = torch.full((), 0.5, device=x.device)
        hi = torch.tensor(1.0, device=x.device)  # seeded[R1]
        idx = (x > 0).nonzero()  # seeded[R1]
        flag = bool(x)  # seeded[R1]
        return torch.where(x > lo, x, -1e30) + hi, idx, flag, k
''',
    # R2: shapes taken from parameters, and stale captures, inside
    # capture roots.
    "fix_r2.py": '''\
import torch


@torch.compile
def good(x):
    return x + torch.arange(x.shape[0])


@torch.compile
def bad(x, n):
    return x + torch.arange(n)  # seeded[R2]


@torch.compile
def bad_slice(x, k):
    return x[:k].sum()  # seeded[R2]


def step_body(x, lens, n):
    # a registry capture root whose n is a host value
    head = x[:, :x.shape[1] // 2]
    pad = torch.zeros((lens, 4))  # seeded[R2]
    return head, pad, x[..., :n]  # seeded[R2]


class Stepper:
    def __init__(self):
        self.scale = 2.0
        self.calls = 0

    def tick(self):
        self.calls += 1

    @torch.compile
    def fused(self, x):
        y = x * self.scale
        return y + self.calls  # seeded[R2]
''',
    # R3: shared-attr store without the owning lock (inline registry).
    "fix_r3.py": '''\
import threading

import torch


class Store:
    _inv_locks_ = {"items": ("_lock",), "count": ("_lock",)}

    def __init__(self):
        self._lock = threading.Lock()
        self.items = []
        self.count = 0

    def good(self, x: torch.Tensor):
        with self._lock:
            self.items.append(x)
            self.count += 1

    def bad(self, x: torch.Tensor):
        self.items = [x]  # seeded[R3]
        self.count += 1  # seeded[R3]
''',
    # R4: a buffer the step updated in place (the donation contract) read
    # through the caller's old reference.
    "fix_r4.py": '''\
import torch


def step(buf, x):
    # writes buf in place and returns it: the caller adopts the result
    buf.add_(x)
    return buf


def good(buf, x):
    out = step(buf, x)
    buf = out            # rebind before any read: fine
    return buf + 1


def bad(buf, x):
    out = step(buf, x)
    stale = buf + 1  # seeded[R4]
    return out, stale
''',
    # R5: pragma hygiene — stale and malformed pragmas are findings; the
    # JAX package's tag is not this checker's and is ignored.
    "fix_r5.py": '''\
CLEAN = 1  # inv-ok-torch[R1]: nothing on this line ever fired  # seeded[R5]
BROKEN = 2  # inv-ok-torch[R9]: unknown rule id is malformed  # seeded[R5]
OTHER = 3  # inv-ok[R1]: the JAX package's tag, not read here
''',
}

FIXTURE_REGISTRY = SimpleNamespace(
    HOST_ENTRIES=(("fix_r1.py", "Engine.step"),),
    HOST_STOPS={("fix_r1.py", "Engine.warmup"): "control-plane fixture"},
    SYNC_HELPERS={("fix_r1.py", "Engine._drain"): "fixture drain"},
    CAPTURE_ROOTS={("fix_r1.py", "Engine._step_impl"): ("n",),
                   ("fix_r2.py", "step_body"): ("n",)},
    ATTR_TARGETS={},
    LOCK_RULES=(),
    LockRule=LockRule,
    DONATION_RULES=(DonationRule("fix_r4.py", ("step",), (0,)),),
    DONATION_REASSIGNERS={},
)


def seeded_expectations(sources: dict[str, str],
                        base: str) -> set[tuple[str, str, int]]:
    """(rule, path, line) for every ``# seeded[R#]`` marker."""
    out = set()
    for name, src in sources.items():
        for i, line in enumerate(src.splitlines(), start=1):
            for m in SEED_RE.finditer(line):
                out.add((m.group(1), os.path.join(base, name), i))
    return out


def run_selftest() -> tuple[bool, list[str]]:
    """Write the fixtures, run the pass, diff found vs seeded.

    Returns ``(ok, report_lines)``.
    """
    lines: list[str] = []
    with tempfile.TemporaryDirectory(prefix="inv_torch_fixtures_") as tmp:
        for name, src in FIXTURES.items():
            with open(os.path.join(tmp, name), "w") as f:
                f.write(src)
        unsuppressed, _ = run_static([tmp], reg=FIXTURE_REGISTRY)
        found = {(f.rule, f.path, f.line) for f in unsuppressed}
        expected = seeded_expectations(FIXTURES, tmp)

        missing = expected - found
        extra = found - expected
        for rule, path, line in sorted(missing):
            lines.append(f"MISSED  {os.path.basename(path)}:{line} "
                         f"seeded {rule} did not fire")
        for rule, path, line in sorted(extra):
            lines.append(f"SPURIOUS {os.path.basename(path)}:{line} "
                         f"unseeded {rule} fired")
        by_rule = {r: sum(1 for (fr, _, _) in expected if fr == r)
                   for r in ("R1", "R2", "R3", "R4", "R5")}
        lines.append("selftest: " + "  ".join(
            f"{r}x{n}" for r, n in by_rule.items()))
        ok = not missing and not extra
        lines.append("selftest OK: every seeded violation fired, nothing "
                     "else did" if ok else "selftest FAILED")
    return ok, lines
