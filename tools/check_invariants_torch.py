#!/usr/bin/env python
"""The port's invariant checker CLI — static pass + runtime sanitizer
driver (the counterpart of tools/check_invariants.py for
``src/repro_torch``).

Static rules (see repro_torch.analysis for the full contract):

  R1 host-sync        no hidden host<->device sync in the step-loop graph
                      or inside a capture root
  R2 recompile-risk   no parameter-sized shapes or stale captures in
                      capture roots
  R3 lock-discipline  shared engine state mutated only under its lock
  R4 donation-safety  buffers updated in place never read through the
                      caller's old reference
  R5 pragma-hygiene   inv-ok-torch pragmas are well-formed, justified, and
                      live

Usage::

    PYTHONPATH=src python tools/check_invariants_torch.py [paths ...]
    PYTHONPATH=src python tools/check_invariants_torch.py --report json --out r.json
    PYTHONPATH=src python tools/check_invariants_torch.py --selftest
    PYTHONPATH=src python tools/check_invariants_torch.py --sanitize

* default paths: ``src/repro_torch`` (the port's tree must be clean);
* ``--selftest`` runs the seeded per-rule fixtures
  (repro_torch.analysis.fixtures) and exits non-zero unless every seeded
  violation fires and nothing unseeded does — the checker checking
  itself;
* ``--sanitize`` additionally runs the runtime lane
  (repro_torch.analysis.sanitizer) on the CUDA device: sync-guarded fused
  steps + the zero-steady-state-build assertion.

Exit status: 0 clean, 1 findings (or selftest/sanitizer failure).
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.analysis.report import format_report, run_static  # noqa: E402

DEFAULT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src", "repro_torch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="the port's static invariant checker (R1-R5) + "
                    "runtime sanitizer")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to check "
                         "(default: src/repro_torch)")
    ap.add_argument("--report", choices=["text", "json"], default="text")
    ap.add_argument("--out", help="also write the report to this file")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded per-rule fixtures instead of "
                         "checking the tree")
    ap.add_argument("--sanitize", action="store_true",
                    help="also run the runtime sanitizer lane on the CUDA "
                         "device (sync guard + build counting)")
    args = ap.parse_args(argv)

    rc = 0

    if args.selftest:
        from repro_torch.analysis.fixtures import run_selftest
        ok, lines = run_selftest()
        print("\n".join(lines))
        return 0 if ok else 1

    unsuppressed, suppressed = run_static(args.paths
                                          or [os.path.normpath(DEFAULT)])
    report = format_report(unsuppressed, suppressed, fmt=args.report)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    if unsuppressed:
        rc = 1

    if args.sanitize:
        from repro_torch.analysis.sanitizer import main as sanitize_main
        print("-- runtime sanitizer " + "-" * 40)
        rc = max(rc, sanitize_main([]))

    return rc


if __name__ == "__main__":
    sys.exit(main())
