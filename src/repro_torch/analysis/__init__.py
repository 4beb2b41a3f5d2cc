"""repro_torch.analysis — the port's invariant checker.

Static AST rules over the port's serving/kernel tree plus a runtime
sanitizer lane, both driven by ``tools/check_invariants_torch.py``:

  R1 host-sync       device->host syncs in the step-loop call graph, and
                     host-to-device copies and data-sized outputs inside
                     capture roots
  R2 recompile-risk  parameter-sized shapes / mutable captures in capture
                     roots (the bodies a CUDA graph or torch.compile
                     would capture)
  R3 lock-discipline registered shared state mutated without its lock
  R4 donation-safety buffers a step updated in place read through the
                     caller's old reference
  R5 pragma-hygiene  stale or unjustified ``# inv-ok-torch[...]`` pragmas

Suppression pragma (justification string is mandatory)::

    host = acc.tolist()   # inv-ok-torch[R1]: the one sanctioned sync

Runtime side (``repro_torch.analysis.sanitizer``): wraps the engine's
fused steps in ``torch.cuda.set_sync_debug_mode("error")`` and counts
kernel builds and dynamo graphs to assert zero new builds after warmup.
"""
from .pragmas import Pragma, scan_pragmas
from .report import Finding, format_report, run_static
from .rules import RULE_IDS

__all__ = [
    "Finding",
    "Pragma",
    "RULE_IDS",
    "format_report",
    "run_static",
    "scan_pragmas",
]
