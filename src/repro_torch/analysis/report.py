"""Static pass driver: file discovery, suppression, R5 hygiene, and
the text/JSON findings report (the JAX package's, over the port's
rules and its ``inv-ok-torch`` pragmas)."""
from __future__ import annotations

import json
import os
from dataclasses import asdict

from repro_torch.analysis import registry as default_registry
from repro_torch.analysis.callgraph import ModuleIndex
from repro_torch.analysis.pragmas import TAG, PragmaIndex
from repro_torch.analysis.rules import (
    RULE_IDS,
    Finding,
    rule_r1,
    rule_r2,
    rule_r3,
    rule_r4,
)

__all__ = ["Finding", "RULE_IDS", "format_report", "run_static"]


def _modname(path: str) -> str:
    """Dotted module name for import-table resolution: everything
    after the last ``src/`` segment (or the relative path itself)."""
    norm = path.replace(os.sep, "/")
    if "/src/" in norm:
        norm = norm.rsplit("/src/", 1)[1]
    elif norm.startswith("src/"):
        norm = norm[len("src/"):]
    norm = norm.removesuffix(".py").removesuffix("/__init__")
    return norm.strip("/").replace("/", ".")


def discover_files(roots: list[str]) -> list[str]:
    out: list[str] = []
    for root in roots:
        if os.path.isfile(root):
            if root.endswith(".py"):
                out.append(root)
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git", ".ruff_cache")]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


def build_index(paths: list[str],
                reg=default_registry) -> tuple[ModuleIndex, PragmaIndex]:
    index = ModuleIndex()
    pragmas = PragmaIndex()
    for path in paths:
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError:
            continue
        index.add_file(path, source, modname=_modname(path))
        pragmas.add_file(path, source)
    index.build()
    for name, target in reg.ATTR_TARGETS.items():
        key = _resolve_target(index, target)
        if key is not None:
            index.attr_targets[name] = key
    for target, static in getattr(reg, "CAPTURE_ROOTS", {}).items():
        key = _resolve_target(index, target)
        if key is not None:
            info = index.funcs[key]
            info.capture_root = True
            info.static_params = frozenset(static)
    return index, pragmas


def _resolve_target(index: ModuleIndex, target: tuple[str, str]):
    suffix, qual = target
    for (path, qualname) in index.funcs:
        if qualname == qual and path.endswith(suffix):
            return (path, qualname)
    return None


def run_static(roots: list[str],
               reg=default_registry) -> tuple[list[Finding], list[Finding]]:
    """Run R1-R5 over *roots* (default registry: the port's).

    Returns ``(unsuppressed, suppressed)`` findings, both sorted.  R5
    findings (malformed/stale pragmas) are never suppressible.
    """
    paths = discover_files(roots)
    index, pragmas = build_index(paths, reg)

    raw: list[Finding] = []
    for rule_fn in (rule_r1, rule_r2, rule_r3, rule_r4):
        raw.extend(rule_fn(index, reg))

    # a nested function is scanned both as itself and inside its
    # parent: keep one finding per physical location
    seen: set[tuple[str, str, int, int]] = set()
    deduped: list[Finding] = []
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.col, f.rule)):
        k = (f.rule, f.path, f.line, f.col)
        if k not in seen:
            seen.add(k)
            deduped.append(f)

    unsuppressed: list[Finding] = []
    suppressed: list[Finding] = []
    for f in deduped:
        if pragmas.suppresses(f.path, f.rule, f.line):
            suppressed.append(f)
        else:
            unsuppressed.append(f)

    # R5: pragma hygiene
    for p in pragmas.all_pragmas():
        complaint = p.malformed
        if complaint is not None:
            unsuppressed.append(Finding(
                "R5", p.path, p.line, 0, f"malformed pragma: {complaint}"))
        elif not p.used_by:
            unsuppressed.append(Finding(
                "R5", p.path, p.line, 0,
                f"stale pragma {TAG}[{','.join(p.rules)}]: no listed rule "
                f"fires on this line any more — delete it"))

    unsuppressed.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return unsuppressed, suppressed


def format_report(unsuppressed: list[Finding], suppressed: list[Finding],
                  *, fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps(
            {
                "findings": [
                    {**asdict(f), "rule_name": f.rule_name}
                    for f in unsuppressed
                ],
                "suppressed": [
                    {**asdict(f), "rule_name": f.rule_name}
                    for f in suppressed
                ],
                "counts": {
                    rid: sum(1 for f in unsuppressed if f.rule == rid)
                    for rid in RULE_IDS
                },
                "ok": not unsuppressed,
            },
            indent=2,
        )
    lines: list[str] = []
    for f in unsuppressed:
        lines.append(f"{f.path}:{f.line}:{f.col}: {f.rule} "
                     f"[{f.rule_name}] {f.message}")
    if suppressed:
        lines.append(f"-- {len(suppressed)} finding(s) suppressed by "
                     f"justified {TAG} pragmas")
    lines.append(
        f"{len(unsuppressed)} unsuppressed finding(s)"
        if unsuppressed else "invariants clean: 0 unsuppressed findings"
    )
    return "\n".join(lines)
