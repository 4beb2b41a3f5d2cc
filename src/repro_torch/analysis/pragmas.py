"""Suppression pragmas for the port's invariant checker.

Syntax (one per line, trailing comment)::

    expr   # inv-ok-torch[R1]: why this is fine
    expr   # inv-ok-torch[R1,R4]: one justification covering both rules

Design points:

* the justification string after the colon is MANDATORY — an empty one
  is itself a finding (R5), so suppressions always carry intent;
* a pragma that suppresses nothing is a *stale* finding (R5), so
  suppressions cannot rot when the flagged code is later fixed;
* the tag is ``inv-ok-torch``, never the JAX package's ``inv-ok``: its
  checker scans the whole source tree and its host-sync rule never roots
  in this package, so a port pragma in its syntax would read to it as
  stale; this scanner in turn reads only its own tag;
* deliberately not ``# noqa`` syntax, so ruff's RUF100 (unused noqa)
  and this checker never fight over each other's comments.

Pragmas are scanned from the raw source (tokenize), not the AST, so
they survive on lines the AST does not attribute exactly.
"""
from __future__ import annotations

import io
import re
import tokenize
from dataclasses import dataclass, field

TAG = "inv-ok-torch"

PRAGMA_RE = re.compile(
    r"#\s*inv-ok-torch\[(?P<rules>[A-Za-z0-9_,\s]*)\]\s*(?::\s*(?P<why>.*))?$"
)


@dataclass
class Pragma:
    """One ``# inv-ok-torch[...]`` comment."""

    path: str
    line: int
    rules: tuple[str, ...]
    justification: str
    used_by: set[str] = field(default_factory=set)

    def covers(self, rule: str, line: int) -> bool:
        return line == self.line and rule in self.rules

    @property
    def malformed(self) -> str | None:
        """Return an R5 complaint string, or None if well-formed."""
        if not self.rules:
            return "pragma lists no rules"
        bad = [r for r in self.rules if not re.fullmatch(r"R[1-5]", r)]
        if bad:
            return f"unknown rule id(s): {', '.join(bad)}"
        if not self.justification.strip():
            return "justification string is mandatory after the colon"
        return None


def scan_pragmas(path: str, source: str) -> list[Pragma]:
    """Extract every inv-ok-torch pragma in *source*, keyed by physical
    line."""
    out: list[Pragma] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(
                r.strip() for r in m.group("rules").split(",") if r.strip()
            )
            out.append(Pragma(
                path=path,
                line=tok.start[0],
                rules=rules,
                justification=(m.group("why") or ""),
            ))
    except tokenize.TokenError:
        pass  # syntactically broken file: the AST pass reports it
    return out


class PragmaIndex:
    """Lookup + usage tracking across one checker run."""

    def __init__(self) -> None:
        self._by_file: dict[str, list[Pragma]] = {}

    def add_file(self, path: str, source: str) -> None:
        self._by_file[path] = scan_pragmas(path, source)

    def suppresses(self, path: str, rule: str, line: int) -> bool:
        for p in self._by_file.get(path, ()):
            if p.covers(rule, line):
                p.used_by.add(f"{rule}:{line}")
                return True
        return False

    def all_pragmas(self) -> list[Pragma]:
        return [p for ps in self._by_file.values() for p in ps]
