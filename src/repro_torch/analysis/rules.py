"""The five invariant rules, as functions over a built ModuleIndex.

Each rule returns *raw* findings; pragma suppression and R5 hygiene
happen in the report layer so a suppressed finding still marks its
pragma as used.

R1 and R2 speak PyTorch: the step loop's host syncs are ``.item()``,
``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``torch.cuda.synchronize`` / ``*.synchronize()``, numpy conversions of
device expressions and calls of the registry's ``SYNC_HELPERS``; inside
a capture root's graph a pageable host-to-device copy
(``torch.tensor``/``torch.as_tensor`` with ``device=``), a data-sized
output (``nonzero``, ``masked_select``) and a coercion of a device
parameter sync too, and a shape taken from a parameter cannot be
captured once for every call.  R3, R4 and R5 are the JAX package's.

Known static limits (deliberate — the registry names the hops that
matter, and the runtime sanitizer backstops the rest):

* the rules cannot tell a tensor from a host value: ``.tolist()`` of a
  numpy array and ``torch.as_tensor(t, device=d)`` of a tensor already
  on ``d`` are flagged like the syncing forms;
* calls through local aliases (``for fn, _ in runs: fn(...)``) are
  invisible to R4;
* mutation of *aliased* objects (``st = self.sched.slots[i];
  st.n_out += 1``) is invisible to R3 — only ``self.<attr>`` chains
  and registered mutator-method calls are tracked;
* nested functions defined inside a lock's ``with`` block are treated
  as running *without* the lock (they usually escape it).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from repro_torch.analysis import registry as default_registry
from repro_torch.analysis.callgraph import (
    FuncInfo,
    FuncKey,
    ModuleIndex,
    attr_chain,
)

RULE_IDS: tuple[str, ...] = ("R1", "R2", "R3", "R4", "R5")

_SYNC_NAMES = {
    "R1": "host-sync",
    "R2": "recompile-risk",
    "R3": "lock-discipline",
    "R4": "donation-safety",
    "R5": "pragma-hygiene",
}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    @property
    def rule_name(self) -> str:
        return _SYNC_NAMES.get(self.rule, self.rule)


def _find_key(index: ModuleIndex, suffix: str, qual: str) -> FuncKey | None:
    for (path, qualname) in index.funcs:
        if qualname == qual and path.endswith(suffix):
            return (path, qualname)
    return None


def _np_call(chain: str | None) -> bool:
    return chain in {"np.asarray", "np.array", "numpy.asarray",
                     "numpy.array", "onp.asarray", "onp.array"}


def _shape_derived(node: ast.expr) -> bool:
    """Does the expression mention .shape/.ndim/.size/len() — i.e. is a
    host coercion of it capture-safe?"""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("shape", "ndim",
                                                       "size", "dtype"):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "len"):
            return True
    return False


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")`` or ``x.to(torch.device(
    "cpu"))``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    args = list(node.args[:1]) + [kw.value for kw in node.keywords
                                  if kw.arg == "device"]
    for a in args:
        if isinstance(a, ast.Call) and attr_chain(a.func) == "torch.device":
            a = a.args[0] if a.args else a
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
    return False


def _h2d_copy(node: ast.Call, chain: str | None) -> bool:
    """``torch.tensor(...)``/``torch.as_tensor(...)`` with ``device=``: a
    host value copied from pageable memory, which waits for the copy."""
    return (chain in ("torch.tensor", "torch.as_tensor")
            and any(kw.arg == "device" for kw in node.keywords))


# --------------------------------------------------------------------------
# R1 — host syncs in the step-loop and capture graphs
# --------------------------------------------------------------------------

def _sync_findings(info: FuncInfo, *, traced: bool,
                   helpers: dict[FuncKey, str],
                   index: ModuleIndex) -> list[Finding]:
    out: list[Finding] = []
    # int()/float()/bool() of a device value is only *known* at a capture
    # root's own signature: deeper in the graph, params are often static
    # config ints threaded through (d_head, rank_grid, chunk), and
    # flagging those would drown the report in false positives
    coercible = (set(info.params) - {"self"} - set(info.static_params)
                 if traced and info.capture_root else set())

    def refs_param(node: ast.expr) -> bool:
        return any(isinstance(n, ast.Name) and n.id in coercible
                   for n in ast.walk(node))

    def add(node: ast.AST, msg: str) -> None:
        out.append(Finding("R1", info.path, node.lineno, node.col_offset,
                           f"{msg} (in {info.qualname})"))

    for node in ast.walk(info.node):
        if not isinstance(node, ast.Call):
            continue
        chain = attr_chain(node.func)
        meth = (node.func.attr if isinstance(node.func, ast.Attribute)
                else None)
        if meth == "item" and not node.args:
            add(node, ".item() forces a device->host sync")
        elif meth == "tolist" and not node.args:
            add(node, ".tolist() copies to host and waits for it")
        elif meth == "cpu" and not node.args:
            add(node, ".cpu() copies to host and waits for it")
        elif meth == "numpy" and not node.args:
            add(node, ".numpy() reads a host copy of a device value")
        elif _to_cpu(node):
            add(node, '.to("cpu") copies to host and waits for it')
        elif ((chain and chain.endswith("cuda.synchronize"))
              or meth == "synchronize"):
            add(node, "synchronize stalls the host until the device drains")
        elif _np_call(chain) and node.args:
            arg = node.args[0]
            # host-side graph: a bare Name is usually an already-
            # fetched host value; attribute/subscript/call args are the
            # device-resident reads that sync
            suspicious = isinstance(arg, (ast.Attribute, ast.Subscript,
                                          ast.Call))
            if traced or suspicious:
                add(node, f"{chain} of a device value copies to host")
        elif chain and (k := index.resolve(info.path, chain,
                                           cls=info.cls)) in helpers:
            add(node, f"{chain}() synchronizes the device "
                      f"({helpers[k]})")
        elif traced and _h2d_copy(node, chain):
            add(node, f"{chain}(..., device=) inside a capture graph copies "
                      f"from pageable host memory and waits for the copy")
        elif traced and (meth in ("nonzero", "masked_select")
                         or chain in ("torch.nonzero",
                                      "torch.masked_select")):
            add(node, f"{meth or chain} has a data-dependent size: it "
                      f"syncs to size its output")
        elif (traced and isinstance(node.func, ast.Name)
              and node.func.id in ("int", "float", "bool")
              and len(node.args) == 1
              and refs_param(node.args[0])
              and not _shape_derived(node.args[0])):
            add(node, f"{node.func.id}() coercion of a device argument "
                      f"inside a capture root syncs (and cannot be "
                      f"captured)")
    return out


def _keys(index: ModuleIndex, entries) -> list[FuncKey]:
    return [k for e in entries if (k := _find_key(index, *e)) is not None]


def rule_r1(index: ModuleIndex, reg=default_registry) -> list[Finding]:
    findings: list[Finding] = []
    entries = _keys(index, reg.HOST_ENTRIES)
    stops = set(_keys(index, reg.HOST_STOPS))
    helpers = {k: why for e, why in getattr(reg, "SYNC_HELPERS", {}).items()
               if (k := _find_key(index, *e)) is not None}
    capture_keys = index.reachable(index.capture_entries())
    # the host loop must not cross into captured bodies: those are the
    # capture graph's domain, scanned with the stricter rules; a sync
    # helper's call site is the finding, not its body
    host_keys = index.reachable(entries, stops | capture_keys | set(helpers))
    for key in host_keys - capture_keys:
        findings += _sync_findings(index.funcs[key], traced=False,
                                   helpers=helpers, index=index)
    for key in capture_keys:
        findings += _sync_findings(index.funcs[key], traced=True,
                                   helpers=helpers, index=index)
    return findings


# --------------------------------------------------------------------------
# R2 — recompile risk inside capture scopes
# --------------------------------------------------------------------------

def _mutable_attrs(index: ModuleIndex, path: str, cls: str) -> set[str]:
    """Attributes of *cls* assigned via ``self.X = ...`` outside
    __init__ — reading them in a captured body bakes in a stale value."""
    out: set[str] = set()
    cnode = index.classes.get((path, cls))
    if cnode is None:
        return out
    for meth in cnode.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name == "__init__":
            continue
        for n in ast.walk(meth):
            targets: list[ast.expr] = []
            if isinstance(n, ast.Assign):
                targets = n.targets
            elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
                targets = [n.target]
            for t in targets:
                for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                           else [t]):
                    if (isinstance(el, ast.Attribute)
                            and isinstance(el.value, ast.Name)
                            and el.value.id == "self"):
                        out.add(el.attr)
    return out


_SHAPE_FNS = (".arange", ".zeros", ".ones", ".full", ".empty")


def rule_r2(index: ModuleIndex, reg=default_registry) -> list[Finding]:
    findings: list[Finding] = []
    capture_keys = index.reachable(index.capture_entries())
    mutable_cache: dict[tuple[str, str], set[str]] = {}
    for key in capture_keys:
        info = index.funcs[key]
        # param-shape checks need *known* parameter kinds — only a
        # capture root's own signature gives that; deeper functions
        # receive static config ints too.  Mutable-capture (below)
        # applies to every captured body.
        params = (set(info.params) - {"self"} if info.capture_root
                  else set())

        def bare_param(e: ast.expr) -> str | None:
            if isinstance(e, ast.Name) and e.id in params:
                return e.id
            return None

        def why(p: str) -> str:
            if p in info.static_params:
                return (f"host value {p!r} sizes a shape: a CUDA graph "
                        f"needs one capture per value")
            return (f"device value {p!r} sizes a shape: reading it syncs "
                    f"and no CUDA graph can capture it")

        for node in ast.walk(info.node):
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                shapey = (chain in ("range", "arange", "np.arange")
                          or (chain or "").endswith(_SHAPE_FNS))
                if shapey and node.args:
                    a = node.args[0]
                    sizes = (a.elts if isinstance(a, (ast.Tuple, ast.List))
                             else [a])
                    for s in sizes:
                        p = bare_param(s)
                        if p is not None:
                            findings.append(Finding(
                                "R2", info.path, node.lineno,
                                node.col_offset,
                                f"{chain}({p}): {why(p)} (in "
                                f"{info.qualname})"))
            elif isinstance(node, ast.Subscript):
                sl = node.slice
                parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
                for part in parts:
                    if not isinstance(part, ast.Slice):
                        continue
                    for bound in (part.lower, part.upper):
                        p = bare_param(bound) if bound is not None else None
                        if p is not None:
                            findings.append(Finding(
                                "R2", info.path, node.lineno,
                                node.col_offset,
                                f"slice bound: {why(p)} (in "
                                f"{info.qualname})"))
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.ctx, ast.Load) and info.cls):
                ch = attr_chain(node)
                if ch and ch.startswith("self."):
                    attr = ch.split(".")[1]
                    mkey = (info.path, info.cls)
                    if mkey not in mutable_cache:
                        mutable_cache[mkey] = _mutable_attrs(index, *mkey)
                    if attr in mutable_cache[mkey]:
                        findings.append(Finding(
                            "R2", info.path, node.lineno, node.col_offset,
                            f"captured body reads self.{attr}, which is "
                            f"reassigned outside __init__: a capture "
                            f"bakes in a stale value (in "
                            f"{info.qualname})"))
    # drop duplicate reads on the same line (chained attributes)
    seen: set[tuple] = set()
    out = []
    for f in findings:
        k = (f.rule, f.path, f.line, f.message)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


# --------------------------------------------------------------------------
# R3 — lock discipline
# --------------------------------------------------------------------------

def _inline_lock_rules(index: ModuleIndex, reg) -> list:
    """Classes can self-register via a ``_inv_locks_`` class attr
    (dict literal: attr -> tuple of lock names); fixtures use this."""
    rules = []
    for (path, cls), cnode in index.classes.items():
        locks: set[str] = set()
        attrs: list[str] = []
        for stmt in cnode.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
                continue
            t = stmt.targets[0]
            if not (isinstance(t, ast.Name) and t.id == "_inv_locks_"):
                continue
            if not isinstance(stmt.value, ast.Dict):
                continue
            for k, v in zip(stmt.value.keys, stmt.value.values):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    attrs.append(k.value)
                    for c in ast.walk(v):
                        if (isinstance(c, ast.Constant)
                                and isinstance(c.value, str)):
                            locks.add(c.value)
        if attrs:
            rules.append(reg.LockRule(
                path_suffix=path, cls=cls, locks=tuple(sorted(locks)),
                attrs=tuple(attrs)))
    return rules


def _with_held(stmt: ast.With, locks: tuple[str, ...]) -> bool:
    for item in stmt.items:
        ch = attr_chain(item.context_expr)
        if ch in {f"self.{lk}" for lk in locks}:
            return True
    return False


def rule_r3(index: ModuleIndex, reg=default_registry) -> list[Finding]:
    findings: list[Finding] = []
    rules = list(reg.LOCK_RULES) + _inline_lock_rules(index, reg)
    for rule in rules:
        matches = [
            (path, cls) for (path, cls) in index.classes
            if cls == rule.cls and path.endswith(rule.path_suffix)
        ]
        for path, cls in matches:
            findings += _check_lock_rule(index, rule, path, cls)
    return findings


def _check_lock_rule(index: ModuleIndex, rule, path: str,
                     cls: str) -> list[Finding]:
    findings: list[Finding] = []
    cnode = index.classes[(path, cls)]
    trusted = set(rule.assume_held) | set(rule.external) | {"__init__"}
    attrs = set(rule.attrs)
    mutators = set(rule.mutator_methods)

    for meth_name, why in rule.external.items():
        if not why.strip():
            findings.append(Finding(
                "R3", path, cnode.lineno, cnode.col_offset,
                f"external method {cls}.{meth_name} has no justification "
                f"in the registry"))

    def scan(node: ast.AST, held: bool, meth: str) -> None:
        if isinstance(node, ast.With):
            inner = held or _with_held(node, rule.locks)
            for s in node.body:
                scan(s, inner, meth)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a closure defined under the lock usually escapes it
            for s in ast.iter_child_nodes(node):
                scan(s, False, meth)
            return
        _check_stmt(node, held, meth)
        for s in ast.iter_child_nodes(node):
            scan(s, held, meth)

    def _check_stmt(node: ast.AST, held: bool, meth: str) -> None:
        hits: list[tuple[ast.AST, str]] = []
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                base = el
                # subscript store mutates the attr's value too
                while isinstance(base, ast.Subscript):
                    base = base.value
                ch = attr_chain(base)
                if ch and ch.startswith("self."):
                    a = ch.split(".")[1]
                    if a in attrs:
                        hits.append((node, f"store to self.{a}"))
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            ch = attr_chain(node.value.func)
            if ch and ch.startswith("self."):
                parts = ch.split(".")
                if (len(parts) >= 3 and parts[1] in attrs
                        and parts[-1] in mutators):
                    hits.append((node, f"{ch}() mutates self.{parts[1]}"))
        if hits and not held:
            lock_s = " or ".join(f"self.{lk}" for lk in rule.locks)
            for n, what in hits:
                findings.append(Finding(
                    "R3", path, n.lineno, n.col_offset,
                    f"{what} without holding {lock_s} "
                    f"(in {cls}.{meth})"))

    for meth in cnode.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name in trusted:
            continue
        for s in meth.body:
            scan(s, False, meth.name)

    # assume_held methods: every intra-class reference must sit under
    # the lock or inside another trusted method
    assumed = set(rule.assume_held)
    if assumed:
        for meth in cnode.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue

            def scan_refs(node: ast.AST, held: bool) -> None:
                if isinstance(node, ast.With):
                    inner = held or _with_held(node, rule.locks)
                    for s in node.body:
                        scan_refs(s, inner)
                    return
                ch = attr_chain(node) if isinstance(
                    node, ast.Attribute) else None
                if (ch and ch.startswith("self.")
                        and ch.split(".")[1] in assumed
                        and len(ch.split(".")) == 2):
                    if not held and meth.name not in trusted:
                        findings.append(Finding(
                            "R3", path, node.lineno, node.col_offset,
                            f"{ch} assumes {' or '.join(rule.locks)} is "
                            f"held, but this call site in "
                            f"{cls}.{meth.name} does not hold it"))
                    return
                for s in ast.iter_child_nodes(node):
                    scan_refs(s, held)

            for s in meth.body:
                scan_refs(s, False)
    return findings


# --------------------------------------------------------------------------
# R4 — donation safety
# --------------------------------------------------------------------------

def _donation_specs(index: ModuleIndex, reg):
    """(path predicate, binding name, donated positions) from both the
    registry and literal ``donate_argnums`` bindings the indexer found."""
    specs: list[tuple[str | None, str, tuple[int, ...]]] = []
    for rule in reg.DONATION_RULES:
        for b in rule.bindings:
            specs.append((rule.path_suffix, b, rule.positions))
    for d in index.donations:
        specs.append((d.path, d.binding, d.positions))
    return specs


def _trackable(node: ast.expr) -> str | None:
    """Donated arg expressions worth tracking: plain Name/Attribute
    chains (fresh temporaries can't be read again anyway)."""
    if isinstance(node, (ast.Name, ast.Attribute)):
        return attr_chain(node)
    return None


def rule_r4(index: ModuleIndex, reg=default_registry) -> list[Finding]:
    findings: list[Finding] = []
    specs = _donation_specs(index, reg)
    reassigners = dict(getattr(reg, "DONATION_REASSIGNERS", {}))
    for key, info in index.funcs.items():
        path = info.path
        local = [(b, pos) for (p, b, pos) in specs
                 if p is None or path.endswith(p) or path == p]
        if not local:
            continue
        findings += _scan_donations(info, dict_local={b: pos
                                                      for b, pos in local},
                                    reassigners=reassigners)
    return findings


def _scan_donations(info: FuncInfo, dict_local: dict[str, tuple[int, ...]],
                    reassigners: dict[str, tuple[str, ...]]) -> list[Finding]:
    findings: list[Finding] = []
    # active donated expressions: chain -> (binding, call line)
    active: dict[str, tuple[str, int]] = {}

    # resolve simple local aliases of donating bindings:
    #   step_fn = self._step_mixed if mid else self._step
    # calls through the alias donate the union of both positions
    def _alias_positions(expr: ast.expr) -> tuple[int, ...] | None:
        if isinstance(expr, ast.IfExp):
            a = _alias_positions(expr.body)
            b = _alias_positions(expr.orelse)
            if a is None or b is None:
                return a or b
            return tuple(sorted(set(a) | set(b)))
        ch = attr_chain(expr)
        if ch is not None:
            name = ch.split(".")[-1]
            if (ch in (name, f"self.{name}")) and name in dict_local:
                return dict_local[name]
        return None

    for n in ast.walk(info.node):
        if isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(
                n.targets[0], ast.Name):
            pos = _alias_positions(n.value)
            if pos:
                dict_local[n.targets[0].id] = pos

    def chains_in(node: ast.AST, skip: set[int]) -> list[tuple[str, ast.AST]]:
        out = []
        stack = [node]
        while stack:
            n = stack.pop()
            if id(n) in skip:
                continue
            if isinstance(n, (ast.Name, ast.Attribute)):
                ch = attr_chain(n)
                if ch is not None:
                    out.append((ch, n))
                    continue  # don't descend into the chain's parts
            stack.extend(ast.iter_child_nodes(n))
        return out

    def donating_calls(node: ast.AST):
        for n in ast.walk(node):
            if not isinstance(n, ast.Call):
                continue
            ch = attr_chain(n.func)
            if ch is None:
                continue
            name = ch.split(".")[-1]
            base_ok = ch == name or ch == f"self.{name}"
            if base_ok and name in dict_local:
                yield n, name, dict_local[name]
            elif base_ok and name in reassigners:
                yield n, name, None  # reassigner call

    def stores_of(stmt: ast.AST) -> set[str]:
        out: set[str] = set()
        targets: list[ast.expr] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                ch = _trackable(el)
                if ch:
                    out.add(ch)
        return out

    def process_stmt(stmt: ast.AST) -> None:
        calls = list(donating_calls(stmt))
        skip: set[int] = set()
        new_active: list[tuple[str, str, int]] = []
        cleared: set[str] = set()
        for call, name, positions in calls:
            if positions is None:  # reassigner: clears its listed exprs
                cleared |= set(reassigners[name])
                skip.add(id(call.func))
                continue
            for i in positions:
                if i < len(call.args):
                    ch = _trackable(call.args[i])
                    if ch:
                        new_active.append((ch, name, call.lineno))
                        skip.add(id(call.args[i]))
            skip.add(id(call.func))
        # reads of previously-donated exprs anywhere in this statement
        # (the donating call's own args are excluded via ``skip``)
        store_targets = stores_of(stmt)
        skip_targets: set[int] = set()
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                skip_targets.add(id(t))
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            skip_targets.add(id(stmt.target))
        for ch, node in chains_in(stmt, skip | skip_targets):
            if ch in active:
                binding, line = active[ch]
                findings.append(Finding(
                    "R4", info.path, node.lineno, node.col_offset,
                    f"{ch} was donated to self.{binding}(...) on line "
                    f"{line} and read afterwards: on a donating backend "
                    f"the buffer is already invalid "
                    f"(in {info.qualname})"))
        for ch in store_targets | cleared:
            active.pop(ch, None)
        for ch, name, line in new_active:
            active[ch] = (name, line)
        # a store in the same statement (tuple-unpack of the call's
        # results) immediately re-captures the donated buffer
        for ch in store_targets:
            active.pop(ch, None)

    def walk_block(stmts: list[ast.stmt]) -> None:
        # source order; branches share state (over-approximation: a
        # donation in one branch stays active in the next — reads
        # there are still suspicious)
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # nested defs analyzed as their own functions
            if isinstance(stmt, (ast.If, ast.While)):
                process_stmt(stmt.test)
                walk_block(stmt.body)
                walk_block(stmt.orelse)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                process_stmt(stmt.iter)
                for ch in stores_of(ast.Assign(targets=[stmt.target],
                                               value=stmt.iter)):
                    active.pop(ch, None)
                walk_block(stmt.body)
                walk_block(stmt.orelse)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    process_stmt(item.context_expr)
                walk_block(stmt.body)
            elif isinstance(stmt, ast.Try):
                walk_block(stmt.body)
                for h in stmt.handlers:
                    walk_block(h.body)
                walk_block(stmt.orelse)
                walk_block(stmt.finalbody)
            else:
                process_stmt(stmt)

    walk_block(info.node.body)
    return findings
