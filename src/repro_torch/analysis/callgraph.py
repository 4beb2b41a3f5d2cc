"""Module index + call graph over a set of Python source files.

The index is built once per checker run (plain ``ast``, no imports of
the analyzed code) and shared by every rule:

* ``FuncInfo`` per function/method, keyed ``(path, qualname)`` with
  nested functions as ``outer.<locals>.inner``;
* an import table per module so bare names and module-attribute calls
  (``policy.draft_ranks``) resolve across files;
* capture-root detection — the bodies a CUDA graph or ``torch.compile``
  would capture: ``@torch.compile``, ``@torch.compile(...)``,
  ``@functools.partial(torch.compile, ...)`` and ``name =
  torch.compile(fn, ...)`` rebinds; the registry's ``CAPTURE_ROOTS`` name
  the eager step bodies the serving engine calls (``report.build_index``
  marks them);
* donation bindings: ``binding = wrapper(fn, donate_argnums=(...))``
  with a literal tuple records which positional args of calls through
  that binding are donated (non-literal tuples are covered by the
  explicit registry instead).

Resolution is deliberately conservative: an edge is added only when a
name resolves to an indexed function (same module, import table, or
the repo registry's dynamic-attribute map); unresolvable calls are
dropped, and the registry names the dynamic hops that matter.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

FuncKey = tuple[str, str]  # (path, qualname)


@dataclass
class FuncInfo:
    path: str
    qualname: str
    node: ast.FunctionDef | ast.AsyncFunctionDef
    cls: str | None = None           # enclosing class name, if a method
    parent: FuncKey | None = None    # enclosing function, if nested
    capture_root: bool = False       # body runs under capture
    params: tuple[str, ...] = ()
    # parameters that are host values by contract (the analogue of
    # static_argnames); set from the registry's CAPTURE_ROOTS
    static_params: frozenset = frozenset()

    @property
    def key(self) -> FuncKey:
        return (self.path, self.qualname)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]


@dataclass
class DonationBinding:
    """``binding = wrapper(fn, donate_argnums=(...))`` with literal nums.

    ``binding`` is the bare or ``self.``-attribute name calls go
    through; ``positions`` are donated positional-arg indices.
    """

    path: str
    binding: str                     # "g" or "_step" (for self._step)
    positions: tuple[int, ...]
    target: FuncKey | None = None    # the wrapped function, when resolved


def _compile_in_expr(node: ast.expr) -> bool:
    """Is this decorator/callee expression torch.compile (possibly
    called with options, or through functools.partial)?"""
    if isinstance(node, ast.Attribute) and node.attr == "compile":
        return attr_chain(node) == "torch.compile"
    if isinstance(node, ast.Call):
        f = node.func
        is_partial = (isinstance(f, ast.Attribute) and f.attr == "partial") or (
            isinstance(f, ast.Name) and f.id == "partial"
        )
        if is_partial and node.args:
            return _compile_in_expr(node.args[0])
        return _compile_in_expr(f)
    return False


def attr_chain(node: ast.expr) -> str | None:
    """Dotted source form of a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _literal_ints(node: ast.expr) -> tuple[int, ...] | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for e in node.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, int)):
                return None
            out.append(e.value)
        return tuple(out)
    return None


class _Indexer(ast.NodeVisitor):
    def __init__(self, index: "ModuleIndex", path: str) -> None:
        self.index = index
        self.path = path
        self.stack: list[str] = []       # qualname parts
        self.cls_stack: list[str] = []
        self.fn_stack: list[FuncKey] = []

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.index.classes[(self.path, node.name)] = node
        self.stack.append(node.name)
        self.cls_stack.append(node.name)
        self.generic_visit(node)
        self.cls_stack.pop()
        self.stack.pop()

    def _visit_func(self, node) -> None:
        qual = ".".join(self.stack + [node.name]) if self.stack else node.name
        info = FuncInfo(
            path=self.path,
            qualname=qual,
            node=node,
            cls=self.cls_stack[-1] if self.cls_stack else None,
            parent=self.fn_stack[-1] if self.fn_stack else None,
            capture_root=any(_compile_in_expr(d) for d in node.decorator_list),
            params=tuple(
                a.arg
                for a in (node.args.posonlyargs + node.args.args
                          + node.args.kwonlyargs)
            ),
        )
        self.index.funcs[info.key] = info
        self.index.by_name.setdefault(node.name, []).append(info)
        # children of a function live under ``qual.<locals>.``
        self.stack.extend([node.name, "<locals>"])
        self.fn_stack.append(info.key)
        self.generic_visit(node)
        self.fn_stack.pop()
        del self.stack[-2:]

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.index.imports[self.path][a.asname or a.name.split(".")[0]] = (
                a.name
            )

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            self.index.imports[self.path][a.asname or a.name] = (
                f"{mod}.{a.name}" if mod else a.name
            )
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # name = torch.compile(fn, ...): capture root; any
        # name = wrapper(fn, donate_argnums=...): donation binding
        if isinstance(node.value, ast.Call):
            call = node.value
            compiled = _compile_in_expr(call.func)
            target_fn = call.args[0] if call.args else None
            donate: tuple[int, ...] | None = None
            for kw in call.keywords:
                if kw.arg == "donate_argnums":
                    donate = _literal_ints(kw.value)
            tkey = None
            if target_fn is not None and (compiled or donate):
                chain = attr_chain(target_fn)
                if chain:
                    tkey = self.index.resolve(self.path, chain,
                                              cls=self.cls_stack[-1]
                                              if self.cls_stack else None)
                    if tkey is not None and compiled:
                        self.index.funcs[tkey].capture_root = True
            for t in node.targets:
                tchain = attr_chain(t)
                if tchain and donate:
                    binding = tchain.split(".")[-1]
                    dup = next(
                        (d for d in self.index.donations
                         if (d.path, d.binding, d.positions)
                         == (self.path, binding, donate)),
                        None,
                    )
                    if dup is None:
                        self.index.donations.append(
                            DonationBinding(self.path, binding, donate, tkey)
                        )
                    elif tkey is not None and dup.target is None:
                        dup.target = tkey
        self.generic_visit(node)


class ModuleIndex:
    """All parsed files of one checker run."""

    def __init__(self) -> None:
        self.files: dict[str, tuple[str, ast.Module]] = {}
        self.funcs: dict[FuncKey, FuncInfo] = {}
        self.classes: dict[tuple[str, str], ast.ClassDef] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        self.imports: dict[str, dict[str, str]] = {}
        self.donations: list[DonationBinding] = []
        self.modname: dict[str, str] = {}       # path -> dotted module
        self.path_of_mod: dict[str, str] = {}
        # dynamic attribute hops the AST can't see (filled from registry)
        self.attr_targets: dict[str, FuncKey] = {}

    # -- building --------------------------------------------------------
    def add_file(self, path: str, source: str, modname: str = "") -> None:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError:
            return
        self.files[path] = (source, tree)
        self.imports.setdefault(path, {})
        if modname:
            self.modname[path] = modname
            self.path_of_mod[modname] = path

    def build(self) -> None:
        for path, (_, tree) in self.files.items():
            _Indexer(self, path).visit(tree)
        # second pass: compile rebinds may reference functions indexed
        # after their own module was walked
        for path, (_, tree) in self.files.items():
            _Rebinder(self, path).visit(tree)

    # -- resolution ------------------------------------------------------
    def resolve(self, path: str, chain: str,
                cls: str | None = None) -> FuncKey | None:
        """Resolve a dotted Name/Attribute chain from *path* to a
        function key, or None."""
        parts = chain.split(".")
        if parts[0] == "self" and len(parts) >= 2:
            if len(parts) == 2 and cls:
                key = (path, f"{cls}.{parts[1]}")
                if key in self.funcs:
                    return key
            # self.x.y / unresolved methods: dynamic hop registry by
            # the last two (then one) dotted parts
            return self._dynamic(parts)
        imp = self.imports.get(path, {})
        # bare name: same module, then import table
        if len(parts) == 1:
            for info in self.by_name.get(parts[0], ()):
                if info.path == path:
                    return info.key
            full = imp.get(parts[0])
            if full:
                mod, _, fn = full.rpartition(".")
                p = self.path_of_mod.get(mod)
                if p and (p, fn) in self.funcs:
                    return (p, fn)
            return None
        # module-attribute: policy.draft_ranks / spec_mod.accept_counts
        head = imp.get(parts[0])
        if head:
            p = self.path_of_mod.get(head)
            if p:
                key = (p, ".".join(parts[1:]))
                if key in self.funcs:
                    return key
        return self._dynamic(parts)

    def _dynamic(self, parts: list[str]) -> FuncKey | None:
        if len(parts) >= 2:
            key = self.attr_targets.get(".".join(parts[-2:]))
            if key is not None:
                return key
        return self.attr_targets.get(parts[-1])

    # -- graph -----------------------------------------------------------
    def edges_from(self, key: FuncKey) -> set[FuncKey]:
        info = self.funcs[key]
        out: set[FuncKey] = set()
        for node in ast.walk(info.node):
            # nested defs belong to their parent's behaviour
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not info.node):
                k = (info.path, f"{info.qualname}.<locals>.{node.name}")
                if k in self.funcs:
                    out.add(k)
                continue
            if isinstance(node, (ast.Name, ast.Attribute)):
                chain = attr_chain(node)
                if chain is None:
                    continue
                # references count as edges too: callbacks, functools.
                # partial(f), compile rebinds
                k = self.resolve(info.path, chain, cls=info.cls)
                if k is not None and k != key:
                    out.add(k)
        return out

    def reachable(self, entries: list[FuncKey],
                  stops: set[FuncKey] = frozenset()) -> set[FuncKey]:
        seen: set[FuncKey] = set()
        todo = [k for k in entries if k in self.funcs]
        while todo:
            k = todo.pop()
            if k in seen or k in stops:
                continue
            seen.add(k)
            for nxt in self.edges_from(k):
                if nxt not in seen and nxt not in stops:
                    todo.append(nxt)
        return seen

    def capture_entries(self) -> list[FuncKey]:
        return [k for k, f in self.funcs.items() if f.capture_root]


class _Rebinder(ast.NodeVisitor):
    """Second indexing pass: now that every function is known, resolve
    compile rebinds and donation bindings that point across modules."""

    def __init__(self, index: ModuleIndex, path: str) -> None:
        self.ix = _Indexer(index, path)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.ix.cls_stack.append(node.name)
        self.generic_visit(node)
        self.ix.cls_stack.pop()

    def _visit_func(self, node) -> None:
        key = None
        for k, f in self.ix.index.funcs.items():
            if f.node is node:
                key = k
                break
        if key:
            self.ix.fn_stack.append(key)
        self.generic_visit(node)
        if key:
            self.ix.fn_stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_Assign(self, node: ast.Assign) -> None:
        self.ix.visit_Assign(node)
