"""This checkout's kernels held to another commit's on one card: the shared
part of the ``--other CHECKOUT`` options of ``tools/few_query_smoke.py``
and ``tools/flash_grad_smoke.py``.

A tool's hidden ``--emit MODE SRC PATH`` step runs in a subprocess of its
own per checkout: it imports the ``repro_torch`` under SRC
(``import_chip_smoke``), builds and runs that checkout's kernels and saves
a list of results to PATH. ``run_trees`` runs the step in each checkout in
turn; ``bitwise`` holds two checkouts' outputs equal case by case, ``ab``
times them in the order other, this, this, other. CHECKOUT is a ``git
archive`` of the other commit unpacked in a git-ignored directory.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def import_chip_smoke(src: str):
    """``chip_smoke``, running on the ``repro_torch`` under ``src`` (a
    checkout's ``src/``) in place of this checkout's."""
    sys.path.insert(0, src)
    import repro_torch  # noqa: F401  (src's package, before chip_smoke adds ROOT/src)
    sys.path.insert(1, ROOT)
    import chip_smoke as cs
    assert os.path.dirname(cs.ops.__file__).startswith(os.path.abspath(src)), cs.ops.__file__
    return cs


def run_trees(tool: str, mode: str, trees) -> list:
    """``tool --emit MODE`` in a subprocess per (name, checkout) of
    ``trees``, in order; what each saved."""
    name = os.path.splitext(os.path.basename(tool))[0]
    out_dir = os.path.join(ROOT, ".scratch", name)
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    outs = []
    for i, (who, tree) in enumerate(trees):
        path = os.path.join(out_dir, f"{mode}_{i}.pt")
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(tool), "--emit", mode,
                        os.path.join(tree, "src"), path], check=True, env=env)
        print(f"  {mode}, {who} checkout ({tree}): built and ran in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        outs.append(torch.load(path))
    return outs


def bitwise(tool: str, mode: str, other: str, labels: list, what: str) -> dict:
    """``mode``'s results in this checkout and in ``other``, one per label,
    equal bitwise (tensors, or tuples of them); raises naming the labels
    that differ."""
    this, that = run_trees(tool, mode, [("this", ROOT), ("other", os.path.abspath(other))])
    assert len(this) == len(that) == len(labels), (len(this), len(that), len(labels))

    def same(a, b):
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    differ = [label for label, a, b in zip(labels, this, that) if not same(a, b)]
    print(f"  {what}: {len(labels) - len(differ)} of {len(labels)} cases bitwise equal to "
          f"the other checkout's build", flush=True)
    if differ:
        raise AssertionError(f"{what} differs from the other checkout's build at {differ}")
    return {"cases": len(labels), "bitwise_equal": len(labels)}


def ab(tool: str, other: str, labels: list, card: str, mode: str = "times") -> dict:
    """``tool --emit MODE`` (ms per label; MODE 'times' unless named) in the
    order other, this, this, other; per label both checkouts' two times."""
    other = os.path.abspath(other)
    runs = run_trees(tool, mode, [("other", other), ("this", ROOT), ("this", ROOT),
                                  ("other", other)])
    res = {}
    for i, label in enumerate(labels):
        mine, theirs = [runs[1][i], runs[2][i]], [runs[0][i], runs[3][i]]
        res[label] = {"this_ms": mine, "other_ms": theirs}
        print(f"  {label}: this {mine[0]:.4f} / {mine[1]:.4f} ms, other {theirs[0]:.4f} / "
              f"{theirs[1]:.4f} ms (this / other of the means {sum(mine) / sum(theirs):.3f}) "
              f"[{card}]", flush=True)
    return res
