"""Shared-prefix KV reuse (port of ``repro.serve.prefix``, whose tree is
numpy only): a token-level radix tree over page-granularity prefixes, with
refcounted page sharing, attention-mass snapshots and copy-on-write.

The K/V values of a position are a function of the token prefix, so once
one stream has prefilled a prompt, a later stream whose prompt starts with
the same tokens points its leading page-table entries at the same physical
pages (``PagedKVCache`` refcounts) and enters chunked prefill at the
divergence point. What cannot be shared is the per-stream low-rank state:
the attention-mass row feeding the weighted-Gram basis and the factor rows
``kt = K . B_r`` depend on which queries attended and on the slot's own
basis. So the tree keeps, per cached prefix, the cumulative prompt mass
over positions ``[0, m)`` from queries ``[0, m)`` (a tensor cloned off the
mass pool: the pool is written in place by later steps), and a hit
re-seeds its slot's mass row from it; the slot's first decision then sees
what a cold admission would have built, and its tokens are a cold
admission's.

A snapshot at ``m`` exists only where chunked prefill paused at ``m``; the
engine takes one at page-aligned chunk boundaries and at the prompt end,
and ``match`` snaps reuse down to the deepest such point. Each node holds
its edge tokens, the physical pages whose first token falls in its span
(``{page_index: phys}``; a deeper node's entry overrides an ancestor's),
the snapshot valid at its end (``snap_ok``) and an LRU stamp. Splitting a
node invalidates the snapshot at the cut; an insertion ending exactly
there heals it. Eviction drops least-recently-used leaves; a page returns
to the free list when neither the tree nor a slot references it. A hit
that shares a partly filled tail page gets a private copy of it
(``PagedKVCache.copy_page``) before appending.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.kv_cache import PagedKVCache


class RadixNode:
    """One edge of the prefix tree; the path from the root spells the
    cached token prefix ``[0, end)``."""

    __slots__ = ("tokens", "end", "pages", "children", "parent",
                 "snap_ok", "snap_mass", "snap_spectra", "last_used")

    def __init__(self, tokens: np.ndarray, end: int,
                 parent: Optional["RadixNode"] = None):
        self.tokens = np.asarray(tokens, np.int32)
        self.end = end                     # prefix length at this node
        self.pages: Dict[int, int] = {}    # page_index -> physical page id
        self.children: Dict[int, "RadixNode"] = {}
        self.parent = parent
        self.snap_ok = False               # end is an exact reuse point
        self.snap_mass: Optional[Any] = None      # (L, end, hkv) or None
        self.snap_spectra: Optional[Any] = None   # (hkv, dh), lazy
        self.last_used = 0

    @property
    def start(self) -> int:
        return self.end - len(self.tokens)


@dataclass
class MatchResult:
    """A prefix lookup: ``reuse_len`` tokens (< prompt length) whose K/V
    live in ``pages``; ``cow_src`` is the shared partially-filled tail
    page to copy-on-write (None when the reuse point is page-aligned);
    ``mass``/``spectra`` are the snapshot to rehydrate the slot's
    low-rank state from; ``nodes`` is the matched path (LRU-protected
    while the admission that looked it up is in flight)."""
    reuse_len: int = 0
    pages: List[int] = field(default_factory=list)
    cow_src: Optional[int] = None
    mass: Optional[Any] = None
    spectra: Optional[Any] = None
    nodes: List[RadixNode] = field(default_factory=list)


class PrefixCache:
    """Radix tree over cached prompt prefixes, sharing pages of one
    :class:`PagedKVCache` via its refcounts."""

    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.ps = cache.page_size
        self.root = RadixNode(np.zeros((0,), np.int32), 0)
        self._clock = 0
        self.n_nodes = 0

    def _touch(self, node: RadixNode) -> None:
        node.last_used = self._clock
        self._clock += 1

    def touch_path(self, nodes: Sequence[RadixNode]) -> None:
        """Advance the LRU stamp of a committed match's path."""
        for n in nodes:
            self._touch(n)

    # -- lookup ----------------------------------------------------------

    def match(self, tokens: np.ndarray) -> MatchResult:
        """Longest reusable prefix of ``tokens``: the deepest fully-matched
        node with a valid snapshot at most ``len(tokens) - 1`` deep (at
        least one prompt token must be computed to produce the first
        logits). Read-only — LRU stamps are advanced by ``touch_path``
        only when the caller actually commits to the hit, so a request
        blocked on page pressure re-matching every step does not inflate
        its path's recency over genuinely served prefixes."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        P = len(tokens)
        node, i = self.root, 0
        pages: Dict[int, int] = {}
        path: List[RadixNode] = []
        best: Optional[RadixNode] = None
        best_pages: Optional[Dict[int, int]] = None
        while i < P:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            e = len(child.tokens)
            if e > P - i or not np.array_equal(child.tokens, tokens[i:i + e]):
                break                      # divergence mid-edge: no deeper
            node = child                   # reuse point can complete
            i += e
            pages.update(child.pages)      # deeper copies override
            path.append(child)
            if child.snap_ok and child.end <= P - 1:
                best, best_pages = child, dict(pages)
        if best is None:
            return MatchResult(nodes=path)
        m = best.end
        plist = []
        for f in range(-(-m // self.ps)):
            assert f in best_pages, \
                f"prefix tree path to depth {m} is missing page {f}"
            plist.append(best_pages[f])
        cow = plist[-1] if m % self.ps else None
        return MatchResult(reuse_len=m, pages=plist, cow_src=cow,
                           mass=best.snap_mass, spectra=best.snap_spectra,
                           nodes=path)

    def probe(self, tokens: np.ndarray) -> int:
        """Longest *snapshotted* reusable prefix length for ``tokens`` —
        the same depth a :meth:`match` at this instant would reuse — as a
        pure read: no page assembly, no LRU movement, no refcounts.

        A router scores replicas with it (the reference's
        ``serve.frontend``), so it must be cheap and leave every
        replica's LRU order untouched."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        P = len(tokens)
        node, i, best = self.root, 0, 0
        while i < P:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            e = len(child.tokens)
            if e > P - i or not np.array_equal(child.tokens, tokens[i:i + e]):
                break
            node = child
            i += e
            if child.snap_ok and child.end <= P - 1:
                best = child.end
        return best

    # -- insertion -------------------------------------------------------

    def _split(self, node: RadixNode, j: int) -> None:
        """Cut ``node``'s edge after ``j`` tokens: ``node`` keeps the top
        half (its snapshot is invalidated — the aggregate mass cannot be
        decomposed at an arbitrary cut), a new child keeps the bottom
        half, the original children, the snapshot, and the pages whose
        first token moved below the cut."""
        cut = node.start + j
        bottom = RadixNode(node.tokens[j:], node.end, parent=node)
        bottom.children = node.children
        for ch in bottom.children.values():
            ch.parent = bottom
        bottom.snap_ok, bottom.snap_mass = node.snap_ok, node.snap_mass
        bottom.snap_spectra = node.snap_spectra
        bottom.last_used = node.last_used
        bottom.pages = {f: p for f, p in node.pages.items()
                        if f * self.ps >= cut}
        node.pages = {f: p for f, p in node.pages.items()
                      if f * self.ps < cut}
        node.tokens = node.tokens[:j]
        node.end = cut
        node.snap_ok, node.snap_mass, node.snap_spectra = False, None, None
        node.children = {int(bottom.tokens[0]): bottom}
        self.n_nodes += 1

    def _heal(self, node: RadixNode, snaps: Dict[int, Any]) -> None:
        """An insertion ending exactly at an unsnapshotted node (e.g. the
        top half of an old split) makes its end an exact reuse point."""
        if not node.snap_ok and node.end in snaps and node.end > 0:
            node.snap_mass = snaps[node.end]
            node.snap_ok = True

    def insert(self, tokens: np.ndarray, pages: Sequence[int],
               snaps: Dict[int, Any]) -> Optional[RadixNode]:
        """Cache a fully-prefilled prompt. ``pages`` are the inserting
        slot's physical pages for page indices ``0..ceil(P/ps)-1``;
        ``snaps`` maps exact snapshot positions (page-aligned chunk
        boundaries and the prompt end) to the cumulative mass captured
        there (None on the rank-off path — the position is still an exact
        reuse point). New nodes are cut at snapshot positions so every
        future hit lands on one; their pages gain a tree reference.
        Returns the deepest node of this prompt (for the engine's lazy
        spectra capture), or None when the prompt added nothing new."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        P = len(tokens)
        node, i = self.root, 0
        while i < P:
            child = node.children.get(int(tokens[i]))
            if child is None:
                break
            e = len(child.tokens)
            n = min(e, P - i)
            j = 0
            while j < n and child.tokens[j] == tokens[i + j]:
                j += 1
            if j == e:                       # full edge match
                node = child
                i += e
                self._touch(child)
                self._heal(child, snaps)
                continue
            if j > 0:                        # diverged (or ended) mid-edge
                self._split(child, j)
                node = child
                i += j
                self._touch(child)
                self._heal(child, snaps)
            break
        if i >= P:
            return node if node is not self.root else None
        # extend with a chain cut at the exact snapshot positions, so each
        # new node's end is a valid reuse point. The first segment owns its
        # (private) copy of a page straddling a mid-page start; later cuts
        # are page-aligned by construction.
        cuts = sorted({p for p in snaps
                       if i < p < P and p % self.ps == 0} | {P})
        start = i
        for c in cuts:
            nn = RadixNode(tokens[start:c], c, parent=node)
            # floor(start/ps): a mid-page start claims the (private) copy
            # of the straddling page; aligned starts claim from their own
            # first page (floor == ceil there)
            nn.pages = {f: int(pages[f])
                        for f in range(start // self.ps, -(-c // self.ps))}
            self.cache.retain(nn.pages.values())
            nn.snap_ok = c in snaps
            nn.snap_mass = snaps.get(c)
            node.children[int(tokens[start])] = nn
            self._touch(nn)
            self.n_nodes += 1
            node, start = nn, c
        return node

    # -- eviction --------------------------------------------------------

    def all_pages(self) -> List[int]:
        """Every physical page the tree references (invariant checks)."""
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.extend(n.pages.values())
            stack.extend(n.children.values())
        return out

    def _leaves(self) -> List[RadixNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            else:
                out.append(n)
        return out

    def evict_lru(self, n_pages_needed: int,
                  protect: Sequence[RadixNode] = ()) -> int:
        """Drop least-recently-used leaves until ``n_pages_needed`` pages
        actually returned to the free list. Only leaves that would free
        at least one page (some page solely tree-referenced) — or that
        own no pages at all (split residue that would otherwise block
        its ancestors forever) — are victims: dropping a leaf whose
        pages are all still held by live slots frees nothing now and
        loses future reuse, so when no leaf can free anything the tree
        is left intact and the caller's allocation simply fails.
        ``protect`` pins the path of an in-flight admission. Returns the
        number of pages freed."""
        pinned = {id(n) for n in protect}
        freed = 0
        while freed < n_pages_needed:
            victims = [n for n in self._leaves() if id(n) not in pinned
                       and (not n.pages
                            or any(int(self.cache.ref[p]) == 1
                                   for p in n.pages.values()))]
            if not victims:
                break
            victim = min(victims, key=lambda n: n.last_used)
            before = self.cache.free_pages
            self.cache.unref(victim.pages.values())
            del victim.parent.children[int(victim.tokens[0])]
            self.n_nodes -= 1
            freed += self.cache.free_pages - before
        return freed

