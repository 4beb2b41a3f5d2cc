"""Slot-paged KV cache for the continuous-batching engine (port of
``repro.serve.kv_cache.PagedKVCache``).

Device pools are torch tensors, written in place; the page table,
refcounts and lengths stay host numpy, as in the reference:

    k_pool, v_pool: (L, n_pages, page_size, hkv, dh)

plus a per-slot page table ``(n_slots, pages_per_slot)`` of physical page
ids. Physical page 0 is the scratch page: inactive slots point every
entry at it, so the fused step's dead-lane writes land somewhere harmless.
Pages are refcounted: ``allocate`` takes an optional leading run of shared
pages (ref + 1 each), ``release`` decrements, and a page returns to the
free list when its last reference drops.

Per-slot state besides the pools:
  * ``lens``    host valid prefix length per slot (int64 numpy);
  * ``ranks``   (n_slots,) int32 rank bucket, on the device;
  * ``basis``   (L, n_slots, hkv, dh, r_keep) f32 segment eigenbasis;
  * ``spectra`` (n_slots, hkv, dh) layer-0 K spectra of the last decision
                (the "before" side of the Eq. 9 veto);
  * ``mass_pool`` (L, n_slots, max_len, hkv) f32 accumulated per-key
                attention mass, slot-indexed (per-stream state);
  * ``kt_pool`` (L, n_slots + 1, max_len, hkv, r_keep) factor-form K cache
                kt = K . B_r, slot-indexed, row n_slots is scratch.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import nn
from repro_torch.configs.base import ModelConfig


class PagedKVCache:
    """Refcounted page pool + page tables + per-slot serving state."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 factored: Optional[bool] = None, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_slots = n_slots
        self.page_size = page_size
        self.pages_per_slot = -(-max_len // page_size)
        self.max_len = self.pages_per_slot * page_size   # logical view M
        # +1 for the reserved scratch page 0
        self.n_pages = (n_pages if n_pages is not None
                        else n_slots * self.pages_per_slot + 1)
        dtype = nn.dt(cfg.dtype)
        dh = cfg.resolved_head_dim()
        L, hkv = cfg.num_layers, cfg.num_kv_heads

        def zeros(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=self.device)

        self.k_pool = zeros(L, self.n_pages, page_size, hkv, dh)
        self.v_pool = zeros(L, self.n_pages, page_size, hkv, dh)
        self.page_table = np.zeros((n_slots, self.pages_per_slot), np.int32)
        self._free: List[int] = list(range(self.n_pages - 1, 0, -1))  # not 0
        self.ref = np.zeros((self.n_pages,), np.int32)
        self.lens = np.zeros((n_slots,), np.int64)
        self.rank_on = cfg.rank.mode != "off"
        r_max = int(cfg.rank.rank_grid[-1]) if self.rank_on else dh
        self.r_keep = min(r_max, dh)
        if factored and not self.rank_on:
            raise ValueError("factor-form K cache requires a rank mode: "
                             "kt = K . B_r needs a segment basis to "
                             "project onto")
        # default: factor form only when it cuts read bytes (r_max < dh)
        self.factored = (self.rank_on and self.r_keep < dh
                         if factored is None else bool(factored))
        self.ranks = torch.full((n_slots,), r_max, dtype=torch.int32,
                                device=self.device)
        self.basis = zeros(L, n_slots, hkv, dh, self.r_keep, dt=torch.float32)
        self.mass_pool = (zeros(L, n_slots, self.max_len, hkv, dt=torch.float32)
                          if self.rank_on else None)
        self.spectra = (zeros(n_slots, hkv, dh, dt=torch.float32)
                        if self.rank_on else None)
        self.kt_pool = (zeros(L, n_slots + 1, self.max_len, hkv, self.r_keep)
                        if self.factored else None)

    # -- host-side page accounting --------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def retain(self, pages: Iterable[int]) -> None:
        """Add one reference to each page."""
        for p in pages:
            if p == 0:
                raise ValueError("cannot retain the scratch page")
            self.ref[p] += 1

    def unref(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; a page whose last reference drops
        returns to the free list."""
        for p in pages:
            r = int(self.ref[p]) - 1
            if r < 0:
                raise AssertionError(f"refcount underflow on page {p}")
            self.ref[p] = r
            if r == 0:
                self._free.append(int(p))

    def allocate(self, slot: int, total_len: int,
                 prefix_pages: Sequence[int] = ()) -> bool:
        """Reserve pages covering ``total_len`` tokens for ``slot``; the
        optional leading ``prefix_pages`` are shared (ref + 1). Returns
        False (no mutation) when the free pool can't cover the rest."""
        need = self.pages_needed(total_len)
        fresh = need - len(prefix_pages)
        if need > self.pages_per_slot or fresh < 0 or fresh > len(self._free):
            return False
        pages = list(prefix_pages) + [self._free.pop() for _ in range(fresh)]
        self.retain(prefix_pages)
        for p in pages[len(prefix_pages):]:
            self.ref[p] += 1            # fresh pages: 0 -> 1
        self.page_table[slot, :] = 0
        self.page_table[slot, :need] = pages
        self.lens[slot] = 0
        return True

    def release(self, slot: int) -> None:
        """Drop the slot's references and park it on scratch."""
        self.unref(int(p) for p in self.page_table[slot] if p != 0)
        self.page_table[slot, :] = 0
        self.lens[slot] = 0

    def shared_floor(self, slot: int) -> int:
        """First logical position in ``slot`` whose page is private (ref
        == 1): everything before it lives on pages shared with the prefix
        tree or another slot and is immutable to this slot. Speculative
        steps write (and a rejection rewinds, by not advancing ``lens``)
        only at positions at or above it; the engine asserts that."""
        floor = 0
        for p in self.page_table[slot]:
            if p == 0 or int(self.ref[p]) <= 1:
                break
            floor += self.page_size
        return floor

    def live_pages(self) -> Dict[int, List[int]]:
        """slot -> referenced physical pages (for invariant checks)."""
        return {s: [int(p) for p in row if p != 0]
                for s, row in enumerate(self.page_table)}

    # -- device-side page ops -------------------------------------------

    def copy_page(self, dst: int, src: int) -> None:
        """Copy one physical page's K/V contents in place (copy-on-write:
        a prefix hit whose shared tail page is only partly filled gets a
        private copy to append into; the shared original stays as it
        is)."""
        self.k_pool[:, dst] = self.k_pool[:, src]
        self.v_pool[:, dst] = self.v_pool[:, src]

    def write_prefill(self, slot: int, k_layers: torch.Tensor,
                      v_layers: torch.Tensor,
                      mass_layers: Optional[torch.Tensor] = None) -> None:
        """Scatter a prefilled (L, s, hkv, dh) K/V run into the slot's pages
        and set its length. The slot's attention-mass row is zeroed (a
        recycled slot must not keep its previous occupant's mass) and,
        when ``mass_layers`` (L, s, hkv) is given, re-seeded with the
        prompt's per-key causal attention mass. The pools are written in
        place."""
        s = k_layers.shape[1]
        pos = np.arange(s)
        phys = torch.as_tensor(self.page_table[slot][pos // self.page_size],
                               dtype=torch.long, device=self.device)
        off = torch.as_tensor(pos % self.page_size, dtype=torch.long,
                              device=self.device)
        self.k_pool[:, phys, off] = k_layers.to(self.k_pool.dtype)
        self.v_pool[:, phys, off] = v_layers.to(self.v_pool.dtype)
        if self.mass_pool is not None:
            self.mass_pool[:, slot] = 0.0
            if mass_layers is not None:
                self.mass_pool[:, slot, :s] = mass_layers.to(self.mass_pool.dtype)
        self.lens[slot] = s

    def gather_slot(self, slot: int):
        """(L, max_len, hkv, dh) contiguous K/V copies of one slot's
        logical view (testing and debugging; the fused step gathers every
        slot itself)."""
        pt = torch.as_tensor(self.page_table[slot], dtype=torch.long,
                             device=self.device)

        def view(pool):
            g = pool[:, pt]                       # (L, pages, ps, hkv, dh)
            return g.reshape(g.shape[0], -1, *g.shape[3:])
        return view(self.k_pool), view(self.v_pool)

    def check_refs(self, tree_pages: Iterable[int] = ()) -> None:
        """Assert the refcount invariant: every page's refcount equals its
        page-table (+ tree) references; free pages are the zero-ref pages,
        each listed once."""
        counts = np.zeros((self.n_pages,), np.int64)
        for p in self.page_table.reshape(-1):
            counts[p] += 1
        for p in tree_pages:
            counts[p] += 1
        counts[0] = 0
        assert 0 not in self._free, "scratch page on the free list"
        assert len(set(self._free)) == len(self._free), "free-list duplicate"
        assert np.array_equal(self.ref[1:], counts[1:]), "refcount mismatch"
        free = np.zeros((self.n_pages,), bool)
        free[self._free] = True
        assert np.array_equal(free[1:], counts[1:] == 0), \
            "free list != zero-ref pages"


def gather_views(k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor):
    """Every slot's logical K/V view. k_pool/v_pool: (L, P, ps, hkv, dh);
    page_table: (n_slots, pages). Returns (L, n_slots, M, hkv, dh) x2 with
    M = pages * ps."""
    def view(pool):
        g = pool[:, page_table.long()]    # (L, n_slots, pages, ps, hkv, dh)
        return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])
    return view(k_pool), view(v_pool)
