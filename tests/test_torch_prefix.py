"""The shared-prefix radix cache of the port against the JAX package.

The tree (``serve/prefix.py``, numpy in both packages) against JAX's
``PrefixCache`` under one seeded random sequence of operations over a tiny
pool and a two-token alphabet (insert, match, probe, release, LRU
eviction, with splits and heals along the way): the same reuse lengths,
pages, ``cow_src``, snapshots, refcounts and free lists after every
operation. Then the engine on the reduced drrl-paper model at the sizes of
``tests/test_serve_prefix.py``: prefix-hit admission gives tokens
IDENTICAL to the JAX engine's with the prefix cache and to the port's own
cold run, with the same hit, reuse and copy-on-write counts, in rank modes
'adaptive', 'fixed' and 'off' x factor cache x ``use_kernel``; copy-on-write
of a partly filled tail page and an exact duplicate; a hit on a recycled
slot; eviction pressure; sampled streams; ``reset``; a submit from a
background thread; prefix hits under speculation; and a check that a
mass snapshot keeps its values while later steps add to the pool. The
refcount invariant (``check_refs`` over the tree's pages) holds after
every run.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve import PagedKVCache as JaxPagedKVCache  # noqa: E402
from repro.serve import PrefixCache as JaxPrefixCache  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, PagedKVCache, SamplingParams  # noqa: E402
from repro_torch.serve.prefix import PrefixCache  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

KNOBS = dict(n_slots=2, max_len=64, page_size=8, segment_len=8, max_new_cap=8,
             prefill_chunk=8)


def _cfg(mode):
    return get_config("drrl-paper", reduced=True).with_(rank=RankConfig(
        mode=mode, rank_grid=(4, 8, 12, 16), fixed_rank=16, segment_len=8))


# -- the tree -------------------------------------------------------------------

def _snaps(p_len, ps, cut_every):
    """Snapshot positions: every ``cut_every``-th page boundary inside the
    prompt and its end, each tagged with its position (the engine stores
    the mass there)."""
    pts = {p: p for p in range(ps, p_len, ps) if (p // ps) % cut_every == 0}
    pts[p_len] = p_len
    return pts


def _same_match(a, b):
    assert (a.reuse_len, a.pages, a.cow_src, a.mass) == \
        (b.reuse_len, b.pages, b.cow_src, b.mass)
    assert [n.end for n in a.nodes] == [n.end for n in b.nodes]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_matches_jax(seed):
    """One random sequence of 120 operations on both trees, each over its
    own cache of 3 slots and 24 pages: matches (reuse length, pages,
    copy-on-write source, snapshot, path), probes, evictions' freed pages,
    node counts, page lists, refcounts and free lists agree after every
    operation; splits (a node cut mid-edge) and heals both occur."""
    rnd = np.random.default_rng(seed)
    cfg = _cfg("off")
    ps, n_slots = 8, 3
    side = {}
    for name, Cache, Tree, kw in (
            ("jax", JaxPagedKVCache, JaxPrefixCache, {}),
            ("torch", PagedKVCache, PrefixCache, {"device": "cpu"})):
        cache = Cache(cfg if name == "jax" else torch_config(cfg), n_slots, max_len=32,
                      page_size=ps, n_pages=24, **kw)
        side[name] = (cache, Tree(cache))
    live, splits, heals = {}, 0, 0
    for _ in range(120):
        op = int(rnd.integers(0, 5))
        toks = rnd.integers(0, 2, int(rnd.integers(4, 25))).astype(np.int32)
        if op <= 1:                                   # admit and insert
            free = [s for s in range(n_slots) if s not in live]
            if not free:
                continue
            slot, cut_every = free[0], int(rnd.integers(1, 3))
            hits = {k: t.match(toks) for k, (c, t) in side.items()}
            _same_match(hits["torch"], hits["jax"])
            ok = set()
            for k, (c, t) in side.items():
                h = hits[k]
                shared = h.pages[:-1] if h.cow_src is not None else h.pages
                if h.reuse_len and c.allocate(slot, len(toks) + 2, prefix_pages=shared):
                    t.touch_path(h.nodes)
                    ok.add(True)
                elif not h.reuse_len and c.allocate(slot, len(toks) + 2):
                    ok.add(True)
                else:
                    ok.add(False)
            assert len(ok) == 1
            if not ok.pop():
                continue
            n_pg = -(-len(toks) // ps)
            ends = []
            for k, (c, t) in side.items():
                before = t.n_nodes
                node = t.insert(toks, [int(p) for p in c.page_table[slot, :n_pg]],
                                _snaps(len(toks), ps, cut_every))
                ends.append((None if node is None else node.end, t.n_nodes - before))
            assert ends[0] == ends[1]
            live[slot] = True
        elif op == 2 and live:                        # release a slot
            slot = list(live)[int(rnd.integers(0, len(live)))]
            for c, _ in side.values():
                c.release(slot)
            del live[slot]
        elif op == 3:                                 # evict some leaves
            n = int(rnd.integers(1, 5))
            freed = {k: t.evict_lru(n) for k, (c, t) in side.items()}
            assert freed["torch"] == freed["jax"]
        else:                                         # read-only lookups
            _same_match(side["torch"][1].match(toks), side["jax"][1].match(toks))
            assert side["torch"][1].probe(toks) == side["jax"][1].probe(toks)
        (cj, tj), (ct, tt) = side["jax"], side["torch"]
        assert tt.n_nodes == tj.n_nodes
        assert sorted(tt.all_pages()) == sorted(tj.all_pages())
        np.testing.assert_array_equal(ct.ref, cj.ref)
        assert ct._free == cj._free
        np.testing.assert_array_equal(ct.page_table, cj.page_table)
        ct.check_refs(tt.all_pages())
        stack = [tt.root]
        while stack:
            n = stack.pop()
            splits += int(not n.snap_ok and n is not tt.root and bool(n.children))
            heals += int(n.snap_ok and bool(n.children))
            stack.extend(n.children.values())
    assert splits > 0 and heals > 0
    for slot in list(live):
        for c, _ in side.values():
            c.release(slot)
    for c, t in side.values():
        t.evict_lru(c.n_pages + 1)
        c.check_refs(t.all_pages())
        assert t.all_pages() == [] and c.free_pages == c.n_pages - 1


def test_match_snaps_to_reuse_points_and_cow():
    """A 20-token prompt (ps 8) caches reuse points at 8, 16 and 20: an
    extension reuses 20 through a copy-on-write tail page, a duplicate
    snaps down to 16, a mid-page divergence to 16, a 9-token query to 8."""
    cfg = torch_config(_cfg("off"))
    cache = PagedKVCache(cfg, 1, max_len=32, page_size=8, n_pages=16, device="cpu")
    pc = PrefixCache(cache)
    toks = np.random.default_rng(0).integers(0, 50, 20).astype(np.int32)
    assert cache.allocate(0, 24)
    pc.insert(toks, [int(p) for p in cache.page_table[0, :3]], _snaps(20, 8, 1))
    hit = pc.match(np.concatenate([toks, [7, 8, 9]]))
    assert hit.reuse_len == 20 and len(hit.pages) == 3 and hit.cow_src == hit.pages[-1]
    assert pc.match(toks).reuse_len == 16 and pc.match(toks).cow_src is None
    div = toks.copy()
    div[18] += 1
    assert pc.match(div).reuse_len == 16
    assert pc.match(toks[:9]).reuse_len == 8
    assert cache.shared_floor(0) == 24 and cache.live_pages() == {0: list(
        int(p) for p in cache.page_table[0, :3])}


def test_copy_page_and_gather_slot():
    """``copy_page`` copies K and V of every layer in place;
    ``gather_slot`` and ``gather_views`` read a slot's logical view."""
    from repro_torch.serve.kv_cache import gather_views
    cfg = torch_config(_cfg("off"))
    cache = PagedKVCache(cfg, 2, max_len=16, page_size=8, device="cpu")
    g = torch.Generator().manual_seed(0)
    cache.k_pool.copy_(torch.randn(cache.k_pool.shape, generator=g))
    cache.v_pool.copy_(torch.randn(cache.v_pool.shape, generator=g))
    assert cache.allocate(0, 16) and cache.allocate(1, 9)
    src, dst = int(cache.page_table[0, 1]), int(cache.page_table[1, 1])
    k_ptr = cache.k_pool.data_ptr()
    cache.copy_page(dst, src)
    assert cache.k_pool.data_ptr() == k_ptr
    assert torch.equal(cache.k_pool[:, dst], cache.k_pool[:, src])
    assert torch.equal(cache.v_pool[:, dst], cache.v_pool[:, src])
    k0, v0 = cache.gather_slot(0)
    kv, vv = gather_views(cache.k_pool, cache.v_pool,
                          torch.as_tensor(cache.page_table))
    assert k0.shape == (cfg.num_layers, 16, cfg.num_kv_heads, cfg.resolved_head_dim())
    assert torch.equal(kv[:, 0], k0) and torch.equal(vv[:, 0], v0)
    assert torch.equal(kv[:, 1, 8:], k0[:, 8:])


# -- the engine -------------------------------------------------------------------

_MODELS = {}
_JAX = {}


def _model(mode):
    if mode not in _MODELS:
        cfg = _cfg(mode)
        _MODELS[mode] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return _MODELS[mode]


def _shared_prefix_prompts(vocab, n=3, shared_len=24, tail=8, seed=0):
    rnd = np.random.default_rng(seed)
    shared = rnd.integers(0, vocab, shared_len).astype(np.int32)
    return [np.concatenate([shared, rnd.integers(0, vocab, tail).astype(np.int32)])
            for _ in range(n)]


def _serve(side, mode, prompts, knobs, reqs=None, gap=8, driver=None):
    """Requests arriving ``gap`` steps apart (``reqs``: SamplingParams
    keywords each). Returns (tokens, ranks per step, engine, driver's
    result)."""
    cfg, tcfg, jparams, tparams = _model(mode)
    kn = {**KNOBS, **knobs}
    if side == "jax":
        eng = JaxEngine(cfg, jparams, config=JaxEngineConfig(**kn))
        S = JaxSamplingParams
    else:
        eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**kn))
        S = SamplingParams
    reqs = reqs or [{}] * len(prompts)
    hs = [eng.submit(p, S(**{"max_new": kn["max_new_cap"], **r}), arrival=gap * i)
          for i, (p, r) in enumerate(zip(prompts, reqs))]
    extra = driver(eng, hs) if driver else eng.run()
    return [h.result() for h in hs], eng.core.ranks_per_step(), eng, extra


PREFIX_STATS = ("prefix_hits", "prefix_misses", "prefix_reused_tokens", "prefix_cow",
                "prefix_evictions", "prefill_tokens", "steps", "decides")


def _check(mode, prompts, knobs, reqs=None, gap=8, cold=True):
    """The port with the prefix cache against JAX's with it (tokens, ranks,
    prefix stats) and against its own run without it (tokens); the
    refcount invariant over the tree's pages. Returns the port's engine."""
    key = (mode, repr(prompts), repr(sorted(knobs.items())), repr(reqs), gap)
    if key not in _JAX:
        jt, jr, je, _ = _serve("jax", mode, prompts, knobs, reqs, gap)
        _JAX[key] = (jt, jr, {k: je.stats[k] for k in PREFIX_STATS})
    jt, jr, js = _JAX[key]
    tt, tr, eng, _ = _serve("torch", mode, prompts, knobs, reqs, gap)
    for i, (a, b) in enumerate(zip(tt, jt)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} vs JAX")
    assert len(tr) == len(jr)
    for t, (a, b) in enumerate(zip(tr, jr)):
        np.testing.assert_array_equal(a, b, err_msg=f"step {t}")
    for k in PREFIX_STATS:
        assert eng.stats[k] == js[k], k
    if cold:
        ct, _, _, _ = _serve("torch", mode, prompts,
                             {**knobs, "prefix_cache": False}, reqs, gap)
        for i, (a, b) in enumerate(zip(tt, ct)):
            np.testing.assert_array_equal(a, b, err_msg=f"request {i} vs cold")
    core = eng.core
    core.cache.check_refs(core.prefix.all_pages())
    assert core.cache.free_pages == core.cache.n_pages - 1 - len(core.prefix.all_pages())
    return eng


CASES = ([(m, f, k) for m in ("adaptive", "fixed") for f in (False, True)
          for k in (False, True)] + [("off", False, False), ("off", False, True)])


@pytest.mark.parametrize("case", CASES, ids=["%s-factor%s-kernel%s" % c for c in CASES])
def test_prefix_hits_match_jax_and_cold(case):
    """Three prompts sharing a 24-token prefix, arrivals 8 steps apart: two
    hits reuse 24 tokens each; tokens equal JAX's and the cold run's."""
    mode, factor, use_kernel = case
    _, _, _, tparams = _model(mode)
    prompts = _shared_prefix_prompts(256, n=3)
    eng = _check(mode, prompts, dict(prefix_cache=True, use_kernel=use_kernel,
                                     factor_cache=factor if mode != "off" else None))
    s = eng.stats
    assert s["prefix_hits"] == 2 and s["prefix_misses"] == 1
    assert s["prefix_reused_tokens"] == 48
    assert s["prefill_tokens"] == sum(len(p) for p in prompts) - 48
    assert eng.prefix_probe(prompts[0]) == 24
    assert eng.prefix_probe(np.concatenate([prompts[0], [1]])) == 32


def test_prefix_cow_and_duplicate_match_jax():
    """A prompt, its extension (reuse at the prompt end, mid-page: the tail
    page is copied) and an exact duplicate (snaps down a page)."""
    rnd = np.random.default_rng(3)
    p1 = rnd.integers(0, 256, 20).astype(np.int32)
    prompts = [p1, np.concatenate([p1, rnd.integers(0, 256, 8).astype(np.int32)]),
               p1.copy()]
    eng = _check("adaptive", prompts, dict(prefix_cache=True))
    assert eng.stats["prefix_cow"] == 1
    assert eng.stats["prefix_reused_tokens"] == 20 + 16


def test_prefix_hit_on_recycled_slot_matches_jax():
    """One slot: each hit rides a slot whose previous occupant left its
    mass, factors and prompt behind."""
    prompts = _shared_prefix_prompts(256, n=3, seed=4)
    eng = _check("adaptive", prompts, dict(n_slots=1, prefix_cache=True, factor_cache=True))
    assert eng.stats["prefix_hits"] >= 1


def test_prefix_eviction_pressure_matches_jax():
    """No prefix headroom (``prefix_pages=0``), one slot, two alternating
    prefix families: LRU eviction frees pages for admissions; the hits
    that survive give cold tokens, refcounts stay exact."""
    rnd = np.random.default_rng(5)
    fams = [rnd.integers(0, 256, 16).astype(np.int32) for _ in range(2)]
    prompts = [np.concatenate([fams[f], rnd.integers(0, 256, 6).astype(np.int32)])
               for f in (0, 0, 1, 1, 0)]
    eng = _check("adaptive", prompts, dict(n_slots=1, max_len=32, max_new_cap=4,
                                           prefix_cache=True, prefix_pages=0), gap=0)
    assert eng.stats["prefix_evictions"] > 0 and eng.stats["prefix_hits"] >= 1


def test_prefix_sampled_streams_match_jax():
    """Seeded sampled streams draw identically from a hit or a cold
    prefill."""
    prompts = _shared_prefix_prompts(256, n=2, seed=6)
    reqs = [dict(temperature=0.7, top_k=12, seed=11 + i) for i in range(2)]
    eng = _check("adaptive", prompts, dict(prefix_cache=True, sampling=True), reqs)
    assert eng.stats["prefix_hits"] == 1


def test_prefix_hits_under_speculation_match_jax():
    """Speculative decode over prefix-hit admissions: drafts and rollbacks
    never write a shared page (the engine asserts the floor every step),
    tokens equal JAX's and the cold, plain run's."""
    prompts = _shared_prefix_prompts(256, n=3, seed=6)
    knobs = dict(n_slots=4, max_new_cap=12, prefix_cache=True, speculative=True,
                 draft_k=3, draft_rank_frac=0.5)
    eng = _check("adaptive", prompts, knobs, gap=10)
    plain, _, _, _ = _serve("torch", "adaptive", prompts, dict(n_slots=4, max_new_cap=12),
                            gap=10)
    for a, b in zip(eng.run().values(), plain):
        np.testing.assert_array_equal(a, b)
    assert eng.stats["prefix_hits"] == 2 and eng.stats["spec_steps"] > 0


def test_spec_prefix_prompts_ending_mid_page():
    """Speculation over prompts that end inside a page: the tree keeps each
    inserting slot's partly filled tail page, whose shared content ends at
    the prompt, and the slot decodes on past it. Tokens equal the cold,
    plain run's, a hit copies the tail page, and refcounts stay exact. The
    reference's floor check counts the whole tail page as shared, so its
    engine stops here with an AssertionError (ROADMAP, faults of the
    reference)."""
    rnd = np.random.default_rng(9)
    p0 = rnd.integers(0, 256, 20).astype(np.int32)
    prompts = [p0, np.concatenate([p0, rnd.integers(0, 256, 8).astype(np.int32)]),
               np.concatenate([p0[:13], rnd.integers(0, 256, 6).astype(np.int32)])]
    knobs = dict(n_slots=3, max_new_cap=12, prefix_cache=True, speculative=True,
                 draft_k=3, draft_rank_frac=0.5)
    tt, _, eng, _ = _serve("torch", "adaptive", prompts, knobs, gap=10)
    cold, _, _, _ = _serve("torch", "adaptive", prompts, dict(n_slots=3, max_new_cap=12),
                           gap=10)
    for i, (a, b) in enumerate(zip(tt, cold)):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i} vs cold")
    s = eng.stats
    assert s["prefix_hits"] == 2 and s["prefix_cow"] == 1 and s["spec_steps"] > 0
    eng.core.cache.check_refs(eng.core.prefix.all_pages())
    with pytest.raises(AssertionError, match="shared-page floor"):
        _serve("jax", "adaptive", prompts, knobs, gap=10)


def test_snapshots_keep_their_values():
    """A snapshot is taken off the mass pool, which later steps write in
    place: at the end of the run every snapshot the tree holds has the
    values it had when its prompt was inserted, while a view of the pool
    cells it was taken from has moved since; and the snapshots equal JAX's
    snapshots of the same prompts (1e-5)."""
    prompts = _shared_prefix_prompts(256, n=3, seed=2)
    taken = []

    def nodes(core):
        out, stack = [], [core.prefix.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def driver(eng, hs):
        core = eng.core
        if isinstance(eng, Engine):
            inner = core._insert_prefix

            def insert(i, st):
                snaps = dict(core._snaps.get(i, {}))
                inner(i, st)
                for n in nodes(core):
                    for p, m in snaps.items():
                        if n.snap_mass is m:
                            taken.append((n, m.clone(), core.cache.mass_pool[:, i, :p]))
            core._insert_prefix = insert
        eng.run()
        return {n.end: np.array(n.snap_mass) for n in nodes(core)
                if n.snap_mass is not None}

    knobs = dict(prefix_cache=True, factor_cache=True)
    _, _, _, jsnaps = _serve("jax", "adaptive", prompts, knobs, driver=driver)
    _, _, eng, tsnaps = _serve("torch", "adaptive", prompts, knobs, driver=driver)
    assert sorted(tsnaps) == sorted(jsnaps) and len(tsnaps) >= 4
    for end in tsnaps:
        np.testing.assert_allclose(tsnaps[end], jsnaps[end], atol=1e-5, rtol=1e-5)
    assert len(taken) >= 4
    for node, at_insert, view in taken:
        assert torch.equal(node.snap_mass, at_insert)
    assert any(not torch.equal(view, at_insert) for _, at_insert, view in taken)


def test_reset_clears_tree_and_validation():
    _, tcfg, _, tparams = _model("adaptive")
    with pytest.raises(ValueError, match="prefix_cache"):
        EngineConfig(prefill_chunk=None, prefix_cache=True)
    from repro_torch.serve.engine import ServeEngine
    with pytest.raises(ValueError, match="prefix_cache"):
        ServeEngine(tcfg, tparams, prefill_chunk=None, prefix_cache=True, device="cpu")
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(
        **{**KNOBS, "max_new_cap": 4}, prefix_cache=True))
    for i, p in enumerate(_shared_prefix_prompts(256, n=2, seed=7)):
        eng.submit(p, SamplingParams(max_new=4), arrival=8 * i)
    eng.run()
    core = eng.core
    assert core.prefix.n_nodes > 0 and eng.stats["prefix_hits"] == 1
    core.cache.check_refs(core.prefix.all_pages())
    eng.reset()
    assert eng.core.prefix.n_nodes == 0 and eng.core.prefix.all_pages() == []
    assert eng.core.prefix.cache is eng.core.cache
    assert eng.stats["prefix_hits"] == 0
    assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
    eng.core.cache.check_refs()


def test_submit_from_background_thread():
    """Requests submitted from another thread while the loop steps all
    finish with the tokens of an upfront submission, prefix hits
    included."""
    _, tcfg, _, tparams = _model("adaptive")
    prompts = _shared_prefix_prompts(256, n=4, seed=8)
    knobs = dict(KNOBS, max_new_cap=6, prefix_cache=True)
    ref = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**knobs))
    want = [ref.submit(p, SamplingParams(max_new=6)) for p in prompts]
    ref.run()
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**knobs))
    first = eng.submit(prompts[0], SamplingParams(max_new=6))
    rest = []

    def feeder():
        for p in prompts[1:]:
            rest.append(eng.submit(p, SamplingParams(max_new=6)))

    t = threading.Thread(target=feeder)
    t.start()
    while eng.step() or t.is_alive() or len(rest) < 3:
        pass
    t.join()
    eng.run()
    for h, w in zip([first] + rest, want):
        np.testing.assert_array_equal(h.result(), w.result())
    core = eng.core
    core.cache.check_refs(core.prefix.all_pages())
