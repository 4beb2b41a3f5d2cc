"""Seeded sampling of the port's engine against the JAX engine.

``_select_token`` alone, on (8, 50257) logits (drrl-paper's vocabulary)
with greedy, temperature, top-k (ties at the k-th value included), top-p
and top-k + top-p rows, each with its own seed and output position; then
end to end: the reduced drrl-paper model served by both engines
(``sampling=True, nucleus=True``) on ``benchmarks/serve_bench.py``'s mixed
staggered workload with two greedy, and temperature, top-k, top-p and
top-k + top-p requests, in rank modes 'adaptive' and 'random', chunked and
one-shot, ``use_kernel`` off and on.

Tokens must be IDENTICAL. The gumbel noise is bit for bit JAX's threefry
output except for its two ``log``s (XLA's and PyTorch's may differ by an
f32 ulp), so a sampled token may only differ where the top two values of
``scaled + gumbel`` lie within 1e-5 of each other; ``_select_token``'s test
prints that gap wherever a token differs, and no engine run has one.
``ranks_per_step()`` must be identical too.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from torch_parity import (build_workload, jax_and_torch_params,  # noqa: E402
                          torch_config)

pytestmark = pytest.mark.serve

GAP_TOL = 1e-5
KNOBS = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
             max_new_cap=12, prefill_chunk=8, sampling=True, nucleus=True)
WORKLOAD = build_workload(6, 12)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """threefry is ~110 small int64 launches per draw: intra-op threads only
    add synchronisation, and under parallel test workers they oversubscribe
    the cores. One thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
PARAMS = [dict(), dict(temperature=0.8, seed=11),
          dict(temperature=1.0, top_k=5, seed=12),
          dict(temperature=0.9, top_p=0.9, seed=13),
          dict(temperature=1.3, top_k=20, top_p=0.8, seed=2 ** 32 - 3),
          dict()]


def _selectors(nucleus=True, cap=64):
    """The two engines' ``_select_token`` on the same knobs."""
    eng = SimpleNamespace(sampling=True, nucleus=nucleus, top_k_cap=cap)
    return (lambda *a: JaxServeEngine._select_token(eng, *a),
            lambda *a: ServeEngine._select_token(eng, *a))


def _rows(V, seed):
    """(logits, out_pos, temps, topks, topps, seeds) for 8 rows."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((8, V)) * 3).astype(np.float32)
    # a tie straddling the top-k cut of row 2 (k = 5): the 4th..7th largest
    top = np.sort(logits[2])[::-1]
    logits[2, np.argsort(logits[2])[::-1][3:7]] = top[3]
    temps = np.array([0, 0.8, 1.0, 0.7, 1.3, 0.5, 2.0, 0], np.float32)
    topks = np.array([0, 0, 5, 0, 20, 1, 64, 3], np.int32)
    topps = np.array([1, 1, 1, 0.9, 0.8, 1, 0.5, 0.3], np.float32)
    seeds = np.array([0, 11, 12, 13, 2 ** 32 - 3, 5, 77, 1], np.uint32)
    pos = rng.integers(0, 200, 8).astype(np.int32)
    return logits, pos, temps, topks, topps, seeds


def _top_two_gap(logits, pos, temps, topks, topps, seeds, row):
    """Top-two gap of the reference's ``scaled + gumbel`` row before the
    nucleus cut (for the print of a differing token)."""
    V = logits.shape[1]
    lg = jnp.asarray(logits)
    kth = jax.lax.top_k(lg, 64)[0]
    thr = jnp.take_along_axis(kth, jnp.clip(jnp.asarray(topks) - 1, 0, 63)[:, None], 1)
    masked = jnp.where((jnp.asarray(topks)[:, None] > 0) & (lg < thr), -jnp.inf, lg)
    scaled = masked / jnp.maximum(jnp.asarray(temps), 1e-6)[:, None]
    key = jax.random.fold_in(jax.random.PRNGKey(seeds[row]), np.uint32(pos[row]))
    z = np.sort(np.asarray(scaled[row] + jax.random.gumbel(key, (V,))))
    return float(z[-1] - z[-2])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_select_token_matches_jax(seed):
    args = _rows(50257, seed)
    sel_j, sel_t = _selectors()
    want = np.asarray(sel_j(*(jnp.asarray(a) for a in args)))
    got = sel_t(*(torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
                  for a in args)).numpy()
    for row in np.nonzero(got != want)[0]:
        gap = _top_two_gap(*args, row)
        print(f"row {row}: port {got[row]}, JAX {want[row]}, top-two gap {gap:.3g}")
        assert gap < GAP_TOL
    logits, _, temps, topks, topps, _ = args
    # greedy rows are the plain argmax; top-k rows stay inside the top k
    assert (got[temps == 0] == logits[temps == 0].argmax(-1)).all()
    for row in np.nonzero((topks > 0) & (temps > 0))[0]:
        kth = np.sort(logits[row])[::-1][topks[row] - 1]
        assert logits[row, got[row]] >= kth


def test_top_p_draws_stay_in_the_nucleus():
    """Every top-p draw, over 64 output positions, lies in the smallest
    probability-sorted set whose mass reaches top_p."""
    logits, _, temps, topks, topps, seeds = _rows(4000, 9)
    _, sel_t = _selectors()
    lt = torch.from_numpy(logits)
    tt, kt, pt = map(torch.from_numpy, (temps, topks, topps))
    st = torch.from_numpy(seeds.astype(np.int64))
    rows = np.nonzero((topps < 1) & (temps > 0))[0]
    for p in range(64):
        tok = sel_t(lt, torch.full((8,), p), tt, kt, pt, st).numpy()
        for row in rows:
            x = logits[row].astype(np.float64)
            if topks[row] > 0:
                x = np.where(x < np.sort(x)[::-1][topks[row] - 1], -np.inf, x)
            pr = np.exp((x - x.max()) / temps[row])
            pr /= pr.sum()
            srt = np.sort(pr)[::-1]
            p_min = srt[np.searchsorted(np.cumsum(srt), topps[row])]
            assert pr[tok[row]] >= p_min * (1 - 1e-5)


@pytest.fixture(scope="module")
def models():
    out = {}
    for mode in ("adaptive", "random"):
        cfg = get_config("drrl-paper", reduced=True).with_(
            rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), segment_len=8))
        out[mode] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return out


def _serve(engine_cls, config_cls, params_cls, cfg, params, knobs, dev):
    eng = engine_cls(cfg, params, config=config_cls(**knobs), **dev)
    hs = [eng.submit(w["tokens"], params_cls(max_new=w["max_new"], **p),
                     arrival=w["arrival"]) for w, p in zip(WORKLOAD, PARAMS)]
    eng.warmup()
    eng.run()
    return [h.result() for h in hs], eng.core.ranks_per_step()


CASES = [(m, c, k) for m in ("adaptive", "random") for c in (8, None)
         for k in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=["%s-chunk%s-kernel%s" % c for c in CASES])
def test_sampled_serving_matches_jax(case, models):
    mode, chunk, use_kernel = case
    cfg, tcfg, jparams, tparams = models[mode]
    knobs = {**KNOBS, "prefill_chunk": chunk, "use_kernel": use_kernel}
    want, want_ranks = _serve(JaxEngine, JaxEngineConfig, JaxSamplingParams,
                              cfg, jparams, knobs, {})
    got, got_ranks = _serve(Engine, EngineConfig, SamplingParams, tcfg,
                            tparams, knobs, {"device": "cpu"})
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} diverged")
    assert len(got_ranks) == len(want_ranks)
    for t, (g, w) in enumerate(zip(got_ranks, want_ranks)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {t}")


def test_stream_is_a_function_of_its_request(models):
    """A sampled stream gives the same tokens alone as among other
    requests, and differs from the greedy one."""
    _, tcfg, _, tparams = models["adaptive"]
    together, _ = _serve(Engine, EngineConfig, SamplingParams, tcfg, tparams,
                         KNOBS, {"device": "cpu"})
    for i in (1, 3, 4):
        eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**KNOBS))
        w = WORKLOAD[i]
        alone = eng.submit(w["tokens"], SamplingParams(max_new=w["max_new"],
                                                       **PARAMS[i])).result()
        np.testing.assert_array_equal(alone, together[i])
        greedy = eng.submit(w["tokens"], SamplingParams(max_new=w["max_new"])).result()
        assert not np.array_equal(alone, greedy)


@pytest.mark.parametrize("knobs,params,match", [
    (dict(sampling=False, nucleus=False), dict(temperature=0.5), "sampling=False"),
    (dict(nucleus=False), dict(temperature=0.5, top_p=0.9), "nucleus=False"),
    (dict(top_k_cap=8), dict(temperature=0.5, top_k=9), "top_k_cap"),
])
def test_sampling_requests_are_validated(knobs, params, match, models):
    """As the JAX engine: sampled requests on a greedy engine, top-p on a
    nucleus=False engine and top-k over the cap fail at submit."""
    _, tcfg, _, tparams = models["adaptive"]
    eng = Engine(tcfg, tparams, device="cpu", config=EngineConfig(**{**KNOBS, **knobs}))
    with pytest.raises(ValueError, match=match):
        eng.submit(WORKLOAD[0]["tokens"], SamplingParams(max_new=4, **params))
    with pytest.raises(ValueError, match="nucleus"):
        Engine(tcfg, tparams, device="cpu",
               config=EngineConfig(**{**KNOBS, "sampling": False}))
