"""The serving policy's dataset, offline evaluation, checkpoints and
'learned' serving in the port, against the JAX package on the CPU. The
trace is JAX's own (reduced drrl-paper, adaptive, the four workload
scenarios), read by both packages:

* ``build_dataset``: features within 1e-5 (relative, 1e-6 absolute),
  masks and recorded actions equal, rewards and fidelities within 1e-6,
  and the oracle equal wherever the best feasible reward leads the next by
  more than 1e-5;
* ``greedy_actions`` and ``evaluate_policy`` from JAX's ``init_policy``
  params carried across (``convert.agent_from_jax``): equal actions,
  evaluations within 1e-6;
* ``CheckpointManager`` both ways (JAX saves, the port loads, and the
  reverse: equal leaves, bit for bit), ``load_policy`` of a JAX-written
  policy checkpoint gives the converted tree, and the reference's
  ``load_policy`` reads the port's;
* 'learned' serving from a loaded checkpoint: JAX's greedy tokens and
  ``ranks_per_step()``.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.core.drrl import feat_dims as jax_feat_dims  # noqa: E402
from repro.core.policy import init_policy as jax_init_policy  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import traces as jtraces  # noqa: E402
from repro.serve import workloads as jworkloads  # noqa: E402
from repro.train import serve_policy as jsp  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.convert import agent_from_jax  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import serve_policy as tsp  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

GRID = (4, 8, 12, 16)
CFG = get_config("drrl-paper", reduced=True).with_(
    rank=RankConfig(mode="adaptive", rank_grid=GRID, fixed_rank=16, segment_len=8))
LCFG = CFG.with_(rank=RankConfig(mode="learned", rank_grid=GRID, fixed_rank=16,
                                 segment_len=8))


def record_jax_trace(directory):
    """The reference test's workload suite through the JAX engine."""
    jparams, _ = jax_and_torch_params(CFG)
    rec = jtraces.TraceRecorder(directory, CFG, scenario="suite")
    for name in jworkloads.workload_names():
        spec = jworkloads.make_workload(name, seed=3, n_requests=4, max_new=10,
                                        vocab=CFG.vocab_size, max_prompt=40)
        eng = JaxServeEngine(CFG, jparams, n_slots=4, max_len=96, page_size=16,
                             segment_len=8, max_new_cap=10, prefill_chunk=8,
                             record_traces=rec, **spec.engine_overrides)
        for r in jworkloads.build(spec):
            eng.submit(r)
        eng.run()
    return rec.flush()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    record_jax_trace(d)
    return (d, jsp.build_dataset(d, CFG.rank),
            tsp.build_dataset(d, torch_config(CFG).rank, device="cpu"))


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_policy(seed, logit_scale=1.0):
    """JAX ``init_policy(PRNGKey(seed))`` for the grid, its logits head
    scaled by ``logit_scale`` (so that a fresh policy's choices spread over
    the grid), as numpy leaves."""
    p = jax_init_policy(jax.random.PRNGKey(seed), jax_feat_dims(CFG.rank),
                        len(GRID), **jsp.POLICY_ARCH)
    p = jax.device_get(p)
    p["head"]["w_logits"] = p["head"]["w_logits"] * logit_scale
    return p


FIELDS = ("feats", "mask_rows", "mask_rec", "actions", "reward_matrix", "fid",
          "oracle", "bookkeeping")


@pytest.mark.parametrize("field", FIELDS)
def test_build_dataset_matches_jax(datasets, field):
    _, dj, dt = datasets
    assert (dt["n"], dt["h"], dt["d"]) == (dj["n"], dj["h"], dj["d"])
    assert np.array_equal(np_(dt["grid"]), np_(dj["grid"]))
    if field == "feats":
        assert sorted(dt["feats"]) == sorted(dj["feats"])
        for k in dj["feats"]:
            np.testing.assert_allclose(np_(dt["feats"][k]), np_(dj["feats"][k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    elif field in ("mask_rows", "mask_rec", "actions"):
        assert np.array_equal(np_(dt[field]), np_(dj[field])), field
    elif field in ("reward_matrix", "fid"):
        np.testing.assert_allclose(np_(dt[field]), np_(dj[field]), rtol=0,
                                   atol=1e-6)
    elif field == "oracle":
        rew = np_(dj["reward_matrix"])
        grid = np_(dj["grid"])
        acts = np_(dj["actions"])
        feas = np_(dj["mask_rec"]) & (grid[None, :] <= grid[acts][:, None])
        feas[np.arange(len(acts)), acts] = True
        top2 = np.sort(np.where(feas, rew, -np.inf), axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-5
        assert clear.sum() > 0
        assert np.array_equal(np_(dt["oracle"])[clear], np_(dj["oracle"])[clear])
    else:
        assert np.array_equal(dt["rid"], dj["rid"])
        assert np.array_equal(dt["seg_t"], dj["seg_t"])
        wj, wt = jsp._windows(dj, 4), tsp._windows(dt, 4)
        assert np.array_equal(wj, wt)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_and_evaluate_match_jax(datasets, seed):
    _, dj, dt = datasets
    pj = jax_policy(seed, logit_scale=100.0)
    pt = agent_from_jax(pj, device="cpu")
    aj = np_(jsp.greedy_actions(pj, dj))
    at = np_(tsp.greedy_actions(pt, dt))
    assert np.array_equal(at, aj)
    ej = jsp.evaluate_policy(dj, CFG.rank, policy_params=pj)
    et = tsp.evaluate_policy(dt, torch_config(CFG).rank, policy_params=pt)
    assert et.keys() == ej.keys()
    for k in ej:
        assert abs(et[k] - ej[k]) <= 1e-6 * max(1.0, abs(ej[k])), k
    for acts in ("actions", "oracle"):
        ej = jsp.evaluate_policy(dj, CFG.rank, actions=dj[acts])
        et = tsp.evaluate_policy(dt, torch_config(CFG).rank, actions=dt[acts])
        for k in ej:
            assert abs(et[k] - ej[k]) <= 1e-6 * max(1.0, abs(ej[k])), (acts, k)


def _tree_equal(a, b):
    la, lb = tu.leaves_with_path(a), tu.leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


def test_checkpoint_jax_to_torch(tmp_path):
    pj = jax_policy(4)
    tree = {"policy": pj, "step": np.int32(7), "mixed": [np.arange(3, dtype=np.int64)]}
    mgr = JaxCheckpointManager(tmp_path, async_save=False, keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree, extra={"note": "jax"})
    port = CheckpointManager(tmp_path)
    assert port.all_steps() == [2, 3] and port.latest_step() == 3
    template = {"policy": agent_from_jax(pj, device="cpu"),
                "step": torch.zeros((), dtype=torch.int32),
                "mixed": [torch.zeros(3, dtype=torch.int64)]}
    got, step, extra = port.load(template)
    assert step == 3 and extra == {"note": "jax"}
    want = {"policy": agent_from_jax(pj, device="cpu"),
            "step": torch.tensor(7, dtype=torch.int32),
            "mixed": [torch.arange(3)]}
    _tree_equal(got, want)
    # onto a one-rank gloo host mesh: the same values (the leaves were saved
    # without specs, so they come back plain tensors on the mesh's device)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    own_group = not dist.is_initialized()
    try:
        got_m, step_m, _ = port.load(template, mesh=make_host_mesh("cpu"))
    finally:
        if own_group:      # leave the worker without the group it started
            dist.destroy_process_group()
    assert step_m == 3
    _tree_equal(got_m, want)


def test_checkpoint_torch_to_jax(tmp_path):
    pj = jax_policy(5)
    pt = agent_from_jax(pj, device="cpu")
    mgr = CheckpointManager(tmp_path, async_save=True, keep=1)
    mgr.save(4, pt, extra={"note": "torch"})
    mgr.save(9, pt, extra={"note": "torch"})
    mgr.wait()
    assert mgr.all_steps() == [9]
    tree, step, extra = JaxCheckpointManager(tmp_path).load(pj)
    assert step == 9 and extra == {"note": "torch"}
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    flat_t = jax.tree_util.tree_leaves_with_path(tree)
    for (pa, a), (pb, b) in zip(flat_j, flat_t):
        assert pa == pb and a.dtype == b.dtype and np.array_equal(a, b)
    manifest = json.loads((tmp_path / "step_9" / "manifest.json").read_text())
    assert "layers/0/wq" in manifest["leaves"] and "embed/h_t/w" in manifest["leaves"]


def _write_jax_policy(directory, pj):
    """A policy checkpoint as the reference's trainer writes it."""
    JaxCheckpointManager(directory, async_save=False, keep=2).save(30, pj)
    (directory / "policy_meta.json").write_text(json.dumps({
        "n_actions": len(GRID), "h_dim": 8, "arch": jsp.POLICY_ARCH,
        "rank_grid": list(GRID), "eval": {}}))


def test_load_policy_both_ways(tmp_path):
    pj = jax_policy(6, logit_scale=100.0)
    _write_jax_policy(tmp_path / "jax", pj)
    _tree_equal(tsp.load_policy(tmp_path / "jax", device="cpu"),
                agent_from_jax(pj, device="cpu"))
    pt = agent_from_jax(jax_policy(8), device="cpu")
    CheckpointManager(tmp_path / "torch", async_save=False).save(3, pt)
    (tmp_path / "torch" / "policy_meta.json").write_text(
        (tmp_path / "jax" / "policy_meta.json").read_text())
    back = jsp.load_policy(tmp_path / "torch")
    for a, b in zip(jax.tree_util.tree_leaves(back), tu.leaves(pt)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_policy_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="policy_meta"):
        tsp.load_policy(tmp_path, device="cpu")
    jtraces.TraceRecorder(tmp_path / "empty", CFG).flush()
    with pytest.raises(ValueError, match="empty"):
        tsp.build_dataset(tmp_path / "empty", torch_config(CFG).rank, device="cpu")
    with pytest.raises(ValueError, match="need policy_params"):
        tsp.evaluate_policy({}, torch_config(CFG).rank)
    with pytest.raises(ValueError, match="heads"):
        tsp._init(torch.Generator().manual_seed(0), {}, 4,
                  {**tsp.POLICY_ARCH, "n_heads": 2}, "cpu")


def test_learned_serving_from_checkpoint_matches_jax(tmp_path):
    """A JAX-written policy checkpoint, loaded by each package, serves in
    rank mode 'learned' with JAX's tokens and ranks."""
    jparams, tparams = jax_and_torch_params(LCFG)
    _write_jax_policy(tmp_path, jax_policy(6, logit_scale=100.0))
    pj = jsp.load_policy(tmp_path)
    pt = tsp.load_policy(tmp_path, device="cpu")
    rnd = np.random.default_rng(0)
    prompts = [rnd.integers(1, 256, int(n)).astype(np.int32) for n in (12, 30, 21)]
    runs = []
    for cls, req, cfg, params, pol, kw in (
            (JaxServeEngine, JaxRequest, LCFG, jparams, pj, {}),
            (ServeEngine, Request, torch_config(LCFG), tparams, pt,
             dict(device="cpu"))):
        eng = cls(cfg, params, pol, n_slots=2, max_len=64, page_size=16,
                  segment_len=8, max_new_cap=16, prefill_chunk=8, **kw)
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, tokens=p, max_new=16, arrival=3 * i))
        outs = eng.run()
        runs.append(([outs[i].tolist() for i in range(3)], eng.ranks_per_step()))
    (tj, rj), (tt, rt) = runs
    assert tt == tj
    assert len(rt) == len(rj) and all(np.array_equal(a, b) for a, b in zip(rt, rj))
    ranks = {int(r) for row in rt for r in row if r >= 0}
    assert len(ranks) > 1, ranks                # the policy's choices vary
