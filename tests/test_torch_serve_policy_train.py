"""The serving policy's offline trainer (``train.serve_policy.
train_serve_policy``) against the JAX package's, on the CPU, on JAX's own
trace of the reference test's workload suite, from JAX's initial params
(``init_policy(PRNGKey(0))``, carried across by replacing the port
module's ``init_policy``):

* the pipeline at the reference test's settings (30 BC steps, 2 PPO
  steps of 1 epoch; nothing is sampled), run once in each package: every
  BC step's loss within 1e-5 relative, PPO losses within 1e-3, the
  snapshots' labels and the picked one equal, the heuristic's and the
  oracle's evaluations within 1e-6, the pick's reward and mean rank within
  1e-3, and the picked params within 2.5 x the peak lr of JAX's with 99 %
  of the elements within 1e-6 (AdamW's early steps move a leaf by about
  sign(g) * lr, so a gradient near 0 may move it the other way);
* each package's ``load_policy`` reads the other's checkpoint, and
  'learned' serving from the JAX-trained checkpoint gives JAX's tokens and
  ranks in the port.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.drrl import feat_dims as jax_feat_dims  # noqa: E402
from repro.core.policy import init_policy as jax_init_policy  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.train import serve_policy as jsp  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.convert import agent_from_jax  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import serve_policy as tsp  # noqa: E402
from test_torch_serve_policy import CFG, LCFG, record_jax_trace  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

LR = 3e-3


def _close_params(tj, tt, lr):
    worst, n_far, n = 0.0, 0, 0
    for a, b in zip(jax.tree_util.tree_leaves(tj), tu.leaves(tt)):
        diff = np.abs(np.asarray(a) - b.numpy())
        worst = max(worst, float(diff.max()))
        n_far += int((diff > 1e-6).sum())
        n += diff.size
    assert worst <= 2.5 * lr, worst
    assert n_far <= 0.01 * n, (n_far, n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The whole pipeline at the reference test's settings (30 BC steps, 2
    PPO steps of 1 epoch) in each package, from JAX's initial params, on
    JAX's trace: (jax params, jax history, torch params, torch history,
    out dir)."""
    root = tmp_path_factory.mktemp("policy")
    record_jax_trace(root / "trace")
    p0 = jax.device_get(jax_init_policy(jax.random.PRNGKey(0),
                                        jax_feat_dims(CFG.rank), 4,
                                        **jsp.POLICY_ARCH))
    kw = dict(bc_steps=30, ppo_steps=2, ppo_epochs=1, lr=LR)
    pj, hj = jsp.train_serve_policy(root / "trace", CFG.rank, out_dir=root / "jax", **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsp, "init_policy",
                   lambda gen, dims, n, **k: agent_from_jax(p0, k["device"]))
        pt, ht = tsp.train_serve_policy(root / "trace", torch_config(CFG).rank,
                                        out_dir=root / "torch", device="cpu", **kw)
    return pj, hj, pt, ht, root


def test_stages_match_jax(runs):
    """BC losses step for step, PPO losses, every snapshot's evaluation, the
    pick and its params."""
    pj, hj, pt, ht, _ = runs
    np.testing.assert_allclose(ht["bc_loss"], hj["bc_loss"], rtol=1e-5)
    for a, b in zip(ht["ppo"], hj["ppo"]):
        assert a.keys() == b.keys()
        for k in b:
            assert abs(a[k] - b[k]) <= 1e-3 * max(1.0, abs(b[k])), k
    ej, et = hj["eval"], ht["eval"]
    print("snapshots (label, reward, mean rank):",
          [(lab, ev["reward"], ev["mean_rank"]) for lab, ev in ht["candidates"]])
    assert [lab for lab, _ in ht["candidates"]] == ["bc@10", "bc@20", "bc@30",
                                                    "ppo@1", "ppo@2"]
    assert et["picked"] == ej["picked"] and et["n_records"] == ej["n_records"]
    for who in ("adaptive", "oracle"):
        for k in ej[who]:
            assert abs(et[who][k] - ej[who][k]) <= 1e-6 * max(1.0, abs(ej[who][k]))
    for k in ("reward", "mean_rank"):
        assert abs(et["learned"][k] - ej["learned"][k]) <= 1e-3 * max(
            1.0, abs(ej["learned"][k])), k
    _close_params(pj, pt, LR)


def test_checkpoints_and_learned_serving(runs):
    """Each package's ``load_policy`` reads the other's checkpoint; the
    JAX-trained policy serves in 'learned' with JAX's tokens and ranks."""
    pj, _, pt, _, root = runs
    from_jax = tsp.load_policy(root / "jax", device="cpu")
    for a, b in zip(jax.tree_util.tree_leaves(pj), tu.leaves(from_jax)):
        assert np.array_equal(np.asarray(a), b.numpy())
    from_torch = jsp.load_policy(root / "torch")
    for a, b in zip(jax.tree_util.tree_leaves(from_torch), tu.leaves(pt)):
        assert np.array_equal(np.asarray(a), b.numpy())

    jparams, tparams = jax_and_torch_params(LCFG)
    rnd = np.random.default_rng(1)
    prompts = [rnd.integers(1, 256, int(n)).astype(np.int32) for n in (14, 33, 20)]
    outs_ranks = []
    for cls, req, cfg, params, pol, ekw in (
            (JaxServeEngine, JaxRequest, LCFG, jparams, jsp.load_policy(root / "jax"), {}),
            (ServeEngine, Request, torch_config(LCFG), tparams, from_jax,
             dict(device="cpu"))):
        eng = cls(cfg, params, pol, n_slots=2, max_len=64, page_size=16,
                  segment_len=8, max_new_cap=12, prefill_chunk=8, **ekw)
        for i, p in enumerate(prompts):
            eng.submit(req(rid=i, tokens=p, max_new=12, arrival=2 * i))
        outs = eng.run()
        outs_ranks.append(([outs[i].tolist() for i in range(3)], eng.ranks_per_step()))
    (tj, rj), (tt, rt) = outs_ranks
    assert tt == tj
    assert len(rt) == len(rj) and all(np.array_equal(a, b) for a, b in zip(rt, rj))
