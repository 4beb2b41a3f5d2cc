"""The port's distribution layer on four gloo ranks of the CPU, against JAX
and against the port's one-process runs: ring attention on a 4-ring
(causal and not) and the 4-stage pipeline against JAX (``flash_ref``, the
stages applied in turn); the sharded training step on a 2 x 2
("data", "model") mesh (reduced drrl-paper in rank modes 'drrl' and
'random', reduced granite at capacity factor 0.5 with the MoE auxiliary
loss and a loss mask of uneven rows, once more with two bf16-accumulated
microbatches, once on a (pod 2, data 2, model 1) mesh, and once with
remat 'dots', each layer checkpointed inside the sharded step), 2 steps each,
against the one-process step on the global batch and against JAX's
``make_train_step``; a JAX-saved checkpoint loaded onto 2 x 2, (4, 1) and
a ("data",) mesh, and a port save from 2 x 2 loaded by JAX; the training
CLI on the group's (4, 1) host mesh (granite, 3 steps with checkpoints,
then resumed to 4; and the one-process run's checkpoint resumed on the
mesh) against the same CLI runs in one process.

One process group serves the module: ``torch.multiprocessing`` starts four
ranks on ``tests/torch_dist_worker.py`` (no JAX import) over a
``file://`` store in the run's directory; the JAX side runs here on the
same numpy inputs and JAX-initialised params.

Tolerances:
  * ring attention and the pipeline: 1e-5 absolute (f32 on both sides);
  * the sharded step against the one-process step: the same f32 ops on
    the same rows, summed over the data ranks in another order: loss and
    grad norm 1e-6 relative; parameters: AdamW normalises each element's
    step, so an element whose gradient is near zero in the last bits can
    move by up to about lr more or less on one side: every element within
    2 x the summed lr, 99 % of each leaf's elements within 1e-6;
  * against JAX: ``tests/test_torch_train_loop.py``'s ``TOL`` ('off' for
    granite);
  * checkpoints: bitwise.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import torch_dist_worker as W  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MoEConfig, RankConfig, TrainConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.kernels.ref import flash_ref  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from torch_parity import (jax_and_torch_agent, jax_power_v0,  # noqa: E402
                          torch_tree)
from test_torch_train_loop import TOL  # noqa: E402

RANK_TIMEOUT_S = 240


class FakeMesh:
    """Duck-typed mesh (``tests/test_dist_units.py``)."""

    def __init__(self, **sizes):
        self._sizes = dict(sizes)

    @property
    def shape(self):
        return dict(self._sizes)

    @property
    def axis_names(self):
        return tuple(self._sizes)


def jax_config(case):
    """JAX's config of a sharded-step case (``torch_dist_worker.case_config``)."""
    if case in ("drrl", "random"):
        cfg = jget_config("drrl-paper", reduced=True)
        if case == "random":
            cfg = cfg.with_(rank=RankConfig(mode="random", rank_grid=(4, 8, 12, 16),
                                            fixed_rank=8))
        return cfg
    return jget_config("granite-moe-3b-a800m", reduced=True).with_(
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, capacity_factor=0.5),
        remat="dots" if case == "granite_dots" else "none")


def jax_loss_fn(case, cfg, agent):
    fns = jget_model(cfg)
    if case == "drrl":
        return lambda p, b, r: fns.loss(p, b, rank_rng=r, policy_params=agent)
    if case == "random":
        return lambda p, b, r: fns.loss(p, b, rank_rng=r)
    return lambda p, b, r: fns.loss(p, b, collect_aux="ranks")


def _spawn(root):
    ctx = mp.start_processes(W.main, args=(root,), nprocs=W.WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran past {RANK_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    outs = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(W.WORLD)]
    for r, o in enumerate(outs):
        assert "error" not in o, f"rank {r}:\n{o['error']}"
    return outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The inputs, JAX's params and checkpoint, then the four ranks' run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("dist"))
    rng = np.random.default_rng(0)
    ring = [rng.standard_normal((2, 64, 2, 16)).astype(np.float32) for _ in range(3)]
    pipe_params = {"w": (rng.standard_normal((W.WORLD, 8, 8)) * 0.5).astype(np.float32),
                   "b": (rng.standard_normal((W.WORLD, 8)) * 0.1).astype(np.float32)}
    pipe_x = rng.standard_normal((6, 3, 8)).astype(np.float32)

    jcfgs = {c: jax_config(c) for c in W.STEP_CASES}
    pj = {"drrl": jax.jit(jget_model(jcfgs["drrl"]).init)(jax.random.PRNGKey(0)),
          "granite": jax.jit(jget_model(jcfgs["granite"]).init)(jax.random.PRNGKey(0))}
    pj = {c: pj["drrl" if c in ("drrl", "random") else "granite"] for c in W.STEP_CASES}
    aj, at = jax_and_torch_agent(jcfgs["drrl"])
    batches = {c: [SyntheticLM(jcfgs[c].vocab_size, W.SEQ, W.BATCH, seed=0).batch_at(i)
                   for i in range(W.STEPS)] for c in W.STEP_CASES}
    # granite's loss masks a different share of each row's tokens, so the
    # masked mean is a global one and not a mean of the data ranks' means
    keep = np.array([0.9, 0.3, 0.6, 0.8])[:, None]
    for c in ("granite", "granite_mb2", "granite_pod", "granite_dots"):
        batches[c] = [dict(b, mask=jnp.asarray(
            (rng.random((W.BATCH, W.SEQ)) < keep).astype(np.float32))) for b in batches[c]]

    jax_ckpt = os.path.join(root, "jax_ckpt")
    jspecs = jshd.param_pspecs(pj["granite"], jcfgs["granite"], FakeMesh(data=2, model=2))
    mgr = JCheckpointManager(jax_ckpt, async_save=False)
    mgr.save(3, pj["granite"], jspecs, extra={"note": "jax"})

    inputs = {
        "ring": [torch.from_numpy(x) for x in ring],
        "pipe_params": {k: torch.from_numpy(v) for k, v in pipe_params.items()},
        "pipe_x": torch.from_numpy(pipe_x),
        "params": {c: params_from_jax(jax.device_get(pj[c]), device="cpu")
                   for c in W.STEP_CASES},
        "batches": {c: [torch_tree(b) for b in batches[c]] for c in W.STEP_CASES},
        "extras": {"agent": at, "power_v0": jax_power_v0(jcfgs["drrl"])},
        "jax_ckpt": jax_ckpt,
    }
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    # the one-process CLI's 3 steps, whose checkpoint the ranks resume
    from repro_torch.launch import train
    cli = [train.main(W.CLI_ARGS + ["--steps", "3", "--ckpt-dir",
                                    os.path.join(root, "cli_one")])["history"]]
    outs = _spawn(root)
    yield dict(root=root, outs=outs, inputs=inputs, ring=ring, pipe_params=pipe_params,
               pipe_x=pipe_x, jcfgs=jcfgs, pj=pj, aj=aj, batches=batches,
               jax_ckpt=jax_ckpt, jspecs=jspecs, cli=cli)
    torch.set_num_threads(n)


# --------------------------------------------------------- ring, pipeline

@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_jax(run, causal):
    got = torch.cat([o["ring"][causal] for o in run["outs"]], dim=1).numpy()
    q, k, v = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)) for x in run["ring"])
    want = np.asarray(jnp.transpose(flash_ref(q, k, v, scale=16 ** -0.5, causal=causal),
                                    (0, 2, 1, 3)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pipeline_matches_jax(run):
    outs = [o["pipeline"].numpy() for o in run["outs"]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    p, ref = run["pipe_params"], jnp.asarray(run["pipe_x"])
    for i in range(W.WORLD):
        ref = jnp.tanh(ref @ p["w"][i] + p["b"][i])
    np.testing.assert_allclose(outs[0], np.asarray(ref), atol=1e-5, rtol=0)


# ------------------------------------------------------ the sharded step

def _params_close(got, want, lr_sum, p99):
    fg, fw = tu.leaves_with_path(got), tu.leaves_with_path(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (name, g), (_, w) in zip(fg, fw):
        d = np.abs(np.asarray(g, np.float64) - np.asarray(w, np.float64)).ravel()
        assert d.max() <= 2 * lr_sum, (name, d.max())
        assert np.quantile(d, 0.99) <= p99, (name, np.quantile(d, 0.99))


@pytest.mark.parametrize("case", W.STEP_CASES)
def test_sharded_step_matches_one_process(run, case):
    """Every rank's history and whole params equal the one-process step's
    on the global batch; granite's fsdp_tp specs shard its matrices."""
    inp = run["inputs"]
    hist, full, _ = W.run_steps(case, inp["params"][case], inp["batches"][case],
                                inp["extras"])
    for o in run["outs"]:
        h_d, full_d, placements = o["steps"][case]
        for a, b in zip(h_d, hist):
            for k, tol in (("loss", 1e-6), ("grad_norm", 1e-6), ("lr", 0.0)):
                assert abs(a[k] - b[k]) <= tol * abs(b[k]), (case, k, h_d, hist)
        _params_close(tu.tree_map(lambda x: x.numpy(), full_d),
                      tu.tree_map(lambda x: x.numpy(), full),
                      sum(h["lr"] for h in hist), 1e-6)
        if case == "granite_pod":          # (pod, data, model) = (2, 2, 1)
            assert placements["layers/attn/wq"] == (("S", 1), ("S", 1), ("S", 2))
            assert placements["layers/moe/w_gate"] == (("S", 2), ("S", 2), ("S", 1))
        elif case.startswith("granite"):
            assert placements["layers/attn/wq"] == (("S", 1), ("S", 2)), placements
            assert placements["layers/moe/w_gate"] == (("S", 2), ("S", 1)), placements
            assert placements["ln_f"] == (("R",), ("R",))
        else:                                   # drrl-paper's sharding is 'dp'
            assert all(c == (("R",), ("R",)) for c in placements.values()), placements


@pytest.mark.parametrize("case", W.STEP_CASES)
def test_sharded_step_matches_jax(run, case):
    cfg = run["jcfgs"][case]
    tc = TrainConfig(**W.case_train_config(case))
    step = jax.jit(jloop.make_train_step(cfg, tc, jax_loss_fn(case, cfg, run["aj"])))
    p, s = run["pj"][case], jadamw.init(run["pj"][case])
    hist = []
    for i in range(W.STEPS):
        p, s, m = step(p, s, run["batches"][case][i],
                       jax.random.fold_in(jax.random.PRNGKey(0), i))
        hist.append({k: float(v) for k, v in m.items()})
    mode = {"drrl": "drrl", "random": "random"}.get(case, "off")
    h_d, full_d, _ = run["outs"][0]["steps"][case]
    for a, b in zip(h_d, hist):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=TOL[mode][k], err_msg=k)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=1e-6)
    want = params_from_jax(jax.device_get(p), device="cpu")
    _params_close(tu.tree_map(lambda x: x.numpy(), full_d),
                  tu.tree_map(lambda x: x.numpy(), want),
                  sum(h["lr"] for h in hist), TOL[mode]["p99"])


def test_granite_capacity_drops_pairs(run, monkeypatch):
    """At capacity factor 0.5 the global batch's routing overflows: the
    (token, expert) pairs past an expert's capacity are dropped in each
    MoE layer of the steps above (the port's routing of the first batch,
    one process)."""
    from repro_torch.models import moe
    seen = []
    route = moe.route

    def recording(cfg, p, xf):
        out = route(cfg, p, xf)
        seen.append(out[1])
        return out
    monkeypatch.setattr(moe, "route", recording)
    cfg = W.case_config("granite")
    get_model(cfg).loss(run["inputs"]["params"]["granite"],
                        run["inputs"]["batches"]["granite"][0])
    T = W.BATCH * W.SEQ
    C = max(int(T * cfg.moe.top_k / cfg.moe.num_experts * cfg.moe.capacity_factor), 1)
    assert len(seen) == cfg.num_layers
    for idx in seen:
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
        assert idx.shape[0] == T
        assert (counts - C).clamp_min(0).sum() > 0, (counts, C)


# ------------------------------------------------------------- checkpoints

def _expected_placements(spec, names):
    """The placements a stored spec resolves to on a mesh of ``names``
    (axes it lacks dropped): ('S', dim) on each mesh dim a tensor dim
    names, ('R',) elsewhere."""
    out = []
    for m in names:
        dims = [i for i, e in enumerate(spec)
                if m == e or (isinstance(e, list) and m in e)]
        out.append(("S", dims[0]) if dims else ("R",))
    return tuple(out)


@pytest.mark.parametrize("mesh", ["2x2", "4x1", "data"])
def test_jax_checkpoint_loads_onto_mesh(run, mesh):
    names = ("data",) if mesh == "data" else ("data", "model")
    manifest = json.loads(open(os.path.join(run["jax_ckpt"], "step_3",
                                            "manifest.json")).read())
    stored = {k: v["spec"] for k, v in manifest["leaves"].items()}
    assert any("model" in json.dumps(s) for s in stored.values())
    for o in run["outs"]:
        got = o["loads"][mesh]
        assert got["step"] == 3
        assert got["placements"] == {k: _expected_placements(s, names)
                                     for k, s in stored.items()}
        for path, arr in jax.tree_util.tree_flatten_with_path(run["pj"]["granite"])[0]:
            name = jshd.path_str(path)
            np.testing.assert_array_equal(got["values"][name].numpy(), np.asarray(arr),
                                          err_msg=name)


def test_port_sharded_save_loads_in_jax(run):
    assert all(o["save"]["n_steps"] == 1 for o in run["outs"])
    d = os.path.join(run["root"], "port_ckpt")
    tree, step, extra = JCheckpointManager(d).load(run["pj"]["granite"])
    assert step == 5 and extra == {"note": "port"}
    want = jax.tree_util.tree_leaves(run["pj"]["granite"])
    for a, b in zip(jax.tree_util.tree_leaves(tree), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    manifest = json.loads(open(os.path.join(d, "step_5", "manifest.json")).read())
    jspecs = jax.tree_util.tree_flatten_with_path(
        run["jspecs"], is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in jspecs:
        got = manifest["leaves"][jshd.path_str(path)]["spec"]
        assert got == [list(a) if isinstance(a, tuple) else a for a in spec], path


def test_training_cli_on_the_group_matches_one_process(run):
    """``launch.train.main`` on four ranks trains with params placed by the
    specs, checkpoints them and resumes onto the mesh, from its own
    checkpoint and from the one-process run's (whose AdamW moments carry no
    spec); its losses, grad norms and params equal one process's CLI runs
    (3 steps, then resumed to 4)."""
    from repro_torch.launch import train
    res = train.main(W.CLI_ARGS + ["--steps", "4", "--ckpt-dir",
                                   os.path.join(run["root"], "cli_one")])
    hist = run["cli"] + [res["history"]]
    assert [[h["step"] for h in hs] for hs in hist] == [[0, 2], [3]]   # logged steps
    lr_sum = sum(h["lr"] for h in sum(hist, []))
    for o in run["outs"]:
        for got, want in ((o["cli"], hist), (o["cli_elastic"], hist[1:])):
            assert got["placed"] and "[ckpt] resumed from step 3" in got["text"]
            assert [[h["step"] for h in hs] for hs in got["history"]] == [
                [h["step"] for h in hs] for hs in want]
            for a, b in zip(sum(got["history"], []), sum(want, [])):
                for k in ("loss", "grad_norm"):
                    assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k]), (k, got["history"], want)
            _params_close(tu.tree_map(lambda x: x.numpy(), got["params"]),
                          tu.tree_map(lambda x: x.numpy(), res["params"]), lr_sum, 1e-6)
