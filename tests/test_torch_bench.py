"""The port's paper tables and figures (``benchmarks/torch_*.py``) against
the reference's (``benchmarks/common.py``, ``fig4_flops_scaling.py``,
``fig5_perturbation.py`` and Table 3's loss) on the CPU, on the same
inputs: ``bench_cfg``, ``forward_dense(return_hidden=True)``, two steps of
``train_lm``, ``eval_ppl``, ``attn_flops_fraction``, Table 3's
``cls_loss`` and its gradients, Fig. 4's ``mean_rank`` and rows, Fig. 5's
heatmap, and the runner's ``--smoke`` canary.

The port's modules are fed the reference's inputs through monkeypatches:
JAX's ``SyntheticLM`` / ``SyntheticClassification`` batches
(``torch_parity.JaxBatches``), JAX's initial parameters (the modules'
``get_model(cfg).init`` returns them; the port's own init draws from a
``torch.Generator``), JAX's agent and power-iteration start vectors
(``drrl.power_starts``), and, for 'performer', JAX's feature matrices.

Tolerances (f32 on both sides):
  * the forward's hidden state and logits: 1e-5 absolute and relative;
  * ``train_lm``'s losses: 1e-5 relative. Its parameters: AdamW normalises
    each element's step, so an element whose gradient is near zero in the
    last bits can move by up to about lr more on one side: every element
    within 2 x the summed lr, and 99 % of each leaf's elements within 5e-5
    (``tests/test_torch_train_loop.py``'s rule for steps through ``eigh``);
  * ``eval_ppl``: 1e-5 relative;
  * ``attn_flops_fraction`` and Fig. 4's ``mean_rank``: 1e-6 relative (the
    ranks themselves equal); Fig. 4's rows exactly equal;
  * Table 3's nll and accuracy: 1e-5 relative; each gradient leaf 1e-5
    relative in the Frobenius norm, 1e-4 in rank mode 'fixed', whose
    gradients pass through ``eigh`` (``GRAD_TOL``);
  * Fig. 5's heatmaps: 1e-5 relative, plus the reference's rounding to 4
    decimals (5e-5 absolute) against its JSON; the trust-region mask equal.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import fig4_flops_scaling as jfig4  # noqa: E402
from benchmarks import fig5_perturbation as jfig5  # noqa: E402
from benchmarks import torch_common as tcommon  # noqa: E402
from benchmarks import torch_fig4_flops_scaling as tfig4  # noqa: E402
from benchmarks import torch_fig5_perturbation as tfig5  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks import torch_table3_downstream as ttable3  # noqa: E402
from repro import nn as jnn  # noqa: E402
from repro.core.baselines import orthogonal_proj  # noqa: E402
from repro.core.drrl import init_agent as jinit_agent  # noqa: E402
from repro.data.synthetic import SyntheticClassification as JCls  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.convert import agent_from_jax, params_from_jax, proj_from_jax  # noqa: E402
from repro_torch.core import drrl as tdrrl  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from torch_parity import (JaxBatches, jax_power_v0, torch_config,  # noqa: E402
                          torch_tree)

P99_TOL = 5e-5
# Table 3's gradients, per leaf, relative in the Frobenius norm; in rank mode
# 'fixed' they pass through eigh, whose backward divides by eigenvalue gaps
# (tests/test_torch_train_loop.py holds grad norms through it to 1e-4)
GRAD_TOL = {"off": 1e-5, "performer": 1e-5, "fixed": 1e-4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port here: the bench model gains
    nothing from more, and beside other test workers OpenMP's waiting
    threads slow it severalfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    """JAX's initial parameters and agent for ``bench_cfg`` (the rank mode
    does not enter either), as JAX trees and as the port's CPU tensors;
    both inits jitted, a third of their eager time."""
    cfg = jcommon.bench_cfg("drrl")
    pj = jax.jit(jget_model(cfg).init)(jax.random.PRNGKey(0))
    aj = jax.jit(lambda k: jinit_agent(k, cfg.rank, cfg.d_model))(jax.random.PRNGKey(7))
    return dict(pj=pj, pt=params_from_jax(jax.device_get(pj), device="cpu"), aj=aj,
                at=agent_from_jax(jax.device_get(aj), device="cpu"), v0=jax_power_v0(cfg))


@pytest.fixture(scope="module", autouse=True)
def bridge(ref):
    """The reference's inputs into the port's modules (module docstring);
    neither side writes its JSON artifacts."""
    mp = pytest.MonkeyPatch()

    def jax_lm(*a, **kw):
        return JaxBatches(JSyntheticLM(*a, **kw))

    def jax_init(get_model):
        def patched(cfg):
            fns = get_model(cfg)
            return fns._replace(init=lambda gen, device="cuda":
                                params_from_jax(jax.device_get(ref["pj"]), device))
        return patched

    for mod in (tcommon, tfig4, tfig5):
        mp.setattr(mod, "SyntheticLM", jax_lm)
    mp.setattr(ttable3, "SyntheticClassification",
               lambda *a, **kw: JaxBatches(JCls(*a, **kw)))
    mp.setattr(tcommon, "get_model", jax_init(tcommon.get_model))
    mp.setattr(tfig5, "get_model", jax_init(tfig5.get_model))
    mp.setattr(tdrrl, "power_starts",
               lambda p_attn: {k: v.to(p_attn[k].device) for k, v in ref["v0"].items()})
    for mod in (jfig4, jfig5, tfig4, tfig5):
        mp.setattr(mod, "save_json", lambda name, obj: None)
    yield
    mp.undo()


def _cfgs(mode):
    return jcommon.bench_cfg(mode), tcommon.bench_cfg(mode)


def _agents(ref, mode):
    return (ref["aj"], ref["at"]) if mode == "drrl" else (None, None)


def test_bench_cfg_matches_jax():
    for mode in ("off", "fixed", "adaptive", "random", "drrl", "performer", "nystrom"):
        jcfg, tcfg = _cfgs(mode)
        assert torch_config(jcfg) == tcfg, mode


def test_forward_return_hidden_matches_jax(ref):
    jcfg, tcfg = _cfgs("fixed")
    tokens = JSyntheticLM(jcfg.vocab_size, jcommon.BENCH_SEQ, 2, seed=5).batch_at(0)["tokens"]
    lj, aj = jtr.forward_dense(jcfg, ref["pj"], tokens, return_hidden=True)
    with torch.no_grad():
        lt, at = ttr.forward_dense(tcfg, ref["pt"], torch_tree(tokens),
                                   return_hidden=True)
        lt_plain, at_plain = ttr.forward_dense(tcfg, ref["pt"], torch_tree(tokens))
    assert "hidden" not in at_plain and torch.equal(lt_plain, lt)
    assert at["hidden"].shape == (2, jcommon.BENCH_SEQ, jcfg.d_model)
    np.testing.assert_allclose(at["hidden"].numpy(), np.asarray(aj["hidden"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["fixed", "random", "drrl"])
def test_train_lm_matches_jax(ref, mode):
    jcfg, tcfg = _cfgs(mode)
    aj, at = _agents(ref, mode)
    oj = jcommon.train_lm(jcfg, steps=2, agent=aj)
    ot = tcommon.train_lm(tcfg, steps=2, agent=at, device="cpu")
    np.testing.assert_allclose(ot["losses"], oj["losses"], rtol=1e-5)
    lr_sum = 2 * oj["tc"].lr
    flat_j = jax.tree_util.tree_flatten_with_path(oj["params"])[0]
    flat_t = tu.leaves_with_path(ot["params"])
    assert len(flat_j) == len(flat_t)
    for (path, j), (name, t) in zip(flat_j, flat_t):
        assert jax.tree_util.keystr(path).replace("']['", "/")[2:-2] == name
        d = np.abs(t.numpy() - np.asarray(j))
        assert d.max() <= 2 * lr_sum, (name, d.max())
        assert np.quantile(d, 0.99) <= P99_TOL, (name, np.quantile(d, 0.99))


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "random", "drrl"])
def test_eval_ppl_matches_jax(ref, mode):
    jcfg, tcfg = _cfgs(mode)
    aj, at = _agents(ref, mode)
    pj = jcommon.eval_ppl(jcfg, ref["pj"], jget_model(jcfg), agent=aj, n_batches=2)
    pt = tcommon.eval_ppl(tcfg, ref["pt"], tcommon.get_model(tcfg), agent=at,
                          n_batches=2)
    np.testing.assert_allclose(pt, pj, rtol=1e-5)


@pytest.mark.parametrize("mode", ["adaptive", "random", "drrl", "performer", "nystrom"])
def test_attn_flops_fraction_matches_jax(ref, mode):
    jcfg, tcfg = _cfgs(mode)
    aj, at = _agents(ref, mode)
    fj = jcommon.attn_flops_fraction(jcfg, ref["pj"], agent=aj)
    ft = tcommon.attn_flops_fraction(tcfg, ref["pt"], agent=at)
    assert 0.0 < ft <= 1.0
    np.testing.assert_allclose(ft, fj, rtol=1e-6)


def _jax_cls_loss(cfg, p, batch):
    """``benchmarks/table3_downstream.py:52-67`` (a closure there) in rank
    modes without a rank key."""
    _, aux = jtr.forward_dense(cfg, p["trunk"], batch["tokens"], return_hidden=True)
    pooled = jnp.mean(aux["hidden"].astype(jnp.float32), axis=1)
    cls = jnn.linear(pooled, p["head"].astype(pooled.dtype))
    labels = batch["labels"]
    logp = jax.nn.log_softmax(cls, -1)
    nll = -jnp.take_along_axis(logp, labels[:, None], -1)[:, 0]
    acc = jnp.mean((jnp.argmax(cls, -1) == labels).astype(jnp.float32))
    return jnp.mean(nll), acc


@pytest.mark.parametrize("mode", ["off", "fixed", "performer"])
def test_cls_loss_and_grads_match_jax(ref, mode):
    jcfg, tcfg = _cfgs(mode)
    head = jnn.dense_init(jax.random.PRNGKey(5), jcfg.d_model, 2)
    pj = {"trunk": ref["pj"], "head": head}
    batch = JCls(jcfg.vocab_size, ttable3.CLS_SEQ, jcommon.BENCH_BATCH, seed=4).batch_at(0)
    (nll_j, acc_j), gj = jax.jit(jax.value_and_grad(
        lambda p, b: _jax_cls_loss(jcfg, p, b), has_aux=True))(pj, batch)
    proj = None
    if mode == "performer":
        dh = jcfg.resolved_head_dim()
        proj = proj_from_jax(orthogonal_proj(jax.random.PRNGKey(42), jcfg.num_heads,
                                             max(2 * dh, 4 * jcfg.rank.fixed_rank), dh),
                             device="cpu")
    pt = params_from_jax(jax.device_get(pj), device="cpu")
    live = tu.tree_map(lambda x: x.requires_grad_(True), pt)
    nll_t, acc_t = ttable3.cls_loss(tcfg, live, torch_tree(batch), proj=proj)
    gt = torch.autograd.grad(nll_t, tu.leaves(live), allow_unused=True)
    gt = [torch.zeros_like(x) if g is None else g for x, g in zip(tu.leaves(live), gt)]
    np.testing.assert_allclose(nll_t.item(), float(nll_j), rtol=1e-5)
    np.testing.assert_allclose(acc_t.item(), float(acc_j), rtol=1e-5)
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    names = [name for name, _ in tu.leaves_with_path(pt)]
    assert len(flat_j) == len(gt) == len(names)
    for (path, j), name, t in zip(flat_j, names, gt):
        assert jax.tree_util.keystr(path).replace("']['", "/")[2:-2] == name
        j = np.asarray(j)
        assert np.linalg.norm(t.numpy() - j) <= GRAD_TOL[mode] * np.linalg.norm(j), name


def test_mean_rank_matches_jax(ref):
    jcfg, tcfg = _cfgs("adaptive")
    rj = jfig4.mean_rank(jcfg, ref["pj"], L_run=256)
    rt = tfig4.mean_rank(tcfg, ref["pt"], L_run=256)
    assert tcfg.rank.rank_grid[0] <= rt <= tcfg.rank.rank_grid[-1]
    np.testing.assert_allclose(rt, rj, rtol=1e-6)


def test_fig4_rows_match_jax(monkeypatch):
    """Fig. 4's rows and claim from a given mean rank: the reference's
    ``run`` and the port's, training and the probe replaced by the rank."""
    r_mean = 21.375
    for mod in (jfig4, tfig4):
        monkeypatch.setattr(mod, "train_lm", lambda cfg, **kw: {"params": None})
        monkeypatch.setattr(mod, "mean_rank", lambda cfg, params, L_run: r_mean)
    want = jfig4.run(quick=True)
    assert tfig4.run(quick=True, device="cpu") == want
    assert tfig4.flops_rows(tcommon.bench_cfg("adaptive"), r_mean) == want["rows"]


def test_fig5_heatmap_matches_jax(ref):
    want = jfig5.run(quick=True)
    _, tcfg = _cfgs("adaptive")
    got = tfig5.heatmap(tcfg, ref["pt"])
    for key in ("heatmap", "heatmap_rel"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=5e-5, err_msg=key)
    assert got["trust_region"].tolist() == want["trust_region"]
    out = tfig5.run(quick=True, device="cpu")
    assert out["grid"] == want["grid"] and out["trust_region"] == want["trust_region"]
    assert out["threshold_rel"] == pytest.approx(want["threshold_rel"], rel=1e-7)
    for key in ("heatmap", "heatmap_rel"):
        np.testing.assert_allclose(out[key], want[key], rtol=1e-5, atol=1e-4, err_msg=key)


def test_runner_names_unported_benchmarks():
    assert list(torch_run.NOT_PORTED) == ["serve"]
    with pytest.raises(SystemExit, match="item 15"):
        torch_run.main(["--only", "serve", "--device", "cpu"])


def test_runner_roofline_reads_dry_run_artifacts(tmp_path, monkeypatch, capsys):
    """``--only roofline`` on the artifacts of a reduced dry run (qwen2.5-14b's
    decode cell on the single production mesh); without artifacts it says so."""
    from benchmarks import torch_roofline
    from repro_torch.configs import SHAPE_CELLS
    from repro_torch.configs import get_config as tget_config
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch_roofline, "ART", tmp_path)
    torch_run.main(["--only", "roofline", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1].endswith(",no_dryrun_artifacts")
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, reduced=False: tget_config(arch, reduced=True))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert dryrun.run_cell("qwen2.5-14b", SHAPE_CELLS[2], "single", device="cpu")["ok"]
    finally:
        torch.set_num_threads(n)
    torch_run.main(["--only", "roofline", "--device", "cpu"])
    name, us, derived = capsys.readouterr().out.splitlines()[-1].split(",")
    assert name == "roofline" and float(us) > 0
    assert derived.startswith("cells=1;best=qwen2.5-14b/decode_32k@"), derived


def test_runner_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "benchmarks.torch_run", "--smoke",
                          "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived" and len(lines) == 2, lines
    name, us, derived = lines[1].split(",")
    fields = dict(kv.split("=") for kv in derived.split(";"))
    assert name == "smoke" and float(us) > 0 and fields["steps"] == "1"
    assert np.isfinite(float(fields["ppl"])) and 0 < float(fields["attn_flops_frac"]) <= 1
