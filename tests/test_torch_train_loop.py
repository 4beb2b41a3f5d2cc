"""The port's LM training stack against the JAX package: ``make_train_step``
(one batch or two microbatches, f32 or bf16 error-feedback accumulation;
rank modes 'off' and 'drrl', the agent carried across), ``run_training``
(its rank keys against JAX's in rank mode 'random', and a resumed run
against an uninterrupted one) and the training CLI with a resume, on
reduced drrl-paper at seq 32, batch 4, on JAX's own ``SyntheticLM``
batches and JAX-initialised parameters.

Tolerances (f32 on both sides; the step differs only in summation order
and in the two LAPACK eigensolvers' last bits):
  * lr: 1e-6 relative (one f32 schedule);
  * loss and grad norm: 1e-6 / 3e-6 relative in rank mode 'off'; in
    'drrl' and 'random' 2e-5 / 1e-4, since gradients pass through ``eigh``
    (JAX's and torch's backward rules divide by eigenvalue gaps) and the
    later steps start from parameters that already differ (below);
  * parameters: AdamW normalises each element's step, so an element whose
    gradient is near zero in the last bits can move by up to about lr more
    or less on one side than on the other: every element within
    2 x lr x steps, and 99 % of each leaf's elements within 1e-6 ('off')
    or 5e-5 ('drrl', 'random');
  * a resumed run equals an uninterrupted one at the reference's
    atol = rtol = 1e-6 (tests/test_system.py).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig, TrainConfig  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import forward_dense  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import loop as tloop  # noqa: E402
from repro_torch.train.rl import value_and_grad  # noqa: E402
from torch_parity import (JaxBatches, jax_and_torch_agent,  # noqa: E402
                          jax_and_torch_params, jax_power_v0, torch_config)

SEQ, BATCH, STEPS, LR = 32, 4, 3, 1e-2
TOL = {"off": dict(loss=1e-6, grad_norm=3e-6, p99=1e-6),
       "drrl": dict(loss=2e-5, grad_norm=1e-4, p99=5e-5),
       "random": dict(loss=2e-5, grad_norm=1e-4, p99=5e-5)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port here: the reduced model gains
    nothing from more, and beside other test workers OpenMP's waiting
    threads slow this file about threefold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mode, remat="none"):
    cfg = get_config("drrl-paper", reduced=True).with_(remat=remat)  # rank mode 'drrl'
    if mode == "drrl":
        return cfg
    return cfg.with_(rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16),
                                     fixed_rank=8))


@pytest.fixture(scope="module")
def setup():
    """JAX and port params (shared by every rank mode: the rank config does
    not enter init), the agent, w_t's start vectors and the batches."""
    cfg = _cfg("drrl")
    pj, pt = jax_and_torch_params(cfg)
    aj, at = jax_and_torch_agent(cfg)
    data = JSyntheticLM(cfg.vocab_size, SEQ, BATCH, seed=0)
    return dict(pj=pj, pt=pt, aj=aj, at=at, v0=jax_power_v0(cfg), data=data,
                tdata=JaxBatches(data))


def _loss_fns(mode, s, remat="none"):
    """(JAX loss_fn, port loss_fn) of ``mode``: 'drrl' passes the agent
    (and, on the port's side, JAX's power-iteration start vectors), and
    'drrl' / 'random' the step's rank key, as the launchers do."""
    cfg = _cfg(mode, remat)
    fj, ft = jget_model(cfg), get_model(torch_config(cfg))
    kj, kt = {}, {}
    if mode == "drrl":
        kj, kt = {"policy_params": s["aj"]}, {"policy_params": s["at"],
                                               "power_v0": s["v0"]}

    def lj(p, b, rng):
        return fj.loss(p, b, **({"rank_rng": rng, **kj} if mode != "off" else {}))

    def lt(p, b, rng):
        return ft.loss(p, b, **({"rank_rng": rng, **kt} if mode != "off" else {}))
    return lj, lt


def _tcs(**kw):
    kw = dict(global_batch=BATCH, seq_len=SEQ, lr=LR, warmup_steps=1,
              total_steps=STEPS, **kw)
    return TrainConfig(**kw), TTrainConfig(**kw)


def _metrics_close(mt, mj, mode):
    for name, rtol in (("loss", TOL[mode]["loss"]),
                       ("grad_norm", TOL[mode]["grad_norm"]), ("lr", 1e-6)):
        np.testing.assert_allclose(float(mt[name]), float(mj[name]), rtol=rtol,
                                   err_msg=name)


def _params_close(pt, pj, mode, lr_sum):
    flat_j = jax.tree_util.tree_flatten_with_path(pj)[0]
    flat_t = tu.leaves_with_path(pt)
    assert len(flat_j) == len(flat_t)
    for (path, j), (name, t) in zip(flat_j, flat_t):
        assert jax.tree_util.keystr(path).replace("']['", "/")[2:-2] == name
        d = np.abs(t.numpy() - np.asarray(j))
        assert d.max() <= 2 * lr_sum, (name, d.max())
        assert np.quantile(d, 0.99) <= TOL[mode]["p99"], (name, np.quantile(d, 0.99))


STEP_CASES = [("off", 1, "none", "none"), ("off", 1, "bf16", "none"),
              ("off", 2, "none", "none"), ("off", 2, "bf16", "none"),
              ("drrl", 1, "none", "none"), ("drrl", 2, "bf16", "none"),
              ("drrl", 1, "none", "dots"), ("drrl", 1, "none", "full")]


@pytest.mark.parametrize("mode,microbatches,compression,remat", STEP_CASES,
                         ids=["-".join(map(str, c[:3])) + ("" if c[3] == "none" else
                                                           f"-remat_{c[3]}")
                              for c in STEP_CASES])
def test_train_step_matches_jax(setup, mode, microbatches, compression, remat):
    """Three steps of make_train_step on both sides; with ``remat`` both
    sides checkpoint each layer (JAX's jax.checkpoint, the port's
    remat_layer) and are held to the same tolerances."""
    s = setup
    tcj, tct = _tcs(microbatches=microbatches, grad_compression=compression)
    lj, lt = _loss_fns(mode, s, remat)
    cfg = _cfg(mode, remat)
    step_j = jax.jit(jloop.make_train_step(cfg, tcj, lj))
    step_t = tloop.make_train_step(torch_config(cfg), tct, lt)
    pj, sj = s["pj"], jadamw.init(s["pj"])
    pt, st = s["pt"], tadamw.init(s["pt"])
    key_j, key_t = jax.random.PRNGKey(0), prng.key(0)
    lr_sum = 0.0
    for i in range(STEPS):
        pj, sj, mj = step_j(pj, sj, s["data"].batch_at(i), jax.random.fold_in(key_j, i))
        pt, st, mt = step_t(pt, st, s["tdata"].batch_at(i), prng.fold_in(key_t, i))
        assert set(mt) == set(mj) == {"loss", "grad_norm", "lr"}
        _metrics_close(mt, mj, mode)
        lr_sum += float(mj["lr"])
    assert int(st.step) == int(sj.step) == STEPS
    _params_close(pt, pj, mode, lr_sum)


def test_bf16_accumulation_matches_jax():
    """Error-feedback bf16 accumulation on a linear loss whose microbatch
    gradients are the rows of x (64 values of mixed magnitudes, 4
    microbatches): the grad norm equals JAX's to 1e-6 relative, and
    differs from the plain f32 sum's by far more (each bf16 rounding
    moves a value by up to 2^-9 of it)."""
    import jax.numpy as jnp
    x = (np.random.default_rng(0).normal(size=(4, 64))
         * np.logspace(-3, 1, 64)).astype(np.float32)
    norms = {}
    for compression in ("bf16", "none"):
        tcj, tct = _tcs(microbatches=4, grad_compression=compression,
                        grad_clip=1e9, weight_decay=0.0)
        step_j = jloop.make_train_step(None, tcj, lambda p, b, r: (
            jnp.sum(p["w"] * b["x"]), {}))
        step_t = tloop.make_train_step(None, tct, lambda p, b, r: (
            (p["w"] * b["x"]).sum(), {}))
        wj, wt = {"w": jnp.zeros(64)}, {"w": torch.zeros(64)}
        _, _, mj = step_j(wj, jadamw.init(wj), {"x": jnp.asarray(x)}, None)
        _, _, mt = step_t(wt, tadamw.init(wt), {"x": torch.from_numpy(x)}, None)
        np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                                   rtol=1e-6)
        norms[compression] = float(mt["grad_norm"])
    assert abs(norms["bf16"] / norms["none"] - 1) > 1e-5, norms


def test_run_training_rank_keys_match_jax(setup):
    """Rank mode 'random' draws each layer's ranks from the step's key:
    run_training's fold_in(key(seed), step) must give JAX's losses."""
    s = setup
    cfg = _cfg("random")
    tcj, tct = _tcs(log_every=1, checkpoint_every=0)
    lj, lt = _loss_fns("random", s)
    out_j = jloop.run_training(cfg, tcj, init_fn=lambda rng: s["pj"], loss_fn=lj,
                               data=s["data"])
    out_t = tloop.run_training(torch_config(cfg), tct,
                               init_fn=lambda gen, device: s["pt"], loss_fn=lt,
                               data=s["tdata"], device="cpu")
    assert [h["step"] for h in out_t["history"]] == list(range(STEPS))
    for ht, hj in zip(out_t["history"], out_j["history"]):
        _metrics_close(ht, hj, "random")
    _params_close(out_t["params"], out_j["params"], "random",
                  sum(h["lr"] for h in out_j["history"]))
    # another seed's keys give other ranks, hence another loss
    out_o = tloop.run_training(torch_config(cfg), dataclasses.replace(tct, seed=1),
                               init_fn=lambda gen, device: s["pt"], loss_fn=lt,
                               data=s["tdata"], device="cpu")
    assert out_o["history"][0]["loss"] != out_t["history"][0]["loss"]


def test_run_training_resume_equals_uninterrupted(setup, tmp_path):
    """4 steps straight against 2 steps, a synchronous checkpoint and a
    resume to 4 (rank mode 'random', so the rank keys must resume too)."""
    s = setup
    cfg = torch_config(_cfg("random"))
    _, lt = _loss_fns("random", s)
    tc = TTrainConfig(global_batch=BATCH, seq_len=SEQ, lr=LR, total_steps=4,
                      warmup_steps=1, checkpoint_every=2, log_every=100,
                      async_checkpoint=False, schedule="constant")
    fns = get_model(cfg)
    kw = dict(init_fn=fns.init, loss_fn=lt, data=s["tdata"], device="cpu")
    out_a = tloop.run_training(cfg, tc, **kw)
    cm = CheckpointManager(tmp_path, async_save=False)
    tloop.run_training(cfg, dataclasses.replace(tc, total_steps=2), ckpt_manager=cm, **kw)
    assert cm.all_steps() == [2]
    out_b = tloop.run_training(cfg, tc, ckpt_manager=cm, **kw)
    assert cm.all_steps() == [2, 4]
    for a, b in zip(tu.leaves(out_a["params"]), tu.leaves(out_b["params"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)
    for a, b in zip(tu.leaves(out_a["opt_state"]), tu.leaves(out_b["opt_state"])):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)
    assert out_b["history"][-1]["step"] == 3
    assert out_b["history"][-1]["loss"] == pytest.approx(out_a["history"][-1]["loss"],
                                                         abs=1e-6)


def test_train_cli_resumes(tmp_path, capsys):
    """``launch.train.main`` on the reduced config (rank mode 'drrl', the
    port's own seeded agent), resumed, then with two bf16 microbatches."""
    argv = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
            "--ckpt-dir", str(tmp_path)]
    out = tlaunch.main(argv + ["--steps", "4"])
    first = capsys.readouterr().out
    assert "[ckpt]" not in first and "final loss" in first
    assert [h["step"] for h in out["history"]] == [0, 3]
    out = tlaunch.main(argv + ["--steps", "6"])
    text = capsys.readouterr().out
    assert "[ckpt] resumed from step 4" in text
    assert [h["step"] for h in out["history"]] == [5]
    assert CheckpointManager(tmp_path).all_steps() == [2, 4, 6]
    out = tlaunch.main(["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
                        "--steps", "2", "--microbatches", "2",
                        "--grad-compression", "bf16"])
    assert "[ckpt]" not in capsys.readouterr().out
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def _sampled_grads(s, remat, seed):
    """Loss, gradients, per-layer ranks and the generator's final state of
    the port's loss on batch 0 in rank mode 'drrl' with sampled actions
    (``greedy=False``) drawn from a generator seeded ``seed``."""
    fns = get_model(torch_config(_cfg("drrl", remat)))
    gen = torch.Generator().manual_seed(seed)
    ranks = []

    def lf(p, b):
        loss, aux = fns.loss(p, b, policy_params=s["at"], power_v0=s["v0"], greedy=False,
                             rank_generator=gen, collect_aux="ranks")
        ranks.append(aux["layers"]["rank"])
        return loss
    loss, grads = value_and_grad(lf, s["pt"], s["tdata"].batch_at(0))
    assert len(ranks) == 1                     # the recompute appends no ranks
    return loss, tu.leaves(grads), ranks[0], gen.get_state()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_sampled_actions_match_none(setup, remat):
    """Sampled actions are drawn from ``rank_generator`` inside each
    checkpointed layer, and checkpointing restores only the global
    generators: remat_layer sets the explicit one back for the recompute.
    From one seed, ``remat`` gives ``none``'s ranks, loss and gradients
    bitwise and leaves the generator where ``none`` does; another seed
    draws other ranks (the draw decides them)."""
    s = setup
    want = _sampled_grads(s, "none", 5)
    got = _sampled_grads(s, remat, 5)
    assert torch.equal(got[2], want[2])
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert torch.equal(got[3], want[3])
    assert not torch.equal(_sampled_grads(s, remat, 6)[2], want[2])


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grad_free_forward_is_unchanged(setup, monkeypatch, remat):
    """Without a gradient ``remat`` changes nothing, as JAX's checkpoint:
    under no_grad, and with grad on but no parameter requiring it (the
    serving engine's calls), forward_dense runs each layer directly
    (checkpoint, made to raise here, is never entered) and gives the
    ``none`` forward's logits and ranks bitwise. Parameters that require
    grad do enter it."""
    s = setup
    toks = s["tdata"].batch_at(0)["tokens"]
    kw = dict(policy_params=s["at"], power_v0=s["v0"], collect_aux="ranks")
    want, aux_w = forward_dense(torch_config(_cfg("drrl")), s["pt"], toks, **kw)

    def entered(*a, **k):
        raise RuntimeError("checkpoint entered")
    monkeypatch.setattr(common, "checkpoint", entered)
    cfg = torch_config(_cfg("drrl", remat))
    with torch.no_grad():
        got = forward_dense(cfg, s["pt"], toks, **kw)
    for logits, aux in (got, forward_dense(cfg, s["pt"], toks, **kw)):
        assert torch.equal(logits, want)
        assert torch.equal(aux["layers"]["rank"], aux_w["layers"]["rank"])
    live = tu.tree_map(lambda x: x.detach().requires_grad_(True), s["pt"])
    with pytest.raises(RuntimeError, match="checkpoint entered"):
        forward_dense(cfg, live, toks, **kw)
