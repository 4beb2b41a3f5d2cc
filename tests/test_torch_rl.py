"""The DR-RL agent's training in the port against the JAX package: the Eq. 13
reward, GAE, the PPO and BC losses and their gradients, AdamW and the LR
schedules, the greedy oracle, the BC batch and the greedy rollout, and
``train_agent``'s BC stage, on JAX-initialised parameters and agents
(``jax_and_torch_params``, ``jax_and_torch_agent``; w_t's power iterations
start from JAX's vectors, ``jax_power_v0``) and JAX's own batches. Also the
port's ``SyntheticLM`` and the kernels' guard against autograd.

Tolerances (f32 on both sides, sums in different orders):
  * rewards, GAE, the schedule: 1e-6 absolute / relative (a few f32 ops);
  * PPO / BC losses 1e-5 relative; the PPO metrics also 1e-6 absolute
    (pg_loss is a mean of O(1) terms that nearly cancel); their gradients
    1e-6 absolute + 1e-4 of the leaf's largest gradient (a 2-layer
    encoder's backward over 6 tokens and tens of samples);
  * AdamW on identical gradients: params 1e-7 absolute + 1e-6 relative;
  * the oracle's rewards and the rollouts' rewards 1e-5 absolute (cosine
    similarities over s x d products, LAPACK spectra through XLA vs torch);
    actions equal wherever the top-two reward gap exceeds that;
  * features 1e-6 + 1e-5 relative, logp and values 1e-5 absolute (as the
    forward's tests hold the agent).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig, TrainConfig  # noqa: E402
from repro.core import oracle as joracle  # noqa: E402
from repro.core import ppo as jppo  # noqa: E402
from repro.core import rewards as jrewards  # noqa: E402
from repro.data.synthetic import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.train import rl as jrl  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.convert import agent_from_jax  # noqa: E402
from repro_torch.configs.base import TrainConfig as TTrainConfig  # noqa: E402
from repro_torch.core import oracle as toracle  # noqa: E402
from repro_torch.core import ppo as tppo  # noqa: E402
from repro_torch.core import rewards as trewards  # noqa: E402
from repro_torch.data.synthetic import SyntheticClassification, SyntheticLM  # noqa: E402
from repro_torch.kernels import lowrank_flash, ops  # noqa: E402
from repro_torch.kernels.ops import reset_launches  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.train import rl as trl  # noqa: E402
from torch_parity import (JaxBatches, jax_and_torch_agent,  # noqa: E402
                          jax_and_torch_params, jax_power_v0, torch_config,
                          torch_tree)

GRID = (4, 8, 12, 16)
REWARD_TOL = 1e-5


def _cfg(arch="drrl-paper", eps0=1.0):
    return get_config(arch, reduced=True).with_(rank=RankConfig(
        mode="drrl", rank_grid=GRID, fixed_rank=8, segment_len=8,
        epsilon0=eps0))


_SETUPS = {}


def _setup(eps0=1.0):
    """Reduced drrl-paper: (jax cfg, port cfg, jax params, port params, jax
    agent, port agent, power_v0); params and agent built once."""
    cfg = _cfg(eps0=eps0)
    if not _SETUPS:
        _SETUPS[0] = (jax_and_torch_params(cfg) + jax_and_torch_agent(cfg)
                      + (jax_power_v0(cfg),))
    return (cfg, torch_config(cfg)) + _SETUPS[0]


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=rtol)


def _grads_close(gt, gj):
    """Every leaf: 1e-6 + 1e-4 of the leaf's largest |gradient|."""
    flat_j = jax.tree_util.tree_flatten_with_path(gj)[0]
    flat_t = tu.leaves_with_path(gt)
    assert len(flat_j) == len(flat_t)
    for (path, j), (tpath, t) in zip(flat_j, flat_t):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        assert name == tpath.replace("[", "").replace("]", ""), (name, tpath)
        j = np.asarray(j)
        _close(t, j, 1e-6 + 1e-4 * np.abs(j).max())


def _rng(seed):
    return np.random.default_rng(seed)


# -- reward, GAE, schedules ---------------------------------------------------

def test_reward_and_flops_fraction_match_jax():
    rc = _cfg().rank
    rng = _rng(0)
    fid = rng.uniform(0.5, 1.0, (3, 5)).astype(np.float32)
    rank = rng.choice(GRID, (3, 5)).astype(np.int32)
    dar = rng.uniform(0.0, 2.0, (3, 5)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (fid, rank, dar)]
    _close(trewards.flops_fraction(t[1], 16, 16),
           jrewards.flops_fraction(jnp.asarray(rank), 16, 16), 1e-6)
    _close(trewards.reward(rc, *t, 16, 16),
           jrewards.reward(rc, fid, jnp.asarray(rank), dar, 16, 16), 1e-6)
    r_t, comp_t = trewards.reward_components(rc, *t, 16, 12)
    r_j, comp_j = jrewards.reward_components(rc, fid, jnp.asarray(rank), dar, 16, 12)
    _close(r_t, r_j, 1e-6)
    for name in comp_j:
        _close(comp_t[name], comp_j[name], 1e-6)


def test_gae_matches_jax():
    rng = _rng(1)
    rw = rng.normal(size=(6, 9)).astype(np.float32)
    val = rng.normal(size=(6, 9)).astype(np.float32)
    adv_j, ret_j = jppo.gae(jnp.asarray(rw), jnp.asarray(val), 0.97, 0.9)
    adv_t, ret_t = tppo.gae(torch.from_numpy(rw), torch.from_numpy(val), 0.97, 0.9)
    _close(adv_t, adv_j, 1e-6)
    _close(ret_t, ret_j, 1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=23, schedule=schedule)
    fj = jsched.make_lr_fn(TrainConfig(**kw))
    ft = tsched.make_lr_fn(TTrainConfig(**kw))
    for step in range(0, 27):
        lj = fj(jnp.asarray(step, jnp.int32))
        lt = ft(torch.tensor(step, dtype=torch.int32))
        assert lt.dtype == torch.float32
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6, atol=0)


def test_train_config_matches_jax():
    """The port's TrainConfig is JAX's, field for field, with its defaults."""
    import dataclasses
    ported = dataclasses.asdict(TTrainConfig())
    reference = dataclasses.asdict(TrainConfig())
    assert list(ported) == list(reference)
    assert ported == reference


# -- AdamW ----------------------------------------------------------------------

def _grad_tree(agent_j, seed, scale):
    rng = _rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (scale * rng.normal(size=x.shape)).astype(np.float32), agent_j)


@pytest.mark.parametrize("clip,weight_decay", [(1e3, 0.0), (0.5, 0.0), (0.5, 0.1)],
                         ids=["no-clip", "clip", "clip-decay"])
def test_adamw_update_matches_jax(clip, weight_decay):
    _, _, _, _, agent_j, agent_t, _ = _setup()
    tcj = TrainConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                      weight_decay=weight_decay, grad_clip=clip)
    tct = TTrainConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                       weight_decay=weight_decay, grad_clip=clip)
    lrj, lrt = jsched.make_lr_fn(tcj), tsched.make_lr_fn(tct)
    sj, st = jadamw.init(agent_j), tadamw.init(agent_t)
    pj, pt = agent_j, agent_t
    update_j = jax.jit(lambda s, p, g: jadamw.update(tcj, lrj, s, p, g))
    for i in range(3):
        g = _grad_tree(agent_j, 10 + i, 0.01)
        pj, sj, mj = update_j(sj, pj, g)
        pt, st, mt = tadamw.update(tct, lrt, st, pt, torch_tree(g))
        clipped = float(mj["grad_norm"]) > clip
        assert clipped == (clip < 1.0)
        np.testing.assert_allclose(mt["grad_norm"].item(), float(mj["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(mt["lr"].item(), float(mj["lr"]), rtol=1e-6)
    assert int(st.step) == int(sj.step) == 3
    for tree_t, tree_j in ((pt, pj), (st.m, sj.m), (st.v, sj.v)):
        for t, j in zip(tu.leaves(tree_t), jax.tree_util.tree_leaves(tree_j)):
            _close(t, j, 1e-7, 1e-6)


def test_decay_mask_sees_jax_leaf_names():
    _, _, _, _, agent_j, agent_t, _ = _setup()
    names_j = ["/".join(str(getattr(k, "key", k)) for k in path)
               for path, _ in jax.tree_util.tree_flatten_with_path(agent_j)[0]]
    names_t = [p for p, _ in tu.leaves_with_path(agent_t)]
    assert names_t == names_j
    assert names_t[:2] == ["conv", "embed/bounds/b"]
    decayed = {n.split("/")[-1]: tadamw._decay_mask(n) for n in names_t}
    assert decayed["b"] and decayed["wq"] and not decayed["ln1"]
    assert [tadamw._decay_mask(n) for n in names_t] == \
        [jadamw._decay_mask(n) for n in names_j]
    # the LM's leaves, with the attention biases of a qkv_bias config
    lm = get_model(torch_config(_cfg()).with_(qkv_bias=True)).init(
        torch.Generator().manual_seed(0), device="cpu")
    names_lm = [p for p, _ in tu.leaves_with_path(lm)]
    assert {"bq", "bk", "bv", "ln1", "ln_f"} <= {n.split("/")[-1] for n in names_lm}
    assert [tadamw._decay_mask(n) for n in names_lm] == \
        [jadamw._decay_mask(n) for n in names_lm]


# -- losses -------------------------------------------------------------------

_ROLLOUTS = {}


def _jax_rollout(eps0=1.0):
    """JAX's greedy rollout of reduced drrl-paper on its batch 1 (agent seed
    7): (batch, Trajectory, metrics), built once per eps0. At eps0 = 1 the
    Eq. 11 mask leaves several ranks legal and forbids some."""
    if eps0 not in _ROLLOUTS:
        cfg, _, jparams, _, agent_j, _, _ = _setup(eps0)
        batch = JSyntheticLM(cfg.vocab_size, 64, 2, seed=0).batch_at(1)
        traj, met = jax.jit(lambda p, a, b: jrl.collect_rollout(cfg, p, a, b, None))(
            jparams, agent_j, batch)
        _ROLLOUTS[eps0] = jax.device_get((batch, traj, met))
    return _ROLLOUTS[eps0]


def _other_agent():
    """The rollout's agent with every leaf moved by 5 % noise: the loss is
    taken away from the rollout's policy, so ratios differ from 1 and the
    clip binds somewhere."""
    agent_j = _setup()[4]
    rng = _rng(11)
    moved = jax.tree_util.tree_map(
        lambda x: np.asarray(x) * (1 + 0.05 * rng.normal(size=x.shape)).astype(np.float32),
        agent_j)
    return moved, agent_from_jax(moved, device="cpu")


def test_ppo_loss_and_grads_match_jax():
    traj_j = _jax_rollout()[1]
    traj_t = torch_tree(traj_j)
    agent_j, agent_t = _other_agent()
    (loss_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda a: jppo.ppo_loss(a, traj_j), has_aux=True))(agent_j)
    (loss_t, m_t), g_t = trl.value_and_grad(tppo.ppo_loss, agent_t, traj_t)
    mask = np.asarray(traj_j.action_mask)
    assert (~mask).any() and (mask.sum(-1) > 1).any()
    assert abs(float(m_j["ratio_mean"]) - 1.0) > 1e-3
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    for name in m_j:
        np.testing.assert_allclose(m_t[name].item(), float(m_j[name]), rtol=1e-5,
                                   atol=1e-6)
    _grads_close(g_t, g_j)
    assert not torch.count_nonzero(g_t["conv"])      # conv feeds neither loss


@pytest.mark.parametrize("forbidden", [False, True], ids=["legal", "forbidden"])
def test_bc_loss_and_grads_match_jax(forbidden):
    """Oracle actions drawn among the legal ones, or with some that the
    Eq. 11 mask forbids: the loss is then about 1e30 and the gradient is
    finite, in JAX and in the port."""
    traj = _jax_rollout()[1]
    T, B = traj.actions.shape
    feats = {k: v.reshape(T * B, -1) for k, v in traj.feats.items()}
    mask = np.asarray(traj.action_mask).reshape(T * B, -1)
    rng = _rng(5)
    ys = np.array([rng.choice(np.flatnonzero(
        ~m if forbidden and i % 7 == 0 and (~m).any() else m))
        for i, m in enumerate(mask)], np.int32)
    assert mask[np.arange(len(ys)), ys].all() != forbidden
    agent_j, agent_t = _other_agent()
    loss_j, g_j = jax.jit(jax.value_and_grad(jppo.bc_loss))(agent_j, feats, ys, mask)
    loss_t, g_t = trl.value_and_grad(tppo.bc_loss, agent_t, torch_tree(feats),
                                     torch_tree(ys), torch_tree(mask))
    assert (float(loss_j) > 1e28) == forbidden
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    assert all(torch.isfinite(x).all() for x in tu.leaves(g_t))
    _grads_close(g_t, g_j)


# -- oracle, BC batch, rollout ----------------------------------------------------

def _qkv(cfg, b, s, seed):
    """Random q, k, v with spread spectra (column scales from 1 to 0.1), so
    the eigen-gaps that set each rank's subspace are clear."""
    rng = _rng(seed)
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    col = np.geomspace(1.0, 0.1, d).astype(np.float32)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32) * col
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32) * col[::-1]
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    return q, k, v


def _top_two_gap(rewards):
    r = np.sort(np.asarray(rewards), axis=-1)
    return r[..., -1] - r[..., -2]


@pytest.mark.parametrize("arch,s,chunked", [
    ("drrl-paper", 64, False), ("drrl-paper", 1040, True),
    ("qwen2.5-14b", 64, False), ("qwen2.5-14b", 1040, True)])
def test_oracle_matches_jax(arch, s, chunked):
    """At s = 1040 the port runs its 1 + G attentions chunked, through
    ``ops.flash_attention``'s plain version; JAX unchunked (the oracle's
    own call)."""
    cfg = _cfg(arch)
    q, k, v = _qkv(cfg, 2, s, seed=s)
    act_j, aux_j = joracle.oracle_actions(cfg.rank, jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    reset_launches()
    act_t, aux_t = toracle.oracle_actions(torch_config(cfg).rank, torch.from_numpy(q),
                                          torch.from_numpy(k), torch.from_numpy(v),
                                          chunked=chunked)
    assert lowrank_flash.LAUNCHES["lowrank_flash"] == 0   # CPU: plain version
    assert act_t.shape == (2, cfg.num_kv_heads)
    _close(aux_t["rewards"], aux_j["rewards"], REWARD_TOL)
    _close(aux_t["bounds_rel"], aux_j["bounds_rel"], 1e-6, 1e-5)
    gap = _top_two_gap(aux_j["rewards"])
    print(f"smallest top-two reward gap {gap.min():.3g}; actions "
          f"{np.asarray(act_j).ravel().tolist()}")
    sure = gap > REWARD_TOL
    np.testing.assert_array_equal(act_t.numpy()[sure], np.asarray(act_j)[sure])


def _feats_close(ft, fj):
    assert sorted(ft) == sorted(fj)
    for name in fj:
        _close(ft[name], fj[name], 1e-6, 1e-5)


def test_collect_bc_batch_matches_jax():
    cfg, tcfg, jparams, tparams, agent_j, agent_t, v0 = _setup()
    batch_j = JSyntheticLM(cfg.vocab_size, 64, 2, seed=0).batch_at(0)
    fj, yj, mj = jax.jit(lambda p, a, b: jrl.collect_bc_batch(cfg, p, a, b, None))(
        jparams, agent_j, batch_j)
    with torch.no_grad():
        ft, yt, mt = trl.collect_bc_batch(tcfg, tparams, agent_t,
                                          torch_tree(batch_j), power_v0=v0)
    _feats_close(ft, fj)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    n = cfg.num_layers * 2 * cfg.num_kv_heads
    assert yt.shape == (n,) and ft["bounds"].shape == (n, len(GRID))
    # the oracle's near-ties (its rewards are held to JAX's in
    # test_oracle_matches_jax): equal actions wherever the reward gap is clear
    with torch.no_grad():
        qkv = ttr.forward_dense(tcfg, tparams, torch_tree(batch_j["tokens"]),
                                policy_params=agent_t, power_v0=v0, collect_aux="rl",
                                collect_qkv=True)[1]["layers"]["qkv"]
        gaps = np.concatenate([_top_two_gap(toracle.oracle_actions(
            tcfg.rank, qkv["q"][li], qkv["k"][li], qkv["v"][li])[1]["rewards"]).ravel()
            for li in range(cfg.num_layers)])
    print(f"smallest top-two oracle reward gap {gaps.min():.3g}; forbidden "
          f"oracle actions {int((~np.asarray(mj)[np.arange(n), yj]).sum())} of {n}")
    sure = gaps > REWARD_TOL
    np.testing.assert_array_equal(yt.numpy()[sure], np.asarray(yj)[sure])


@pytest.mark.parametrize("eps0", [1.0, 1.5])
def test_greedy_rollout_matches_jax(eps0):
    cfg, tcfg, jparams, tparams, agent_j, agent_t, v0 = _setup(eps0=eps0)
    batch_j, traj_j, met_j = _jax_rollout(eps0)
    with torch.no_grad():
        traj_t, met_t = trl.collect_rollout(tcfg, tparams, agent_t,
                                            torch_tree(batch_j), power_v0=v0)
    _feats_close(traj_t.feats, traj_j.feats)
    np.testing.assert_array_equal(traj_t.actions.numpy(), np.asarray(traj_j.actions))
    np.testing.assert_array_equal(traj_t.action_mask.numpy(),
                                  np.asarray(traj_j.action_mask))
    _close(traj_t.rewards, traj_j.rewards, REWARD_TOL)
    _close(traj_t.logp_old, traj_j.logp_old, 1e-5)
    _close(traj_t.values_old, traj_j.values_old, 1e-5)
    for name in ("reward_mean", "fidelity_mean", "rank_mean"):
        np.testing.assert_allclose(met_t[name].item(), float(met_j[name]), atol=1e-5)


def test_train_agent_bc_stage_matches_jax():
    """Two BC steps from the same JAX batches. The first AdamW step moves a
    leaf by about sign(g) * lr, so a gradient near 0 whose sign differs
    between the two sides moves it by up to 2 lr: the final agent is held
    to 2.5 x the largest step's lr (1.2e-4 at step 2 of a 5-step warm-up),
    and 99 % of its elements to 1e-6."""
    cfg, tcfg, jparams, tparams, agent_j, agent_t, v0 = _setup()
    data = JSyntheticLM(cfg.vocab_size, 64, 2, seed=0)
    new_j, hist_j = jrl.train_agent(cfg, jparams, agent_j, data, bc_steps=2,
                                    ppo_steps=0, lr=3e-4, seed=0)
    new_t, hist_t = trl.train_agent(tcfg, tparams, agent_t, JaxBatches(data),
                                    bc_steps=2, ppo_steps=0, lr=3e-4, seed=0,
                                    power_v0=v0)
    assert hist_t["ppo"] == [] and len(hist_t["bc_loss"]) == 2
    np.testing.assert_allclose(hist_t["bc_loss"], hist_j["bc_loss"], rtol=1e-5)
    lr_max = 3e-4 * 2 / 5
    tight = total = 0
    moved = 0.0
    for t, j, t0 in zip(tu.leaves(new_t), jax.tree_util.tree_leaves(new_j),
                        tu.leaves(agent_t)):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert diff.max() <= 2.5 * lr_max
        tight += int((diff <= 1e-6).sum())
        total += diff.size
        moved = max(moved, (t - t0).abs().max().item())
    assert tight >= 0.99 * total, f"{tight} of {total} elements within 1e-6"
    assert moved > 1e-4                       # the agent did move


# -- data ---------------------------------------------------------------------

def test_synthetic_lm_is_a_pure_function_of_seed_and_step():
    data = SyntheticLM(300, 40, 3, seed=4, motif_len=8)
    a, b = data.batch_at(5, device="cpu"), data.batch_at(5, device="cpu")
    for name in a:
        assert torch.equal(a[name], b[name])
    c = SyntheticLM(300, 40, 3, seed=4).batch_at(6, device="cpu")
    d = SyntheticLM(300, 40, 3, seed=5).batch_at(5, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
    assert not torch.equal(a["tokens"], d["tokens"])
    assert a["tokens"].shape == a["labels"].shape == (3, 40)
    assert a["tokens"].dtype == torch.int64 and a["mask"].dtype == torch.float32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 300
    assert bool((a["mask"] == 1).all())
    # the motif structure: windows equal to the one before, about half of them
    full = torch.cat([a["tokens"], a["labels"][:, -1:]], 1)[:, :40].reshape(3, 5, 8)
    rep = (full[:, 1:] == full[:, :-1]).all(-1).float().mean().item()
    assert 0.1 < rep < 0.9
    # Zipf: token 0 is the most frequent
    big = SyntheticLM(300, 512, 4, seed=0).batch_at(0, device="cpu")["tokens"]
    assert torch.bincount(big.flatten(), minlength=300).argmax().item() == 0


def test_synthetic_classification_batches():
    data = SyntheticClassification(100, 256, 64, seed=2)
    a = data.batch_at(3, device="cpu")
    assert all(torch.equal(a[k], data.batch_at(3, device="cpu")[k]) for k in a)
    assert a["tokens"].shape == (64, 256) and a["labels"].shape == (64,)
    assert set(a["labels"].tolist()) == {0, 1}
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100
    # the label's population (upper half of the vocabulary for 1) is the 70 %
    hi = (a["tokens"] >= 50).float().mean(1)
    assert bool(((hi > 0.5) == (a["labels"] == 1)).all())


# -- the kernels' guard against autograd ---------------------------------------------

def test_plain_versions_differentiate_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 2, 20, 8), generator=g, requires_grad=True)
    k = torch.randn((1, 2, 20, 8), generator=g, requires_grad=True)
    v = torch.randn((1, 2, 20, 8), generator=g, requires_grad=True)
    ops.flash_attention(q, k, v, scale=0.3).sum().backward()
    qd = torch.randn((1, 2, 8), generator=g, requires_grad=True)
    ops.decode_attention(qd, k, v, torch.tensor([12]), scale=0.3).square().sum().backward()
    for x in (q, k, v, qd):
        assert x.grad is not None and torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_train_agent_leaves_no_graph_on_its_trajectories(monkeypatch):
    cfg, tcfg, _, tparams, _, agent_t, v0 = _setup()
    seen = []

    def banked(fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            seen.append(out)
            return out
        return wrapped
    monkeypatch.setattr(trl, "collect_rollout", banked(trl.collect_rollout))
    monkeypatch.setattr(trl, "collect_bc_batch", banked(trl.collect_bc_batch))
    data = SyntheticLM(cfg.vocab_size, 32, 2, seed=1)

    class OnCpu:
        def batch_at(self, step, device="cpu"):
            return data.batch_at(step, device=device)
    new, hist = trl.train_agent(tcfg, tparams, agent_t, OnCpu(), bc_steps=1,
                                ppo_steps=1, ppo_epochs=2, power_v0=v0)
    assert len(seen) == 2 and len(hist["ppo"]) == 1
    tensors = [x for out in seen for x in tu.leaves(list(out))]
    assert tensors and all(not x.requires_grad and x.grad_fn is None for x in tensors)
    assert all(not x.requires_grad for x in tu.leaves(new))
    assert all(np.isfinite(h) for h in hist["bc_loss"] + [hist["ppo"][0]["loss"]])


@pytest.mark.cuda
def test_cuda_wrappers_refuse_inputs_that_require_grad():
    """decode_attention (flash_decode has no backward) refuses inputs that
    require grad; flash_attention differentiates through its backward
    kernel in f32 and in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card: pytest -m cuda)")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((1, 2, 20, 8), generator=g, device="cuda")
    k = torch.randn((1, 2, 20, 8), generator=g, device="cuda")
    v = torch.randn((1, 2, 20, 8), generator=g, device="cuda")
    kv_len = torch.tensor([12], dtype=torch.int32, device="cuda")
    def call(x):
        return ops.decode_attention(x[:, :, 0].contiguous(), k, v, kv_len, scale=0.3)
    with pytest.raises(RuntimeError, match="backward"):
        call(q.clone().requires_grad_(True))
    with torch.no_grad():
        assert torch.isfinite(call(q.clone().requires_grad_(True))).all()
    assert torch.isfinite(call(q)).all()
    for dtype in (torch.float32, torch.bfloat16):
        leaf = q.to(dtype).requires_grad_(True)
        (dq,) = torch.autograd.grad(ops.flash_attention(leaf, k.to(dtype), v.to(dtype),
                                                        scale=0.3).float().sum(), (leaf,))
        assert dq.dtype == dtype and torch.isfinite(dq.float()).all()
