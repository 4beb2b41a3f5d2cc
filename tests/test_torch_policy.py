"""The port's segment decision (``repro_torch.serve.policy``) against JAX
``make_decide_fn`` on the same serving state, in 'fixed', 'adaptive' and
'drrl' modes (the agent: JAX ``init_agent(PRNGKey(7))`` through
``agent_from_jax``), first decisions and veto-checked transitions.

Ranks and the Eq. 9 ``vetoed`` flag must be equal. Spectra agree to 1e-4
of the top eigenvalue and the rank-r projectors B_r B_r^T to 1e-4 (LAPACK
through XLA vs through torch). Raw bases and raw ``kt`` columns carry
solver-dependent signs, so ``kt`` is compared through its projector:
kt B_r^T = K B_r B_r^T.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve.policy import make_decide_fn as jax_make_decide  # noqa: E402
from repro_torch.serve.policy import make_decide_fn, median_mean  # noqa: E402
from torch_parity import jax_and_torch_agent, torch_config  # noqa: E402

NS, PS, PPS = 3, 8, 4
M = PS * PPS


def _cfg(mode, **kw):
    return get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), segment_len=8, **kw))


def _state(cfg, lens, seed, decay=0.75):
    """Random K pages whose per-head spectra decay (so the NER rank lands
    inside the grid), random attention mass, fresh rank state."""
    rng = np.random.default_rng(seed)
    L, h, d = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    k = (rng.standard_normal((L, NS * PPS + 1, PS, h, d))
         * decay ** np.arange(d)).astype(np.float32)
    pt = np.arange(1, NS * PPS + 1, dtype=np.int32).reshape(NS, PPS)
    return {
        "k_pool": k,
        "mass_pool": rng.random((L, NS, M, h)).astype(np.float32),
        "kt_pool": np.zeros((L, NS + 1, M, h, d), np.float32),
        "page_table": pt,
        "lens": np.asarray(lens, np.int32),
        "ranks": np.full((NS,), 16, np.int32),
        "basis": np.zeros((L, NS, h, d, d), np.float32),
        "spectra": np.zeros((NS, h, d), np.float32),
    }


def _run_both(cfg, st, slot, has_rank, t):
    order = ("k_pool", "mass_pool", "kt_pool", "page_table", "lens", "ranks",
             "basis", "spectra")
    agent_j, agent_t = (jax_and_torch_agent(cfg) if cfg.rank.mode == "drrl"
                        else (None, None))
    out_j = jax_make_decide(cfg, agent_j)(*(jnp.asarray(st[k]) for k in order),
                                          np.int32(slot), np.bool_(has_rank),
                                          np.int32(t))
    out_t = make_decide_fn(torch_config(cfg), agent_t)(
        *(torch.from_numpy(st[k].copy()) for k in order), slot, has_rank, t)
    return ([np.asarray(x) for x in out_j],
            [x.numpy() if isinstance(x, torch.Tensor) else x for x in out_t])


def _check(cfg, st, slot, has_rank, t, check_basis=True):
    (r_j, b_j, s_j, kt_j, v_j), (r_t, b_t, s_t, kt_t, v_t) = _run_both(
        cfg, st, slot, has_rank, t)
    np.testing.assert_array_equal(r_t, r_j)
    assert bool(v_t) == bool(v_j)
    top = s_j[slot][..., :1]
    np.testing.assert_allclose(s_t[slot] / top, s_j[slot] / top, atol=1e-4)
    r = min(int(r_j[slot]), cfg.resolved_head_dim())
    for L in range(b_j.shape[0] if check_basis else 0):
        pj = b_j[L, slot][..., :r] @ np.swapaxes(b_j[L, slot][..., :r], -1, -2)
        pt = b_t[L, slot][..., :r] @ np.swapaxes(b_t[L, slot][..., :r], -1, -2)
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        # factors through the projector: kt B_r^T == K B_r B_r^T
        back_j = np.einsum("mhr,hdr->mhd", kt_j[L, slot][..., :r], b_j[L, slot][..., :r])
        back_t = np.einsum("mhr,hdr->mhd", kt_t[L, slot][..., :r], b_t[L, slot][..., :r])
        scale = np.abs(back_j).max()
        np.testing.assert_allclose(back_t / scale, back_j / scale, atol=1e-4)
    return int(r_j[slot]), bool(v_j)


@pytest.mark.parametrize("mode", ["fixed", "adaptive", "drrl"])
@pytest.mark.parametrize("slot,lens", [(0, (20, 32, 3)), (1, (20, 32, 3)),
                                       (2, (20, 32, 3))])
def test_first_decision(mode, slot, lens):
    cfg = _cfg(mode, fixed_rank=8)
    rank, vetoed = _check(cfg, _state(cfg, lens, seed=slot), slot, False, 0)
    assert not vetoed
    if lens[slot] < 8:
        assert rank == 16                 # too little signal: r_max


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
@pytest.mark.parametrize("eps0", [1.0, 1e-3])
def test_transition_veto(mode, eps0):
    """A second decision against persisted previous spectra: with a tight
    threshold the switch away from the previous rank is vetoed, with the
    default one it goes through; both frameworks agree either way."""
    cfg = _cfg(mode, fixed_rank=8, epsilon0=eps0)
    st = _state(cfg, (24, 24, 24), seed=5)
    prev = _state(cfg, (24, 24, 24), seed=6, decay=0.9)
    st["spectra"][1] = np.sort(np.abs(prev["k_pool"][0, 1:4, :, :, :]).sum(
        axis=(0, 1)), axis=-1)[:, ::-1] ** 2
    st["ranks"][1] = 16
    rank, vetoed = _check(cfg, st, 1, True, 3)
    if eps0 < 1e-2:
        assert vetoed and rank == 16
    else:
        assert not vetoed and rank != 16


@pytest.mark.parametrize("eps0", [1.0, 0.3, 1e-3])
def test_drrl_transition_matches_jax(eps0):
    """A second 'drrl' decision against persisted previous spectra: the
    policy's masked head-mean argmax and the Eq. 9 veto, both frameworks
    alike; at eps0 = 1e-3 the mask leaves only r_max and the veto holds the
    previous rank."""
    cfg = _cfg("drrl", epsilon0=eps0)
    st = _state(cfg, (24, 24, 24), seed=5)
    prev = _state(cfg, (24, 24, 24), seed=6, decay=0.9)
    st["spectra"][1] = np.sort(np.abs(prev["k_pool"][0, 1:4, :, :, :]).sum(
        axis=(0, 1)), axis=-1)[:, ::-1] ** 2
    st["ranks"][1] = 8
    rank, vetoed = _check(cfg, st, 1, True, 3)
    if eps0 < 1e-2:
        assert vetoed and rank == 8


def test_even_head_median_between_two_ranks():
    """4 heads whose NER ranks are (4, 4, 11, 11): ``jnp.median`` gives 7.5,
    which snaps to 8; ``torch.median`` would give 4. Both frameworks must
    choose 8."""
    cfg = _cfg("adaptive")
    st = _state(cfg, (32, 32, 32), seed=7)
    rng = np.random.default_rng(8)
    d = cfg.resolved_head_dim()
    keys = np.zeros((M, 4, d), np.float32)
    for h, n_big in enumerate((4, 4, 12, 12)):
        s = np.where(np.arange(d) < n_big, 1.0, 1e-2)
        u = np.linalg.qr(rng.standard_normal((M, d)))[0]
        v = np.linalg.qr(rng.standard_normal((d, d)))[0]
        keys[:, h] = (u * s) @ v.T
    slot = 0
    pages = st["page_table"][slot]
    st["k_pool"][:, pages] = keys.reshape(PPS, PS, 4, d)[None]
    st["mass_pool"][:] = 0.0                 # zero mass: the plain Gram
    # the basis is not unique here (degenerate clusters): ranks and spectra
    rank, _ = _check(cfg, st, slot, False, 0, check_basis=False)
    assert rank == 8
    heads = torch.tensor([4.0, 4.0, 11.0, 11.0])
    assert float(median_mean(heads)) == 7.5 and float(torch.median(heads)) == 4.0
