"""The port's fused paged decode step against JAX ``decode_step_paged`` on
the same state: reduced drrl-paper (adaptive rank path) and reduced
qwen2.5-14b (GQA + qkv bias; its config ships rank mode 'off', and it also
runs with an adaptive grid), in the pure-decode and mixed forms, with the
factor pool on and off, the mass pool, and ``use_kernel`` off (plain
attention) and on (JAX: Pallas in interpret mode; port: the kernel's plain
version, since the tensors lie on the CPU).

Compared: logits of live rows, K/V pools without scratch page 0, the mass
pool, and the factor pool without scratch row n_slots (the basis is an
input here, so factors compare directly). Tolerance 1e-4 on logits (two
f32 layers of matmuls, summed in other orders) and 1e-5 on the pools.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models.transformer import decode_step_paged as jax_step  # noqa: E402
from repro_torch.models.transformer import decode_step_paged as torch_step  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

NS, PS, MAX_LEN, C = 3, 8, 32, 4
ADAPTIVE = RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16))
MODELS = {
    "drrl-adaptive": ("drrl-paper", ADAPTIVE),
    "qwen-off": ("qwen2.5-14b", None),
    "qwen-adaptive": ("qwen2.5-14b", ADAPTIVE),
}
_PARAMS = {}


def _model(name):
    if name not in _PARAMS:
        arch, rank = MODELS[name]
        cfg = get_config(arch, reduced=True)
        if rank is not None:
            cfg = cfg.with_(rank=rank)
        _PARAMS[name] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return _PARAMS[name]


def _state(cfg, mixed, kt, seed=0):
    """Random serving state: slot 0 decodes at length 5, slot 1 decodes at
    12 (or, mixed, prefills a 4-token chunk at 12), slot 2 is idle."""
    rng = np.random.default_rng(seed)
    L, hkv, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim()
    pps = MAX_LEN // PS
    n_pages = NS * pps + 1
    r_keep = min(cfg.rank.rank_grid[-1], dh)
    pt = np.zeros((NS, pps), np.int32)
    pt[0] = [3, 7, 1, 10]
    pt[1] = [2, 12, 5, 4]
    st = {
        "pool_k": rng.standard_normal((L, n_pages, PS, hkv, dh)).astype(np.float32),
        "pool_v": rng.standard_normal((L, n_pages, PS, hkv, dh)).astype(np.float32),
        "page_table": pt,
        "tokens": rng.integers(0, cfg.vocab_size, (NS, C if mixed else 1)).astype(np.int32),
        "slot_lens": np.asarray([5, 12, 0], np.int32),
        "active": np.asarray([True, True, False]),
    }
    if mixed:
        st["q_lens"] = np.asarray([1, 4, 1], np.int32)
        st["prefill_rows"] = np.asarray([False, True, False])
    if cfg.rank.mode != "off":
        basis = np.linalg.qr(rng.standard_normal((L, NS, hkv, dh, dh)))[0]
        st["basis"] = basis[..., :r_keep].astype(np.float32)
        st["slot_ranks"] = np.asarray([8, 12, 16], np.int32)
        st["mass_pool"] = rng.random((L, NS, MAX_LEN, hkv)).astype(np.float32)
        if kt:
            st["kt_pool"] = rng.standard_normal(
                (L, NS + 1, MAX_LEN, hkv, r_keep)).astype(np.float32)
    return st


CASES = [(m, form, kt, uk)
         for m in MODELS for form in ("decode", "mixed")
         for kt in ((False, True) if m != "qwen-off" else (False,))
         for uk in (False, True)]


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c)) for c in CASES])
def test_decode_step_paged_matches_jax(case):
    name, form, kt, use_kernel = case
    cfg, tcfg, jparams, tparams = _model(name)
    st = _state(cfg, form == "mixed", kt)
    pos = ("pool_k", "pool_v", "page_table", "tokens")
    kw = {k: v for k, v in st.items() if k not in pos}
    lg_j, pools_j = jax_step(cfg, jparams, *(jnp.asarray(st[k]) for k in pos),
                             use_kernel=use_kernel,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    # the port updates the pools in place: hand it copies
    lg_t, pools_t = torch_step(tcfg, tparams,
                               *(torch.from_numpy(st[k].copy()) for k in pos),
                               use_kernel=use_kernel,
                               **{k: torch.from_numpy(v.copy()) for k, v in kw.items()})
    live = st["active"]
    assert lg_t.shape == lg_j.shape
    np.testing.assert_allclose(lg_t.numpy()[live], np.asarray(lg_j)[live],
                               atol=1e-4, rtol=1e-4)
    assert set(pools_t) == set(pools_j)
    for key in pools_j:
        got, want = pools_t[key].numpy(), np.asarray(pools_j[key])
        if key in ("k", "v"):
            got, want = got[:, 1:], want[:, 1:]            # page 0 is scratch
        elif key == "kt":
            got, want = got[:, :NS], want[:, :NS]          # row NS is scratch
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5, err_msg=key)


def test_mass_cells_reset_when_appended():
    """The in-graph cell reset: a mass cell appended this step holds this
    step's mass only, and idle slots' mass rows do not move."""
    cfg, tcfg, _, tparams = _model("drrl-adaptive")
    st = _state(cfg, True, False)
    st["mass_pool"][:] = 1e6                          # stale occupant mass
    pos = ("pool_k", "pool_v", "page_table", "tokens")
    kw = {k: torch.from_numpy(v.copy()) for k, v in st.items() if k not in pos}
    _, pools = torch_step(tcfg, tparams, *(torch.from_numpy(st[k].copy()) for k in pos),
                          **kw)
    mass = pools["mass"].numpy()
    # slot 0 appends position 5; slot 1 appends 12..15 (its 4-token chunk)
    assert np.all(mass[:, 0, 5] <= 1.0 + 1e-6)
    assert np.all(mass[:, 1, 12:16] <= 4.0 + 1e-6)
    assert np.all(mass[:, 0, 6:] == 1e6) and np.all(mass[:, 2] == 1e6)
