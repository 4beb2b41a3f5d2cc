"""The port's sequence-mixer scans against the JAX package's on the same
numpy inputs: Mamba2's ``ssd_chunked`` and RWKV6's ``wkv6_chunked``
against JAX's and against the naive recurrences (``ssd_naive``,
``wkv6_naive``) of both sides, at lengths that are not chunk multiples (12
and 37 at chunk 16) and at ``n_groups`` 1 and 2 (B and C repeated per group
as ``jnp.repeat`` does); the wkv6 state carried across two calls against one
call; ``_causal_conv`` with a carried state; a single-step Mamba2 and RWKV6
block against the chunked block on the same tokens; and the gradient of
both scans finite where the decay's masked upper triangle would overflow.

Tolerances: f32 outputs and states within 2e-5 absolute plus 1e-5 of the
value (the chunked scans against JAX's, the single-step blocks against the
chunked ones: the states reach magnitudes near 10, where f32 sums in
another order differ by a few ulp); the chunked scans against the naive
recurrences, another association of the same sums, 5e-5 absolute plus
1e-5 of the value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import mamba2 as jm  # noqa: E402
from repro.models import rwkv6 as jr  # noqa: E402
from repro_torch.models import mamba2 as tm  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5
ORACLE_ATOL = 5e-5
CHUNK = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=RTOL)


def _ssd_inputs(seed, l, g, b=2, h=4, p=8, n=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 2.0, h)).astype(np.float32)
    B = rng.standard_normal((b, l, g, n)).astype(np.float32)
    C = rng.standard_normal((b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


_ssd_chunked_j = jax.jit(jm.ssd_chunked, static_argnums=5)
_ssd_naive_j = jax.jit(jm.ssd_naive)


@pytest.mark.parametrize("seed,l,g", [(0, 12, 1), (1, 37, 1), (2, 37, 2), (3, 48, 2)])
def test_ssd_chunked_matches_jax_and_oracle(seed, l, g):
    arrs = _ssd_inputs(seed, l, g)
    y_j, s_j = _ssd_chunked_j(*map(jnp.asarray, arrs), CHUNK)
    y_t, s_t = tm.ssd_chunked(*map(torch.from_numpy, arrs), CHUNK)
    assert y_t.shape == (2, l, 4, 8) and s_t.shape == (2, 4, 8, 8)
    _close(y_t, y_j)
    _close(s_t, s_j)
    _close(y_t, _ssd_naive_j(*map(jnp.asarray, arrs)), ORACLE_ATOL)
    _close(tm.ssd_naive(*map(torch.from_numpy, arrs)), y_j, ORACLE_ATOL)


def _wkv_inputs(seed, l, b=2, d=32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, l, d)).astype(np.float32) for _ in range(3))
    # the model's clip range, both ends reached
    w_log = np.clip(-np.exp(rng.normal(0.0, 2.0, (b, l, d))), -8.0, -1e-4).astype(np.float32)
    u = (rng.standard_normal(d) * 0.5).astype(np.float32)
    return r, k, v, w_log, u


_wkv_chunked_j = jax.jit(jr.wkv6_chunked, static_argnums=(5, 6))
_wkv_naive_j = jax.jit(jr.wkv6_naive, static_argnums=5)


@pytest.mark.parametrize("seed,l", [(0, 12), (1, 37), (2, 48)])
def test_wkv6_chunked_matches_jax_and_oracle(seed, l):
    arrs = _wkv_inputs(seed, l)
    y_j, s_j = _wkv_chunked_j(*map(jnp.asarray, arrs), 8, CHUNK)
    y_t, s_t = tr.wkv6_chunked(*map(torch.from_numpy, arrs), 8, CHUNK)
    assert y_t.dtype == torch.float32 and y_t.shape == (2, l, 32)
    _close(y_t, y_j)
    _close(s_t, s_j)
    y_n, s_n = _wkv_naive_j(*map(jnp.asarray, arrs), 8)
    _close(y_t, y_n, ORACLE_ATOL)
    _close(s_t, s_n, ORACLE_ATOL)
    y_tn, s_tn = tr.wkv6_naive(*map(torch.from_numpy, arrs), 8)
    _close(y_tn, y_n)
    _close(s_tn, s_n)


def test_wkv6_state_carries_across_calls(monkeypatch):
    """37 tokens in one call == 20 then 17 from the first call's state, on
    both sides and against the oracle; the chunk groups of the decay block
    (forced to one chunk at a time here) give the same result."""
    arrs = _wkv_inputs(4, 37)
    ts = [torch.from_numpy(a) for a in arrs]
    y_all, s_all = tr.wkv6_chunked(*ts, 8, CHUNK)
    y1, s1 = tr.wkv6_chunked(*(t[:, :20] for t in ts[:4]), ts[4], 8, CHUNK)
    y2, s2 = tr.wkv6_chunked(*(t[:, 20:] for t in ts[:4]), ts[4], 8, CHUNK, state0=s1)
    _close(torch.cat([y1, y2], 1), y_all.numpy())
    _close(s2, s_all.numpy())
    js = [jnp.asarray(a) for a in arrs]
    _, sj1 = _wkv_chunked_j(*(a[:, :20] for a in js[:4]), js[4], 8, CHUNK)
    yj2, sj2 = _wkv_chunked_j(*(a[:, 20:] for a in js[:4]), js[4], 8, CHUNK, sj1)
    _close(y2, yj2)
    _close(s2, sj2)
    monkeypatch.setattr(tr, "DECAY_BLOCK_ELEMS", 1)
    y_g, s_g = tr.wkv6_chunked(*ts, 8, CHUNK)
    _close(y_g, y_all.numpy(), 1e-6)


def test_causal_conv_state_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st):
        y_j, n_j = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                   None if state is None else jnp.asarray(state))
        y_t, n_t = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(b),
                                   None if state is None else torch.from_numpy(state))
        _close(y_t, y_j)
        _close(n_t, n_j)
    # 9 tokens at once == 5, then 4 from the carried state
    y_all, _ = tm._causal_conv(*map(torch.from_numpy, (x, w, b)))
    y1, s1 = tm._causal_conv(torch.from_numpy(x[:, :5]), torch.from_numpy(w),
                             torch.from_numpy(b))
    y2, _ = tm._causal_conv(torch.from_numpy(x[:, 5:]), torch.from_numpy(w),
                            torch.from_numpy(b), s1)
    _close(torch.cat([y1, y2], 1), y_all.numpy(), 1e-6)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_block_single_step_matches_chunked(groups):
    """The reduced zamba2's first mamba block: 10 tokens chunked against
    token-by-token single steps from the zero state (conv and ssm states
    carried), on both sides; the chunked block against JAX's."""
    from repro.configs.base import SSMConfig
    base = get_config("zamba2-7b", reduced=True)
    cfg = base.with_(ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                                   n_groups=groups, chunk_size=16))
    tcfg = torch_config(cfg)
    jp, tp = jax_and_torch_params(cfg)
    mj = jax.tree_util.tree_map(lambda a: a[0], jp["mamba"])
    mt = {k: v[0] for k, v in tp["mamba"].items()}
    x = np.random.default_rng(6).standard_normal((2, 10, 64)).astype(np.float32)
    y_j, c_j, s_j = jax.jit(lambda p, v: jm.mamba_block(cfg, p, v))(mj, jnp.asarray(x))
    y_t, c_t, s_t = tm.mamba_block(tcfg, mt, torch.from_numpy(x))
    _close(y_t, y_j)
    _close(c_t, c_j)
    _close(s_t, s_j)
    conv, ssm = tm.init_mamba_state(tcfg, 2, torch.float32, device="cpu")
    ys = []
    for t in range(10):
        y, conv, ssm = tm.mamba_block(tcfg, mt, torch.from_numpy(x[:, t:t + 1]),
                                      conv_state=conv, ssm_state=ssm, single_step=True)
        ys.append(y)
    _close(torch.cat(ys, 1), y_j, ORACLE_ATOL)
    _close(ssm, s_j, ORACLE_ATOL)
    cj, sj = jm.init_mamba_state(cfg, 2, jnp.float32)
    y1_j, _, s1_j = jax.jit(lambda p, v, c, s: jm.mamba_block(
        cfg, p, v, conv_state=c, ssm_state=s, single_step=True))(mj, jnp.asarray(x[:, :1]),
                                                                 cj, sj)
    _close(ys[0], y1_j)


def test_rwkv_block_single_step_matches_chunked():
    """The reduced rwkv6's first block: 21 tokens chunked against
    token-by-token single steps, and 13 + 8 chunked with the state carried,
    on both sides; the state holds the last *normed* inputs."""
    cfg = get_config("rwkv6-1.6b", reduced=True)
    tcfg = torch_config(cfg)
    jp, tp = jax_and_torch_params(cfg)
    pj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    pt = {k: v[0] for k, v in tp["layers"].items()}
    x = np.random.default_rng(7).standard_normal((2, 21, 64)).astype(np.float32)
    y_j, st_j = jax.jit(lambda p, v: jr.rwkv_block(cfg, p, v))(pj, jnp.asarray(x))
    y_t, st_t = tr.rwkv_block(tcfg, pt, torch.from_numpy(x))
    _close(y_t, y_j)
    for a, b in zip(st_t, st_j):
        _close(a, b)
    st = tr.init_rwkv_state(tcfg, 2, torch.float32, device="cpu")
    ys = []
    for t in range(21):
        y, st = tr.rwkv_block(tcfg, pt, torch.from_numpy(x[:, t:t + 1]), state=st,
                              single_step=True)
        ys.append(y)
    _close(torch.cat(ys, 1), y_j, ORACLE_ATOL)
    y1, s1 = tr.rwkv_block(tcfg, pt, torch.from_numpy(x[:, :13]))
    y2, s2 = tr.rwkv_block(tcfg, pt, torch.from_numpy(x[:, 13:]), state=s1)
    _close(torch.cat([y1, y2], 1), y_j)
    for a, b in zip(s2, st_j):
        _close(a, b)


def test_scan_gradients_are_finite():
    """Masking before the exp: the upper triangle's positive exponents
    (here up to 8 x 15 in wkv6 and far more in SSD) leave no inf * 0 NaN in
    the gradients of either scan."""
    arrs = [torch.from_numpy(a).requires_grad_(True) for a in _wkv_inputs(8, 37)]
    arrs[3].data.fill_(-8.0)
    y, s = tr.wkv6_chunked(*arrs, 8, CHUNK)
    (y.sum() + s.sum()).backward()
    assert all(torch.isfinite(a.grad).all() for a in arrs)
    x, dt, A, B, C = _ssd_inputs(9, 37, 1)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt * 20, A * 10, B, C)]
    y, s = tm.ssd_chunked(*ts, CHUNK)
    (y.sum() + s.sum()).backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)
