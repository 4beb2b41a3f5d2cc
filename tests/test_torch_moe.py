"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``) on the same parameters (JAX ``init_moe``
through ``params_from_jax``) and the same numpy inputs: the sort-based
dispatch with capacity binding and not, shared experts, the Switch
auxiliary loss, the dense fallback, an exact tie in the router (the top-k
order: ``jax.lax.top_k`` keeps the lower expert first, the port's stable
descending sort too), and bf16 activations (the router's bf16 operands with
f32 accumulation).

Tolerances: f32 outputs 1e-5 absolute (matmuls summed in other orders),
the auxiliary loss 1e-6; bf16 outputs two bf16 steps of the largest output
(2^-6 x max|y|), the auxiliary loss 1e-6 (it is f32 on both sides); the
chosen experts identical.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import MoEConfig  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from torch_parity import torch_config  # noqa: E402

# (experts, top_k, capacity_factor, shared experts): capacity 2.0 never
# binds at these sizes, 0.5 drops about half the pairs
MOE_CASES = [
    (4, 2, 2.0, 0),
    (4, 2, 0.5, 0),
    (8, 3, 1.25, 0),
    (6, 2, 0.75, 1),
    (4, 2, 2.0, 2),
]
IDS = ["E%d-k%d-cf%g-shared%d" % c for c in MOE_CASES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(E, K, cf, shared, dtype="float32"):
    base = get_config("granite-moe-3b-a800m", reduced=True)
    return base.with_(moe=MoEConfig(num_experts=E, top_k=K, d_expert=32,
                                    num_shared_experts=shared, d_shared=24,
                                    capacity_factor=cf),
                      dtype=dtype)


def _params(cfg, seed=0):
    jp = jmoe.init_moe(cfg, jax.random.PRNGKey(seed), jnp.float32)
    return jp, params_from_jax(jax.device_get(jp), device="cpu")


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _dropped(tcfg, tp, x) -> int:
    """(token, expert) pairs past their expert's capacity C = max(int(T K /
    E x capacity_factor), 1)."""
    m = tcfg.moe
    T = x.shape[0] * x.shape[1]
    _, idx, _ = tmoe.route(tcfg, tp, torch.from_numpy(x.reshape(T, -1)))
    counts = torch.bincount(idx.flatten(), minlength=m.num_experts)
    C = max(int(T * m.top_k / m.num_experts * m.capacity_factor), 1)
    return int((counts - C).clamp_min(0).sum())


@pytest.mark.parametrize("case", MOE_CASES, ids=IDS)
def test_moe_ffn_matches_jax(case):
    cfg = _cfg(*case)
    tcfg = torch_config(cfg)
    jp, tp = _params(cfg)
    x = _x(3, 11, cfg.d_model)
    y_j, aux_j = jmoe.moe_ffn(cfg, jp, jnp.asarray(x))
    y_t, aux_t = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(aux_t["aux_loss"].item(), float(aux_j["aux_loss"]), atol=1e-6)
    drops = _dropped(tcfg, tp, x)
    if case[2] == 2.0:
        assert drops == 0
    if case[2] == 0.5:
        assert drops > 0
        # with pairs dropped the routed FFN is not the oracle's
        assert not np.allclose(y_t.numpy(), tmoe.moe_ffn_dense_fallback(
            tcfg, tp, torch.from_numpy(x)).numpy(), atol=1e-3)


@pytest.mark.parametrize("case", MOE_CASES, ids=IDS)
def test_dense_fallback_matches_jax(case):
    cfg = _cfg(*case)
    tcfg = torch_config(cfg)
    jp, tp = _params(cfg, seed=2)
    x = _x(2, 9, cfg.d_model, seed=3)
    y_j = jmoe.moe_ffn_dense_fallback(cfg, jp, jnp.asarray(x))
    y_t = tmoe.moe_ffn_dense_fallback(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    if case[2] == 2.0:
        # no pair dropped: the routed FFN is the oracle
        y_r, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
        np.testing.assert_allclose(y_r.numpy(), y_t.numpy(), atol=1e-5)


def test_router_tie_keeps_the_lower_expert():
    """Experts 1, 2 and 3 share one router column and expert 0 has a lower
    one: every token's probabilities tie exactly among 1, 2 and 3, so top-2
    picks (1, 2) by index on both sides, and the outputs agree."""
    cfg = _cfg(4, 2, 2.0, 0)
    tcfg = torch_config(cfg)
    jp, _ = _params(cfg, seed=4)
    r = np.asarray(jp["router"]).copy()
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 1]
    r[:, 0] = r[:, 1] - 0.5 * np.abs(r[:, 1]) - 0.01
    jp = dict(jp, router=jnp.asarray(r))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    x = np.abs(_x(2, 7, cfg.d_model, seed=5))           # x . (r1 - r0) > 0
    _, idx_j = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x.reshape(-1, cfg.d_model)) @ r, -1), 2)
    _, idx_t, _ = tmoe.route(tcfg, tp, torch.from_numpy(x.reshape(-1, cfg.d_model)))
    assert (np.asarray(idx_j) == [1, 2]).all()
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    # torch.topk makes no such promise; the stable sort does
    y_j, _ = jmoe.moe_ffn(cfg, jp, jnp.asarray(x))
    y_t, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn_bf16_matches_jax(shared):
    """bf16 activations and expert weights, the f32 router: the router
    multiplies bf16-rounded operands with f32 accumulation on both sides,
    so the experts chosen are identical."""
    cfg = _cfg(8, 2, 1.0, shared, dtype="bfloat16")
    tcfg = torch_config(cfg)
    jp = jmoe.init_moe(cfg, jax.random.PRNGKey(6), jnp.bfloat16)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    assert tp["router"].dtype == torch.float32 and tp["w_up"].dtype == torch.bfloat16
    x = _x(4, 16, cfg.d_model, seed=7)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    logits_j = jnp.einsum("td,de->te", xj.reshape(-1, cfg.d_model),
                          jp["router"].astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)
    _, idx_j = jax.lax.top_k(jax.nn.softmax(logits_j, -1), 2)
    _, idx_t, _ = tmoe.route(tcfg, tp, xt.reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    y_j, aux_j = jmoe.moe_ffn(cfg, jp, xj)
    y_t, aux_t = tmoe.moe_ffn(tcfg, tp, xt)
    assert y_t.dtype == torch.bfloat16
    yj = np.asarray(y_j.astype(jnp.float32))
    np.testing.assert_allclose(y_t.float().numpy(), yj, atol=2 ** -6 * np.abs(yj).max())
    np.testing.assert_allclose(aux_t["aux_loss"].item(), float(aux_j["aux_loss"]), atol=1e-6)


def test_every_row_takes_capacity():
    """Rows the caller ignores (idle slots, padding queries) are routed and
    take capacity as in the reference: a (b, s) call equals the
    reference's on the same (b, s) rows, and differs from routing the live
    rows alone once capacity binds."""
    cfg = _cfg(4, 2, 0.5, 0)
    tcfg = torch_config(cfg)
    jp, tp = _params(cfg, seed=8)
    x = _x(4, 6, cfg.d_model, seed=9)
    y_t, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x))
    y_j, _ = jmoe.moe_ffn(cfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
    live, _ = tmoe.moe_ffn(tcfg, tp, torch.from_numpy(x[:1]))
    assert not np.allclose(live.numpy(), y_t.numpy()[:1], atol=1e-4)


def test_config_carries_moe_fields():
    cfg = _cfg(6, 2, 0.75, 1)
    tcfg = torch_config(cfg)
    assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(cfg.moe)
