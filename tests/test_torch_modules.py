"""The port's small modules against their JAX counterparts on the same
numpy inputs: nn, models.common, models.attention, core.lowrank,
core.perturbation, the seeded init and the parameter converter.

Tolerances: 1e-5 for f32 elementwise work and small reductions (different
summation orders), 1e-4 relative for eigen-solver outputs (LAPACK through
XLA vs through torch); bf16 results at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import nn as jnn  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.core import perturbation as jpert  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.core import lowrank as tlr  # noqa: E402
from repro_torch.core import perturbation as tpert  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

RNG = np.random.default_rng(0)


def _randn(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.float().numpy() if isinstance(t, torch.Tensor) else t,
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    x, g = _randn(3, 5, 64), _randn(64)
    tol = 1e-5 if dtype == "float32" else 2e-2
    out_t = tnn.rms_norm(torch.from_numpy(x).to(tnn.dt(dtype)),
                         torch.from_numpy(g), 1e-5)
    out_j = jnn.rms_norm(jnp.asarray(x).astype(jnn.dt(dtype)), jnp.asarray(g), 1e-5)
    assert out_t.dtype == tnn.dt(dtype)             # f32 inside, x's dtype out
    _close(out_t, out_j, tol)


def test_swiglu():
    x, wg, wu, wd = _randn(2, 7, 32), _randn(32, 48), _randn(32, 48), _randn(48, 32)
    out_t = tnn.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    out_j = jnn.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd)))
    _close(out_t, out_j, 1e-4)       # two chained matmuls of width 32 / 48


def test_apply_rope():
    x = _randn(2, 6, 4, 16)
    pos = RNG.integers(0, 300, (2, 6)).astype(np.int32)
    out_t = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    out_j = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    _close(out_t, out_j, 1e-4)       # cos/sin of angles up to 300 rad in f32


def test_repeat_kv_and_group_mean():
    x = _randn(2, 5, 3, 8)
    _close(tcommon.repeat_kv(torch.from_numpy(x), 4),
           jcommon.repeat_kv(jnp.asarray(x), 4), 0.0)
    w = _randn(2, 12, 9)
    _close(tcommon.kv_group_mean(torch.from_numpy(w), 3),
           jcommon.kv_group_mean(jnp.asarray(w), 3))


@pytest.mark.parametrize("score_dtype", ["float32", "bfloat16"])
def test_attend_kv_len_and_probs(score_dtype):
    q, k, v = _randn(2, 4, 3, 8), _randn(2, 10, 3, 8), _randn(2, 10, 3, 8)
    kv_len = np.asarray([[3, 4, 5, 6], [10, 10, 2, 1]], np.int32)[:, None, :, None]
    out_t, p_t = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.3, causal=False,
                              kv_len=torch.from_numpy(kv_len),
                              score_dtype=tnn.dt(score_dtype), return_probs=True)
    out_j, p_j = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.3, causal=False, kv_len=jnp.asarray(kv_len),
                              score_dtype=jnn.dt(score_dtype), return_probs=True)
    tol = 1e-5 if score_dtype == "float32" else 2e-2
    _close(out_t, out_j, tol)
    _close(p_t, p_j, tol)
    out_t = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), scale=0.3, causal=True, q_offset=6)
    out_j = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=0.3, causal=True, q_offset=6)
    _close(out_t, out_j)


def _gram(n, d, decay):
    x = _randn(3, n, d) * (decay ** np.arange(d))[None, None, :]
    return np.einsum("bnd,bne->bde", x, x)


@pytest.mark.parametrize("n", [40, 6])
def test_gram_spectrum_spectra_and_projectors(n):
    """Spectra and rank-r projectors agree; raw eigenvector signs do not
    have to. ``n = 6 < d`` is the rank-deficient Gram: there only the
    spectrum and the projectors onto the non-null directions are unique."""
    d = 16
    g = _gram(n, d, 0.8)
    s_t, e_t = tlr.gram_spectrum(torch.from_numpy(g))
    s_j, e_j = jlr.gram_spectrum(jnp.asarray(g))
    s_j, e_j = np.asarray(s_j), np.asarray(e_j)
    scale = s_j[..., :1]
    np.testing.assert_allclose(s_t.numpy() / scale, s_j / scale, atol=1e-4)
    assert np.all(np.diff(s_t.numpy(), axis=-1) <= 0) and s_t.min() >= 0
    for r in (2, 4, min(n, 8)):
        pt = np.einsum("bdr,ber->bde", e_t[..., :r].numpy(), e_t[..., :r].numpy())
        pj = np.einsum("bdr,ber->bde", e_j[..., :r], e_j[..., :r])
        np.testing.assert_allclose(pt, pj, atol=1e-4)


def test_ner_and_rank_for_energy():
    s2 = np.sort(np.abs(_randn(5, 16)) ** 3, axis=-1)[:, ::-1].copy()
    s2[4] = 0.0                          # all-zero spectrum: falls back to r_max
    for thr in (0.5, 0.9, 0.99):
        r_t = tlr.rank_for_energy(torch.from_numpy(s2), thr, 4, 16)
        r_j = jlr.rank_for_energy(jnp.asarray(s2), thr, 4, 16)
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    _close(tlr.ner_curve(torch.from_numpy(s2)), jlr.ner_curve(jnp.asarray(s2)))


def test_perturbation_bounds():
    q2 = np.sort(np.abs(_randn(4, 16)), axis=-1)[:, ::-1].copy()
    k2 = np.sort(np.abs(_randn(4, 16)), axis=-1)[:, ::-1].copy()
    grid = (4, 8, 12, 16)
    b_t, n_t = tpert.guardrail_report(torch.from_numpy(q2), torch.from_numpy(k2), grid, 16)
    b_j, n_j = jpert.guardrail_report(jnp.asarray(q2), jnp.asarray(k2), grid, 16)
    _close(b_t, b_j)
    _close(n_t, n_j)
    _close(tpert.delta_a_bound(torch.from_numpy(q2), torch.from_numpy(k2), 3, 16),
           jpert.delta_a_bound(jnp.asarray(q2), jnp.asarray(k2), 3, 16))
    for t in (0, 7, 1000):
        _close(tpert.annealed_threshold(1.0, 1e-3, t),
               jpert.annealed_threshold(1.0, 1e-3, t), 1e-7)


@pytest.mark.parametrize("arch", ["drrl-paper", "qwen2.5-14b"])
def test_init_shapes_scales_and_converter(arch):
    """The port's seeded init has the JAX init's tree, shapes, dtypes and
    scales; the converter carries JAX values across exactly."""
    jcfg = get_config(arch, reduced=True)
    cfg = torch_config(jcfg)
    jp, conv = jax_and_torch_params(jcfg)
    own = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jleaves) > 0
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        t_own, t_conv = own, conv
        for key in keys:
            t_own, t_conv = t_own[key], t_conv[key]
        assert tuple(t_own.shape) == leaf.shape, keys
        assert t_own.dtype == tnn.dt(jcfg.param_dtype)
        np.testing.assert_array_equal(t_conv.numpy(), np.asarray(leaf))
        a = np.asarray(leaf)
        if a.std() > 0:          # weights: same scale within sampling noise
            assert abs(t_own.float().std().item() / a.std() - 1) < 0.1, keys
