"""The rank-r KV cache (``repro_torch.models.lowrank_cache``) against
``repro.models.lowrank_cache`` on the same parameters and tokens:
``attention_mass`` (whole prompt and a padded bucket's ``q_len``), then
``prefill_lowrank`` (mass-weighted and plain K Gram) and 8 steps of
``decode_step_lowrank``, on reduced drrl-paper and reduced qwen2.5-14b
(GQA, qkv bias).

Bases are compared through their projectors E_r E_r^T per (layer, row,
head), never raw (eigenvector signs are solver-dependent), to 1e-4; the
mass 1e-5 relative; logits 1e-4 absolute at every step; the stored V
exactly as the forward computed it, 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models import lowrank_cache as jlc  # noqa: E402
from repro_torch.models import lowrank_cache as tlc  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        cfg = get_config(arch, reduced=True).with_(rank=RankConfig(
            mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
        _MODELS[arch] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return _MODELS[arch]


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


def _projector(b):
    b = np.asarray(b, np.float64)
    return b @ np.swapaxes(b, -1, -2)


@pytest.mark.parametrize("q_len", [None, 13])
def test_attention_mass_matches_jax(q_len):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 2, 20, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 2, 20, 2, 8)).astype(np.float32)
    want = jlc.attention_mass(jnp.asarray(q), jnp.asarray(k), q_len=q_len)
    got = tlc.attention_mass(torch.from_numpy(q), torch.from_numpy(k), q_len=q_len)
    _close(got, want, 1e-6, 1e-5)


@pytest.mark.parametrize("arch", ["drrl-paper", "qwen2.5-14b"])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("rank", [4, 8])
def test_prefill_and_decode_match_jax(arch, weighted, rank):
    cfg, tcfg, jparams, tparams = _model(arch)
    toks = np.random.default_rng(1).integers(0, 256, (2, 40)).astype(np.int32)
    jc = jlc.init_lowrank_cache(cfg, 2, 64, rank)
    tc = tlc.init_lowrank_cache(tcfg, 2, 64, rank, device="cpu")
    lj, jc = jlc.prefill_lowrank(cfg, jparams, jnp.asarray(toks[:, :32]), jc,
                                 rank, weighted=weighted)
    lt, tc = tlc.prefill_lowrank(tcfg, tparams, torch.from_numpy(toks[:, :32]),
                                 tc, rank, weighted=weighted)
    assert tc["len"] == int(jc["len"]) == 32
    assert tc["kt"].shape == jc["kt"].shape and tc["basis"].shape == jc["basis"].shape
    _close(lt, lj, 1e-4)
    np.testing.assert_allclose(_projector(tc["basis"].numpy()),
                               _projector(jc["basis"]), atol=1e-4)
    _close(tc["v"], jc["v"], 1e-5)
    for i in range(32, 40):
        lj, jc = jlc.decode_step_lowrank(cfg, jparams, jc, jnp.asarray(toks[:, i:i + 1]))
        lt, tc = tlc.decode_step_lowrank(tcfg, tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
        assert tc["len"] == int(jc["len"]) == i + 1
        _close(lt, lj, 1e-4)
