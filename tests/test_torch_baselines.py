"""The paper's static comparison baselines (``repro_torch.core.baselines``)
against ``repro.core.baselines`` on the same numpy inputs: FAVOR+
features, Performer attention (causal prefix sums and the non-causal
form) and Nystromformer (landmarks, 6 Newton-Schulz pseudo-inverse
iterations, the causal mass-fraction rescale), GQA-free (b, s, h, d)
layouts as ``mhsa`` hands them over; then the whole forward in rank modes
'performer' and 'nystrom' at s = 64 (below the flash branch's 1024 keys).

The Performer's feature matrices are JAX's own ``orthogonal_proj(
PRNGKey(42), ...)`` carried across by ``convert.proj_from_jax``: the port
draws its own from a seeded ``torch.Generator`` (the same distribution;
JAX's chi-square draw is a rejection sampler, not worth porting bit for
bit), which the last test checks for shape, orthogonality and norms.

Tolerances: features 1e-6 relative; attention outputs 1e-5 absolute (f32
sums of up to 1040 terms in another order); Nystromformer's pseudo-
inverse iterations amplify rounding, so its outputs 1e-4; logits 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.convert import proj_from_jax  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402


def _qkv(s, h=4, d=16, dv=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, s, h, d), (2, s, h, d), (2, s, h, dv))]


def _proj(h=4, m=32, d=16):
    return np.asarray(jb.orthogonal_proj(jax.random.PRNGKey(42), h, m, d))


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("m", [16, 40])
def test_favor_features_match_jax(m):
    q, _, _ = _qkv(37)
    proj = _proj(m=m)
    _close(tb.favor_features(torch.from_numpy(q), proj_from_jax(proj, "cpu")),
           jb.favor_features(jnp.asarray(q), jnp.asarray(proj)), 1e-7, 1e-6)


@pytest.mark.parametrize("s", [64, 1040])
@pytest.mark.parametrize("causal", [True, False])
def test_performer_attention_matches_jax(s, causal):
    q, k, v = _qkv(s, seed=s)
    proj = _proj()
    want = jb.performer_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  proj=jnp.asarray(proj), causal=causal)
    got = tb.performer_attention(*map(torch.from_numpy, (q, k, v)),
                                 proj=proj_from_jax(proj, "cpu"), causal=causal)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("s,landmarks", [(64, 8), (1040, 32), (37, 8), (5, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_nystrom_attention_matches_jax(s, landmarks, causal):
    """s = 37 leaves a tail past the last whole segment out of the
    landmarks; s = 5 < 8 landmarks takes one token per landmark."""
    q, k, v = _qkv(s, seed=s + 1)
    want = jb.nystrom_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                n_landmarks=landmarks, causal=causal)
    got = tb.nystrom_attention(*map(torch.from_numpy, (q, k, v)),
                               n_landmarks=landmarks, causal=causal)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("mode", ["performer", "nystrom"])
@pytest.mark.parametrize("arch", ["drrl-paper", "qwen2.5-14b"])
def test_baseline_forward_matches_jax(mode, arch):
    """Reduced drrl-paper and reduced qwen2.5-14b (GQA: k/v repeated to
    the q heads before the baseline) at s = 64, logits 1e-4."""
    cfg = get_config(arch, reduced=True).with_(rank=RankConfig(
        mode=mode, rank_grid=(4, 8, 12, 16), fixed_rank=8))
    tcfg = torch_config(cfg)
    jparams, tparams = jax_and_torch_params(cfg)
    toks = np.random.default_rng(2).integers(0, 256, (2, 64)).astype(np.int32)
    kw = {}
    if mode == "performer":
        dh = cfg.resolved_head_dim()
        kw["proj"] = proj_from_jax(_proj(cfg.num_heads, max(2 * dh, 32), dh), "cpu")
    lj, _ = jtr.forward_dense(cfg, jparams, jnp.asarray(toks))
    lt, _ = ttr.forward_dense(tcfg, tparams, torch.from_numpy(toks), **kw)
    _close(lt, lj, 1e-4)


def test_orthogonal_proj_distribution():
    """The port's own draw: (h, m, d), each d-row block orthogonal up to
    the chi(d) row norms, norms like JAX's (mean of chi^2(d) = d), the
    same matrices from the same seed, and the forward's default draw is
    the seed-42 one."""
    h, m, d = 3, 40, 16
    w = tb.orthogonal_proj(torch.Generator().manual_seed(42), h, m, d)
    assert w.shape == (h, m, d)
    norms = w.norm(dim=-1)
    for blk in range(0, m, d):
        u = w[:, blk:blk + d] / norms[:, blk:blk + d, None]
        gram = u @ u.transpose(1, 2)
        np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[-1])[None]
                                   .repeat(h, 0), atol=1e-5)
    sq = (norms ** 2).flatten().numpy()
    ref = (np.asarray(_proj(8, 64, d)) ** 2).sum(-1).flatten()
    assert abs(sq.mean() - d) < 3 and abs(ref.mean() - d) < 3
    again = tb.orthogonal_proj(torch.Generator().manual_seed(42), h, m, d)
    assert torch.equal(w, again)
    cfg = torch_config(get_config("drrl-paper", reduced=True).with_(
        rank=RankConfig(mode="performer", fixed_rank=8)))
    ctx = ttr.make_rank_ctx(cfg, device="cpu")
    dh = cfg.resolved_head_dim()
    want = tb.orthogonal_proj(torch.Generator().manual_seed(42), cfg.num_heads,
                              max(2 * dh, 32), dh)
    assert torch.equal(ctx["proj"], want)
