"""The encoder-decoder (seamless-m4t-medium) and the VLM's M-RoPE
(qwen2-vl-7b) on the port against the JAX package, reduced, on JAX's
``init(PRNGKey(0))`` parameters (jitted) carried across by
``params_from_jax`` and the same numpy frames, patch embeddings, positions
and tokens: seamless ``encode``, ``forward_encdec`` (rank modes 'off' and
'adaptive'; the decoder's chunked self-attention at 1040 target tokens,
JAX ``_attend_chunked`` against the port's plain ``lowrank_flash``),
``loss``, ``prefill_cross`` and ``decode_step_encdec`` step by step;
``apply_mrope`` on (t, h, w) streams that differ (a patch grid, then text)
and its sections' order; qwen2-vl's ``forward_dense`` with patch
embeddings prepended and 3-stream positions ('off' and 'adaptive', ranks),
its chunked forward at 1040 positions, its ``loss`` with ``patch_embeds``
and ``positions`` in the batch, and ``decode_step_dense`` with the default
3-stream positions; and the port's ``Engine`` refusing qwen2-vl (no paged
step for M-RoPE), as the reference's does.

Tolerances: f32 logits and encoder states 1e-4 absolute, losses 1e-5,
ranks identical; ``apply_mrope`` 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig  # noqa: E402
from torch_parity import torch_config  # noqa: E402

GRID = (4, 8, 12, 16)
SEAMLESS, QWEN_VL = "seamless-m4t-medium", "qwen2-vl-7b"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PARAMS = {}


def _model(arch, mode="off"):
    """(JAX config, the port's, JAX params, the port's), the parameters
    drawn once per arch whatever the rank mode."""
    cfg = get_config(arch, reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=GRID, segment_len=8))
    if arch not in _PARAMS:
        jp = jax.jit(jax_get_model(cfg).init)(jax.random.PRNGKey(0))
        _PARAMS[arch] = (jp, params_from_jax(jax.device_get(jp), device="cpu"))
    return (cfg, torch_config(cfg)) + _PARAMS[arch]


def _rng(seed):
    return np.random.default_rng(seed)


def _tokens(b, s, seed=0):
    return _rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                               rtol=0)


def _frames(b, s, seed=1):
    return _rng(seed).standard_normal((b, s, 64)).astype(np.float32)


def test_encode_matches_jax():
    cfg, tcfg, jp, tp = _model(SEAMLESS)
    fr = _frames(2, 16)
    m_j = jax.jit(lambda p, f: je.encode(cfg, p, f))(jp, jnp.asarray(fr))
    m_t = te.encode(tcfg, tp, torch.from_numpy(fr))
    assert m_t.shape == (2, 16, 64)
    _close(m_t, m_j)


@pytest.mark.parametrize("mode,s,chunked", [("off", 24, False), ("adaptive", 24, False),
                                            ("adaptive", 1040, True)])
def test_forward_encdec_matches_jax(mode, s, chunked):
    cfg, tcfg, jp, tp = _model(SEAMLESS, mode)
    fr, toks = _frames(1, 16), _tokens(1, s)
    lg_j, _ = jax.jit(lambda p, f, t: je.forward_encdec(cfg, p, f, t, chunked=chunked))(
        jp, jnp.asarray(fr), jnp.asarray(toks))
    lg_t, aux = te.forward_encdec(tcfg, tp, torch.from_numpy(fr), torch.from_numpy(toks),
                                  chunked=chunked)
    assert aux == {}
    _close(lg_t, lg_j)


def test_encdec_loss_matches_jax():
    cfg, tcfg, jp, tp = _model(SEAMLESS, "adaptive")
    toks = _tokens(2, 20, seed=2)
    batch = {"frames": _frames(2, 16, seed=3), "tokens": toks,
             "labels": np.roll(toks, -1, 1)}
    l_j, _ = jax.jit(jax_get_model(cfg).loss)(jp, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})
    l_t, _ = get_model(tcfg).loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(l_t.item(), float(l_j), atol=1e-5, rtol=0)


def test_encdec_decode_matches_jax():
    """``init_cache`` (src_len = frontend_positions), ``prefill_cross``
    from the encoder memory, then an 8-token prompt and three single tokens,
    each step against JAX's; the last step also against the teacher-forced
    forward over the same 11 tokens."""
    cfg, tcfg, jp, tp = _model(SEAMLESS)
    fr, toks = _frames(2, 16, seed=4), _tokens(2, 11, seed=5)
    fj, ft = jax_get_model(cfg), get_model(tcfg)
    cache_j = fj.init_cache(2, 16)
    cache_t = ft.init_cache(2, 16, device="cpu")
    assert cache_t["xk"].shape == tuple(cache_j["xk"].shape) == (2, 2, 16, 4, 16)
    cache_j = je.prefill_cross(cfg, jp, je.encode(cfg, jp, jnp.asarray(fr)), cache_j)
    cache_t = te.prefill_cross(tcfg, tp, te.encode(tcfg, tp, torch.from_numpy(fr)), cache_t)
    _close(cache_t["xk"], cache_j["xk"])
    _close(cache_t["xv"], cache_j["xv"])
    step_j = jax.jit(fj.decode_step)
    for a, b in ((0, 8), (8, 9), (9, 10), (10, 11)):
        d_j, cache_j = step_j(jp, cache_j, jnp.asarray(toks[:, a:b]))
        d_t, cache_t = ft.decode_step(tp, cache_t, torch.from_numpy(toks[:, a:b]))
        _close(d_t, d_j)
    assert cache_t["len"] == 11 == int(cache_j["len"])
    full, _ = te.forward_encdec(tcfg, tp, torch.from_numpy(fr), torch.from_numpy(toks))
    _close(d_t[:, -1], full[:, -1].numpy())


def _vlm_positions(b, n_patch, s_txt, grid_w):
    """Qwen2-VL's 3-stream ids: the patches of one image on a grid of
    ``grid_w`` columns (t = 0, h = row, w = column), then text whose three
    streams continue together from max + 1."""
    i = np.arange(n_patch)
    img = np.stack([np.zeros_like(i), i // grid_w, i % grid_w])
    txt = img.max() + 1 + np.arange(s_txt)
    pos = np.concatenate([img, np.stack([txt] * 3)], axis=1)
    return np.broadcast_to(pos[None], (b, 3, n_patch + s_txt)).astype(np.int32).copy()


@pytest.mark.parametrize("sections", [(2, 3, 3), (3, 3, 2)])
def test_apply_mrope_matches_jax(sections):
    """On a patch grid's (t, h, w) ids the three streams differ, so a wrong
    section order shows: the rotation also differs from plain RoPE on any
    one stream."""
    x = _rng(6).standard_normal((2, 20, 3, 16)).astype(np.float32)
    pos = _vlm_positions(2, 12, 8, 4)
    assert not (pos[:, 0] == pos[:, 1]).all() and not (pos[:, 1] == pos[:, 2]).all()
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), sections, 1e6)
    _close(got, want, 1e-6)
    for stream in range(3):
        one = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[:, stream]), 1e6)
        assert (one - got).abs().max().item() > 1e-3
    with pytest.raises(ValueError, match="sum to d/2"):
        tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (2, 3, 2), 1e6)


@pytest.mark.parametrize("mode,s_txt,chunked", [("off", 24, False), ("adaptive", 24, False),
                                                ("adaptive", 1032, True)])
def test_vlm_forward_matches_jax(mode, s_txt, chunked):
    """8 patch embeddings on a 4-column grid prepended to ``s_txt`` tokens
    (1032: 1040 positions, the flash branch)."""
    cfg, tcfg, jp, tp = _model(QWEN_VL, mode)
    b = 1 if chunked else 2
    pe = _rng(7).standard_normal((b, 8, 64)).astype(np.float32)
    toks = _tokens(b, s_txt, seed=8)
    pos = _vlm_positions(b, 8, s_txt, 4)
    lg_j, aux_j = jax.jit(lambda p, t, e, q: jt.forward_dense(
        cfg, p, t, positions=q, extra_embeddings=e, collect_aux="ranks",
        chunked=chunked))(jp, jnp.asarray(toks), jnp.asarray(pe), jnp.asarray(pos))
    lg_t, aux_t = tt.forward_dense(tcfg, tp, torch.from_numpy(toks),
                                   positions=torch.from_numpy(pos),
                                   extra_embeddings=torch.from_numpy(pe),
                                   collect_aux="ranks", chunked=chunked)
    assert lg_t.shape == (b, 8 + s_txt, 256)
    _close(lg_t, lg_j)
    if mode != "off":
        np.testing.assert_array_equal(aux_t["layers"]["rank"].numpy(),
                                      np.asarray(aux_j["layers"]["rank"]))


def test_vlm_loss_matches_jax():
    """The batch of the reference's VLM stub: patch embeddings, 3-stream
    positions, labels over patches and text."""
    cfg, tcfg, jp, tp = _model(QWEN_VL, "adaptive")
    toks = _tokens(2, 16, seed=9)
    batch = {"tokens": toks, "patch_embeds": _rng(10).standard_normal((2, 8, 64)).astype(
        np.float32), "positions": _vlm_positions(2, 8, 16, 4),
        "labels": _tokens(2, 24, seed=11)}
    l_j, _ = jax.jit(jax_get_model(cfg).loss)(jp, {k: jnp.asarray(v)
                                                   for k, v in batch.items()})
    l_t, _ = get_model(tcfg).loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(l_t.item(), float(l_j), atol=1e-5, rtol=0)


def test_vlm_decode_matches_jax():
    """``decode_step_dense`` with the default positions (cache['len'] on
    all three streams): a 10-token prompt, then three single tokens, each
    against JAX's; the last also against the forward over the 13 tokens."""
    cfg, tcfg, jp, tp = _model(QWEN_VL)
    toks = _tokens(2, 13, seed=12)
    fj, ft = jax_get_model(cfg), get_model(tcfg)
    assert fj.decode_step_paged is None and ft.decode_step_paged is None
    cache_j = fj.init_cache(2, 16)
    cache_t = ft.init_cache(2, 16, device="cpu")
    step_j = jax.jit(fj.decode_step)
    for a, b in ((0, 10), (10, 11), (11, 12), (12, 13)):
        d_j, cache_j = step_j(jp, cache_j, jnp.asarray(toks[:, a:b]))
        d_t, cache_t = ft.decode_step(tp, cache_t, torch.from_numpy(toks[:, a:b]))
        _close(d_t, d_j)
    full, _ = tt.forward_dense(tcfg, tp, torch.from_numpy(toks))
    _close(d_t[:, -1], full[:, -1].numpy())


def test_engine_refuses_mrope_as_reference():
    cfg, tcfg, jp, tp = _model(QWEN_VL)
    with pytest.raises(ValueError, match="no paged decode step"):
        JaxEngine(cfg, jp, config=JaxEngineConfig(n_slots=2, max_len=32))
    with pytest.raises(ValueError, match="no paged decode step"):
        Engine(tcfg, tp, device="cpu", config=EngineConfig(n_slots=2, max_len=32))
    with pytest.raises(ValueError, match="M-RoPE"):
        tt.decode_step_paged(tcfg, tp, None, None, None, torch.zeros((1, 1)),
                             slot_lens=torch.zeros(1))
