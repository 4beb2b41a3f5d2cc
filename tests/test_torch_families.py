"""The dense configs (qwen2.5-14b, internlm2-20b, phi3-medium-14b,
deepseek-coder-33b) and granite-moe-3b-a800m (dense attention, the MoE FFN)
on the port against the JAX package, reduced, on the same parameters (JAX
``init(PRNGKey(0))`` through ``params_from_jax``) and the same numpy
tokens: ``forward_dense`` (rank mode 'adaptive', masked: logits and ranks),
``loss`` (granite's with its layers' auxiliary loss, kept by
``collect_aux``) and ``decode_step_dense`` for each arch; granite's chunked
forward at s = 1040 > 1024 keys; a bf16 case of qwen and of granite (bf16
params and activations, granite's f32 router); and the port's ``Engine``
against the JAX engine on the serving benchmark's staggered workload
(chunked prefill, 3 slots recycled), greedy tokens and per-step ranks
identical in 'off' and 'adaptive', granite also with capacity factor 0.5,
where the fused step's idle rows and padding queries take capacity as in
the reference; and the serving CLI's ``--arch`` over the registry (the
families without a paged step refused).

Tolerances: f32 logits 1e-4 absolute (as tests/test_torch_forward.py),
losses 1e-5, ranks and tokens identical; bf16 logits four bf16 steps of the
largest logit (2^-6 x max|logit|), the loss 2^-7 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import MoEConfig, RankConfig  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro.serve.api import Engine as JaxEngine  # noqa: E402
from repro.serve.api import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.serve.api import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, SamplingParams  # noqa: E402
from torch_parity import build_workload, jax_and_torch_params, torch_config  # noqa: E402

ARCHS = ("qwen2.5-14b", "internlm2-20b", "phi3-medium-14b", "deepseek-coder-33b",
         "granite-moe-3b-a800m")
GRID = (4, 8, 12, 16)
KNOBS = dict(n_slots=3, max_len=64, page_size=16, segment_len=8,
             max_new_cap=12, prefill_chunk=8)
WORKLOAD = build_workload(6, 12)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, mode="adaptive", **kw):
    return get_config(arch, reduced=True).with_(
        rank=RankConfig(mode=mode, rank_grid=GRID, segment_len=8), **kw)


_MODELS = {}


def _model(arch, mode="adaptive", **kw):
    key = (arch, mode, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg = _cfg(arch, mode, **kw)
        _MODELS[key] = (cfg, torch_config(cfg)) + jax_and_torch_params(cfg)
    return _MODELS[key]


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _close(t, j, atol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_decode_match_jax(arch):
    cfg, tcfg, jp, tp = _model(arch)
    toks = _tokens(2, 40)
    lg_j, aux_j = jax_get_model(cfg).loss(jp, {"tokens": jnp.asarray(toks),
                                               "labels": jnp.asarray(np.roll(toks, -1, 1))},
                                          collect_aux="ranks")
    lg_t, aux_t = get_model(tcfg).loss(tp, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(np.roll(toks, -1, 1))},
                                       collect_aux="ranks")
    np.testing.assert_allclose(lg_t.item(), float(lg_j), atol=1e-5)
    np.testing.assert_array_equal(aux_t["layers"]["rank"].numpy(),
                                  np.asarray(aux_j["layers"]["rank"]))
    if cfg.family == "moe":
        _close(aux_t["layers"]["aux_loss"], aux_j["layers"]["aux_loss"], 1e-6)
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    f_j, _ = jtr.forward_dense(cfg, jp, jnp.asarray(toks))
    f_t, _ = ttr.forward_dense(tcfg, tp, torch.from_numpy(toks))
    _close(f_t, f_j, 1e-4)
    # the dense-cache decode: a 10-token prompt, then two single tokens
    cache_j = jax_get_model(cfg).init_cache(2, 16)
    cache_t = get_model(tcfg).init_cache(2, 16, device="cpu")
    for a, b in ((0, 10), (10, 11), (11, 12)):
        d_j, cache_j = jax_get_model(cfg).decode_step(jp, cache_j, jnp.asarray(toks[:, a:b]))
        d_t, cache_t = get_model(tcfg).decode_step(tp, cache_t, torch.from_numpy(toks[:, a:b]))
        _close(d_t, d_j, 1e-4)
    assert cache_t["len"] == 12 == int(cache_j["len"])


def test_granite_chunked_forward_at_1040_matches_jax():
    """s = 1040: JAX ``_attend_chunked`` against the port's
    ``ops.flash_attention`` (the plain ``lowrank_flash``), with the MoE FFN
    routing all 1040 tokens of each row."""
    cfg, tcfg, jp, tp = _model("granite-moe-3b-a800m")
    toks = _tokens(1, 1040, seed=1)
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    lg_j, aux_j = jtr.forward_dense(cfg, jp, jnp.asarray(toks), chunked=True,
                                    collect_aux="ranks")
    lg_t, aux_t = ttr.forward_dense(tcfg, tp, torch.from_numpy(toks), chunked=True,
                                    collect_aux="ranks")
    _close(lg_t, lg_j, 1e-4)
    np.testing.assert_array_equal(aux_t["layers"]["rank"].numpy(),
                                  np.asarray(aux_j["layers"]["rank"]))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "granite-moe-3b-a800m"])
def test_bf16_forward_matches_jax(arch):
    """bf16 params and activations at reduced width (the full configs'
    types): logits within four bf16 steps of the largest."""
    cfg, tcfg, jp, tp = _model(arch, "off", dtype="bfloat16", param_dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    if cfg.family == "moe":
        assert tp["layers"]["moe"]["router"].dtype == torch.float32
    toks = _tokens(2, 24, seed=2)
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    lg_j, _ = jtr.forward_dense(cfg, jp, jnp.asarray(toks))
    lg_t, _ = ttr.forward_dense(tcfg, tp, torch.from_numpy(toks))
    assert lg_t.dtype == torch.bfloat16
    ref = np.asarray(lg_j.astype(jnp.float32))
    _close(lg_t, ref, 2 ** -6 * np.abs(ref).max())
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    l_j, _ = jax_get_model(cfg).loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    l_t, _ = get_model(tcfg).loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(l_t.item(), float(l_j), rtol=2 ** -7)


ENGINE_CASES = [("qwen2.5-14b", "off", None), ("qwen2.5-14b", "adaptive", None),
                ("granite-moe-3b-a800m", "off", None),
                ("granite-moe-3b-a800m", "adaptive", None),
                ("granite-moe-3b-a800m", "adaptive", 0.5)]
ENGINE_IDS = ["%s-%s%s" % (a, m, "" if c is None else "-cf%g" % c)
              for a, m, c in ENGINE_CASES]


@pytest.fixture(scope="module")
def jax_runs():
    """case -> (tokens per request, ranks per step) of the JAX engine."""
    cache = {}

    def run(case):
        if case not in cache:
            cfg, _, jp, _ = _engine_model(case)
            eng = JaxEngine(cfg, jp, config=JaxEngineConfig(**KNOBS))
            hs = [eng.submit(w["tokens"], JaxSamplingParams(max_new=w["max_new"]),
                             arrival=w["arrival"]) for w in WORKLOAD]
            eng.warmup()
            eng.run()
            cache[case] = ([h.result() for h in hs], eng.core.ranks_per_step())
        return cache[case]
    return run


def _engine_model(case):
    arch, mode, cf = case
    kw = {}
    if cf is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_expert=32, capacity_factor=cf)
    return _model(arch, mode, **kw)


@pytest.mark.serve
@pytest.mark.parametrize("case", ENGINE_CASES, ids=ENGINE_IDS)
def test_engine_matches_jax(case, jax_runs):
    """Greedy tokens and per-step ranks of the port's Engine (the kernel's
    plain version on the CPU) equal the JAX engine's."""
    _, tcfg, _, tp = _engine_model(case)
    want_toks, want_ranks = jax_runs(case)
    eng = Engine(tcfg, tp, device="cpu", config=EngineConfig(**KNOBS, use_kernel=True))
    hs = [eng.submit(w["tokens"], SamplingParams(max_new=w["max_new"]),
                     arrival=w["arrival"]) for w in WORKLOAD]
    eng.warmup()
    eng.run()
    for i, (h, want) in enumerate(zip(hs, want_toks)):
        np.testing.assert_array_equal(h.result(), want, err_msg=f"request {i} diverged")
    got_ranks = eng.ranks_per_step()
    assert len(got_ranks) == len(want_ranks)
    for t, (g, w) in enumerate(zip(got_ranks, want_ranks)):
        np.testing.assert_array_equal(g, w, err_msg=f"step {t}")
    assert eng.stats["mixed_steps"] > 0
    if case[1] == "adaptive":
        assert eng.stats["decides"] >= len(WORKLOAD)
    eng.core.cache.check_refs()


NO_PAGED_STEP = ("deepseek-v3-671b", "zamba2-7b", "rwkv6-1.6b", "seamless-m4t-medium",
                 "qwen2-vl-7b")


@pytest.mark.parametrize("arch", ARCHS + NO_PAGED_STEP)
def test_serve_cli_takes_every_arch(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <id>`` on the CPU: the
    reduced dense configs and granite serve; DeepSeek-V3, Zamba2, RWKV6,
    Seamless and Qwen2-VL (M-RoPE) have no paged step, so the engine
    refuses them, as the reference's does."""
    from repro_torch.launch import serve
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "8",
            "--tokens", "3", "--chunk", "4"]
    if arch in NO_PAGED_STEP:
        with pytest.raises(ValueError, match="no paged decode step"):
            serve.main(argv)
    else:
        serve.main(argv)
        assert "decoded (2, 3)" in capsys.readouterr().out
