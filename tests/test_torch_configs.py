"""The port's config registry against the JAX package's: every arch id's
full and reduced config field for field (its MoE, MLA, SSM and RWKV
sub-configs too), ``n_params`` and ``n_active_params``, the registry's ids,
the parameter trees ``get_model(cfg).init`` draws (leaf paths and shapes
equal JAX ``init``'s, so ``params_from_jax`` copies leaf for leaf), and
``get_model``'s dispatch of every family the reference names (the hybrid,
rwkv, encdec and vlm families to their builders, 'ssm' refused as the
reference refuses it). Exact equality throughout (no tolerance: configs
are data, and the counts are integer arithmetic)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.api import get_model as jax_get_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

FAMILY_ARCHS = ("zamba2-7b", "rwkv6-1.6b", "seamless-m4t-medium", "qwen2-vl-7b")
PORTED = ("qwen2.5-14b", "internlm2-20b", "phi3-medium-14b", "deepseek-coder-33b",
          "granite-moe-3b-a800m", "deepseek-v3-671b") + FAMILY_ARCHS + ("drrl-paper",)
# the reference's fields the port does not carry: XLA's scan knob and its
# GSPMD sequence-sharding hints (the sharding rules' fields, ``sharding``,
# ``mesh_axes`` and ``cache_seq_shard``, are carried, and so is ``remat``,
# compared like every other field)
XLA_KNOBS = {"scan_layers", "seq_shard", "seq_shard_attn"}
CASES = [(a, r) for a in PORTED for r in (False, True)]
IDS = ["%s-%s" % (a, "reduced" if r else "full") for a, r in CASES]


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_ids_match_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs._ARCH_MODULES) == set(jconfigs._ARCH_MODULES) == set(PORTED)


@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_config_matches_jax(arch, reduced):
    t = tconfigs.get_config(arch, reduced=reduced)
    j = jconfigs.get_config(arch, reduced=reduced)
    td, jd = _as_dict(t), _as_dict(j)
    for name, value in td.items():
        assert value == jd[name], f"{arch}: field {name}: {value!r} != {jd[name]!r}"
    left_out = set(jd) - set(td)
    assert left_out == XLA_KNOBS, left_out
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.resolved_head_dim() == j.resolved_head_dim()


def test_field_order_matches_jax():
    """The port's fields appear in the reference's order (with its XLA
    knobs left out), and its sub-configs' fields and defaults are the
    reference's."""
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ref = [f.name for f in dataclasses.fields(jconfigs.ModelConfig)
           if f.name not in XLA_KNOBS]
    assert names == ref
    for tcls, jcls in ((tconfigs.MoEConfig, jconfigs.MoEConfig),
                       (tconfigs.MLAConfig, jconfigs.MLAConfig),
                       (tconfigs.SSMConfig, jconfigs.SSMConfig),
                       (tconfigs.RWKVConfig, jconfigs.RWKVConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(tcls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_arch_matches_jax(arch):
    """Zamba2, RWKV6, Seamless and Qwen2-VL: full and reduced configs equal
    the reference's field for field, their sub-configs and ``n_params``
    (the reference's crude per-family formula) included."""
    for reduced in (False, True):
        t = tconfigs.get_config(arch, reduced=reduced)
        j = jconfigs.get_config(arch, reduced=reduced)
        jd = _as_dict(j)
        assert _as_dict(t) == {k: v for k, v in jd.items() if k not in XLA_KNOBS}
        assert t.n_params() == j.n_params() and t.n_params() > 0
        for sub in ("ssm", "rwkv"):
            assert (getattr(t, sub) is None) == (getattr(j, sub) is None)


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


FAMILY_CASES = [("ssm", None), ("rwkv", "rwkv6-1.6b"), ("hybrid", "zamba2-7b"),
                ("encdec", "seamless-m4t-medium"), ("vlm", "qwen2-vl-7b")]


@pytest.mark.parametrize("family,arch", FAMILY_CASES, ids=[f for f, _ in FAMILY_CASES])
def test_family_dispatches_as_jax(family, arch):
    """``get_model`` sends each family to its builder: the hybrid, rwkv and
    encdec families and the vlm have no paged step, as in the reference;
    'ssm' (which the reference's ``n_params`` counts but no config uses)
    is refused by both. ``n_params`` of each family equals the
    reference's."""
    if arch is None:
        j = jconfigs.get_config("rwkv6-1.6b", reduced=True).with_(family=family)
        t = tconfigs.get_config("rwkv6-1.6b", reduced=True).with_(family=family)
        with pytest.raises(ValueError, match="unknown family"):
            jax_get_model(j)
        with pytest.raises(ValueError, match="unknown family"):
            get_model(t)
    else:
        t, j = tconfigs.get_config(arch, reduced=True), jconfigs.get_config(arch, reduced=True)
        assert t.family == family
        fns = get_model(t)
        assert fns.decode_step_paged is None
        assert (fns.decode_step_paged is None) == (jax_get_model(j).decode_step_paged is None)
        params = fns.init(torch.Generator().manual_seed(0), device="cpu")
        assert set(params) == set(jax.eval_shape(jax_get_model(j).init,
                                                 jax.random.PRNGKey(0)))
    assert t.n_params() == j.n_params()


@pytest.mark.parametrize("arch", PORTED[:-1])
def test_init_tree_matches_jax(arch):
    """The reduced model's parameter tree: the same leaf paths (in JAX's
    leaf order), shapes and dtypes as JAX ``init``'s, and
    ``params_from_jax`` carries JAX's values across unchanged."""
    torch.set_num_threads(1)
    jcfg = jconfigs.get_config(arch, reduced=True)
    tcfg = tconfigs.get_config(arch, reduced=True)
    jp = jax.device_get(jax_get_model(jcfg).init(jax.random.PRNGKey(0)))
    tp = get_model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    paths_j = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
               for path, _ in flat_j]
    got = tu.leaves_with_path(tp)
    assert [p.replace("[", "").replace("]", "") for p, _ in got] == paths_j
    for (p, t), (_, j) in zip(got, flat_j):
        assert tuple(t.shape) == tuple(np.shape(j)), p
        assert str(t.dtype).replace("torch.", "") == str(np.asarray(j).dtype), p
    conv = params_from_jax(jp, device="cpu")
    for (p, t), (_, j) in zip(tu.leaves_with_path(conv), flat_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=p)


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-1.6b"])
def test_bf16_init_keeps_f32_leaves_as_jax(arch):
    """Under bf16 params the SSM's ``A_log``, ``dt_bias``, ``D`` and RWKV's
    ``w0``, ``u`` stay f32 in JAX ``init``, in the port's ``init`` and
    through ``params_from_jax``; every other leaf is bf16."""
    torch.set_num_threads(1)
    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    jcfg = jconfigs.get_config(arch, reduced=True).with_(**kw)
    tcfg = tconfigs.get_config(arch, reduced=True).with_(**kw)
    jp = jax.device_get(jax.jit(jax_get_model(jcfg).init)(jax.random.PRNGKey(0)))
    tp = get_model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    conv = params_from_jax(jp, device="cpu")
    f32 = {"A_log", "dt_bias", "D", "w0", "u"}
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    for (path, j), (p, t), (_, c) in zip(flat_j, tu.leaves_with_path(tp),
                                         tu.leaves_with_path(conv)):
        want = torch.float32 if p.split("/")[-1] in f32 else torch.bfloat16
        assert t.dtype == c.dtype == want, p
        assert str(np.asarray(j).dtype) == str(want).replace("torch.", ""), p
        assert tuple(t.shape) == tuple(c.shape) == tuple(np.shape(j)), p
    assert sum(p.split("/")[-1] in f32 for p, _ in tu.leaves_with_path(tp)) >= 2
