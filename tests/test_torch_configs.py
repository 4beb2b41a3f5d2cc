"""The port's config registry against the JAX package's: every ported arch
id's full and reduced config field for field (its MoE and MLA sub-configs
too), ``n_params`` and ``n_active_params``, the registry's ids, the
parameter trees ``get_model(cfg).init`` draws (leaf paths and shapes equal
JAX ``init``'s, so ``params_from_jax`` copies leaf for leaf), and the arch
ids and families that are not ported yet raising ``not_ported`` for ROADMAP
item 18. Exact equality throughout (no tolerance: configs are data, and
the counts are integer arithmetic)."""
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

PORTED = ("qwen2.5-14b", "internlm2-20b", "phi3-medium-14b", "deepseek-coder-33b",
          "granite-moe-3b-a800m", "deepseek-v3-671b", "drrl-paper")
UNPORTED = ("zamba2-7b", "rwkv6-1.6b", "seamless-m4t-medium", "qwen2-vl-7b")
# the reference's fields the port does not carry: XLA's remat / scan /
# sharding knobs, and the fields of families still to be ported
XLA_KNOBS = {"remat", "scan_layers", "sharding", "seq_shard", "seq_shard_attn",
             "mesh_axes", "cache_seq_shard"}
LATER_FAMILIES = {"ssm", "rwkv", "num_encoder_layers", "hybrid_period",
                  "frontend_positions", "mrope_sections"}
CASES = [(a, r) for a in PORTED for r in (False, True)]
IDS = ["%s-%s" % (a, "reduced" if r else "full") for a, r in CASES]


def _as_dict(cfg):
    return dataclasses.asdict(cfg)


def test_registry_ids_match_jax():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(tconfigs._ARCH_MODULES) == set(jconfigs._ARCH_MODULES)
    assert {a for a, m in tconfigs._ARCH_MODULES.items() if m is None} == set(UNPORTED)


@pytest.mark.parametrize("arch,reduced", CASES, ids=IDS)
def test_config_matches_jax(arch, reduced):
    t = tconfigs.get_config(arch, reduced=reduced)
    j = jconfigs.get_config(arch, reduced=reduced)
    td, jd = _as_dict(t), _as_dict(j)
    for name, value in td.items():
        assert value == jd[name], f"{arch}: field {name}: {value!r} != {jd[name]!r}"
    left_out = set(jd) - set(td)
    assert left_out == XLA_KNOBS | LATER_FAMILIES, left_out
    # the later families' fields hold the reference's defaults here, so
    # nothing the port does not read shapes these models
    defaults = {f.name: f.default for f in dataclasses.fields(type(j))
                if f.name in LATER_FAMILIES}
    for name, default in defaults.items():
        assert jd[name] == (dataclasses.asdict(default) if dataclasses.is_dataclass(default)
                            else default), f"{arch}: {name} = {jd[name]!r}"
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    assert t.resolved_head_dim() == j.resolved_head_dim()


def test_field_order_matches_jax():
    """The port's fields appear in the reference's order (with its later
    families' and XLA knobs' fields left out)."""
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    ref = [f.name for f in dataclasses.fields(jconfigs.ModelConfig)
           if f.name not in XLA_KNOBS | LATER_FAMILIES]
    assert names == ref
    for tcls, jcls in ((tconfigs.MoEConfig, jconfigs.MoEConfig),
                       (tconfigs.MLAConfig, jconfigs.MLAConfig)):
        assert ([(f.name, f.default) for f in dataclasses.fields(tcls)]
                == [(f.name, f.default) for f in dataclasses.fields(jcls)])


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_arch_raises_not_ported(arch):
    with pytest.raises(NotImplementedError, match="item 18"):
        tconfigs.get_config(arch)
    with pytest.raises(NotImplementedError, match="item 18"):
        tconfigs.get_config(arch, reduced=True)


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("family", ["ssm", "rwkv", "hybrid", "encdec", "vlm"])
def test_unported_family_raises_not_ported(family):
    cfg = tconfigs.get_config("qwen2.5-14b", reduced=True).with_(family=family)
    with pytest.raises(NotImplementedError, match="item 18"):
        get_model(cfg)
    with pytest.raises(NotImplementedError, match="item 18"):
        cfg.n_params()


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
