"""The port's sharding rules (``repro_torch.dist.sharding``) and activation
specs (``dist.ctx``) against the reference's, with no processes: every
arch's reduced parameter tree on duck-typed meshes of (data 4, model 2),
(pod 2, data 2, model 4) and (data 1, model 1), leaf by leaf by
``path_str``; the hostile-shape cases of ``tests/test_dist_units.py``
(prime dims, partial drops, expert stacks, 'dp' mode, norms,
``batch_pspecs`` and ``cache_pspecs`` with ``cache_seq_shard``);
``logits_spec`` / ``activation_spec``; and ``to_placements`` /
``resolve_spec`` for single and tuple axes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import ctx as jctx  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.dist import ctx  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402


class FakeMesh:
    """Duck-typed mesh (``tests/test_dist_units.py``): the rules read only
    ``.shape`` and ``.axis_names``."""

    def __init__(self, **sizes):
        self._sizes = dict(sizes)

    @property
    def shape(self):
        return dict(self._sizes)

    @property
    def axis_names(self):
        return tuple(self._sizes)


MESHES = {"data4_model2": dict(data=4, model=2),
          "pod2_data2_model4": dict(pod=2, data=2, model=4),
          "data1_model1": dict(data=1, model=1)}


def _jax_specs(tree):
    """{path_str: spec as a tuple} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jshd.path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {shd.path_str(p): s for p, s in tu.flatten_with_keys(tree, is_leaf=shd.is_spec)}


def _jcfg(**kw):
    return jget_config("qwen2.5-14b", reduced=True).with_(**kw)


def _tcfg(**kw):
    return get_config("qwen2.5-14b", reduced=True).with_(**kw)


@pytest.fixture(scope="module")
def trees():
    """Every arch's reduced parameter tree: JAX's shapes (eval_shape) and
    the port's meta tensors."""
    out = {}
    for arch in ARCH_IDS:
        jcfg, tcfg = jget_config(arch, reduced=True), get_config(arch, reduced=True)
        shapes = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
        meta = get_model(tcfg).init(torch.Generator().manual_seed(0), device="meta")
        out[arch] = (jcfg, tcfg, shapes, meta)
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_reference(trees, arch, mesh):
    jcfg, tcfg, shapes, meta = trees[arch]
    assert tcfg.sharding == jcfg.sharding
    fake = FakeMesh(**MESHES[mesh])
    want = _jax_specs(jshd.param_pspecs(shapes, jcfg, fake))
    got = _port_specs(shd.param_pspecs(meta, tcfg, fake))
    assert got == want
    flat = {shd.path_str(p): x for p, x in tu.flatten_with_keys(meta)}
    assert set(flat) == set(got)
    for name, spec in got.items():
        assert len(spec) == flat[name].dim(), name


# ------------------------------------------------- the reference's unit cases

def _both_params(tree_shapes, **cfg_kw):
    """(port specs, reference specs) of a tree of zeros of these shapes."""
    jtree = jax.tree_util.tree_map(lambda s: np.zeros(s, np.float32), tree_shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    ttree = jax.tree_util.tree_map(lambda s: torch.zeros(s), tree_shapes,
                                   is_leaf=lambda x: isinstance(x, tuple))
    return jtree, ttree


PARAM_CASES = {
    # name: (mesh, tree of shapes, cfg kwargs, {path: expected spec})
    "prime_dims_drop_all_axes": (
        dict(data=4, model=2), {"layers": {"attn": {"wq": (7, 13)}}}, {},
        {"layers/attn/wq": (None, None)}),
    "partial_drop_keeps_dividing_axis": (
        dict(data=4, model=2), {"layers": {"attn": {"wq": (7, 64)}}}, {},
        {"layers/attn/wq": (None, "model")}),
    "mesh_size_one_divides_everything": (
        dict(data=1, model=1), {"layers": {"attn": {"wq": (7, 13)}}}, {},
        {"layers/attn/wq": ("data", "model")}),
    "col_and_row_parallel": (
        dict(data=4, model=2),
        {"layers": {"attn": {"wq": (2, 64, 32), "wo": (2, 32, 64)},
                    "ffn": {"w_down": (2, 32, 64)}}}, {},
        {"layers/attn/wq": (None, "data", "model"),
         "layers/attn/wo": (None, "model", "data"),
         "layers/ffn/w_down": (None, "model", "data")}),
    "expert_stack_shards_expert_dim": (
        dict(data=4, model=2),
        {"layers": {"moe": {"w_gate": (2, 4, 64, 32), "router": (2, 64, 4),
                            "shared": {"w_gate": (2, 64, 32)}}}}, {},
        {"layers/moe/w_gate": (None, "model", "data", None),
         "layers/moe/router": (None, "data", "model"),
         "layers/moe/shared/w_gate": (None, "data", "model")}),
    "dp_mode_replicates_everything": (
        dict(data=4, model=2), {"embed": (64, 64), "layers": {"attn": {"wq": (64, 64)}}},
        {"sharding": "dp"},
        {"embed": (None, None), "layers/attn/wq": (None, None)}),
    "tp_mode_model_only": (
        dict(data=4, model=2), {"embed": (64, 64), "layers": {"attn": {"wq": (64, 64)}}},
        {"sharding": "tp"},
        {"embed": ("model", None), "layers/attn/wq": (None, "model")}),
    "fsdp_mode_data_only": (
        dict(pod=2, data=2, model=2),
        {"embed": (64, 64), "layers": {"attn": {"wo": (64, 64)}}},
        {"sharding": "fsdp"},
        {"embed": (None, ("pod", "data")), "layers/attn/wo": (None, ("pod", "data"))}),
    "norms_replicate": (
        dict(data=4, model=2), {"layers": {"ln1": (2, 64)}, "ln_f": (64,)}, {},
        {"layers/ln1": (None, None), "ln_f": (None,)}),
    "list_indices": (
        dict(data=2, model=2), {"dense_layers": [{"wq": (4, 8)}, {"wo": (8, 4)}]}, {},
        {"dense_layers/0/wq": ("data", "model"), "dense_layers/1/wo": ("model", "data")}),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_rules_match_reference(case):
    mesh, shapes, kw, expect = PARAM_CASES[case]
    fake = FakeMesh(**mesh)
    jtree, ttree = _both_params(shapes)
    want = _jax_specs(jshd.param_pspecs(jtree, _jcfg(**kw), fake))
    got = _port_specs(shd.param_pspecs(ttree, _tcfg(**kw), fake))
    assert got == want
    assert {k: got[k] for k in expect} == expect


BATCH_CASES = {
    "shards_leading_dim": (
        dict(data=4, model=2),
        {"tokens": (8, 32), "odd": (7, 32), "scalar": ()},
        {"tokens": ("data", None), "odd": (None, None), "scalar": ()}),
    "multi_pod": (
        dict(pod=2, data=4, model=2), {"tokens": (16, 8)},
        {"tokens": (("pod", "data"), None)}),
    "multi_pod_partial": (
        dict(pod=2, data=4, model=2), {"tokens": (6, 8)},
        {"tokens": ("pod", None)}),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_pspecs_match_reference(case):
    mesh, shapes, expect = BATCH_CASES[case]
    fake = FakeMesh(**mesh)
    jtree, ttree = _both_params(shapes)
    want = _jax_specs(jshd.batch_pspecs(jtree, fake))
    got = _port_specs(shd.batch_pspecs(ttree, fake))
    assert got == want == expect


@pytest.mark.parametrize("seq_shard", [False, True])
def test_cache_pspecs_match_reference(seq_shard):
    fake = FakeMesh(data=4, model=2)
    shapes = {"k": (2, 8, 64, 2, 16), "h": (8, 64), "len": ()}
    jtree, ttree = _both_params(shapes)
    want = _jax_specs(jshd.cache_pspecs(jtree, _jcfg(cache_seq_shard=seq_shard), fake))
    got = _port_specs(shd.cache_pspecs(ttree, _tcfg(cache_seq_shard=seq_shard), fake))
    assert got == want
    assert got["k"] == (None, "data", "model" if seq_shard else None, None, None)
    assert got["h"] == ("data", None) and got["len"] == ()


# ------------------------------------------------------------------ path_str

def test_path_str_round_trips_and_matches_jax():
    tree = {"layers": {"attn": {"wq": 1, "wo": 2}, "ln": 3}, "embed": 4,
            "dense_layers": [{"w": 5}, {"w": 6}]}
    jnames = [jshd.path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    flat = tu.flatten_with_keys(tree)
    assert [shd.path_str(p) for p, _ in flat] == jnames
    for path, leaf in flat:
        node = tree
        for part in shd.path_str(path).split("/"):
            node = node[int(part)] if part.isdigit() else node[part]
        assert node == leaf


# ------------------------------------------------------------ ctx's specs

CTX_CASES = [dict(mesh_axes=()), dict(mesh_axes=("data", "model")),
             dict(mesh_axes=("pod", "data", "model")),
             dict(mesh_axes=("data", "model"), sharding="dp"),
             dict(mesh_axes=("data", "model"), sharding="fsdp"),
             dict(mesh_axes=("data",))]


@pytest.mark.parametrize("kw", CTX_CASES, ids=lambda kw: "-".join(map(str, kw.values())) or "bare")
def test_ctx_specs_match_reference(kw):
    def norm(spec):
        return None if spec is None else tuple(spec)
    jcfg, tcfg = _jcfg(**kw), _tcfg(**kw)
    assert ctx.logits_spec(tcfg) == norm(jctx.logits_spec(jcfg))
    for ndim in (1, 2, 3, 4):
        assert ctx.activation_spec(tcfg, ndim) == norm(jctx.activation_spec(jcfg, ndim))


# ---------------------------------------------------------------- placement

def test_to_placements_single_and_tuple_axes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh(pod=2, data=2, model=4)
    assert shd.to_placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert shd.to_placements(("data", "model"), mesh) == (Replicate(), Shard(0), Shard(1))
    assert shd.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.to_placements((), mesh) == (Replicate(),) * 3
    assert shd.to_placements(None, mesh) == (Replicate(),) * 3
    for bad in [("data", "data"), (("data", "pod"),), ("expert",)]:
        with pytest.raises(ValueError):
            shd.to_placements(bad, mesh)


def test_resolve_spec_drops_missing_axes():
    mesh = FakeMesh(data=4)
    assert shd.resolve_spec(("data", "model"), mesh) == ("data", None)
    assert shd.resolve_spec((("pod", "data"), None), mesh) == ("data", None)
    assert shd.resolve_spec((["data", "model"],), FakeMesh(data=2, model=2)) == (
        ("data", "model"),)
    assert shd.resolve_spec([], mesh) == ()


def test_data_parallel_helpers_identity_and_thread_local():
    """With no context the row-coupling helpers are the identity; under
    ``data_parallel`` they read this rank's place; and the context holds
    only for the code that entered it, not for another thread."""
    import threading
    x = torch.arange(8.0)
    assert ctx.n_data() == 1 and ctx.my_rows(x) is x and ctx.gather_rows(x) is x
    assert ctx.global_sum(x) is x and torch.equal(ctx.sum_before(x), torch.zeros(8))
    dp = ctx.DataParallel(groups=(None, None), sizes=(2, 2), index=3)
    seen = {}
    with ctx.data_parallel(dp):
        assert ctx.n_data() == 4
        assert torch.equal(ctx.my_rows(x), torch.tensor([6.0, 7.0]))
        t = threading.Thread(target=lambda: seen.update(n=ctx.n_data(), rows=ctx.my_rows(x)))
        t.start()
        t.join()
    assert seen["n"] == 1 and seen["rows"] is x
    assert ctx.n_data() == 1
