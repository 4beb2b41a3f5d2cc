"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads,
against the reference: ``SHAPE_CELLS``, ``LONG_CONTEXT_ARCHS`` and
``cells_for``; ``ModelFns.input_specs`` at the full configs leaf for leaf
(shape and dtype) against JAX's ``get_model(cfg).input_specs(cell)``; the
per-device argument bytes of each reduced arch's three cells on fake
(data 4, model 2) and (pod 2, data 2, model 2) meshes against the local
shard sizes of the reference's ``param_pspecs`` / ``batch_pspecs`` /
``cache_pspecs``; reduced qwen2.5-14b's training step on a fake 8-rank
group, its all-gather and reduce-scatter bytes against a count made from
the specs and its FLOPs at world size 1 against ``FlopCounterMode`` on a
real CPU run; FLOPs and collective bytes that grow by the same amount
per layer (every layer is traced); a cell that cannot trace recorded as failed; the CLI. Every fake process
group is destroyed by the test that made it."""
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import LONG_CONTEXT_ARCHS as J_LONG  # noqa: E402
from repro.configs import SHAPE_CELLS as J_CELLS  # noqa: E402
from repro.configs import cells_for as jcells_for  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models.api import get_model as jget_model  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import (LONG_CONTEXT_ARCHS, SHAPE_CELLS, cells_for,  # noqa: E402
                                 get_config)
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_fake_mesh  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402


class FakeMesh:
    """Duck-typed mesh (``tests/test_dist_units.py``): the reference's rules
    read only ``.shape`` and ``.axis_names``."""

    def __init__(self, **sizes):
        self._sizes = dict(sizes)

    @property
    def shape(self):
        return dict(self._sizes)

    @property
    def axis_names(self):
        return tuple(self._sizes)


MESHES = {"data4_model2": dict(data=4, model=2),
          "pod2_data2_model2": dict(pod=2, data=2, model=2)}
THREE = [c for c in SHAPE_CELLS if c.name != "long_500k"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced(monkeypatch):
    """The dry run on the reduced configs (layers as given per arch)."""
    layers = {}

    def cfg_of(arch, reduced=False):
        cfg = get_config(arch, reduced=True)
        return cfg.with_(num_layers=layers[arch]) if arch in layers else cfg
    monkeypatch.setattr(dryrun, "get_config", cfg_of)
    return layers


@pytest.fixture
def art_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    return tmp_path


def fake_mesh(sizes):
    return make_fake_mesh(tuple(sizes.values()), tuple(sizes), "cpu")


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _specs(tree, is_leaf=None) -> dict:
    return {shd.path_str(p): s for p, s in tu.flatten_with_keys(tree, is_leaf=is_leaf)}


def _jax_leaves(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jshd.path_str(p): x for p, x in flat}


def test_shape_cells_match_reference():
    assert [dataclasses.astuple(c) for c in SHAPE_CELLS] == [
        dataclasses.astuple(c) for c in J_CELLS]
    assert LONG_CONTEXT_ARCHS == J_LONG
    for arch in ARCH_IDS:
        assert [c.name for c in cells_for(arch)] == [c.name for c in jcells_for(arch)], arch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every leaf of every cell's stand-ins, full config: shape and dtype.
    The dense caches' ``len`` is a host int in the port (ROADMAP §3), an
    int32 scalar in JAX: that leaf is compared apart."""
    fns, jfns = get_model(get_config(arch)), jget_model(jget_config(arch))
    for cell, jcell in zip(cells_for(arch), jcells_for(arch)):
        got = _specs(fns.input_specs(cell))
        want = _jax_leaves(jfns.input_specs(jcell))
        if "cache/len" in want:
            assert got.pop("cache/len") == 0 and want.pop("cache/len").shape == ()
        assert set(got) == set(want), (cell.name, set(got) ^ set(want))
        for path, x in got.items():
            assert x.device.type == "meta", path
            assert (tuple(x.shape), _dt(x.dtype)) == (
                tuple(want[path].shape), str(want[path].dtype)), (cell.name, path)


def _local_bytes(shape, dtype, spec, sizes) -> int:
    n = 1
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        n *= dim // math.prod(sizes[a] for a in axes)
    return n * jax.numpy.dtype(dtype).itemsize


def _tree_bytes(shapes, specs, sizes, dtype=None) -> int:
    s = _jax_leaves(specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return sum(_local_bytes(x.shape, dtype or x.dtype, s[p], sizes)
               for p, x in _jax_leaves(shapes).items() if p != "len")


def _reference_argument_bytes(arch, cell, sizes) -> int:
    """Local shard bytes of the reference's placed inputs of ``cell``: the
    params (and AdamW's f32 moments with their specs plus its int32 step)
    and the batch, or the params, the cache (but its ``len``) and the
    tokens; the port's step also takes its rank key ``prng.key``."""
    mesh = FakeMesh(**sizes)
    jcfg = jget_config(arch, reduced=True).with_(mesh_axes=tuple(sizes))
    jfns = jget_model(jcfg)
    pshape = jax.eval_shape(jfns.init, jax.random.PRNGKey(0))
    pspecs = jshd.param_pspecs(pshape, jcfg, mesh)
    n = _tree_bytes(pshape, pspecs, sizes)
    specs = jfns.input_specs(cell)
    if cell.kind == "train":
        n += 2 * _tree_bytes(pshape, pspecs, sizes, "float32") + 4 + prng.key(0).nbytes
    if cell.kind in ("train", "prefill"):
        return n + _tree_bytes(specs["batch"], jshd.batch_pspecs(specs["batch"], mesh), sizes)
    cache = specs["cache"]
    return (n + _tree_bytes(cache, jshd.cache_pspecs(cache, jcfg, mesh), sizes)
            + _tree_bytes({"t": specs["tokens"]},
                          jshd.batch_pspecs({"t": specs["tokens"]}, mesh), sizes))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_reference_specs(arch, mesh_name, reduced):
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = MESHES[mesh_name]
    mesh = fake_mesh(sizes)
    try:
        for cell in THREE:
            with FakeTensorMode(allow_non_fake_inputs=True):
                _, args = dryrun.build_cell(arch, cell, mesh, device="cpu")
                got = dryrun.StepCounter(dryrun.local_tensors(args), {}).argument_bytes
            assert got == _reference_argument_bytes(arch, cell, sizes), (cell.name, got)
    finally:
        dist.destroy_process_group()


def _spec_collective_bytes(sizes, cell):
    """All-gather and reduce-scatter result bytes of the sharded step, from
    the reference's param specs: each param gathered whole, DTensor taking
    its mesh dims innermost first ('model', then the data axes), each
    result counted; each gradient reduced to its placement in mesh order, a
    reduce-scatter over each data axis it is sharded on (a slice, no
    collective, over 'model'); plus the batch's rows gathered (the step
    takes the global batch)."""
    names = list(sizes)
    jcfg = jget_config("qwen2.5-14b", reduced=True).with_(mesh_axes=tuple(names))
    pshape = jax.eval_shape(jget_model(jcfg).init, jax.random.PRNGKey(0))
    specs = _jax_leaves(jshd.param_pspecs(pshape, jcfg, FakeMesh(**sizes)),
                        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    gather = scatter = 0
    for path, x in _jax_leaves(pshape).items():
        item = jax.numpy.dtype(x.dtype).itemsize
        dim_of = {a: d for d, e in enumerate(specs[path])
                  for a in ((e,) if isinstance(e, str) else tuple(e or ()))}
        shape = [n // math.prod(sizes[a] for a, d in dim_of.items() if d == i)
                 for i, n in enumerate(x.shape)]
        for a in reversed(names):
            if a in dim_of:
                shape[dim_of[a]] *= sizes[a]
                gather += math.prod(shape) * item
        grad = list(x.shape)
        for a in names:
            if a in dim_of:
                grad[dim_of[a]] //= sizes[a]
                if a != "model":
                    scatter += math.prod(grad) * item
    gather += 2 * cell.global_batch * cell.seq_len * 4      # tokens, labels (int32)
    return gather, scatter


def test_train_collectives_match_spec_count(reduced):
    sizes = MESHES["data4_model2"]
    cell = SHAPE_CELLS[0]
    mesh = fake_mesh(sizes)
    try:
        rec = dryrun.trace_step("qwen2.5-14b", cell, mesh, device="cpu")
    finally:
        dist.destroy_process_group()
    coll = rec["collectives"]
    assert (coll["all-gather"], coll["reduce-scatter"]) == _spec_collective_bytes(sizes, cell)
    assert coll["counts"]["all-gather"] > 0 and coll["counts"]["reduce-scatter"] > 0
    assert set(coll["by_axis"]) == {"data", "model"}
    assert sum(coll["by_axis"].values()) == coll["total"]
    # CommDebugMode sees the same collectives
    assert sum(rec["comm_debug_counts"].values()) == sum(coll["counts"].values())
    assert rec["devices"] == 8 and rec["memory"]["temp_bytes"] > 0


def _fake_and_real_flops(overrides=None):
    """The FLOPs of reduced qwen2.5-14b's train step at 4 x 32 traced on a
    fake (1, 1) mesh, and FlopCounterMode's of the same step run for real
    on the CPU (a one-rank gloo group)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    cell = ShapeCell("train_4k", 32, 4, "train")
    mesh = fake_mesh({"data": 1, "model": 1})
    try:
        rec = dryrun.trace_step("qwen2.5-14b", cell, mesh, device="cpu", overrides=overrides)
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        fn, args = dryrun.build_cell("qwen2.5-14b", cell, mesh, overrides=overrides,
                                     device="cpu")
        for x in dryrun.local_tensors(args):
            x.zero_()
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
        assert torch.isfinite(out[2]["loss"])
    finally:
        dist.destroy_process_group()
    return rec["flops"], fc.get_total_flops()


def test_train_flops_match_real_run_at_world_size_1(reduced):
    """The fake trace's FLOPs equal FlopCounterMode on the same step run for
    real on the CPU (a one-rank gloo group)."""
    fake, real = _fake_and_real_flops()
    assert fake == real > 0


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_train_counts(reduced, remat):
    """The train cell of reduced qwen2.5-14b on a fake (data 4, model 2)
    mesh under each ``remat``, against 'none': 'dots' recomputes no matrix
    product, so its FLOPs are 'none''s; 'full' recomputes each layer's
    forward, so its FLOPs are more and its temporaries less (the layers
    keep only their inputs). The checkpointed sharded step traces on fake
    tensors and, at world size 1, counts the FLOPs of a real run."""
    cell = SHAPE_CELLS[0]
    recs = {}
    for r in ("none", remat):
        mesh = fake_mesh(MESHES["data4_model2"])
        try:
            recs[r] = dryrun.trace_step("qwen2.5-14b", cell, mesh, device="cpu",
                                        overrides={"remat": r})
        finally:
            dist.destroy_process_group()
    got, want = recs[remat], recs["none"]
    if remat == "dots":
        assert got["flops"] == want["flops"]
    else:
        assert got["flops"] > want["flops"]
        assert got["memory"]["temp_bytes"] < want["memory"]["temp_bytes"]
    assert got["collectives"] == want["collectives"]
    fake, real = _fake_and_real_flops({"remat": remat})
    assert fake == real > 0


def test_trace_counts_every_layer(reduced, art_dir):
    """The eager trace counts every layer: at depths 1, 3 and 4 (each a
    tagged run with a ``num_layers`` override, as the hillclimb runs its
    variants) the FLOPs and collective bytes grow by the same amount per
    layer. Each tagged run writes an artifact of its own."""
    cell = SHAPE_CELLS[0]
    recs = {k: dryrun.run_cell("qwen2.5-14b", cell, "single", device="cpu",
                               tag=f"__L{k}", overrides={"num_layers": k})
            for k in (1, 3, 4)}
    assert all(r["ok"] for r in recs.values())
    for count in (lambda r: r["flops"], lambda r: r["collectives"]["total"]):
        per_layer = (count(recs[3]) - count(recs[1])) / 2
        assert per_layer > 0 and count(recs[4]) == count(recs[3]) + per_layer
    assert {p.name for p in art_dir.iterdir()} == {
        f"qwen2.5-14b__train_4k__single__L{k}.json" for k in (1, 3, 4)}


def test_untraceable_cell_is_recorded_failed(reduced, art_dir, monkeypatch):
    """A data-dependent op under fake tensors fails the cell with its error;
    nothing is written down as a count."""
    real = dryrun.get_model

    def with_item(cfg):
        fns = real(cfg)

        def loss(p, b, **kw):
            int(b["tokens"].sum())
            return fns.loss(p, b, **kw)
        return fns._replace(loss=loss)
    monkeypatch.setattr(dryrun, "get_model", with_item)
    rec = dryrun.run_cell("qwen2.5-14b", SHAPE_CELLS[1], "single", device="cpu")
    assert rec["ok"] is False and "flops" not in rec
    assert "DataDependent" in rec["error"], rec["error"]
    assert json.loads((art_dir / "qwen2.5-14b__prefill_32k__single.json").read_text()) == rec
    assert not dist.is_initialized()


def test_cli_writes_artifacts(reduced, art_dir):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "rwkv6-1.6b", "--cell", "long_500k", "--mesh", "both",
                     "--device", "cpu"])
    assert e.value.code == 0
    for mesh, devices in (("single", 256), ("multi", 512)):
        rec = json.loads((art_dir / f"rwkv6-1.6b__long_500k__{mesh}.json").read_text())
        assert rec["ok"] and rec["devices"] == devices and rec["device"] == "cpu"
        assert rec["memory"]["argument_bytes"] > 0 and rec["counts"] == dryrun.COUNTS


def test_cli_refuses_cuda_without_cuda(monkeypatch, art_dir):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "qwen2.5-14b", "--cell", "train_4k", "--device", "cuda"])
    assert not list(art_dir.iterdir()) and not dist.is_initialized()


def test_production_mesh_refuses_an_existing_group():
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True, device="cpu")
    try:
        assert shd.mesh_sizes(mesh) == {"pod": 2, "data": 16, "model": 16}
        assert dist.get_world_size() == 512 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="process group exists"):
            make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
