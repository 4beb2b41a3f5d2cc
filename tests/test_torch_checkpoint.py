"""The port's checkpoints, text corpus and serving clocks against the JAX
package: a ``(params, AdamWState)`` checkpoint has JAX's leaf names and
partition specs and loads across the two packages both ways;
``ByteCorpus.batch_at`` equals JAX's bit for bit on the repo's own
``src/`` tree; ``stats['decode_s']`` leaves out the one-shot prefill that
accrues inside a step or run (``prefill_s``), by the reference's rule."""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.data.text import ByteCorpus as JByteCorpus  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.text import ByteCorpus  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serve import Engine, EngineConfig, Request, SamplingParams, ServeEngine  # noqa: E402
from repro_torch.serve import engine as engine_mod  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

SRC = str(__import__("pathlib").Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(scope="module")
def trees():
    """(params, adamw.init(params)) of reduced drrl-paper in JAX and the
    port, the optimiser state moved off zero so that every leaf differs."""
    cfg = get_config("drrl-paper", reduced=True)
    pj, pt = jax_and_torch_params(cfg)
    sj = jadamw.init(pj)
    sj = sj._replace(step=sj.step + 5,
                     m=jax.tree_util.tree_map(lambda x: x + 0.25, sj.m),
                     v=jax.tree_util.tree_map(lambda x: x + 0.5, sj.v))
    st = tadamw.AdamWState(step=torch.tensor(5, dtype=torch.int32),
                           m=tu.tree_map(lambda x: torch.zeros_like(x) + 0.25, pt),
                           v=tu.tree_map(lambda x: torch.zeros_like(x) + 0.5, pt))
    return (pj, sj), (pt, st)


def _manifest(d, step):
    return json.loads((d / f"step_{step}" / "manifest.json").read_text())


def _order(manifest):
    """Leaf names in file order (``leaf_<i>.npy``)."""
    return sorted(manifest["leaves"],
                  key=lambda n: int(manifest["leaves"][n]["file"][5:-4]))


def test_manifest_names_and_specs_match_jax(trees, tmp_path):
    (pj, sj), (pt, st) = trees
    spec_j = jax.tree_util.tree_map(lambda x: P(None, ("data", "fsdp"))
                                    if x.ndim == 2 else P(), pj)
    spec_t = tu.tree_map(lambda x: (None, ("data", "fsdp")) if x.ndim == 2
                         else (), pt)
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(3, (pj, sj), spec_j)
    CheckpointManager(tmp_path / "t", async_save=False).save(3, (pt, st), spec_t)
    mj, mt = _manifest(tmp_path / "j", 3), _manifest(tmp_path / "t", 3)
    assert _order(mt) == _order(mj)
    assert "1/step" in mt["leaves"] and "1/m/layers/attn/wq" in mt["leaves"]
    for name, ent in mj["leaves"].items():
        assert mt["leaves"][name]["spec"] == ent["spec"], name
        assert mt["leaves"][name]["dtype"] == ent["dtype"], name
    assert mt["leaves"]["0/embed"]["spec"] == [None, ["data", "fsdp"]]
    assert mt["leaves"]["1/m/embed"]["spec"] == []           # past the specs
    with pytest.raises(ValueError, match="specs has"):
        CheckpointManager(tmp_path / "u", async_save=False).save(
            1, pt, (spec_t, spec_t))


def _assert_same(tree_t, tree_j):
    flat_t = tu.leaves(tree_t[0]) + [tree_t[1].step] + tu.leaves(tree_t[1].m) \
        + tu.leaves(tree_t[1].v)
    flat_j = jax.tree_util.tree_leaves(tree_j)
    assert len(flat_t) == len(flat_j)
    for t, j in zip(flat_t, flat_j):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)


def test_jax_checkpoint_loads_into_port_and_back(trees, tmp_path):
    (pj, sj), (pt, st) = trees
    # JAX writes, the port loads into its (params, AdamWState) template
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(4, (pj, sj))
    zeros = tu.tree_map(torch.zeros_like, pt)
    template = (zeros, tadamw.init(zeros))
    (lp, ls), step, _ = CheckpointManager(tmp_path / "j").load(template)
    assert step == 4 and type(ls) is tadamw.AdamWState
    _assert_same((lp, ls), (pj, sj))
    # the port writes (async, with extra), JAX loads into its own template
    cm = CheckpointManager(tmp_path / "t")
    cm.save(6, (lp, ls), None, {"note": "port"})
    cm.wait()
    jt = jax.tree_util.tree_map(np.zeros_like, (pj, sj))
    (lpj, lsj), step, extra = JCheckpointManager(str(tmp_path / "t")).load(jt)
    assert step == 6 and extra == {"note": "port"} and type(lsj) is jadamw.AdamWState
    _assert_same((lp, ls), (lpj, lsj))


@pytest.mark.parametrize("max_bytes", [32 * 1024 * 1024, 200_000])
def test_byte_corpus_matches_jax(max_bytes, tmp_path):
    j = JByteCorpus([SRC], seq_len=32, global_batch=4, seed=3, max_bytes=max_bytes)
    t = ByteCorpus([SRC], seq_len=32, global_batch=4, seed=3, max_bytes=max_bytes)
    np.testing.assert_array_equal(t.data, j.data)
    for step in (0, 1, 17, 1000):
        bj, bt = j.batch_at(step), t.batch_at(step, device="cpu")
        assert bt["tokens"].dtype == bt["labels"].dtype == torch.int64
        assert bt["mask"].dtype == torch.float32
        for name in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(bt[name].numpy(), bj[name])
    tiny = tmp_path / "tiny.md"
    tiny.write_bytes(b"x" * 65)
    with pytest.raises(ValueError, match="too small"):
        ByteCorpus([str(tiny)], seq_len=32, global_batch=4)


# -- stats['decode_s'] against one-shot prefill --------------------------------

def _oneshot_cfg():
    cfg = torch_config(get_config("drrl-paper", reduced=True))
    return cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16),
                                     segment_len=8))


@pytest.fixture(scope="module")
def oneshot():
    cfg = _oneshot_cfg()
    params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.arange(n) % cfg.vocab_size for n in (9, 20, 14, 30)]
    return cfg, params, prompts


class FakeClock:
    """``time.perf_counter`` that advances by one second per call."""

    def __init__(self):
        self.reads = []

    def perf_counter(self):
        self.reads.append(float(len(self.reads)))
        return self.reads[-1]


def test_run_decode_s_excludes_oneshot_prefill(oneshot, monkeypatch):
    """ServeEngine.run, one-shot: the run's wall time less the prefill that
    accrued in it (``src/repro/serve/engine.py``, ``run``), on a clock
    under the test's control; the first and last reads are run's own."""
    cfg, params, prompts = oneshot
    eng = ServeEngine(cfg, params, n_slots=2, max_len=64, segment_len=8,
                      max_new_cap=6, prefill_chunk=None, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new=6, arrival=i))
    clock = FakeClock()
    monkeypatch.setattr(engine_mod, "time", clock)
    eng.run()
    st = eng.stats
    assert st["prefills"] == len(prompts) and st["prefill_s"] >= len(prompts)
    wall = clock.reads[-1] - clock.reads[0]
    assert st["decode_s"] == wall - st["prefill_s"]


def test_engine_decode_s_excludes_oneshot_prefill(oneshot):
    """Engine.step, one-shot: decode_s + prefill_s fits inside the wall
    time of the steps (each step accrues its wall less its prefill)."""
    cfg, params, prompts = oneshot
    eng = Engine(cfg, params, device="cpu", config=EngineConfig(
        n_slots=2, max_len=64, segment_len=8, prefill_chunk=None))
    hs = [eng.submit(p, SamplingParams(max_new=6), arrival=i)
          for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    eng.run()
    wall = time.perf_counter() - t0
    st = eng.stats
    assert [len(h.result()) for h in hs] == [6] * len(prompts)
    assert st["prefill_s"] > 0 and st["decode_s"] > 0
    assert st["decode_s"] + st["prefill_s"] <= wall
