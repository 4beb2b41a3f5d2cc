"""Serving traces and workloads of the port against the JAX package, on
the CPU:

* ``make_workload`` gives JAX's requests bit for bit, for every scenario
  and seed;
* the two packages record the same workload suite (reduced drrl-paper,
  adaptive, the four scenarios through one shared recorder): the integer
  and boolean columns are equal, the spectra within 1e-5 of each record's
  largest value, the float outcome columns within 1e-5 relative;
* each package's ``TraceReader`` reads the other's shards (the port
  writes 3 records a shard, so its columns concatenate back from many
  shards in order, against JAX's one);
* a reader rejects an unknown schema version and a missing manifest, the
  recorder rejects ``shard_size < 1``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.configs.base import RankConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import traces as jtraces  # noqa: E402
from repro.serve import workloads as jworkloads  # noqa: E402
from repro_torch.serve import ServeEngine, traces, workloads  # noqa: E402
from torch_parity import jax_and_torch_params, torch_config  # noqa: E402

pytestmark = pytest.mark.serve

GRID = (4, 8, 12, 16)
CFG = get_config("drrl-paper", reduced=True).with_(
    rank=RankConfig(mode="adaptive", rank_grid=GRID, fixed_rank=16, segment_len=8))
TCFG = torch_config(CFG)
INT_COLUMNS = ("rid", "slot", "seg_t", "kv_len", "layer_id", "prev_rank",
               "chosen_rank", "has_prev", "n_tokens", "spec_accepted",
               "spec_drafted")
FLOAT_COLUMNS = ("latency_s", "read_bytes_per_token", "agreement")


def _record(engine_cls, wl, params, directory, *, shard_size=512, **engine_kw):
    """The reference test's suite: every scenario, 4 requests of 10 tokens,
    through one recorder shared by one engine per scenario."""
    cfg = TCFG if engine_cls is ServeEngine else CFG
    tr = (traces if engine_cls is ServeEngine else jtraces).TraceRecorder(
        directory, cfg, shard_size=shard_size, scenario="suite")
    for name in wl.workload_names():
        spec = wl.make_workload(name, seed=3, n_requests=4, max_new=10,
                                vocab=cfg.vocab_size, max_prompt=40)
        eng = engine_cls(cfg, params, n_slots=4, max_len=96, page_size=16,
                         segment_len=8, max_new_cap=10, prefill_chunk=8,
                         record_traces=tr, **spec.engine_overrides, **engine_kw)
        for r in wl.build(spec):
            eng.submit(r)
        outs = eng.run()
        assert all(0 < len(v) <= 10 for v in outs.values())
    return tr.flush()


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """(jax dir, torch dir, jax manifest, torch manifest)."""
    jparams, tparams = jax_and_torch_params(CFG)
    root = tmp_path_factory.mktemp("traces")
    mj = _record(JaxServeEngine, jworkloads, jparams, root / "jax")
    mt = _record(ServeEngine, workloads, tparams, root / "torch", shard_size=3,
                 device="cpu")
    return root / "jax", root / "torch", mj, mt


@pytest.mark.parametrize("name", jworkloads.workload_names())
@pytest.mark.parametrize("seed", [0, 5, 17])
def test_workload_bitwise_jax(name, seed):
    a = jworkloads.make_workload(name, seed=seed, n_requests=7, max_new=9,
                                 vocab=512, max_prompt=44)
    b = workloads.make_workload(name, seed=seed, n_requests=7, max_new=9,
                                vocab=512, max_prompt=44)
    assert (a.name, a.engine_overrides) == (b.name, b.engine_overrides)
    assert len(a.requests) == len(b.requests) == 7
    for ra, rb in zip(a.requests, b.requests):
        assert ra.keys() == rb.keys()
        for k in ra:
            if k == "tokens":
                assert ra[k].dtype == rb[k].dtype and np.array_equal(ra[k], rb[k])
            else:
                assert ra[k] == rb[k] and type(ra[k]) is type(rb[k]), k
    for qa, qb in zip(jworkloads.build(a), workloads.build(b)):
        assert qa.rid == qb.rid and qa.arrival == qb.arrival
        assert np.array_equal(qa.tokens, qb.tokens)


def test_workload_names_and_unknown():
    assert workloads.workload_names() == jworkloads.workload_names()
    assert workloads.WORKLOADS == jworkloads.WORKLOADS
    with pytest.raises(ValueError, match="unknown workload"):
        workloads.make_workload("nope")


def test_manifests_match(recorded):
    _, _, mj, mt = recorded
    assert {**mj, "shards": None} == {**mt, "shards": None}
    assert len(mj["shards"]) == 1 and len(mt["shards"]) > 1
    assert mt["version"] == traces.TRACE_SCHEMA_VERSION == jtraces.TRACE_SCHEMA_VERSION
    assert mt["n_records"] > 0 and mt["rank_grid"] == list(GRID)


@pytest.mark.parametrize("col", INT_COLUMNS)
def test_integer_columns_equal(recorded, col):
    dj, dt, _, _ = recorded
    a = jtraces.TraceReader(dj).records[col]
    b = traces.TraceReader(dt).records[col]
    assert a.dtype == b.dtype and np.array_equal(a, b), col


@pytest.mark.parametrize("col", ("s2", "prev_s2"))
def test_spectra_columns_close(recorded, col):
    """Spectra from the two eigensolvers: within 1e-5 of each record's
    largest eigenvalue."""
    dj, dt, _, _ = recorded
    a = jtraces.TraceReader(dj).records[col]
    b = traces.TraceReader(dt).records[col]
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    scale = np.abs(a).reshape(len(a), -1).max(axis=1)[:, None, None]
    assert (np.abs(a - b) <= 1e-5 * scale).all(), np.abs(a - b).max()


@pytest.mark.parametrize("col", FLOAT_COLUMNS)
def test_float_columns_close(recorded, col):
    dj, dt, _, _ = recorded
    a = jtraces.TraceReader(dj).records[col]
    b = traces.TraceReader(dt).records[col]
    assert a.dtype == b.dtype
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=0)


@pytest.mark.parametrize("direction", ["jax_reads_torch", "torch_reads_jax"])
def test_readers_cross_read(recorded, direction):
    dj, dt, _, _ = recorded
    src, reader, own = ((dt, jtraces.TraceReader, traces.TraceReader)
                        if direction == "jax_reads_torch"
                        else (dj, traces.TraceReader, jtraces.TraceReader))
    a, b = reader(src), own(src)
    assert len(a) == len(b) and a.manifest == b.manifest
    assert sorted(a.records) == sorted(b.records)
    for k in a.records:
        assert np.array_equal(a.records[k], b.records[k]), k


def test_reset_closes_outcome_windows(tmp_path):
    """A reset ends every live stream: the open records are closed, and a
    flush after it writes them."""
    _, tparams = jax_and_torch_params(CFG)
    eng = ServeEngine(TCFG, tparams, n_slots=2, max_len=64, page_size=16,
                      segment_len=8, max_new_cap=10, prefill_chunk=8,
                      record_traces=str(tmp_path), device="cpu")
    for i in range(2):
        eng.submit(workloads.Request(rid=i, tokens=np.arange(12) + i, max_new=10))
    for _ in range(4):
        eng.step()
    assert eng.trace._open and eng.stats["decides"] == 2
    eng.reset()
    assert not eng.trace._open
    assert eng.trace.flush()["n_records"] == 2
    rec = traces.TraceReader(tmp_path).records
    assert sorted(rec["rid"].tolist()) == [0, 1] and (rec["n_tokens"] > 0).all()


def test_schema_version_rejected(recorded, tmp_path):
    _, dt, _, _ = recorded
    doc = json.loads((dt / "manifest.json").read_text())
    doc["version"] = traces.TRACE_SCHEMA_VERSION + 1
    (tmp_path / "manifest.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="schema version"):
        traces.TraceReader(tmp_path)
    with pytest.raises(FileNotFoundError):
        traces.TraceReader(tmp_path / "nowhere")


def test_recorder_validates_shard_size(tmp_path):
    with pytest.raises(ValueError, match="shard_size"):
        traces.TraceRecorder(tmp_path, TCFG, shard_size=0)
