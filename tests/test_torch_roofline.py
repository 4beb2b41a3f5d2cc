"""The port's roofline, forensics and hillclimb (``benchmarks/torch_roofline.py``,
``torch_forensics.py``, ``torch_hillclimb.py``) against the reference's:
``model_flops`` for every arch x cell; ``analyse`` given the reference's
TPU constants against ``benchmarks/roofline.py:analyse`` on the same
records, and with the card's own peaks by compute dtype; the table from a
reduced dry run's artifacts; forensics' source lines; the hillclimb's
not-ported variants, a ``softmax_dtype`` variant run through the
full-depth dry run, and hypothesis texts that quote no TPU size."""
import json
import re

import pytest

torch = pytest.importorskip("torch")

from benchmarks import roofline as jroof  # noqa: E402
from benchmarks import torch_forensics, torch_hillclimb, torch_roofline  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import SHAPE_CELLS, cells_for, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reduced(monkeypatch, tmp_path):
    """The dry run on reduced configs (4 layers), its artifacts in a
    temporary directory that the roofline reads."""
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, reduced=False: get_config(arch, reduced=True)
                        .with_(num_layers=4))
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    monkeypatch.setattr(torch_roofline, "ART", tmp_path)
    return tmp_path


def _records(arch):
    """A synthetic artifact per cell of ``arch`` on each mesh."""
    return [{"arch": arch, "cell": c.name, "mesh": m, "devices": d,
             "flops": 3.1e15 * (i + 1), "bytes_accessed": 7.7e13 / (i + 1),
             "collectives": {"total": 2.9e10 * (i + 2)}}
            for i, c in enumerate(cells_for(arch))
            for m, d in (("single", 256), ("multi", 512))]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference(arch):
    for c in cells_for(arch):
        for devices in (256, 512):
            assert torch_roofline.model_flops(arch, c.name, devices) == \
                jroof.model_flops(arch, c.name, devices), c.name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analyse_matches_reference(arch):
    """With the reference's constants the terms and ratios are the
    reference's; by default the compute term takes the H100 peak of the
    arch's compute dtype, the others HBM and NVLink."""
    for rec in _records(arch):
        got = torch_roofline.analyse(rec, peak=jroof.PEAK, hbm=jroof.HBM, link=jroof.ICI)
        assert got == pytest.approx(jroof.analyse(rec), rel=1e-12)
        own = torch_roofline.analyse(rec)
        peak = torch_roofline.PEAKS[get_config(arch).dtype]
        assert own["compute_s"] == rec["flops"] / peak
        assert own["memory_s"] == rec["bytes_accessed"] / tmesh.HBM_BW
        assert own["collective_s"] == rec["collectives"]["total"] / tmesh.NVLINK_BW


def test_constants_are_the_h100_published_peaks():
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.PEAK_FLOPS_F32, tmesh.HBM_BW, tmesh.NVLINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)
    assert torch_roofline.header().startswith("NVIDIA H100 80GB HBM3, 700.00 W")


def test_table_from_dry_run_artifacts(reduced, capsys):
    for cell in SHAPE_CELLS[:3]:
        assert dryrun.run_cell("granite-moe-3b-a800m", cell, "single", device="cpu")["ok"]
    rows = torch_roofline.load_all("single")
    assert [r["cell"] for r in rows] == ["decode_32k", "prefill_32k", "train_4k"]
    for r in rows:
        rec = json.loads((reduced / f"granite-moe-3b-a800m__{r['cell']}__single.json")
                         .read_text())
        assert r == torch_roofline.analyse(rec)
        assert r["dominant"] in ("compute", "memory", "collective")
    capsys.readouterr()
    torch_roofline.main(["--mesh", "single"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == torch_roofline.header() and len(out) == 3 + len(rows)
    # the markdown table: one row per cell, single / multi; a failed cell shows its error
    (reduced / "granite-moe-3b-a800m__train_4k__multi.json").write_text(json.dumps(
        {"arch": "granite-moe-3b-a800m", "cell": "train_4k", "mesh": "multi", "ok": False,
         "error": "DataDependentOutputException: aten._local_scalar_dense.default"}))
    table = torch_roofline.markdown().splitlines()
    assert table[0].startswith(torch_roofline.header()) and len(table) == 4 + len(rows)
    train = next(line for line in table if "| train_4k |" in line)
    assert "| ok / DataDependentOutputException" in train, train
    assert "| ok / not run |" in next(line for line in table if "| decode_32k |" in line)


@pytest.mark.parametrize("cell,line", [("train_4k", "[backward: "),
                                       ("prefill_32k", "repro_torch/models/attention.py:")])
def test_forensics_names_source_lines(reduced, capsys, cell, line):
    """The collectives come from the params' gathers and gradients'
    reductions (``dist/sharding.py``); the largest ops name the model code
    that dispatched them, or in the backward pass the autograd node."""
    torch_forensics.main(["--arch", "qwen2.5-14b", "--cell", cell, "--layers", "2",
                          "--topk", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    colls = out.split("== top 4 collectives")[1].split("== top 4 ops")[0].splitlines()[1:]
    assert sum("repro_torch/dist/sharding.py" in c for c in colls) == 4, out
    assert re.search(r"all-gather\s+over (data|model)", out), out
    ops = out.split("== top 4 ops by output bytes ==")[1].split("==")[0]
    assert line in ops, out


@pytest.mark.parametrize("arch,encoder,remat", [
    ("seamless-m4t-medium", True, None), ("qwen2.5-14b", False, None),
    ("qwen2.5-14b", False, "full"), ("deepseek-v3-671b", False, "dots")],
    ids=["seamless-m4t-medium-True", "qwen2.5-14b-False", "qwen2.5-14b-remat_full",
         "deepseek-v3-671b-remat_dots"])
def test_forensics_layers_override(arch, encoder, remat):
    """``--layers`` also sets the encoder's depth where the config has an
    encoder, as the reference's does for the encoder-decoder; ``--remat``
    sets the config's ``remat``, which the port's ModelConfig carries."""
    ov = torch_forensics.overrides_of(arch, layers=2, sharding="fsdp", remat=remat)
    assert ov == {"num_layers": 2, "sharding": "fsdp",
                  **({"num_encoder_layers": 2} if encoder else {}),
                  **({"remat": remat} if remat else {})}
    assert get_config(arch).with_(**ov).remat == (remat or get_config(arch).remat)


def test_hillclimb_variants(reduced):
    lines = torch_hillclimb.climb("qwen-train", device="cpu")
    by_name = {line.split()[0]: line for line in lines if line.startswith("  v")}
    assert list(by_name) == [v[0] for v in torch_hillclimb.CELLS["qwen-train"]["variants"]]
    # remat is ported: v3_remat_none is not run for seq_shard_attn alone
    assert by_name["v3_remat_none"] == "  %-16s not ported: seq_shard_attn, %s" % (
        "v3_remat_none", torch_hillclimb.NOT_PORTED["seq_shard_attn"])
    assert "not ported: seq_shard_attn," in by_name["v2_seqshard"]
    assert "not ported" not in by_name["v0_baseline"] + by_name["v1_bf16_scores"]
    base = json.loads((reduced / "qwen2.5-14b__train_4k__single__v0_baseline.json")
                      .read_text())
    bf16 = json.loads((reduced / "qwen2.5-14b__train_4k__single__v1_bf16_scores.json")
                      .read_text())
    assert base["ok"] and bf16["ok"] and bf16["flops"] == base["flops"]
    assert bf16["bytes_accessed"] != base["bytes_accessed"]
    # a variant's artifact is read under its tag only, never as the cell's own
    assert torch_roofline.load_all("single") == []
    assert torch_roofline.load_all("single", "__v1_bf16_scores") == [
        torch_roofline.analyse(bf16)]
    assert "compute=" in by_name["v1_bf16_scores"] and "vs v0_baseline" in \
        by_name["v1_bf16_scores"]
    # a cell whose every variant names an unported field runs nothing
    assert all("not ported: seq_shard_attn," in line for line in
               torch_hillclimb.climb("qwen-prefill", device="cpu") if line.startswith("  v"))


def test_hillclimb_quotes_no_tpu_size():
    for spec in torch_hillclimb.CELLS.values():
        for variant in spec["variants"]:
            assert not re.search(r"\d\s*[GT]B", variant[2]), variant
        unported = {f for v in spec["variants"] for f in torch_hillclimb.unported(v[1])}
        assert unported <= set(torch_hillclimb.NOT_PORTED)
