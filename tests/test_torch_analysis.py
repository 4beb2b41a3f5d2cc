"""The port's invariant checker (repro_torch.analysis) on the CPU:
per-rule fixtures, the pragma life cycle with the port's own tag, parity
of the rules the port keeps unchanged (R3, R4, R5) with the JAX package's
checker on its own fixtures, the port's tree clean under its checker, and
the runtime sanitizer's plumbing (the workload, the sync guard around
exactly the step calls, the build counter, and its refusal of a non-CUDA
device). The sanitizer itself needs the card (``chip_smoke.py`` phase 19).
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import fixtures as ref_fixtures  # noqa: E402
from repro.analysis import pragmas as ref_pragmas  # noqa: E402
from repro.analysis import report as ref_report  # noqa: E402
from repro.analysis import sanitizer as ref_sanitizer  # noqa: E402
from repro_torch.analysis import sanitizer  # noqa: E402
from repro_torch.analysis.fixtures import (  # noqa: E402
    FIXTURE_REGISTRY,
    FIXTURES,
    SEED_RE,
    run_selftest,
    seeded_expectations,
)
from repro_torch.analysis.pragmas import scan_pragmas  # noqa: E402
from repro_torch.analysis.report import format_report, run_static  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SRC = os.path.join(ROOT, "src", "repro_torch")
REF_SRC = os.path.join(ROOT, "src", "repro")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the reduced engines gain nothing from more,
    and beside other test workers OpenMP's waiting threads slow them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run_fixture(tmp_path, name, source, reg=FIXTURE_REGISTRY, run=run_static):
    path = tmp_path / name
    path.write_text(source)
    un, sup = run([str(path)], reg=reg)
    return str(path), un, sup


def _seeded_lines(source, rule):
    return {i for i, line in enumerate(source.splitlines(), start=1)
            if any(m.group(1) == rule for m in SEED_RE.finditer(line))}


def _port_tag(source):
    """A JAX-package source with its pragma tag rewritten to the port's."""
    return source.replace("inv-ok[", "inv-ok-torch[")


# ---------------------------------------------------------------------------
# per-rule positive + negative
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,fixture", [
    ("R1", "fix_r1.py"),
    ("R2", "fix_r2.py"),
    ("R3", "fix_r3.py"),
    ("R4", "fix_r4.py"),
    ("R5", "fix_r5.py"),
])
def test_rule_fires_exactly_on_seeded_lines(tmp_path, rule, fixture):
    src = FIXTURES[fixture]
    _, un, _ = _run_fixture(tmp_path, fixture, src)
    found = {f.line for f in un if f.rule == rule}
    assert found == _seeded_lines(src, rule), \
        f"{rule} fired on {sorted(found)}, seeded " \
        f"{sorted(_seeded_lines(src, rule))}"
    # negative: nothing outside the seeded set, for ANY rule
    all_seeded = {(r, ln) for (r, _, ln)
                  in seeded_expectations({fixture: src}, str(tmp_path))}
    assert {(f.rule, f.line) for f in un} == all_seeded


def test_selftest_roundtrip():
    ok, lines = run_selftest()
    assert ok, "\n".join(lines)
    assert lines[-2] == "selftest: R1x10  R2x5  R3x2  R4x1  R5x2"


def test_tool_cli(tmp_path, capsys):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import check_invariants_torch as tool
    finally:
        sys.path.pop(0)
    assert tool.main(["--selftest"]) == 0
    out = tmp_path / "report.json"
    assert tool.main(["--report", "json", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["ok"] is True and doc["findings"] == []
    assert doc["suppressed"]
    bad = tmp_path / "bad.py"
    bad.write_text(FIXTURES["fix_r5.py"])
    assert tool.main([str(bad)]) == 1
    assert "2 unsuppressed finding(s)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# pragma life cycle, with the port's tag
# ---------------------------------------------------------------------------

SEEDED_SYNC = "torch.cuda.synchronize()  # seeded[R1]"


def test_justified_pragma_suppresses(tmp_path):
    src = FIXTURES["fix_r1.py"].replace(
        SEEDED_SYNC, "torch.cuda.synchronize()  # inv-ok-torch[R1]: test suppression")
    _, un, sup = _run_fixture(tmp_path, "fix_r1.py", src)
    assert not any(f.rule == "R1" and f.line == 8 for f in un)
    assert [(f.rule, f.line) for f in sup] == [("R1", 8)]
    # the pragma is live, so no R5 stale finding appears for its line
    assert not any(f.rule == "R5" for f in un)


def test_pragma_only_covers_listed_rule(tmp_path):
    # an R4 pragma on an R1 violation suppresses nothing — and is itself
    # stale
    src = FIXTURES["fix_r1.py"].replace(
        SEEDED_SYNC, "torch.cuda.synchronize()  # inv-ok-torch[R4]: wrong rule on purpose")
    _, un, sup = _run_fixture(tmp_path, "fix_r1.py", src)
    assert any(f.rule == "R1" and f.line == 8 for f in un)
    assert [(f.rule, f.line) for f in un if f.rule == "R5"] == [("R5", 8)]
    assert "stale" in next(f.message for f in un if f.rule == "R5")
    assert not sup


def test_stale_pragma_is_a_finding(tmp_path):
    _, un, _ = _run_fixture(tmp_path, "clean.py",
                            "X = 1  # inv-ok-torch[R1]: nothing ever fired here\n")
    assert [f.rule for f in un] == ["R5"]
    assert "stale" in un[0].message and "inv-ok-torch[R1]" in un[0].message


@pytest.mark.parametrize("line,complaint", [
    ("X = 1  # inv-ok-torch[R1]", "justification"),
    ("X = 1  # inv-ok-torch[]: no rules listed", "no rules"),
    ("X = 1  # inv-ok-torch[R7]: not a rule", "unknown rule"),
])
def test_malformed_pragmas_are_findings(tmp_path, line, complaint):
    _, un, _ = _run_fixture(tmp_path, "bad.py", line + "\n")
    assert [f.rule for f in un] == ["R5"]
    assert complaint in un[0].message


def test_reference_tag_is_ignored(tmp_path):
    # the JAX package's tag neither suppresses the port's finding nor
    # counts as a (stale) pragma of the port's
    src = FIXTURES["fix_r1.py"].replace(
        SEEDED_SYNC, "torch.cuda.synchronize()  # inv-ok[R1]: the other checker's tag")
    _, un, sup = _run_fixture(tmp_path, "fix_r1.py", src)
    assert any(f.rule == "R1" and f.line == 8 for f in un)
    assert not sup and not any(f.rule == "R5" for f in un)
    assert scan_pragmas("x.py", "y = 1  # inv-ok[R1]: not ours\n") == []
    # and the JAX package's scanner does not read the port's tag
    assert ref_pragmas.scan_pragmas(
        "x.py", "y = 1  # inv-ok-torch[R1]: not theirs\n") == []


def test_pragma_scanner_parses_multi_rule():
    pragmas = scan_pragmas(
        "x.py", "y = 1  # inv-ok-torch[R1,R4]: one reason for both\n")
    assert len(pragmas) == 1
    assert pragmas[0].rules == ("R1", "R4")
    assert pragmas[0].malformed is None
    assert pragmas[0].covers("R4", 1) and not pragmas[0].covers("R2", 1)


def test_json_report_shape(tmp_path):
    _, un, sup = _run_fixture(tmp_path, "fix_r3.py", FIXTURES["fix_r3.py"])
    doc = json.loads(format_report(un, sup, fmt="json"))
    assert doc["ok"] is False
    assert doc["counts"]["R3"] == len(_seeded_lines(FIXTURES["fix_r3.py"], "R3"))
    assert all({"rule", "path", "line", "col", "message",
                "rule_name"} <= set(f) for f in doc["findings"])
    _, un, sup = _run_fixture(tmp_path, "fine.py", "X = 1\n")
    assert not un and not sup
    assert "invariants clean" in format_report(un, sup)


# ---------------------------------------------------------------------------
# parity with the JAX package's checker on its own fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fixture", ["fix_r3.py", "fix_r4.py", "fix_r5.py"])
def test_kept_rules_match_reference(tmp_path, fixture):
    src = ref_fixtures.FIXTURES[fixture]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref_dir.mkdir()
    port_dir.mkdir()
    _, ref_un, ref_sup = _run_fixture(ref_dir, fixture, src,
                                      reg=ref_fixtures.FIXTURE_REGISTRY,
                                      run=ref_report.run_static)
    want = {(f.rule, f.line, f.col) for f in ref_un}
    assert want, "the reference fixture seeds findings"
    ported = _port_tag(src)
    for reg in (ref_fixtures.FIXTURE_REGISTRY, FIXTURE_REGISTRY):
        _, un, sup = _run_fixture(port_dir, fixture, ported, reg=reg)
        assert {(f.rule, f.line, f.col) for f in un} == want
        assert {(f.rule, f.line, f.col) for f in sup} == \
            {(f.rule, f.line, f.col) for f in ref_sup}
    # the pragma scanners agree on the same text
    mine = [(p.line, p.rules, p.justification, p.malformed)
            for p in scan_pragmas("x.py", ported)]
    theirs = [(p.line, p.rules, p.justification, p.malformed)
              for p in ref_pragmas.scan_pragmas("x.py", src)]
    assert mine == theirs


# ---------------------------------------------------------------------------
# the port's tree under its own checker
# ---------------------------------------------------------------------------

def _qualname(finding):
    return finding.message.rsplit("(in ", 1)[1].rstrip(")")


def test_port_tree_is_clean():
    un, sup = run_static([PORT_SRC])
    assert not un, format_report(un, sup)
    port_r1 = {(os.path.relpath(f.path, PORT_SRC), _qualname(f))
               for f in sup if f.rule == "R1"}
    # every step-loop function where the JAX engine sanctions a sync
    # carries a sanctioned sync of the port's
    _, ref_sup = ref_report.run_static([REF_SRC])
    ref_fns = {_qualname(f) for f in ref_sup if f.rule == "R1"
               and f.path.endswith(os.path.join("serve", "engine.py"))}
    assert {"ServeEngine.step", "ServeEngine.run", "ServeEngine._check_drift",
            "ServeEngine._step_live_spec",
            "ServeEngine._evict_finished"} <= ref_fns
    mine = {q for p, q in port_r1 if p == os.path.join("serve", "engine.py")}
    assert ref_fns <= mine, sorted(ref_fns - mine)
    assert any(p == os.path.join("serve", "api.py") for p, _ in port_r1)
    # the one host-value shape the speculative step needs stays visible
    assert [_qualname(f) for f in sup if f.rule == "R2"] == \
        ["ServeEngine._step_spec_impl"]


# ---------------------------------------------------------------------------
# the runtime sanitizer's plumbing, without the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("sampling", [False, True])
def test_workload_matches_reference(seed, sampling):
    mine = sanitizer._workload(6, 12, seed=seed, sampling=sampling)
    theirs = ref_sanitizer._workload(6, 12, seed=seed, sampling=sampling)
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        for k in a:
            if k == "tokens":
                assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all()
            else:
                assert a[k] == b[k] and type(a[k]) is type(b[k]), k


class _ModeRecorder:
    """Stands in for torch.cuda's sync debug mode on the CPU."""

    def __init__(self):
        self.mode = 0
        self.sets = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.sets.append(mode)
        self.mode = mode


@pytest.mark.parametrize("name", sanitizer.SCENARIOS)
def test_guard_wraps_exactly_the_steps(monkeypatch, name):
    from repro_torch.serve import Request

    rec = _ModeRecorder()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", rec.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", rec.set)
    eng = sanitizer.scenario_engine(name, device="cpu")
    seen = {"step": [], "decide": []}

    def spy(kind, fn):
        def wrapper(*args, **kwargs):
            seen[kind].append(rec.mode)
            return fn(*args, **kwargs)
        return wrapper

    for attr in sanitizer.STEP_NAMES:
        if getattr(eng, attr) is not None:
            setattr(eng, attr, spy("step", getattr(eng, attr)))
    eng._decide = spy("decide", eng._decide)
    calls = sanitizer.guard_steps(eng)
    want = ({"_step", "_step_mixed", "_step_spec"} if name == "speculative"
            else {"_step", "_step_mixed"})
    assert set(calls) == want
    sampling = name in ("mixed_sampling", "observability")
    for w in sanitizer._workload(6, 12, seed=7, sampling=sampling):
        eng.submit(Request(**w))
    eng.run()
    n = len(seen["step"])
    assert n > 0 and sum(calls.values()) == n
    assert n == eng.stats["steps"]
    assert seen["step"] == ["error"] * n          # every step under the guard
    assert seen["decide"] and set(seen["decide"]) == {0}   # decisions outside
    assert rec.sets == ["error", 0] * n and rec.mode == 0
    if name == "speculative":
        assert calls["_step_spec"] > 0 and eng.stats["spec_steps"] > 0


def test_guard_restores_mode_when_the_step_raises(monkeypatch):
    rec = _ModeRecorder()
    rec.mode = "warn"
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", rec.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", rec.set)

    class Eng:
        _step_mixed = _step_spec = None

        def _step(self, *args):
            assert rec.mode == "error"
            raise RuntimeError("called a synchronizing CUDA operation")

    eng = Eng()
    calls = sanitizer.guard_steps(eng)
    with pytest.raises(RuntimeError, match="synchronizing"):
        eng._step(1, 2)
    assert calls == {"_step": 1} and rec.sets == ["error", "warn"]


def test_compile_counter_counts_builds_and_graphs(monkeypatch):
    from repro_torch.kernels import build

    built = set()

    def fake_build(names):                         # nvcc only when missing
        secs = {n: 0.0 if n in built else 1.5 for n in names}
        built.update(names)
        return secs

    graphs = [3]                                   # dynamo's graphs so far
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(sanitizer, "_dynamo_graphs", lambda: graphs[0])
    counter = sanitizer.CompileCounter()
    with counter.attached():
        assert counter.count == 0
        build.build(["decode_attn"])               # an nvcc run
        build._libs["decode_attn"] = object()      # and its library loaded
        warm = counter.count
        build.build(["decode_attn"])               # already built
        assert counter.count == warm
        build.build(["lowrank_flash"])             # a steady-state build
        graphs[0] += 1                             # and a dynamo graph
        steady = counter.count - warm
    assert warm == 2 and steady == 2
    assert counter.messages[0].startswith("nvcc built decode_attn.cu")
    assert counter.messages[1] == "loaded kernel library decode_attn"
    assert counter.messages[2].startswith("nvcc built lowrank_flash.cu")
    assert counter.messages[3] == "torch._dynamo graph 4"
    assert build.build is fake_build               # unwrapped again


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_run_scenario_refuses_the_cpu(device):
    with pytest.raises(RuntimeError, match="CUDA device"):
        sanitizer.run_scenario("mixed_sampling", device=device)
    with pytest.raises(ValueError, match="unknown scenario"):
        sanitizer.scenario_engine("nope", device=device)
