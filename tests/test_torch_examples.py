"""The port's examples run on the CPU at their smallest flags with ``jax``
and the ``repro`` package made unimportable: the seven serving examples
(each asserts its own parity: speculative and prefix-cached tokens equal
plain decode's, routing leaves tokens unchanged and affinity beats
round-robin, the traced run equals the untraced one) and the LM training
driver, run twice on one checkpoint directory so that the second run
resumes; then ``ByteCorpus`` and the training CLI with two
bf16-accumulated microbatches, in the same process."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = [
    ("serve_adaptive_torch.py", "--batch 2 --tokens 8 --segment 4", "rank buckets exercised"),
    ("serve_stream_torch.py", "--streams 2 --tokens 8", "chunked prefill"),
    ("serve_spec_torch.py", "--streams 2 --tokens 8",
     "exact: all streams token-identical to plain decode"),
    ("serve_prefix_torch.py", "--streams 2 --tokens 6", "token parity with the cache-off"),
    ("serve_router_torch.py", "--groups 2 --per-group 2 --tokens 4", "tokens identical"),
    ("serve_observe_torch.py", "--streams 2 --tokens 8 --out-dir {tmp}/obs", "flight"),
    ("serve_learned_torch.py",
     "--requests 2 --tokens 6 --bc-steps 4 --ppo-steps 1 --work-dir {tmp}/learned",
     "served     : 8 requests with mode='learned'"),
    ("train_lm_100m_torch.py", "--reduced --steps 3 --batch 2 --seq 32 --ckpt {tmp}/lm",
     "over steps 0..2"),
    ("train_lm_100m_torch.py", "--reduced --steps 5 --batch 2 --seq 32 --ckpt {tmp}/lm",
     "[ckpt] resumed from step 3"),
]

SCRIPT = r"""
import runpy, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["repro"] = None        # and so does any import of the JAX package
for name, flags in RUNS:
    sys.argv = [name] + flags.split() + ["--device", "cpu"]
    print("=== " + name, flush=True)
    runpy.run_path("examples/" + name, run_name="__main__")
from repro_torch.data.text import ByteCorpus   # the text corpus and the training CLI
from repro_torch.launch import train
b = ByteCorpus(["src"], seq_len=16, global_batch=2, seed=1).batch_at(3, device="cpu")
assert b["tokens"].shape == (2, 16) and bool((b["tokens"][:, 1:] == b["labels"][:, :-1]).all())
out = train.main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--microbatches", "2", "--grad-compression", "bf16"])
assert [h["step"] for h in out["history"]] == [0, 1]
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert all(sys.modules[m] is None for m in loaded), loaded
"""


def test_examples_run_without_jax(tmp_path):
    runs = [(name, flags.format(tmp=tmp_path)) for name, flags, _ in RUNS]
    # one thread: the reduced models gain nothing from intra-op threads, and
    # beside other test workers OpenMP's waiting threads slow them tenfold
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", f"RUNS = {runs!r}\n" + SCRIPT],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    parts = res.stdout.split("=== ")[1:]
    assert [p.split("\n", 1)[0] for p in parts] == [name for name, _, _ in RUNS]
    for part, (name, _, want) in zip(parts, RUNS):
        assert want in part, (name, part[-2000:])
    assert "[ckpt]" not in parts[-2]
