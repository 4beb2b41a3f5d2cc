"""The port stands alone: with ``jax`` and the ``repro`` package made
unimportable, every module of ``repro_torch`` and ``chip_smoke.py`` import,
and the engine serves two requests on the CPU."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["repro"] = None        # and so does any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke                   # its work sits under __main__
import numpy as np, torch
from repro_torch.configs import get_config
from repro_torch.configs.base import RankConfig
from repro_torch.models.api import get_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams
cfg = get_config("drrl-paper", reduced=True).with_(
    rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
params = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
eng = Engine(cfg, params, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=8, use_kernel=True))
hs = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5)) for n in (9, 20)]
eng.run()
assert [len(h.result()) for h in hs] == [5, 5]
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert all(sys.modules[m] is None for m in loaded), loaded
print("modules", len(names))
"""


def test_port_imports_and_serves_without_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split("modules")[-1])
    assert n >= 15, res.stdout
