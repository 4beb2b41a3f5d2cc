"""The port stands alone: with ``jax`` and the ``repro`` package made
unimportable, every module of ``repro_torch`` and ``chip_smoke.py`` import,
the engine serves two requests on the CPU, chunked and one-shot, a chunked
``forward_dense`` runs its flash branch at s = 1040, and the reduced
drrl-paper model in its own rank mode 'drrl' runs the forward and serves
with the port's own seeded agent."""
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
eng = Engine(cfg, params, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=None))
hs2 = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5)) for n in (9, 20)]
eng.run()
assert [list(a.result()) for a in hs2] == [list(a.result()) for a in hs]
loss, aux = get_model(cfg).loss(params, {
    "tokens": torch.arange(2 * 1040).reshape(2, 1040) % 256,
    "labels": torch.arange(2 * 1040).reshape(2, 1040) % 251},
    chunked=True, collect_aux="ranks", compute_fidelity=True)
assert torch.isfinite(loss) and aux["layers"]["rank"].shape == (2, 2, 4)
from repro_torch.core.drrl import init_agent
cfg = get_config("drrl-paper", reduced=True)           # rank mode 'drrl'
agent = init_agent(torch.Generator().manual_seed(7), cfg.rank, cfg.d_model, device="cpu")
logits, aux = get_model(cfg).loss(params, {
    "tokens": torch.arange(2 * 40).reshape(2, 40) % 256,
    "labels": torch.arange(2 * 40).reshape(2, 40) % 251},
    policy_params=agent, collect_aux="ranks")
assert set(aux["layers"]["rank"].flatten().tolist()) <= {4, 8, 12, 16}
eng = Engine(cfg, params, agent, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=8, segment_len=8))
hs3 = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5)) for n in (9, 20)]
eng.run()
assert [len(h.result()) for h in hs3] == [5, 5] and eng.stats["decides"] >= 2
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
