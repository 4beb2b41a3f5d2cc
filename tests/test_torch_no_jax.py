"""The port stands alone: with ``jax`` and the ``repro`` package made
unimportable, every module of ``repro_torch`` and ``chip_smoke.py`` import,
the engine serves two requests on the CPU, chunked and one-shot, then a
speculative request and a prefix hit (both at once, and the tokens equal
the plain run's), then
seeded sampled requests in rank mode 'random' with the drift trigger and a
cancel, a chunked ``forward_dense`` runs its flash branch at s = 1040, the
forward runs in rank modes 'random', 'performer' and 'nystrom', the rank-r
cache prefills and decodes, the reduced
drrl-paper model in its own rank mode 'drrl' runs the forward and serves
with the port's own seeded agent, an engine records serving traces with
obs tracing and flight dumps on, serves through a ``FrontEnd`` and a
2-replica ``Router``, the serving policy trains on the trace, loads and
serves in rank mode 'learned', and ``examples/quickstart_torch.py``
trains the DR-RL agent (BC, then PPO) on the CPU. The paper's tables and
figures (every ``benchmarks/torch_*.py``) and
``examples/finetune_classification_torch.py`` import too, and the port's
invariant checker (every ``repro_torch.analysis`` module) runs
``tools/check_invariants_torch.py --selftest`` and its static pass. The
dense configs and the MoE family import (``models.moe``, ``mla``,
``deepseek_v3`` and their configs), every arch id gives its config,
reduced granite serves and reduced DeepSeek-V3 computes its loss (with
MTP) and decodes, and reduced zamba2, rwkv6, seamless and qwen2-vl each
compute a loss and a cached decode step. The distribution layer
(``repro_torch.dist.*``, ``launch.mesh``) imports, and on a one-rank gloo
``make_host_mesh`` reduced granite's params are placed by ``param_pspecs``
(``distribute``) and take one sharded training step. The dry run
(``launch.dryrun``) and its roofline, forensics and hillclimb
(``benchmarks/torch_roofline.py``, ``torch_forensics.py``,
``torch_hillclimb.py``) import."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, pkgutil, runpy, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
sys.modules["repro"] = None        # and so does any import of the JAX package
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert {"repro_torch.train.loop", "repro_torch.data.text", "repro_torch.launch.train",
        "repro_torch.checkpoint.manager"} <= set(names), names
assert {"repro_torch.analysis." + m for m in ("callgraph", "fixtures", "pragmas", "registry",
        "report", "rules", "sanitizer")} <= set(names), names
assert {"repro_torch.dist." + m for m in ("ctx", "pipeline", "ring_attention", "sharding")} | {
    "repro_torch.launch.mesh", "repro_torch.launch.dryrun"} <= set(names), names
assert {"repro_torch.models." + m for m in ("moe", "mla", "deepseek_v3")} | {
    "repro_torch.configs." + m for m in ("qwen2_5_14b", "internlm2_20b", "phi3_medium_14b",
    "deepseek_coder_33b", "granite_moe_3b_a800m", "deepseek_v3_671b")} <= set(names), names
check = runpy.run_path("tools/check_invariants_torch.py")["main"]
assert check(["--selftest"]) == 0 and check([]) == 0
import chip_smoke                   # its work sits under __main__
import glob, os                     # the paper's tables and figures, the fine-tune example
tables = sorted(os.path.basename(p)[:-3] for p in glob.glob("benchmarks/torch_*.py"))
for name in tables:
    importlib.import_module("benchmarks." + name)
assert len(tables) == 12 and {"torch_run", "torch_roofline", "torch_forensics",
                              "torch_hillclimb"} <= set(tables), tables
assert callable(runpy.run_path("examples/finetune_classification_torch.py")["main"])
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
outs = []
for knobs in ({}, dict(speculative=True, draft_k=3, prefix_cache=True)):
    eng = Engine(cfg, params, device="cpu", config=EngineConfig(
        n_slots=2, max_len=64, prefill_chunk=8, **knobs))
    hs5 = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5), arrival=8 * i)
           for i, n in enumerate((20, 24))]
    eng.run()
    outs.append([list(a.result()) for a in hs5])
assert outs[0] == outs[1]
assert eng.stats["prefix_hits"] == 1 and eng.stats["spec_steps"] > 0
eng.core.cache.check_refs(eng.core.prefix.all_pages())
rcfg = cfg.with_(rank=RankConfig(mode="random", rank_grid=(4, 8, 12, 16), segment_len=8))
eng = Engine(rcfg, params, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=8, nucleus=True, drift_threshold=0.05))
hs4 = [eng.submit(np.arange(n) % 256, SamplingParams(
    max_new=6, temperature=0.8, top_k=20, top_p=0.9, seed=n)) for n in (9, 20, 12)]
assert hs4[2].cancel() and not hs4[2].cancel()
eng.run()
assert [len(h.result()) for h in hs4] == [6, 6, 0]
assert eng.core.cache.free_pages == eng.core.cache.n_pages - 1
from repro_torch.core import prng
from repro_torch.models import lowrank_cache as lrc
toks = torch.arange(2 * 40).reshape(2, 40) % 256
for mode in ("random", "performer", "nystrom"):
    mcfg = cfg.with_(rank=RankConfig(mode=mode, rank_grid=(4, 8, 12, 16), fixed_rank=8))
    lg, _ = get_model(mcfg).loss(params, {"tokens": toks, "labels": toks},
                                 rank_rng=prng.key(1))
    assert torch.isfinite(lg)
c = lrc.init_lowrank_cache(cfg, 2, 48, 8, device="cpu")
lg, c = lrc.prefill_lowrank(cfg, params, toks[:, :32], c, 8)
lg, c = lrc.decode_step_lowrank(cfg, params, c, toks[:, 32:33])
assert lg.shape == (2, 1, cfg.vocab_size) and c["len"] == 33
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
import tempfile                     # the front end, router, traces, learned policy
from repro_torch.serve import FleetConfig, FrontEnd, Router, make_workload
from repro_torch.train.serve_policy import load_policy, train_serve_policy
acfg = cfg.with_(rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
tmp = tempfile.mkdtemp()
eng = Engine(acfg, params, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=8, segment_len=8, record_traces=tmp + "/tr",
    obs_trace=True, flight_dir=tmp + "/fl", nucleus=True, prefix_cache=True))
for name in ("bursty", "shared_prefix", "mixed_sampling"):
    for r in make_workload(name, seed=1, n_requests=3, max_new=6, max_prompt=24).requests:
        eng.submit(r["tokens"], SamplingParams(max_new=6, temperature=r.get("temperature", 0.0),
                   top_k=r.get("top_k", 0), top_p=r.get("top_p", 1.0), seed=r.get("seed", 0)),
                   arrival=r["arrival"])
    eng.run()
assert eng.core.trace.flush()["n_records"] > 0 and eng.obs.prometheus()
with FrontEnd(eng, idle_poll_s=0.01) as fe:
    h = fe.submit(np.arange(12) % 256, SamplingParams(max_new=5))
    assert fe.drain(60) and len(h.result()) == 5
fleet = FleetConfig(engine=EngineConfig(n_slots=2, max_len=64, prefill_chunk=8,
                                        prefix_cache=True), n_replicas=2, idle_poll_s=0.01)
with Router(acfg, params, fleet=fleet, device="cpu") as router:
    hr = [router.submit(np.arange(20 + i) % 256, SamplingParams(max_new=4)) for i in range(3)]
    assert router.drain(60) and [len(x.result()) for x in hr] == [4, 4, 4]
pol, hist = train_serve_policy(tmp + "/tr", acfg.rank, out_dir=tmp + "/pol", bc_steps=4,
                               ppo_steps=1, ppo_epochs=1, device="cpu")
lcfg = acfg.with_(rank=RankConfig(mode="learned", rank_grid=(4, 8, 12, 16), segment_len=8))
eng = Engine(lcfg, params, load_policy(tmp + "/pol", device="cpu"), device="cpu",
             config=EngineConfig(n_slots=2, max_len=64, prefill_chunk=8, segment_len=8))
hl = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5)) for n in (9, 20)]
eng.run()
assert [len(x.result()) for x in hl] == [5, 5] and eng.stats["decides"] >= 2
# the dense configs and the MoE family: granite served, DeepSeek-V3's loss and decode
from repro_torch.configs import ARCH_IDS
assert all(get_config(arch, reduced=True).name == arch for arch in ARCH_IDS)
# the remaining families: zamba2, rwkv6, seamless and qwen2-vl, one forward each
ft = torch.arange(2 * 20).reshape(2, 20) % 256
for arch, extra in (("zamba2-7b", {}), ("rwkv6-1.6b", {}),
                    ("seamless-m4t-medium", {"frames": torch.randn(2, 16, 64)}),
                    ("qwen2-vl-7b", {"patch_embeds": torch.randn(2, 8, 64)})):
    fcfg = get_config(arch, reduced=True)
    ffns = get_model(fcfg)
    fp = ffns.init(torch.Generator().manual_seed(0), device="cpu")
    n_lab = 28 if arch == "qwen2-vl-7b" else 20
    fl, _ = ffns.loss(fp, {"tokens": ft, "labels": torch.zeros(2, n_lab, dtype=torch.long),
                           **extra})
    fc = ffns.init_cache(2, 24, device="cpu")
    flg, fc = ffns.decode_step(fp, fc, ft[:, :4])
    assert torch.isfinite(fl) and flg.shape == (2, 4, 256) and ffns.decode_step_paged is None
gcfg = get_config("granite-moe-3b-a800m", reduced=True).with_(
    rank=RankConfig(mode="adaptive", rank_grid=(4, 8, 12, 16), segment_len=8))
gp = get_model(gcfg).init(torch.Generator().manual_seed(0), device="cpu")
eng = Engine(gcfg, gp, device="cpu", config=EngineConfig(
    n_slots=2, max_len=64, prefill_chunk=8, use_kernel=True))
hg = [eng.submit(np.arange(n) % 256, SamplingParams(max_new=5)) for n in (9, 20)]
eng.run()
assert [len(h.result()) for h in hg] == [5, 5]
from repro_torch.configs.base import TrainConfig   # the distribution layer, one gloo rank
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adamw
from repro_torch.train.loop import make_train_step
mesh = make_host_mesh("cpu")
gd = shd.distribute(gp, shd.param_pspecs(gp, gcfg, mesh), mesh)
gstep = make_train_step(gcfg, TrainConfig(global_batch=2, seq_len=16, warmup_steps=1,
                                          total_steps=1), lambda p, b, r: get_model(gcfg).loss(p, b))
gtok = torch.arange(2 * 16).reshape(2, 16) % 256
gd, gopt, gm = gstep(gd, adamw.init(gd), {"tokens": gtok, "labels": gtok}, None)
assert shd.is_dtensor(gd["embed"]) and torch.isfinite(gm["loss"]) and int(gopt.step) == 1
dcfg = get_config("deepseek-v3-671b", reduced=True)
dfns = get_model(dcfg)
dp = dfns.init(torch.Generator().manual_seed(0), device="cpu")
dt = torch.arange(2 * 24).reshape(2, 24) % 256
dl, daux = dfns.loss(dp, {"tokens": dt, "labels": dt})
assert torch.isfinite(dl) and daux["mtp_logits"].shape == (2, 23, 256)
dc = dfns.init_cache(2, 32, device="cpu")
dlg, dc = dfns.decode_step(dp, dc, dt[:, :8])
assert dlg.shape == (2, 8, 256) and dc["len"] == 8 and dfns.decode_step_paged is None
# the agent's training: BC, then PPO
sys.argv = ["quickstart_torch.py", "--device", "cpu"]
runpy.run_path("examples/quickstart_torch.py", run_name="__main__")
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "repro.")))
assert all(sys.modules[m] is None for m in loaded), loaded
print("modules", len(names))
"""


def test_port_imports_and_serves_without_jax():
    # one thread: the reduced models gain nothing from intra-op threads, and
    # beside other test workers OpenMP's waiting threads slow them severalfold
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split("modules")[-1])
    assert n >= 15, res.stdout
