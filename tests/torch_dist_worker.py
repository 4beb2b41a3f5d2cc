"""Rank code of ``tests/test_torch_dist.py``: one gloo process group of
four CPU ranks runs every distributed case of the port, and each rank
writes what it saw for the parent to hold against JAX and against the
port's one-process runs. Imports torch and ``repro_torch`` only, so the
spawned ranks do not pay JAX's import.

The parent writes ``inputs.pt`` (numpy-made inputs, the JAX-initialised
params as the port's tensors, a JAX-saved checkpoint's directory) into a
run directory and starts :func:`main` on each rank with
``torch.multiprocessing.spawn``; rank ``r`` writes ``rank<r>.pt``.
"""
from __future__ import annotations

import os
import traceback

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as tu
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig, RankConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.dist import sharding as shd
from repro_torch.dist.pipeline import make_pipeline
from repro_torch.dist.ring_attention import make_ring_attention
from repro_torch.models.api import get_model
from repro_torch.optim import adamw
from repro_torch.train import loop

WORLD = 4
SEQ, BATCH, STEPS, LR = 32, 4, 2, 1e-2

# the sharded step's cases: the port's config, its TrainConfig knobs and its
# mesh (granite_pod: data over ("pod", "data"), pod-major; granite_dots: the
# full config's remat='dots', each layer checkpointed inside the step)
STEP_CASES = ("drrl", "random", "granite", "granite_mb2", "granite_pod", "granite_dots")


def case_mesh(case):
    if case == "granite_pod":
        return mesh_of((2, 2, 1), ("pod", "data", "model"))
    return mesh_of((2, 2), ("data", "model"))


def case_config(case):
    """The port's config of a sharded-step case."""
    if case in ("drrl", "random"):
        cfg = get_config("drrl-paper", reduced=True)          # rank mode 'drrl'
        if case == "random":
            cfg = cfg.with_(rank=RankConfig(mode="random", rank_grid=(4, 8, 12, 16),
                                            fixed_rank=8))
        return cfg
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    return cfg.with_(moe=MoEConfig(num_experts=4, top_k=2, d_expert=32,
                                   capacity_factor=0.5),
                     remat="dots" if case == "granite_dots" else "none")


def case_train_config(case) -> dict:
    """TrainConfig fields of a case (the same on JAX's side)."""
    kw = dict(global_batch=BATCH, seq_len=SEQ, lr=LR, warmup_steps=1, total_steps=STEPS)
    if case == "granite_mb2":
        kw.update(microbatches=2, grad_compression="bf16")
    return kw


def case_loss_fn(case, cfg, extras):
    """The launchers' loss: rank mode 'drrl' with the agent (and JAX's
    power-iteration start vectors), 'drrl' / 'random' with the step's key;
    granite keeps the MoE layers' auxiliary loss (``collect_aux``)."""
    fns = get_model(cfg)
    if case == "drrl":
        return lambda p, b, rng: fns.loss(p, b, rank_rng=rng, policy_params=extras["agent"],
                                          power_v0=extras["power_v0"])
    if case == "random":
        return lambda p, b, rng: fns.loss(p, b, rank_rng=rng)
    return lambda p, b, rng: fns.loss(p, b, collect_aux="ranks")


def run_steps(case, params, batches, extras, mesh=None):
    """STEPS steps of ``make_train_step`` from ``params`` on ``batches``
    (the global batches), placed on ``mesh`` by ``param_pspecs`` where
    given. Returns ({'loss', 'grad_norm', 'lr'} per step, the final
    params whole, their placements by path)."""
    cfg = case_config(case)
    tc = TrainConfig(**case_train_config(case))
    step = loop.make_train_step(cfg, tc, case_loss_fn(case, cfg, extras))
    if mesh is not None:
        params = shd.distribute(params, shd.param_pspecs(params, cfg, mesh), mesh)
    opt = adamw.init(params)
    hist = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, batches[i], prng.fold_in(prng.key(0), i))
        hist.append({k: float(v) for k, v in m.items()})
    flat = tu.flatten_with_keys(params)
    placements = {shd.path_str(p): placement_code(x) for p, x in flat}
    full = tu.rebuild(params, {p: shd.full_tensor(x) for p, x in flat})
    if mesh is not None:
        full_m = [shd.full_tensor(x) for x in tu.leaves(opt.m)]
        assert all(x.shape == y.shape for x, y in zip(full_m, tu.leaves(full)))
    return hist, full, placements


def placement_code(x):
    """A DTensor's placements as (('S', dim) | ('R',), ...); None for a
    plain tensor."""
    if not shd.is_dtensor(x):
        return None
    return tuple(("S", p.dim) if p.is_shard() else ("R",) for p in x.placements)


def mesh_of(shape, names):
    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape), mesh_dim_names=names)


def ring_case(inp, causal):
    mesh = mesh_of((WORLD,), ("data",))
    q, k, v = inp["ring"]
    C = q.shape[1] // WORLD
    r = dist.get_rank()
    fn = make_ring_attention(mesh, scale=q.shape[-1] ** -0.5, causal=causal)
    return fn(*(x[:, r * C:(r + 1) * C] for x in (q, k, v)))


def pipeline_case(inp):
    mesh = mesh_of((WORLD,), ("pod",))
    pipe = make_pipeline(mesh, lambda p, x: torch.tanh(x @ p["w"] + p["b"]),
                         axis_name="pod")
    return pipe(inp["pipe_params"], inp["pipe_x"])


def load_case(ckpt_dir, template, shape, names):
    """The checkpoint at ``ckpt_dir`` loaded onto a mesh: placements and
    whole values by path."""
    mesh = mesh_of(shape, names)
    tree, step, _ = CheckpointManager(ckpt_dir, async_save=False).load(template, mesh=mesh)
    flat = tu.flatten_with_keys(tree)
    return {"step": step,
            "placements": {shd.path_str(p): placement_code(x) for p, x in flat},
            "values": {shd.path_str(p): shd.full_tensor(x) for p, x in flat}}


def save_case(root, inp):
    """A 2 x 2 sharded (params, AdamW state) of granite saved with its
    specs (every rank calls ``save``; rank 0 writes)."""
    mesh = mesh_of((2, 2), ("data", "model"))
    cfg = case_config("granite")
    params = inp["params"]["granite"]
    specs = shd.param_pspecs(params, cfg, mesh)
    placed = shd.distribute(params, specs, mesh)
    mgr = CheckpointManager(os.path.join(root, "port_ckpt"), async_save=True)
    mgr.save(5, placed, specs, extra={"note": "port"})
    mgr.wait()
    return {"n_steps": len(mgr.all_steps())}


CLI_ARGS = ["--arch", "granite-moe-3b-a800m", "--reduced", "--device", "cpu",
            "--batch", "4", "--seq", "32"]


def cli_case(ckpt_dir, steps=(3, 4)):
    """``launch.train.main`` on the group's (4, 1) host mesh for each of
    ``steps`` in turn, checkpointing every step in ``ckpt_dir`` (so each run
    after the first resumes). Returns the runs' histories, the last run's
    whole params and the printed lines."""
    import contextlib
    import io
    from repro_torch.launch import train
    out, text = [], io.StringIO()
    with contextlib.redirect_stdout(text):
        for n in steps:
            res = train.main(CLI_ARGS + ["--steps", str(n), "--ckpt-dir", ckpt_dir])
            out.append(res["history"])
    full = tu.tree_map(shd.full_tensor, res["params"])
    return {"history": out, "params": full, "text": text.getvalue(),
            "placed": shd.is_dtensor(res["params"]["embed"])}


def elastic_cli_case(root):
    """The one-process CLI's 3-step checkpoint (params' specs only; the
    AdamW moments stored without one) resumed to 4 steps on the mesh."""
    import shutil
    ckpt_dir = os.path.join(root, "cli_elastic")
    if dist.get_rank() == 0:
        shutil.copytree(os.path.join(root, "cli_one"), ckpt_dir)
    dist.barrier()
    return cli_case(ckpt_dir, steps=(4,))


def main(rank, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(root, "pg"),
                            rank=rank, world_size=WORLD)
    out = {}
    try:
        inp = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
        out["ring"] = {c: ring_case(inp, c) for c in (True, False)}
        out["pipeline"] = pipeline_case(inp)
        out["steps"] = {case: run_steps(case, inp["params"][case], inp["batches"][case],
                                        inp["extras"], mesh=case_mesh(case))
                        for case in STEP_CASES}
        tmpl = inp["params"]["granite"]
        out["loads"] = {name: load_case(inp["jax_ckpt"], tmpl, shape, names)
                        for name, shape, names in (("2x2", (2, 2), ("data", "model")),
                                                   ("4x1", (4, 1), ("data", "model")),
                                                   ("data", (4,), ("data",)))}
        out["save"] = save_case(root, inp)
        out["cli"] = cli_case(os.path.join(root, "cli_ckpt"))
        out["cli_elastic"] = elastic_cli_case(root)
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    dist.destroy_process_group()
