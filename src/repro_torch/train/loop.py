"""The LM training step and its driver (``repro.train.loop``): gradient
accumulation over microbatches with optional bf16 error-feedback
compression, AdamW through :mod:`repro_torch.optim`, checkpoint / resume
and straggler logging.

The step runs eagerly on the device of the parameters; the reference jits
it. It differentiates whatever ``loss_fn`` computes. The training CLI calls
the model's ``loss`` unchunked, as the reference's does, so no attention
kernel runs there; a ``loss_fn`` that calls ``loss(..., chunked=True)``
sends every attention over more than 1024 keys through
``kernels/ops.py:flash_attention``, which on the card runs ``lowrank_flash``
forward and its backward kernel, in f32 or bf16.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.dist import ctx as dctx
from repro_torch.dist import sharding as shd
from repro_torch.optim import adamw
from repro_torch.optim.schedules import make_lr_fn
from repro_torch.train.rl import value_and_grad


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    loss_fn: Callable[..., Tuple[torch.Tensor, Any]],
                    grad_compression: Optional[str] = None):
    """loss_fn(params, batch, rng) -> (loss, aux). Returns
    train_step(params, opt_state, batch, rng) -> (params, opt_state,
    {'loss', 'grad_norm', 'lr'}).

    With ``tc.microbatches`` k > 1 the batch splits into k equal
    microbatches along its leading axis, each differentiated with the same
    ``rng``; their gradients sum in f32, or with ``grad_compression ==
    'bf16'`` in a bf16 accumulator whose rounding error is carried in f32
    and fed into the next sum (error feedback). The summed gradients are
    divided by k in f32 and the loss is the microbatches' mean.

    Params (and the AdamW state) placed as DTensors by
    ``dist.sharding.distribute`` take the sharded step: every rank gathers
    each param whole, runs ``loss_fn`` unchanged on its rows of each
    (global) microbatch under ``dist.ctx.data_parallel``, so that it
    computes its share of what one device computes on the global batch,
    reduces each microbatch's gradients to the params' placements (summed
    over the data ranks), clips by the global norm over every rank's shards
    and updates its shards with AdamW. The ``model`` axis splits storage
    only. ``batch`` is the global batch, alike on every rank."""
    lr_fn = make_lr_fn(tc)
    compression = grad_compression or tc.grad_compression

    def lf_of(rng):
        def lf(p, b):
            loss, _ = loss_fn(p, b, rng)
            return loss
        return lf

    def microbatches(batch):
        k = tc.microbatches
        return [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
                 for name, x in batch.items()} for i in range(k)]

    def accumulate(mbs, grad_of, like):
        """The microbatches' mean loss and summed gradients / k (leaf
        lists shaped as ``like``), each microbatch's from ``grad_of``."""
        k = len(mbs)
        acc = [torch.zeros_like(p, dtype=torch.bfloat16 if compression == "bf16"
                                else torch.float32) for p in like]
        err = [torch.zeros_like(p, dtype=torch.float32) for p in like]
        loss_sum = 0.0
        for mb in mbs:
            loss, grads = grad_of(mb)
            if compression == "bf16":
                # error-feedback bf16 accumulation
                for i, g in enumerate(grads):
                    s = acc[i].float() + g.float() + err[i]
                    acc[i] = s.to(torch.bfloat16)
                    err[i] = s - acc[i].float()
            else:
                acc = [a + g.float() for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss
        return loss_sum / k, [a.float() / k for a in acc]

    def train_step(params, opt_state, batch, rng):
        if any(shd.is_dtensor(p) for p in tu.leaves(params)):
            return sharded_step(params, opt_state, batch, rng)
        lf = lf_of(rng)
        if tc.microbatches <= 1:
            loss, grads = value_and_grad(lf, params, batch)
        else:
            def grad_of(mb):
                loss, grads = value_and_grad(lf, params, mb)
                return loss, tu.leaves(grads)
            loss, leaves = accumulate(microbatches(batch), grad_of, tu.leaves(params))
            grads = tu.unflatten(params, leaves)
        params, opt_state, om = adamw.update(tc, lr_fn, opt_state, params, grads)
        return params, opt_state, {"loss": loss, **om}

    def sharded_step(params, opt_state, batch, rng):
        likes = tu.leaves(params)
        mesh = likes[0].device_mesh
        mbs = microbatches(batch) if tc.microbatches > 1 else [batch]
        _check_rows(mbs[0], mesh)
        dp = dctx.data_parallel_of(mesh)
        full = tu.tree_map(shd.full_tensor, params)
        lf = lf_of(rng)

        def grad_of(mb):
            with dctx.data_parallel(dp):
                loss, grads = value_and_grad(
                    lf, full, {name: dctx.my_rows(x) for name, x in mb.items()})
            return loss, [shd.reduce_grad(g, p) for g, p in zip(tu.leaves(grads), likes)]

        shards = [p.to_local() for p in likes]
        if len(mbs) == 1:
            loss, grads = grad_of(mbs[0])
        else:
            loss, grads = accumulate(mbs, grad_of, shards)
        loss = dp.all_sum(loss)
        gnorm = shd.sharded_global_norm(grads, likes)
        local = adamw.AdamWState(*(tu.tree_map(_local, t) for t in opt_state))
        new_p, new_s, om = adamw.update(tc, lr_fn, local, tu.unflatten(params, shards),
                                        tu.unflatten(params, grads), grad_norm=gnorm)
        new_p = tu.unflatten(params, [shd.like(x, p) for x, p in
                                      zip(tu.leaves(new_p), likes)])
        new_s = adamw.AdamWState(*(
            tu.unflatten(old, [shd.like(x, o) if shd.is_dtensor(o) else x
                               for x, o in zip(tu.leaves(new), tu.leaves(old))])
            for new, old in zip(new_s, opt_state)))
        return new_p, new_s, {"loss": loss, **om}

    return train_step


def _local(x):
    return x.to_local() if shd.is_dtensor(x) else x


def _check_rows(batch, mesh) -> None:
    """Raise unless ``batch_pspecs`` splits the rows of every leaf of
    ``batch`` (a dict of batch-major tensors) over all data axes of
    ``mesh``."""
    want = shd.data_axes(mesh)
    for path, spec in tu.flatten_with_keys(shd.batch_pspecs(batch, mesh),
                                           is_leaf=shd.is_spec):
        entry = spec[0] if spec else None
        if ((entry,) if isinstance(entry, str) else tuple(entry or ())) != want:
            raise ValueError(f"the rows of batch leaf {shd.path_str(path)} do not "
                             f"split over the data axes {want} (spec {spec})")


def run_training(cfg: ModelConfig, tc: TrainConfig, *, init_fn, loss_fn,
                 data, ckpt_manager=None, param_specs=None, hooks=(),
                 straggler_warn_s: float = 60.0, device="cuda",
                 mesh=None) -> Dict[str, Any]:
    """Single-process driver with checkpoint / restart and per-step
    straggler logging, on ``device``. Returns {'params', 'opt_state',
    'history'}.

    ``init_fn(generator, device=...)`` takes what the port's
    ``get_model(cfg).init`` takes: a ``torch.Generator`` on ``device``
    seeded with ``tc.seed`` (the reference's ``init_fn`` takes its JAX key,
    which the port cannot give). With ``ckpt_manager`` the run resumes
    from its latest step, saves ``(params, opt_state)`` with
    ``param_specs`` every ``tc.checkpoint_every`` steps and waits for the
    last save before returning. Step ``i`` trains on ``data.batch_at(i,
    device=...)`` with the rank key ``prng.fold_in(prng.key(tc.seed), i)``
    (JAX's ``fold_in(PRNGKey(seed), i)`` bits, on the CPU: the layers'
    rank draws stay off the card).

    With a ``mesh`` (a ``DeviceMesh``; every rank calls this alike) the
    params and AdamW state are placed by ``param_specs`` (``distribute``;
    None replicates) and take the sharded step on the global batch;
    checkpoints then store the specs of the AdamW moments too, and a resume
    loads onto the mesh. Every rank prints the same log."""
    rng = prng.key(tc.seed)
    params = init_fn(torch.Generator(device).manual_seed(tc.seed), device=device)
    save_specs = param_specs
    if mesh is not None:
        if param_specs is None:
            param_specs = tu.tree_map(lambda x: (None,) * x.dim(), params)
        params = shd.distribute(params, param_specs, mesh)
        save_specs = (param_specs, adamw.AdamWState(step=(), m=param_specs,
                                                    v=param_specs))
    opt_state = adamw.init(params)
    start_step = 0
    if ckpt_manager is not None:
        latest = ckpt_manager.latest_step()
        if latest is not None:
            (params, opt_state), start_step, _ = ckpt_manager.load(
                (params, opt_state), latest, mesh=mesh)
            print(f"[ckpt] resumed from step {start_step}")

    step_fn = make_train_step(cfg, tc, loss_fn)
    history = []
    for step in range(start_step, tc.total_steps):
        batch = data.batch_at(step, device=device)
        t0 = time.monotonic()
        params, opt_state, metrics = step_fn(params, opt_state, batch,
                                             prng.fold_in(rng, step))
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.monotonic() - t0
        if dt > straggler_warn_s:
            print(f"[straggler] step {step} took {dt:.1f}s")
        if step % tc.log_every == 0 or step == tc.total_steps - 1:
            history.append({"step": step, **metrics, "s_per_step": dt})
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"lr {metrics['lr']:.2e} gnorm {metrics['grad_norm']:.2f} "
                  f"({dt:.2f}s)")
        for hook in hooks:
            hook(step, params, metrics)
        if ckpt_manager is not None and tc.checkpoint_every > 0 \
                and (step + 1) % tc.checkpoint_every == 0:
            ckpt_manager.save(step + 1, (params, opt_state), save_specs)
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return {"params": params, "opt_state": opt_state, "history": history}
