"""The LM training step and its driver (``repro.train.loop``): gradient
accumulation over microbatches with optional bf16 error-feedback
compression, AdamW through :mod:`repro_torch.optim`, checkpoint / resume
and straggler logging.

The step runs eagerly on the device of the parameters; the reference jits
it. Training calls the model's ``loss`` with ``chunked=False``, as the
reference does, so no attention kernel runs in the step (the kernels have
no backward; ``kernels/ops.py`` refuses inputs that require grad on CUDA).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import prng
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
    divided by k in f32 and the loss is the microbatches' mean."""
    lr_fn = make_lr_fn(tc)
    compression = grad_compression or tc.grad_compression

    def compute_grads(params, batch, rng):
        def lf(p, b):
            loss, _ = loss_fn(p, b, rng)
            return loss

        if tc.microbatches <= 1:
            return value_and_grad(lf, params, batch)

        k = tc.microbatches
        mbs = [{name: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i]
                for name, x in batch.items()} for i in range(k)]
        acc = [torch.zeros_like(p, dtype=torch.bfloat16 if compression == "bf16"
                                else torch.float32) for p in tu.leaves(params)]
        err = [torch.zeros_like(p, dtype=torch.float32) for p in tu.leaves(params)]
        loss_sum = 0.0
        for mb in mbs:
            loss, grads = value_and_grad(lf, params, mb)
            if compression == "bf16":
                # error-feedback bf16 accumulation
                for i, g in enumerate(tu.leaves(grads)):
                    s = acc[i].float() + g.float() + err[i]
                    acc[i] = s.to(torch.bfloat16)
                    err[i] = s - acc[i].float()
            else:
                acc = [a + g.float() for a, g in zip(acc, tu.leaves(grads))]
            loss_sum = loss_sum + loss
        grads = tu.unflatten(params, [a.float() / k for a in acc])
        return loss_sum / k, grads

    def train_step(params, opt_state, batch, rng):
        loss, grads = compute_grads(params, batch, rng)
        params, opt_state, om = adamw.update(tc, lr_fn, opt_state, params, grads)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def run_training(cfg: ModelConfig, tc: TrainConfig, *, init_fn, loss_fn,
                 data, ckpt_manager=None, param_specs=None, hooks=(),
                 straggler_warn_s: float = 60.0, device="cuda") -> Dict[str, Any]:
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
    rank draws stay off the card)."""
    rng = prng.key(tc.seed)
    params = init_fn(torch.Generator(device).manual_seed(tc.seed), device=device)
    opt_state = adamw.init(params)
    start_step = 0
    if ckpt_manager is not None:
        latest = ckpt_manager.latest_step()
        if latest is not None:
            (params, opt_state), start_step, _ = ckpt_manager.load(
                (params, opt_state), latest)
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
            ckpt_manager.save(step + 1, (params, opt_state), param_specs)
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return {"params": params, "opt_state": opt_state, "history": history}
