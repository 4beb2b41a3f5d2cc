"""Parameters across frameworks: the JAX param pytree -> the port's tree.

The JAX tree (``repro.models.transformer.init_dense``) is a nested dict:
``embed`` (V, d), ``layers`` with every leaf stacked on a leading L axis
(``attn/{wq,wk,wv,wo[,bq,bk,bv]}``, ``ffn/{w_gate,w_up,w_down}``,
``ln1``, ``ln2``), ``ln_f`` and ``lm_head`` (d, V). The port keeps exactly
this tree and JAX's (in, out) matrix layout (``x @ w``), so conversion is
a leaf-wise copy: no transpose. The DR-RL agent's tree
(``repro.core.drrl.init_agent``) converts the same way: its policy
``layers`` is a list, and its ``conv`` kernel keeps JAX's (k, d, f) layout.
Pass the leaves as numpy arrays (``jax.device_get(params)``); this module
imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16: no numpy view
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree, on ``device``, from the JAX param tree
    given as nested dicts and lists of numpy arrays."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v, device) for v in tree]
    return _leaf(tree, device)


AGENT_KEYS = {"conv", "embed", "layers", "ln_f", "head"}


def agent_from_jax(tree, device="cuda"):
    """The DR-RL agent's tree on ``device`` from the JAX ``init_agent``
    tree (numpy leaves), leaf for leaf; ``conv`` stays (k, d, f)."""
    if set(tree) != AGENT_KEYS or np.ndim(tree["conv"]) != 3:
        raise ValueError(f"not a DR-RL agent tree: keys {sorted(tree)}")
    return params_from_jax(tree, device)
