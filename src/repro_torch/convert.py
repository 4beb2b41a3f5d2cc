"""Parameters across frameworks: the JAX param pytree -> the port's tree.

The JAX tree (``repro.models.transformer.init_dense``) is a nested dict:
``embed`` (V, d), ``layers`` with every leaf stacked on a leading L axis
(``attn/{wq,wk,wv,wo[,bq,bk,bv]}``, ``ffn/{w_gate,w_up,w_down}``,
``ln1``, ``ln2``), ``ln_f`` and ``lm_head`` (d, V). The MoE family without
MLA (granite) has ``layers/moe`` in place of ``ffn``: the f32 router (L,
d, E), the experts ``w_gate``/``w_up`` (L, E, d, f) and ``w_down`` (L, E,
f, d) and, with shared experts, ``shared/{w_gate,w_up,w_down}``.
DeepSeek-V3 (``repro.models.deepseek_v3.init_deepseek``) has
``dense_layers`` a list of unstacked blocks, ``moe_layers`` stacked on a
leading axis (MLA ``attn/{wq_a,q_norm,wq_b,wkv_a,kv_norm,wkv_b,wo}``,
``moe``) and ``mtp`` (``proj``, one MoE ``block``, ``ln_h``, ``ln_e``).
Zamba2 (``init_zamba``) has ``mamba`` (every block leaf stacked on
n_mamba), ``shared`` (one ``attn``, ``ffn``, ``ln1``, ``ln2``) and
``lora/{a,b}`` stacked on the invocations; RWKV6 ``layers`` stacked on
L; the encoder-decoder ``enc`` and ``dec`` (with ``xattn``, ``ln_x``)
stacked, and ``ln_enc``. Each leaf keeps its dtype: ``A_log``,
``dt_bias``, ``D``, ``w0`` and ``u`` stay f32 under bf16 params.
The port keeps exactly these trees and JAX's (in, out) matrix layout
(``x @ w``), so conversion is a leaf-wise copy: no transpose. The DR-RL agent's tree
(``repro.core.drrl.init_agent``) converts the same way: its policy
``layers`` is a list, and its ``conv`` kernel keeps JAX's (k, d, f) layout.
The Performer baseline's feature matrices convert the same way
(``proj_from_jax``). Pass the leaves as numpy arrays
(``jax.device_get(params)``); this module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tu


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes bfloat16: no numpy view
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)     # a writable copy


def params_from_jax(tree, device="cuda"):
    """The port's parameter tree, on ``device``, from the JAX param tree
    given as nested dicts and lists of numpy arrays."""
    return tu.tree_map(lambda x: _leaf(x, device), tree)


POLICY_KEYS = {"embed", "layers", "ln_f", "head"}
AGENT_KEYS = POLICY_KEYS | {"conv"}


def agent_from_jax(tree, device="cuda"):
    """The DR-RL agent's tree on ``device`` from the JAX ``init_agent``
    tree (numpy leaves), leaf for leaf; ``conv`` stays (k, d, f). The
    policy network alone (``init_policy``'s tree, as the serving policy's
    trainer checkpoints it) converts the same way."""
    if set(tree) == POLICY_KEYS:
        return params_from_jax(tree, device)
    if set(tree) != AGENT_KEYS or np.ndim(tree["conv"]) != 3:
        raise ValueError(f"not a DR-RL agent tree: keys {sorted(tree)}")
    return params_from_jax(tree, device)


def proj_from_jax(proj, device="cuda") -> torch.Tensor:
    """The Performer feature matrices (h, m, d) of the reference's
    ``orthogonal_proj(PRNGKey(42), ...)``, as numpy, on ``device``. The port
    draws its own from a seeded ``torch.Generator`` (same distribution,
    other bits: the reference's chi-square draw is a rejection sampler);
    parity tests pass JAX's through ``forward_dense(proj=...)``."""
    a = np.asarray(proj)
    if a.ndim != 3:
        raise ValueError(f"not a (h, m, d) projection: shape {a.shape}")
    return _leaf(a, device)
