"""Shared helpers of the parity tests between the JAX package (``repro``)
and its PyTorch port (``repro_torch``): config, parameter, DR-RL agent,
batch and trajectory bridges, and the serving benchmark's mixed staggered
workload."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.configs.base import MLAConfig as TMLAConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import RankConfig as TRankConfig
from repro_torch.configs.base import RWKVConfig as TRWKVConfig
from repro_torch.configs.base import SSMConfig as TSSMConfig
from repro_torch.convert import agent_from_jax, params_from_jax


def torch_config(cfg):
    """The port's ModelConfig holding the same values as JAX ``cfg`` (its
    MoE, MLA, SSM and RWKV sub-configs too)."""
    rank = TRankConfig(**{f.name: getattr(cfg.rank, f.name)
                          for f in dataclasses.fields(TRankConfig)})
    subs = {"moe": TMoEConfig, "mla": TMLAConfig, "ssm": TSSMConfig,
            "rwkv": TRWKVConfig}
    kw = {}
    for f in dataclasses.fields(TModelConfig):
        v = getattr(cfg, f.name)
        if f.name in subs and v is not None:
            v = subs[f.name](**dataclasses.asdict(v))
        kw[f.name] = v
    kw["rank"] = rank
    return TModelConfig(**kw)


def jax_and_torch_params(cfg, seed: int = 0):
    """JAX ``init`` params (PRNGKey(seed)) and the same values as the
    port's CPU tensors."""
    from repro.models.api import get_model
    params = get_model(cfg).init(jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.device_get(params), device="cpu")


def jax_and_torch_agent(cfg, seed: int = 7):
    """JAX ``init_agent(PRNGKey(seed))`` for ``cfg`` and the same values
    as the port's CPU tensors."""
    from repro.core.drrl import init_agent
    agent = init_agent(jax.random.PRNGKey(seed), cfg.rank, cfg.d_model)
    return agent, agent_from_jax(jax.device_get(agent), device="cpu")


def jax_power_v0(cfg):
    """The start vectors JAX ``weight_stats`` draws (``PRNGKey(2)`` at each
    matrix width), as the port's ``power_v0``."""
    dh = cfg.resolved_head_dim()
    widths = {"wq": cfg.num_heads * dh, "wk": cfg.num_kv_heads * dh,
              "wv": cfg.num_kv_heads * dh}
    return {name: torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(2), (n,), jnp.float32))) for name, n in widths.items()}


def torch_tree(x, device="cpu"):
    """A JAX batch, feature dict, agent-shaped tree or
    ``repro.core.ppo.Trajectory`` as the port's tensors (a
    ``repro_torch.core.ppo.Trajectory`` for the last)."""
    from repro_torch.core.ppo import Trajectory
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return Trajectory(*(torch_tree(v, device) for v in x))
    if isinstance(x, dict):
        return {k: torch_tree(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [torch_tree(v, device) for v in x]
    return torch.from_numpy(np.array(jax.device_get(x))).to(device)


class JaxBatches:
    """A JAX data source (``batch_at(step)``) that hands the port its
    batches: ``batch_at(step, device)`` gives the same tokens as tensors."""

    def __init__(self, data):
        self.data = data

    def batch_at(self, step: int, device="cpu"):
        return torch_tree(self.data.batch_at(step), device)


def build_workload(n_requests: int, max_new: int, seed: int = 0):
    """benchmarks/serve_bench.py:build_workload: mixed prompt lengths
    (8..32), arrivals staggered every 2 steps."""
    rnd = np.random.default_rng(seed)
    lens = rnd.choice([8, 12, 16, 24, 32], size=n_requests)
    return [dict(rid=i, tokens=rnd.integers(0, 256, int(s)).astype(np.int32),
                 max_new=max_new, arrival=2 * i)
            for i, s in enumerate(lens)]
