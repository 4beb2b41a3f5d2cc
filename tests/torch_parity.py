"""Shared helpers of the parity tests between the JAX package (``repro``)
and its PyTorch port (``repro_torch``): config, parameter and DR-RL agent
bridges, and the serving benchmark's mixed staggered workload."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import RankConfig as TRankConfig
from repro_torch.convert import agent_from_jax, params_from_jax


def torch_config(cfg):
    """The port's ModelConfig holding the same values as JAX ``cfg``."""
    rank = TRankConfig(**{f.name: getattr(cfg.rank, f.name)
                          for f in dataclasses.fields(TRankConfig)})
    kw = {f.name: getattr(cfg, f.name)
          for f in dataclasses.fields(TModelConfig) if f.name != "rank"}
    return TModelConfig(rank=rank, **kw)


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


def build_workload(n_requests: int, max_new: int, seed: int = 0):
    """benchmarks/serve_bench.py:build_workload: mixed prompt lengths
    (8..32), arrivals staggered every 2 steps."""
    rnd = np.random.default_rng(seed)
    lens = rnd.choice([8, 12, 16, 24, 32], size=n_requests)
    return [dict(rid=i, tokens=rnd.integers(0, 256, int(s)).astype(np.int32),
                 max_new=max_new, arrival=2 * i)
            for i, s in enumerate(lens)]
