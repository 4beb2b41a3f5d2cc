"""The host mesh of the port (``repro.launch.mesh.make_host_mesh``): every
rank of the default process group as a ("data", "model") ``DeviceMesh`` of
shape (world, 1).

Without a process group it starts one: from the environment under
``torchrun`` (``WORLD_SIZE`` set), else a one-rank group on an in-process
store. The backend follows the device, NCCL for ``cuda`` and gloo for
``cpu``, and a group that fails to start raises: NCCL is brought up by a
first all-reduce here, never replaced by gloo. The reference's
production meshes and TPU constants are not carried over (ROADMAP item
19's second slice).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def ensure_process_group(device="cuda") -> None:
    """Start the default process group for ``device`` unless one exists."""
    dev_type = torch.device(device).type
    if dev_type not in BACKENDS:
        raise ValueError(f"no process-group backend for device {device!r}")
    if dist.is_initialized():
        return
    backend = BACKENDS[dev_type]
    kw = {}
    if dev_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)   # the group's own card
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
    if dev_type == "cuda":
        # NCCL starts its communicator lazily: start it now, so a failure
        # surfaces here
        dist.all_reduce(torch.zeros(1, device="cuda"))
        torch.cuda.synchronize()


def make_host_mesh(device="cuda"):
    """Every rank of the default process group (started for ``device`` if
    none exists) as a ("data", "model") mesh of shape (world, 1)."""
    ensure_process_group(device)
    dev_type = torch.device(device).type
    group_backend = str(dist.get_backend())
    if BACKENDS[dev_type] not in group_backend:
        raise RuntimeError(f"the process group runs {group_backend}, not "
                           f"{BACKENDS[dev_type]} for {device!r}")
    return init_device_mesh(dev_type, (dist.get_world_size(), 1),
                            mesh_dim_names=("data", "model"))
