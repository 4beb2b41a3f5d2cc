"""The meshes of the port (``repro.launch.mesh``) and the card's published
peaks that the dry run's roofline reads.

:func:`make_host_mesh`: every rank of the default process group as a
("data", "model") ``DeviceMesh`` of shape (world, 1). Without a process
group it starts one: from the environment under ``torchrun``
(``WORLD_SIZE`` set), else a one-rank group on an in-process store. The
backend follows the device, NCCL for ``cuda`` and gloo for ``cpu``, and a
group that fails to start raises: NCCL is brought up by a first
all-reduce here, never replaced by gloo.

:func:`make_production_mesh`: the reference's production meshes, (data 16,
model 16) or (pod 2, data 16, model 16), as this process's rank 0 of a
``"fake"`` process group of 256 or 512 ranks. Collectives on it move
nothing and return tensors of the right shapes, so
:mod:`repro_torch.launch.dryrun` traces one rank's step of a mesh that no
machine here has. Importing this module starts no group.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
# at the full 700 W power limit), per card; the dry run's roofline divides
# its counts by them.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W (published peaks)"
PEAK_FLOPS_BF16 = 989e12          # tensor cores, bf16
PEAK_FLOPS_F32 = 67e12            # f32 outside the tensor cores: PyTorch's
#                                   default leaves TF32 off for matmuls
HBM_BW = 3.35e12                  # bytes/s
NVLINK_BW = 450e9                 # bytes/s each way. A 16-wide mesh axis spans
#                                   two 8-card hosts, so over such an axis this
#                                   is a lower bound on the time


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


# the reference's production meshes: (shape, axis names)
PRODUCTION_MESHES = {"single": ((16, 16), ("data", "model")),
                     "multi": ((2, 16, 16), ("pod", "data", "model"))}


def make_fake_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` whose process group is a
    fake one of as many ranks, with this process as rank 0. Raises if a
    default process group exists (a real one is never reused); the caller
    destroys the group when done (``torch.distributed.destroy_process_group``)."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; a fake mesh starts its "
                           "own group")
    # FakeStore and the "fake" backend ship in the wheel under a private
    # module (importing it registers the backend)
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(multi_pod: bool = False, device="cuda"):
    """The reference's production mesh as rank 0 of a fake process group
    (:func:`make_fake_mesh`): ("data", "model") (16, 16) over 256 ranks, or
    with ``multi_pod`` ("pod", "data", "model") (2, 16, 16) over 512."""
    return make_fake_mesh(*PRODUCTION_MESHES["multi" if multi_pod else "single"],
                          device=device)
