"""Meshes over the running process group: the port of
``repro.launch.mesh``.

Single pod: 16x16 = 256 ranks (data, model). Multi-pod: 2x16x16 = 512
ranks (pod, data, model), ``pod`` the slowest axis. The dry run builds
them over a ``fake`` process group of that many ranks in one process
(``launch/dryrun.py``); on real hardware the group is the job's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over the ranks of the running group, one card
    per rank (the CPU under ``gloo``)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
