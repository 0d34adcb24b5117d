"""Device meshes over ``torch.distributed``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
dimensions carry the reference's axis names (``"data"``, ``"model"``, and
``"pod"`` on a multi-pod mesh).  Both builders are functions over the
default process group, which the caller starts (the dry-run starts a fake
one of 256 or 512 ranks in one process).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel dimensions (``"pod"``, ``"data"``), in the
    mesh's order."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in names if a in ("pod", "data"))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh over the default process group:
    ``(16, 16)`` as ``("data", "model")``, or ``(2, 16, 16)`` as ``("pod",
    "data", "model")`` with ``multi_pod``, so the dry-run's cells compare
    with the reference's specs one to one.

    On H100s these shapes are the reference's, not the card's: a 16-wide
    ``"model"`` axis spans two 8-GPU NVLink domains, so its collectives
    leave NVLink for the inter-node network (the roofline charges them
    there).  The caller starts a group of 256 (512) ranks first."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    size = 512 if multi_pod else 256
    if not dist.is_initialized() or dist.get_world_size() != size:
        raise RuntimeError(f"the production mesh {shape} needs a process group of "
                           f"{size} ranks; start one first")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, device_type: str = "cpu"):
    """A ``(n_data, n_model)`` mesh with dims ``("data", "model")`` over
    the default process group: gloo for ``device_type="cpu"``, NCCL for
    ``"cuda"`` (each rank on its own card).  The caller starts a group of
    ``n_data * n_model`` ranks first; a mesh of one device with no group
    started starts its own world of one in this process
    (``dist.HashStore``)."""
    from torch.distributed.device_mesh import init_device_mesh

    size = n_data * n_model
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(f"a {n_data} x {n_model} mesh needs a process group of "
                               f"{size} ranks; start one first")
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() != size:
        raise ValueError(f"a {n_data} x {n_model} mesh over a world of "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
