"""Device meshes over ``torch.distributed``.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose
dimensions carry the reference's axis names (``"data"``, ``"model"``, and
``"pod"`` on a multi-pod mesh).  The production mesh builder is not ported
yet: it comes with the LM step builders that use it.
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
