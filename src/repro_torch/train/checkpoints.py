"""Checkpointing: atomic, step-indexed, in the reference's on-disk layout.

Layout:  ``<dir>/step_<N>/`` with one ``leaf_<i>.npy`` per leaf of the
state tree (:mod:`repro_torch.tree`, JAX's leaf order) plus
``manifest.json`` (``{"step", "leaves": [{key, file, shape, dtype}],
"extra"}``: data cursors, the step).  bf16 leaves are stored as their
uint16 bits (``.npy`` has no bf16) with ``"dtype": "bfloat16"``.  Writes go
to ``step_<N>.tmp`` and are renamed only after the manifest's fsync: a
killed writer never corrupts the latest checkpoint.  The port reads the
reference's checkpoints and the reference the port's.

Restore places each leaf on the template leaf's device (or on
``torch_device`` when given).  With ``shardings=`` (a tree like the
template whose leaves are ``(mesh, Spec)`` pairs, ``(mesh, placements)``
pairs, DTensors to copy the layout of, or ``None``) each leaf lands as a
DTensor at that layout on the mesh, whatever layout wrote it: the files
hold whole arrays, so a checkpoint written at one layout restores at any
other (the reference's elastic resharding).
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

# torch dtype <-> the dtype name the manifest records (numpy's, and bf16's)
_NP_NAME = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
            torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
            torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
            torch.bool: "bool"}
_TORCH = {v: k for k, v in _NP_NAME.items()}


def leaf_to_numpy(leaf) -> np.ndarray:
    """A leaf as the array the file holds: bf16 as its uint16 bits."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def leaf_from_numpy(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """The tensor a file's array stands for (``dtype_name`` from the
    manifest), on ``device``."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.array(arr, order="C").view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, order="C")).to(_TORCH[dtype_name])
    return t.to(device)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return _NP_NAME[leaf.dtype]
    return str(np.asarray(leaf).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ------------------------------------------------------------------ #
    def save(self, step: int, state: Dict[str, Any], extra: Optional[Dict] = None):
        """state: tree of tensors.  extra: JSON-serializable metadata (data
        cursors, the step) stored in the manifest."""
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for i, (key, leaf) in enumerate(flatten_with_paths(state)):
            arr = leaf_to_numpy(leaf)
            fname = f"leaf_{i}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": _dtype_name(leaf)})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------ #
    def restore(self, template, step: Optional[int] = None, shardings=None,
                torch_device=None) -> Any:
        """template: tree with the same structure as the saved state.
        Returns (state, extra, step); each leaf lands on ``torch_device``
        when given, else on its template leaf's device, and where
        ``shardings`` names a layout for it, as a DTensor at that layout
        (see the module note)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no checkpoints found")
        d = self.dir / f"step_{step}"
        with open(d / "manifest.json") as f:
            manifest = json.load(f)
        tmpl = flatten_with_paths(template)
        assert len(tmpl) == len(manifest["leaves"]), (
            f"leaf count mismatch: template {len(tmpl)} vs "
            f"checkpoint {len(manifest['leaves'])}"
        )
        layouts = (_layouts(template, shardings) if shardings is not None
                    else [None] * len(tmpl))
        out = []
        for (_, leaf), rec, layout in zip(tmpl, manifest["leaves"], layouts):
            dev = torch_device
            if dev is None:
                dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            t = leaf_from_numpy(np.load(d / rec["file"]), rec["dtype"], dev)
            out.append(t if layout is None else _distribute(t, layout))
        return unflatten(template, out), manifest["extra"], step


def _layouts(template, shardings) -> list:
    """One layout (or ``None``) a leaf of ``template``, in its leaf order:
    ``shardings`` follows the template's structure down to the leaves (a
    ``None`` subtree: no layout under it)."""
    from repro_torch.tree import _children, _is_container

    if template is None:
        return []
    if not _is_container(template):
        return [shardings]
    out = []
    for key, child in _children(template):
        if shardings is None:
            sub = None
        elif isinstance(template, dict):
            sub = shardings[key]
        elif hasattr(template, "_fields"):
            sub = getattr(shardings, key[1:])
        else:
            sub = shardings[int(key)]
        out += _layouts(child, sub)
    return out


def _distribute(t: torch.Tensor, layout):
    """``t`` (the whole leaf) as a DTensor at ``layout``: ``(mesh, Spec)``,
    ``(mesh, placements)`` or a DTensor whose mesh and placements it
    takes.  Each rank keeps its own piece (``distribute_tensor``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.distributed.sharding_rules import Spec, placements

    if isinstance(layout, DTensor):
        mesh, pl = layout.device_mesh, list(layout.placements)
    else:
        mesh, pl = layout
        if isinstance(pl, Spec):
            pl = placements(pl, mesh)
    for i, p in enumerate(pl):
        if p.is_shard() and t.shape[p.dim] % mesh.size(i):
            raise ValueError(f"a leaf of shape {tuple(t.shape)} does not split at "
                             f"{pl} over {tuple(mesh.shape)}")
    return distribute_tensor(t.to(mesh.device_type), mesh, pl)
