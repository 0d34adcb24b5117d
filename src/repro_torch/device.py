"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: every
``torch_device=`` argument defaults to ``"cuda"``, and asking for CUDA on a
machine without it raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(torch_device="cuda") -> torch.device:
    """``torch_device`` (a string or :class:`torch.device`) as a device;
    raises when it names CUDA and no CUDA device is available."""
    dev = torch.device(torch_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"torch_device={str(dev)!r} but torch.cuda.is_available() is "
            "False; pass torch_device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported torch_device {str(dev)!r}")
    return dev


def upload(a, dev: torch.device, dtype=np.int32) -> torch.Tensor:
    """A copy of host array ``a`` as a ``dtype`` tensor on ``dev``.  Always
    a copy: plan tensors are patched in place and must not alias the
    caller's (possibly read-only) arrays on the CPU."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(dev)
