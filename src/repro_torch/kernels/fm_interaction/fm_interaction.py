"""Kernel K4: the FM second-order interaction, ``[B, F, K] -> [B]``.

The CUDA kernel is ``csrc/fm_interaction.cu`` (its opening note says what
it replaces and how it is designed).  :func:`fm_interaction` launches it
for CUDA tensors and takes :func:`fm_interaction_plain` (the oracle
:func:`~repro_torch.kernels.fm_interaction.ref.fm_interaction_ref`) only
for tensors on the CPU.  The plain version is also the kernel's oracle on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref

#: the kernel stages one example's F * K floats in 48 KB of shared memory
MAX_ROW_FLOATS = 48 * 1024 // 4

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load("fm_interaction").fm_interaction_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def fm_interaction_plain(emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fm_interaction`."""
    return fm_interaction_ref(emb)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb: contiguous [B, F, K] float32 -> [B] float32.  CPU tensors take
    :func:`fm_interaction_plain`; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    _build.check_tensor(emb, torch.float32, 3, "emb")
    if emb.device.type == "cpu":
        return fm_interaction_plain(emb)
    if emb.device.type != "cuda":
        raise ValueError(f"fm_interaction: unsupported device {emb.device}")
    b, f, k = emb.shape
    if f * k > MAX_ROW_FLOATS:
        raise ValueError(f"F * K = {f * k} floats exceed one block's shared "
                         f"memory ({MAX_ROW_FLOATS})")
    out = torch.empty((b,), dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    if f == 0 or k == 0:
        return out.zero_()
    fn = _lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = fn(emb.data_ptr(), b, f, k, out.data_ptr(), stream)
    _build.check(err, "fm_interaction_f32")
    fm_interaction.launches += 1
    return out


#: kernel launches so far (a plain count; callers may reset it to 0)
fm_interaction.launches = 0
