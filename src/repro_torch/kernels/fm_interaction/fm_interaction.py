"""Kernel K4: the FM second-order interaction, ``[B, F, K] -> [B]``.

The CUDA kernel is ``csrc/fm_interaction.cu`` (its opening note says what
it replaces and how it is designed).  :func:`fm_interaction` launches it
for CUDA tensors and takes :func:`fm_interaction_plain` (the oracle
:func:`~repro_torch.kernels.fm_interaction.ref.fm_interaction_ref`) only
for tensors on the CPU.  The plain version is also the kernel's oracle on
the card.

The backward is a second entry of the same source:
:func:`fm_interaction_bwd` launches it for CUDA tensors and takes
:func:`fm_interaction_bwd_plain` (autograd through the oracle) for CPU
tensors.  :class:`FMInteractionFn` joins the two kernels for autograd;
:func:`fm_interaction_train` applies it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

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


def _bwd_lib():
    fn = _build.load("fm_interaction").fm_interaction_bwd_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _I, _I, _I, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def _check_emb(emb: torch.Tensor) -> None:
    _build.check_tensor(emb, torch.float32, 3, "emb")
    if emb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fm_interaction: unsupported device {emb.device}")
    if not _build.plain_route(emb) and emb.shape[1] * emb.shape[2] > MAX_ROW_FLOATS:
        raise ValueError(f"F * K = {emb.shape[1] * emb.shape[2]} floats exceed one "
                         f"block's shared memory ({MAX_ROW_FLOATS})")


def fm_interaction_plain(emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fm_interaction`."""
    return fm_interaction_ref(emb)


def fm_interaction(emb: torch.Tensor) -> torch.Tensor:
    """emb: contiguous [B, F, K] float32 -> [B] float32.  CPU tensors take
    :func:`fm_interaction_plain`; CUDA tensors launch the kernel, and
    anything the kernel does not take raises."""
    _check_emb(emb)
    if _build.plain_route(emb):
        return fm_interaction_plain(emb)
    _build.check_untracked("fm_interaction", emb)
    b, f, k = emb.shape
    if b == 0:
        return torch.empty((b,), dtype=torch.float32, device=emb.device)
    if f == 0 or k == 0:
        return torch.zeros((b,), dtype=torch.float32, device=emb.device)
    return torch.ops.repro_torch.fm_interaction_fwd(emb)


@torch.library.custom_op("repro_torch::fm_interaction_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_launch(emb: torch.Tensor) -> torch.Tensor:
    """One launch of the forward kernel (checked input)."""
    b, f, k = emb.shape
    out = torch.empty((b,), dtype=torch.float32, device=emb.device)
    fn = _lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = fn(emb.data_ptr(), b, f, k, out.data_ptr(), stream)
    _build.check(err, "fm_interaction_f32")
    fm_interaction.launches += 1
    return out


@_fwd_launch.register_fake
def _(emb):
    return emb.new_empty((emb.shape[0],))


@register_flop_formula(torch.ops.repro_torch.fm_interaction_fwd)
def _(emb_shape, *args, **kwargs) -> int:
    # per example and column: F adds for the sum, F multiply-adds for the
    # squares, then the square of the sum and a subtract
    b, f, k = emb_shape
    return b * k * (3 * f + 2)


#: kernel launches so far (a plain count; callers may reset it to 0)
fm_interaction.launches = 0


def fm_interaction_bwd_plain(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fm_interaction_bwd`: autograd
    through :func:`~repro_torch.kernels.fm_interaction.ref.fm_interaction_ref`."""
    with torch.enable_grad():
        e = emb.detach().requires_grad_()
        return torch.autograd.grad(fm_interaction_ref(e), e, g)[0]


def fm_interaction_bwd(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``sum_b g[b] * fm_interaction(emb)[b]`` with respect
    to ``emb``: contiguous [B, F, K] and [B] float32 -> [B, F, K] float32,
    ``g[b] * (sum_f' emb[b, f', k] - emb[b, f, k])``.  CPU tensors take
    :func:`fm_interaction_bwd_plain`; CUDA tensors launch the kernel, and
    anything it does not take raises.  Every launch adds one to
    ``fm_interaction_bwd.launches``."""
    _check_emb(emb)
    _build.check_tensor(g, torch.float32, 1, "g", emb.device)
    if g.shape[0] != emb.shape[0]:
        raise ValueError(f"g has {g.shape[0]} rows for {emb.shape[0]} examples")
    if _build.plain_route(emb):
        return fm_interaction_bwd_plain(emb, g)
    if emb.numel() == 0:
        return torch.empty_like(emb)
    return torch.ops.repro_torch.fm_interaction_bwd(emb, g)


@torch.library.custom_op("repro_torch::fm_interaction_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_launch(emb: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """One launch of the backward kernel (checked inputs)."""
    b, f, k = emb.shape
    out = torch.empty_like(emb)
    fn = _bwd_lib()
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        err = fn(emb.data_ptr(), g.data_ptr(), b, f, k, out.data_ptr(), stream)
    _build.check(err, "fm_interaction_bwd_f32")
    fm_interaction_bwd.launches += 1
    return out


@_bwd_launch.register_fake
def _(emb, g):
    return torch.empty_like(emb)


@register_flop_formula(torch.ops.repro_torch.fm_interaction_bwd)
def _(emb_shape, g_shape, *args, **kwargs) -> int:
    # the column sums, then g * (sum - emb) an element
    b, f, k = emb_shape
    return b * k * (3 * f + f)


#: backward kernel launches so far (a plain count; callers may reset it to 0)
fm_interaction_bwd.launches = 0


class FMInteractionFn(torch.autograd.Function):
    """K4 for autograd: the forward kernel, and the backward kernel on the
    saved ``emb`` (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, emb):
        ctx.save_for_backward(emb)
        return fm_interaction(emb)

    @staticmethod
    def backward(ctx, g):
        (emb,) = ctx.saved_tensors
        return fm_interaction_bwd(emb, g.contiguous())


def fm_interaction_train(emb: torch.Tensor) -> torch.Tensor:
    """:func:`fm_interaction` that autograd differentiates through
    :func:`fm_interaction_bwd`."""
    return FMInteractionFn.apply(emb)
