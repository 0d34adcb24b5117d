"""Kernel K3: causal GQA flash attention, forward.

Two CUDA kernels share the wrapper, chosen by a fixed table on (dtype, D):

=============  ===============  ==========================================
dtype          head size D      kernel (route)
=============  ===============  ==========================================
bfloat16       64, 128          ``csrc/flash_attention_sm90.cu`` (``sm90``):
                                wgmma tensor cores, TMA, an mbarrier ring
bfloat16       16, 32           ``csrc/flash_attention.cu`` (``simt``):
                                CUDA cores
float32        16, 32, 64, 128  ``csrc/flash_attention.cu`` (``simt``): a
                                float32 product on the tensor cores would
                                be TF32
=============  ===============  ==========================================

Each source's opening note says what it replaces and how it is designed.
:func:`flash_attention` launches the table's kernel for CUDA tensors, with
no retry on the other kernel, and takes :func:`flash_attention_plain` — the
chunked streaming-softmax
:func:`~repro_torch.kernels.flash_attention.ref.flash_torch` — only for
tensors on the CPU.  The plain version is also the kernels' oracle on the
card.

The backward routes by the same table (:func:`bwd_route`):

=============  ===============  ==========================================
dtype          head size D      kernel (route)
=============  ===============  ==========================================
bfloat16       64, 128          ``csrc/flash_attention_bwd_sm90.cu``
                                (``sm90``): wgmma, TMA rings, no atomics
bfloat16       16, 32           ``csrc/flash_attention_bwd.cu`` (``simt``):
                                CUDA cores
float32        16, 32, 64, 128  ``csrc/flash_attention_bwd.cu`` (``simt``)
=============  ===============  ==========================================

:func:`flash_attention_bwd` launches the route's three kernels (stats,
dK/dV, dQ) for CUDA tensors, with no retry on the other route, and takes
:func:`flash_attention_bwd_plain` (autograd through ``flash_torch``) for
CPU tensors.  :class:`FlashAttentionFn` joins forward and backward for
autograd; :func:`flash_attention_train` applies it, and training on the
card reaches it through ``models.attention.attention``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build as _build
from repro_torch.kernels.flash_attention.ref import flash_torch

#: head sizes the kernels are compiled for
HEAD_DIMS = (16, 32, 64, 128)
#: (dtype, head sizes) that take the tensor-core kernel; the rest take simt
SM90 = (torch.bfloat16, (64, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head size launches:
    ``"sm90"`` or ``"simt"``.  Raises for what neither kernel takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"q: expected float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} not in {HEAD_DIMS}")
    return "sm90" if dtype == SM90[0] and d in SM90[1] else "simt"


def _lib(name: str):
    if name == "sm90":
        fn = _build.load("flash_attention_sm90").flash_attention_sm90_fwd
        argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    else:
        fn = _build.load("flash_attention").flash_attention_fwd
        argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward kernel a CUDA call with this dtype and head size
    launches: ``"sm90"`` or ``"simt"`` (the forward's table).  Raises for
    what neither kernel takes."""
    return route(dtype, d)


def _bwd_lib(name: str):
    if name == "sm90":
        fn = _build.load("flash_attention_bwd_sm90").flash_attention_bwd_sm90
        argtypes = [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P]
    else:
        fn = _build.load("flash_attention_bwd").flash_attention_bwd
        argtypes = [_P] * 10 + [_I] * 7 + [ctypes.c_float, _P]
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(q, k, v):
    """(b, hq, hkv, s, d) of contiguous q, k, v that K3 takes; raises else."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    _build.check_tensor(q, q.dtype, 4, "q")
    _build.check_tensor(k, q.dtype, 4, "k", q.device)
    _build.check_tensor(v, q.dtype, 4, "v", q.device)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or v.shape != k.shape:
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return b, hq, hkv, s, d


def flash_attention_plain(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`."""
    return flash_torch(q, k, v, causal=causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: [B, Hq, S, D]; k, v: [B, Hkv, S, D] -> [B, Hq, S, D] in q's dtype.

    Contiguous float32 or bfloat16 tensors of one dtype, Hq % Hkv == 0,
    any S >= 1.  CPU tensors take :func:`flash_attention_plain`; CUDA
    tensors launch the kernel :func:`route` names (D in :data:`HEAD_DIMS`),
    and anything it does not take raises, as does a CUDA call that autograd
    would record (use :func:`flash_attention_train`)."""
    b, hq, hkv, s, d = _check_qkv(q, k, v)
    if _build.plain_route(q):
        return flash_attention_plain(q, k, v, causal=causal)
    _build.check_untracked("flash_attention", q, k, v)
    route(q.dtype, d)
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535 rows")
    if s == 0 or b == 0:
        return torch.empty_like(q)
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> torch.Tensor:
    """One launch of :func:`route`'s forward kernel (checked inputs)."""
    b, hq, s, d = q.shape
    name = route(q.dtype, d)
    out = torch.empty_like(q)
    fn = _lib(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if name == "sm90":
            err = fn(*ptrs, b, hq, k.shape[1], s, d, int(causal), d ** -0.5, stream)
        else:
            err = fn(*ptrs, _DTYPE_CODE[q.dtype], b, hq, k.shape[1], s, d, int(causal),
                     d ** -0.5, stream)
    _build.check(err, f"flash_attention ({name})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[name] += 1
    return out


@_fwd_launch.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def attention_flops(b: int, hq: int, s: int, d: int, causal: bool, products: int = 2) -> int:
    """Multiply-add FLOPs (2 a multiply-add) of ``products`` [S, S] x [S, D]
    products a head: over the causal triangle's S (S + 1) / 2 (query, key)
    pairs, or all S * S."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * products * b * hq * pairs * d


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    b, hq, s, d = q_shape
    return attention_flops(b, hq, s, d, causal)


#: kernel launches so far, in all and by route (plain counts; callers may
#: reset them to 0)
flash_attention.launches = 0
flash_attention.launches_by_route = {"sm90": 0, "simt": 0}


def flash_attention_bwd_plain(q, k, v, do, *, causal: bool = True):
    """Plain PyTorch version of :func:`flash_attention_bwd`: autograd
    through :func:`~repro_torch.kernels.flash_attention.ref.flash_torch`."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        out = flash_torch(*qkv, causal=causal)
        return torch.autograd.grad(out, qkv, do)


def flash_attention_bwd(q, k, v, o, do, *, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention` at q, k, v, given its output
    ``o`` and the output's gradient ``do`` (both [B, Hq, S, D] in q's
    dtype), each in its input's shape and dtype.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the three
    passes of the kernel :func:`bwd_route` names (D in :data:`HEAD_DIMS`,
    float32 or bf16), and anything it does not take raises.  Every call on
    the card adds one to ``flash_attention_bwd.launches`` and to its
    route's ``flash_attention_bwd.launches_by_route``."""
    b, hq, hkv, s, d = _check_qkv(q, k, v)
    for name, t in (("o", o), ("do", do)):
        _build.check_tensor(t, q.dtype, 4, name, q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, q {tuple(q.shape)}")
    if _build.plain_route(q):
        return flash_attention_bwd_plain(q, k, v, do, causal=causal)
    bwd_route(q.dtype, d)
    if b * hq > 65535:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's 65535 rows")
    if s == 0 or b == 0:
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    return tuple(torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, do, causal))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                do: torch.Tensor, causal: bool) -> Tuple[torch.Tensor, torch.Tensor,
                                                         torch.Tensor]:
    """One call of :func:`bwd_route`'s three backward kernels (checked
    inputs)."""
    b, hq, s, d = q.shape
    name = bwd_route(q.dtype, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # lse and delta scratch: the sm90 kernels read whole 64-row tiles of it
    rows = -(-s // 64) * 64 if name == "sm90" else s
    lse = torch.empty((b, hq, rows), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = _bwd_lib(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                delta.data_ptr())
        if name == "sm90":
            err = fn(*ptrs, b, hq, k.shape[1], s, d, int(causal), d ** -0.5, stream)
        else:
            err = fn(*ptrs, _DTYPE_CODE[q.dtype], b, hq, k.shape[1], s, d, int(causal),
                     d ** -0.5, stream)
    _build.check(err, f"flash_attention_bwd ({name})")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[name] += 1
    return dq, dk, dv


@_bwd_launch.register_fake
def _(q, k, v, o, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q_shape, k_shape, v_shape, o_shape, do_shape, causal, *args, **kwargs) -> int:
    # the recomputed scores, dP = dO V^T, dV = P^T dO, dQ = dS K, dK = dS^T Q
    b, hq, s, d = q_shape
    return attention_flops(b, hq, s, d, causal, products=5)


#: backward calls on the card so far, in all and by route, each three
#: kernel launches (stats, dK/dV, dQ); plain counts, callers may reset them
#: to 0
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_by_route = {"sm90": 0, "simt": 0}


class FlashAttentionFn(torch.autograd.Function):
    """K3 for autograd: the forward kernel, and the backward kernel on its
    saved q, k, v and output (the plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        o = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """:func:`flash_attention` that autograd differentiates through
    :func:`flash_attention_bwd`."""
    return FlashAttentionFn.apply(q, k, v, causal)
