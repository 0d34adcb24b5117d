"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds).  Libraries land in ``build/kernels/`` at the root of
the checkout, named by a hash of the source and the compiler flags, so an
edited source rebuilds and an unchanged one is reused.  A failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: every kernel source the port ships
KERNELS = ("segment_sum", "bitset_expand", "flash_attention", "flash_attention_sm90",
           "flash_attention_bwd", "flash_attention_bwd_sm90", "fm_interaction",
           "inherit_scan")

_LIBS: Dict[str, ctypes.CDLL] = {}
# serializes first uses: two threads (a service's flusher and its updater)
# launching kernels must not both start nvcc on one output file
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source + flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns build seconds per kernel
    (0.0 for one already built); raises with the compiler output when any
    build fails.  ``ptxas`` register/spill reports go to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed (one
    thread at a time; a loaded library is returned without the lock)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib


def ptxas_report(name: str) -> dict:
    """What ``ptxas -v`` said of kernel ``name`` in its build log:
    ``{"functions": {mangled name: {registers, stack, spill_stores,
    spill_loads}}, "setmaxnreg_ignored": count of ptxas's C7508 warnings}``."""
    lines = library_path(name).with_suffix(".log").read_text().splitlines()
    funcs: Dict[str, Dict[str, int]] = {}
    fn = None
    for ln in lines:
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = funcs.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and fn is not None:
            fn.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                      spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
    return {"functions": funcs,
            "setmaxnreg_ignored": sum("setmaxnreg ignored" in ln for ln in lines)}


def sass(name: str) -> str:
    """The SASS of kernel ``name``'s library, by the toolkit's ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(library_path(name))],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {name}: {out.stderr.strip()}")
    return out.stdout


def is_fake(t) -> bool:
    """A fake tensor (``FakeTensorMode``: shapes only, no storage)."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)


def plain_route(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` takes its kernel's plain version: a
    real tensor on the CPU does; a CUDA tensor launches the kernel, and a
    fake tensor (the dry-run's, on any device) takes the kernel's route,
    where the kernel's registered fake implementation stands in for the
    launch."""
    return t.device.type == "cpu" and not is_fake(t)


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def check_untracked(what: str, *ts) -> None:
    """Raise when autograd would record a call on ``ts``: grad mode is on
    and one of them requires grad.  A kernel launched through ctypes gives a
    result with no ``grad_fn``, so such a call would silently cut the
    gradient; the kernels with a backward kernel take it through their
    ``torch.autograd.Function`` instead."""
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{what}: an input requires grad and grad mode is on, but the "
            "kernel's result would carry no gradient; call it under "
            "torch.no_grad() or on detached inputs")


def check_tensor(t: torch.Tensor, dtype, ndim: int, name: str, device=None) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D ``dtype`` tensor on
    ``device`` (when given) that 32-bit row indices can address."""
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {ndim}-D {dtype}, got "
                        f"{t.dim()}-D {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                         "indexes rows with 32-bit ints")
