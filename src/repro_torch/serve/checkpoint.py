"""Snapshot checkpoints: bound WAL replay at recovery and enable rejoin.

A checkpoint is a pickle-free, CRC-attributed serialization of a
session's *graph* at one version (``GCKP1`` file format below).  The
graph is the only state that needs saving: indices, plans, and executors
are deterministic functions of it, and the repo's bit-identity invariant
guarantees that a session rebuilt from the checkpointed graph answers
exactly what the incrementally maintained original answered at that
version.  Recovery then becomes **checkpoint-load + bounded tail
replay** (:meth:`repro_torch.core.api.Session.restore_from_wal` with
``checkpoint=``) instead of replaying the whole log, and sealed WAL
segments at or below the newest checkpoint become safe to truncate
(:meth:`repro_torch.serve.wal.SegmentedWriteAheadLog.truncate_upto`).

File format (all little-endian)::

    header   := b"GCKP1\\n\\x00\\x00"                       (8 bytes)
    meta     := u32 len | crc32 | sorted-key JSON
    array    := u64 len | crc32 | raw bytes     (one per meta["arrays"])

``meta`` carries ``version``, the graph shape (``n``, ``directed``), the
array table (name, dtype, length — ``src``/``dst`` plus one entry per
vertex attribute), and the writer's :meth:`Session.digest` dict.  Every
section has its own crc32 so corruption is *attributed*: a failing section CRC
raises :class:`CheckpointCorruptError`; a loaded graph whose recomputed
``graph_crc`` disagrees with the stamped digest raises
:class:`CheckpointDigestError` (the file is internally consistent but
does not describe the state it claims to).

Checkpoints are written atomically (tmp file + ``os.replace``) and named
``ckpt-{version:012d}.gckp`` so :func:`latest_checkpoint` can pick the
newest usable one by filename alone.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.core.graph import Graph

__all__ = [
    "CheckpointCorruptError",
    "CheckpointDigestError",
    "checkpoint_filename",
    "latest_checkpoint",
    "list_checkpoints",
    "load_checkpoint",
    "save_checkpoint",
    "write_checkpoint",
]

_CKPT_MAGIC = b"GCKP1\n\x00\x00"
_META_HDR = struct.Struct("<II")   # len, crc32
_ARR_HDR = struct.Struct("<QI")    # len, crc32
_CKPT_PREFIX = "ckpt-"
_CKPT_SUFFIX = ".gckp"


class CheckpointCorruptError(ValueError):
    """A checkpoint section failed its CRC / framing — the file's bytes
    are damaged (storage rot, torn write).  Fall back to an older
    checkpoint or full WAL replay."""


class CheckpointDigestError(ValueError):
    """The checkpoint is internally consistent but its reconstructed
    graph does not match the stamped ``graph_crc`` — the writer and the
    file disagree about the state it describes.  Treat like a divergence
    finding: do not serve from it."""


def checkpoint_filename(version: int) -> str:
    """``ckpt-{version:012d}.gckp`` (lexical order == version order)."""
    return f"{_CKPT_PREFIX}{int(version):012d}{_CKPT_SUFFIX}"


def list_checkpoints(directory) -> List[Tuple[int, str]]:
    """``[(version, path)]`` for every checkpoint file, version order."""
    directory = os.fspath(directory)
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        if not (name.startswith(_CKPT_PREFIX)
                and name.endswith(_CKPT_SUFFIX)):
            continue
        stem = name[len(_CKPT_PREFIX): -len(_CKPT_SUFFIX)]
        if stem.isdigit():
            out.append((int(stem), os.path.join(directory, name)))
    out.sort()
    return out


def latest_checkpoint(directory,
                      upto_version: Optional[int] = None
                      ) -> Optional[Tuple[int, str]]:
    """The newest ``(version, path)`` with ``version <= upto_version``
    (or the newest overall), or None when no checkpoint qualifies."""
    best = None
    for version, path in list_checkpoints(directory):
        if upto_version is not None and version > int(upto_version):
            continue
        best = (version, path)
    return best


# ---------------------------------------------------------------------- #
def _section(payload: bytes, hdr: struct.Struct) -> bytes:
    return hdr.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def write_checkpoint(path, version: int, graph: Graph,
                     digest: Optional[Dict] = None) -> str:
    """Serialize ``graph`` at ``version`` to ``path`` (atomic).

    ``digest`` is the writer's :meth:`Session.digest` dict; when omitted,
    only the locally computed ``graph_crc`` is stamped.  Exposed below
    :func:`save_checkpoint` so tests can craft files with a deliberate
    digest (verification-path coverage)."""
    from repro_torch.obs.audit import graph_crc

    path = os.fspath(path)
    arrays: List[Tuple[str, np.ndarray]] = [
        ("src", np.asarray(graph.src)), ("dst", np.asarray(graph.dst))]
    for name in sorted(graph.attrs):
        arrays.append((f"attr:{name}", np.asarray(graph.attrs[name])))
    if digest is None:
        digest = {"graph_crc": graph_crc(graph)}
    meta = {
        "version": int(version),
        "n": int(graph.n),
        "directed": bool(graph.directed),
        "n_edges": int(np.asarray(graph.src).shape[0]),
        "digest": digest,
        "arrays": [{"name": name, "dtype": str(a.dtype),
                    "shape": list(a.shape)} for name, a in arrays],
    }
    blob = [_CKPT_MAGIC,
            _section(json.dumps(meta, sort_keys=True).encode(), _META_HDR)]
    for _, a in arrays:
        blob.append(_section(np.ascontiguousarray(a).tobytes(), _ARR_HDR))
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(blob))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _read_section(data: bytes, off: int, hdr: struct.Struct,
                  what: str, path) -> Tuple[bytes, int]:
    if off + hdr.size > len(data):
        raise CheckpointCorruptError(
            f"{path!r}: truncated {what} header at byte {off}")
    length, crc = hdr.unpack_from(data, off)
    off += hdr.size
    end = off + length
    if end > len(data):
        raise CheckpointCorruptError(
            f"{path!r}: truncated {what} payload at byte {off}")
    payload = data[off:end]
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointCorruptError(
            f"{path!r}: {what} crc mismatch at byte {off}")
    return payload, end


def load_checkpoint(path, verify: bool = True) -> Tuple[int, Graph, Dict]:
    """Read a checkpoint: ``(version, graph, digest)``.

    Every section CRC is checked (:class:`CheckpointCorruptError` on
    damage); with ``verify`` (default) the rebuilt graph's ``graph_crc``
    must equal the stamped digest's (:class:`CheckpointDigestError`
    otherwise — "checkpoint digest mismatch" in the runbook)."""
    from repro_torch.obs.audit import graph_crc

    path = os.fspath(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[: len(_CKPT_MAGIC)] != _CKPT_MAGIC:
        raise CheckpointCorruptError(f"{path!r}: bad checkpoint magic")
    meta_raw, off = _read_section(data, len(_CKPT_MAGIC), _META_HDR,
                                  "meta", path)
    meta = json.loads(meta_raw.decode())
    arrays: Dict[str, np.ndarray] = {}
    for entry in meta["arrays"]:
        raw, off = _read_section(data, off, _ARR_HDR,
                                 f"array {entry['name']}", path)
        a = np.frombuffer(raw, dtype=np.dtype(entry["dtype"]))
        arrays[entry["name"]] = a.reshape(entry["shape"]).copy()
    attrs = {name[len("attr:"):]: a for name, a in arrays.items()
             if name.startswith("attr:")}
    graph = Graph(n=int(meta["n"]), src=arrays["src"], dst=arrays["dst"],
                  directed=bool(meta["directed"]), attrs=attrs)
    digest = meta.get("digest") or {}
    if verify and "graph_crc" in digest:
        got = graph_crc(graph)
        if got != digest["graph_crc"]:
            raise CheckpointDigestError(
                f"{path!r}: reconstructed graph_crc {got} != stamped "
                f"{digest['graph_crc']} (version {meta['version']})")
    return int(meta["version"]), graph, digest


def save_checkpoint(session, directory, obs=None) -> Tuple[int, str]:
    """Checkpoint a live session into ``directory``.

    Stamps the session's full :meth:`~repro_torch.core.api.Session.digest`
    (graph + plan CRCs) and returns ``(version, path)``.  Idempotent per
    version (an existing file for the same version is replaced
    atomically with identical bytes)."""
    directory = os.fspath(directory)
    os.makedirs(directory, exist_ok=True)
    version = int(session.version)
    path = os.path.join(directory, checkpoint_filename(version))
    write_checkpoint(path, version, session.graph,
                     digest=session.digest())
    reg = obs if obs is not None else _obs.get_registry()
    reg.counter("repro_checkpoint_saves_total",
                "snapshot checkpoints written").inc()
    reg.gauge("repro_checkpoint_last_version",
              "version of the newest checkpoint written").set(version)
    return version, path
