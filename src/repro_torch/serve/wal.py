"""Write-ahead log of :class:`~repro_torch.core.updates.UpdateBatch`es.

Durability for the serving tier: the service appends every batch to the
log *before* applying it to the live :class:`~repro_torch.core.api.Session`
(append-before-apply), so any state a reader could ever observe is
reconstructible by replaying the log into a fresh session —
:meth:`repro_torch.core.api.Session.restore_from_wal`.  The format is the
reference package's byte for byte, so either package replays the other's
log; a follower tailing the file by byte offset (or segment cursor) reads
it as it grows.

File format (all little-endian)::

    header  := b"GWAL1\\n\\x00\\x00"                      (8 bytes, once)
    record  := b"WREC" | version u64 | payload_len u64 | crc32 u32
               | payload
    digest  := b"WDIG" | version u64 | payload_len u64 | crc32 u32
               | payload
    payload := the UpdateBatch codec bytes
               (:func:`repro_torch.core.updates.encode_update_batch`)
               for records; sorted-key JSON (the
               :func:`repro_torch.obs.audit.session_digest` dict) for digests

``version`` is the session version the batch *produces* (monotonically
increasing).  The crc32 covers the payload only; readers stop cleanly at
the first truncated or checksum-failing record — a torn tail from a crash
mid-append loses at most the records not yet fsynced, never corrupts the
prefix.

Digest records (:meth:`WriteAheadLog.append_digest`) are the leader's
per-version content attestation: a follower recomputes its own digest
after applying record ``v`` and compares
(:func:`repro_torch.obs.audit.digests_match`), attributing any divergence
to the first bad version and the digest record's byte offset.  :func:`read_wal_records` *skips*
digest records, so every pre-digest reader (replay, recovery, replicas
polling by offset) keeps working on logs with or without them;
:func:`scan_wal_entries` surfaces both record kinds with their byte
offsets.  :attr:`WriteAheadLog.synced_size` is the durable high-water
mark — everything below it is *sealed*, which is the region the
background scrubber (:class:`repro_torch.obs.audit.WalScrubber`) sweeps for
at-rest CRC rot without ever mistaking an in-flight tail for corruption.

fsync policy is *batched* (group commit): ``append`` always writes through
to the OS (so process crashes lose nothing), and the file is fsynced once
every ``fsync_every`` appends or ``fsync_interval_s`` seconds — whichever
comes first — so a power failure loses at most one commit group.
``sync()`` forces it; ``close()`` syncs.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch import obs as _obs
from repro_torch.core.updates import (
    UpdateBatch,
    decode_update_batch,
    encode_update_batch,
)

_FILE_MAGIC = b"GWAL1\n\x00\x00"
_REC_MAGIC = b"WREC"
_DIG_MAGIC = b"WDIG"
_REC_HDR = struct.Struct("<4sQQI")  # magic, version, payload_len, crc32


class WriteAheadLog:
    """Append-only, crash-tolerant log of update batches.

    Opens (or creates) ``path`` for appending; an existing log is resumed
    — :attr:`last_version` is recovered from the valid record prefix so
    version numbering continues monotonically.
    """

    def __init__(self, path, fsync_every: int = 8,
                 fsync_interval_s: float = 0.05, obs=None):
        self.path = os.fspath(path)
        assert fsync_every >= 1
        self.fsync_every = int(fsync_every)
        self.fsync_interval_s = float(fsync_interval_s)
        obs = obs if obs is not None else _obs.get_registry()
        self._m_appends = obs.counter(
            "repro_wal_appends_total", "records appended")
        self._m_bytes = obs.counter(
            "repro_wal_bytes_total", "record bytes written")
        self._m_fsync = obs.histogram(
            "repro_wal_fsync_seconds", "fsync latency (group commit)")
        self._m_commit = obs.histogram(
            "repro_wal_commit_records", "appends per group commit",
            buckets=_obs.DEFAULT_SIZE_BUCKETS)
        self._m_torn = obs.counter(
            "repro_wal_torn_truncations_total",
            "torn tails truncated at resume")
        existing = os.path.exists(self.path) and os.path.getsize(self.path) > 0
        self.last_version: Optional[int] = None
        self.resumed_records = 0
        self.torn_truncations = 0
        if existing:  # resume: scan the valid prefix, truncate a torn tail
            records, end = read_wal_records(self.path)
            if records:
                self.last_version = records[-1][0]
            self.resumed_records = len(records)
            if end < os.path.getsize(self.path):
                with open(self.path, "r+b") as f:
                    f.truncate(end)
                self.torn_truncations = 1
                self._m_torn.inc()
        self._f = open(self.path, "ab")
        # write the magic whenever the file is (or was truncated back to)
        # empty — a kill mid-header-write leaves a <8-byte file whose torn
        # tail IS the header, and resume must re-seed it
        if self._f.tell() == 0:
            self._f.write(_FILE_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        self._unsynced = 0
        self._last_sync = time.perf_counter()
        #: durable high-water mark: byte size of the *sealed* region
        #: (everything below it has been fsynced — the scrubber's domain)
        self.synced_size = self._f.tell()
        # telemetry
        self.appends = 0
        self.digest_appends = 0
        self.fsyncs = 0
        self.bytes_written = 0
        self.last_fsync_s = 0.0  # duration of the most recent fsync

    # ------------------------------------------------------------------ #
    def append(self, batch: UpdateBatch, version: Optional[int] = None,
               sync: Optional[bool] = None) -> int:
        """Append one batch; returns its version.

        Must be called *before* the batch is applied to the session
        (append-before-apply).  ``sync=True`` forces an fsync for this
        record; ``sync=False`` defers it past the batching policy; the
        default applies the policy."""
        if version is None:
            version = (self.last_version or 0) + 1
        payload = encode_update_batch(batch)
        self._write_record(_REC_MAGIC, int(version), payload, sync)
        self.appends += 1
        self._m_appends.inc()
        self.last_version = int(version)
        return int(version)

    def append_digest(self, digest: Dict,
                      version: Optional[int] = None,
                      sync: Optional[bool] = None) -> int:
        """Append one content-digest record (``WDIG``) for ``version``.

        ``digest`` is the :func:`repro_torch.obs.audit.session_digest` dict (any
        JSON-able dict works); the leader stamps one after publishing each
        version so followers can self-check after every poll.  Digest
        records do not advance :attr:`last_version` and are invisible to
        :func:`read_wal_records` / :meth:`replay` — they are attestation,
        not history."""
        if version is None:
            version = int(digest.get("version", self.last_version or 0))
        payload = json.dumps(digest, sort_keys=True).encode()
        self._write_record(_DIG_MAGIC, int(version), payload, sync)
        self.digest_appends += 1
        return int(version)

    def _write_record(self, magic: bytes, version: int, payload: bytes,
                      sync: Optional[bool]) -> None:
        rec = _REC_HDR.pack(magic, version, len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF) + payload
        self._f.write(rec)
        self._f.flush()  # through to the OS: ordered before the apply
        self.bytes_written += len(rec)
        self._m_bytes.inc(len(rec))
        self._unsynced += 1
        now = time.perf_counter()
        if sync or (sync is None and (
                self._unsynced >= self.fsync_every
                or now - self._last_sync >= self.fsync_interval_s)):
            self.sync()

    def sync(self) -> None:
        """Force the batched fsync (group commit boundary)."""
        if self._unsynced:
            t0 = time.perf_counter()
            os.fsync(self._f.fileno())
            self.last_fsync_s = time.perf_counter() - t0
            self._m_fsync.observe(self.last_fsync_s)
            self._m_commit.observe(self._unsynced)
            self.fsyncs += 1
            self._unsynced = 0
            self.synced_size = self._f.tell()
        self._last_sync = time.perf_counter()

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def replay(self) -> Iterator[Tuple[int, UpdateBatch]]:
        """Iterate ``(version, batch)`` over the whole durable prefix."""
        self.sync()
        return iter(read_wal_records(self.path)[0])

    @property
    def stats(self) -> Dict:
        return {
            "path": self.path,
            "appends": self.appends,
            "digest_appends": self.digest_appends,
            "fsyncs": self.fsyncs,
            "bytes_written": self.bytes_written,
            "last_version": self.last_version,
            "unsynced": self._unsynced,
            "synced_size": self.synced_size,
            "records": self.appends,
            "bytes": self.bytes_written,
            "resumed_records": self.resumed_records,
            "torn_truncations": self.torn_truncations,
            "last_fsync_s": self.last_fsync_s,
        }


# ---------------------------------------------------------------------- #
def read_wal_records(
    path, offset: int = 0
) -> Tuple[List[Tuple[int, UpdateBatch]], int]:
    """Decode records from ``offset`` (0 = start, past the file header).

    Returns ``(records, end_offset)`` where ``records`` is a list of
    ``(version, batch)`` and ``end_offset`` is the byte position after the
    last *complete, checksum-valid* record — a replica polls by passing the
    previous call's ``end_offset`` back in, and a partially appended tail
    is simply retried on the next poll rather than treated as corruption.
    """
    with open(path, "rb") as f:
        data = f.read()
    off = int(offset)
    if off == 0:
        if len(data) < len(_FILE_MAGIC):
            return [], 0
        if data[: len(_FILE_MAGIC)] != _FILE_MAGIC:
            raise ValueError(f"{path!r} is not a WAL file (bad header)")
        off = len(_FILE_MAGIC)
    records: List[Tuple[int, UpdateBatch]] = []
    while off + _REC_HDR.size <= len(data):
        magic, version, length, crc = _REC_HDR.unpack_from(data, off)
        if magic not in (_REC_MAGIC, _DIG_MAGIC):
            break  # corrupt header: stop at the valid prefix
        end = off + _REC_HDR.size + length
        if end > len(data):
            break  # truncated tail (mid-append or torn write)
        payload = data[off + _REC_HDR.size: end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break  # torn write inside the payload
        if magic == _REC_MAGIC:
            records.append((int(version), decode_update_batch(payload)))
        # digest records are attestation, not history: skip but advance
        off = end
    return records, off


def scan_wal_entries(path, offset: int = 0) -> Tuple[List[Dict], int]:
    """Decode *every* record kind from ``offset`` with byte attribution.

    Like :func:`read_wal_records` but surfaces digest records too.  Returns
    ``(entries, end_offset)`` where each entry is a dict with ``kind``
    (``"batch"`` or ``"digest"``), ``version``, ``offset`` (byte position
    of the record header — the attribution handle for divergence
    findings), and either ``batch`` (an
    :class:`~repro_torch.core.updates.UpdateBatch`) or ``digest`` (the decoded
    JSON dict).  Stops at the first truncated / checksum-failing record,
    same as :func:`read_wal_records`.
    """
    with open(path, "rb") as f:
        data = f.read()
    off = int(offset)
    if off == 0:
        if len(data) < len(_FILE_MAGIC):
            return [], 0
        if data[: len(_FILE_MAGIC)] != _FILE_MAGIC:
            raise ValueError(f"{path!r} is not a WAL file (bad header)")
        off = len(_FILE_MAGIC)
    entries: List[Dict] = []
    while off + _REC_HDR.size <= len(data):
        magic, version, length, crc = _REC_HDR.unpack_from(data, off)
        if magic not in (_REC_MAGIC, _DIG_MAGIC):
            break
        end = off + _REC_HDR.size + length
        if end > len(data):
            break
        payload = data[off + _REC_HDR.size: end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            break
        if magic == _REC_MAGIC:
            entries.append({"kind": "batch", "version": int(version),
                            "offset": off,
                            "batch": decode_update_batch(payload)})
        else:
            entries.append({"kind": "digest", "version": int(version),
                            "offset": off,
                            "digest": json.loads(payload.decode())})
        off = end
    return entries, off


def replay_wal(path) -> Iterator[Tuple[int, UpdateBatch]]:
    """Iterate ``(version, batch)`` over a log file's valid prefix."""
    return iter(read_wal_records(path)[0])


# ---------------------------------------------------------------------- #
#  Segmented WAL: a directory of GWAL1 files named by base version
# ---------------------------------------------------------------------- #
_SEG_SUFFIX = ".wal"


class WalTruncatedError(RuntimeError):
    """A reader's cursor (or required history) points below the oldest
    retained segment — the records were truncated away.  Recover from a
    checkpoint (:mod:`repro_torch.serve.checkpoint`) instead of the log."""


def segment_filename(base_version: int) -> str:
    """Segment file name for the segment whose first record is
    ``base_version`` (zero-padded so lexical order == version order)."""
    return f"{int(base_version):012d}{_SEG_SUFFIX}"


def list_segments(directory) -> List[Tuple[int, str]]:
    """``[(base_version, path)]`` for every segment file, version order."""
    directory = os.fspath(directory)
    out: List[Tuple[int, str]] = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        if not name.endswith(_SEG_SUFFIX):
            continue
        stem = name[: -len(_SEG_SUFFIX)]
        if stem.isdigit():
            out.append((int(stem), os.path.join(directory, name)))
    out.sort()
    return out


def scan_segmented_entries(
    directory, cursor: Optional[Tuple[int, int]] = None
) -> Tuple[List[Dict], Tuple[int, int]]:
    """:func:`scan_wal_entries` across a segment directory.

    ``cursor`` is ``(segment_base, offset)`` — the resume handle a replica
    passes back in (``None`` starts at the oldest retained segment).  Each
    returned entry additionally carries ``"segment"`` (its segment's base
    version).  Segment-boundary rules:

    * a *sealed* segment (one with a successor) that scans clean to its
      end-of-file advances the cursor to ``(next_base, 0)``;
    * a sealed segment that stops early (torn/corrupt bytes mid-file) is
      **held**, never skipped: the cursor stays inside it so no records
      can be silently jumped over — the scrubber surfaces the corruption;
    * the last (active) segment behaves like the single-file scan: a
      partially appended tail is simply retried on the next call.

    Raises :class:`WalTruncatedError` when the cursor's segment no longer
    exists (truncated away) — the reader must rebuild from a checkpoint.
    """
    segs = list_segments(directory)
    if not segs:
        return [], (cursor or (0, 0))
    if cursor is None or cursor == (0, 0):
        cur_base, cur_off = segs[0][0], 0
    else:
        cur_base, cur_off = int(cursor[0]), int(cursor[1])
    bases = [b for b, _ in segs]
    if cur_base not in bases:
        raise WalTruncatedError(
            f"cursor segment {cur_base} not in retained segments "
            f"{bases[:3]}..{bases[-1:]} under {os.fspath(directory)!r}")
    entries: List[Dict] = []
    out_cursor = (cur_base, cur_off)
    for i in range(bases.index(cur_base), len(segs)):
        base, path = segs[i]
        start = cur_off if base == cur_base else 0
        if os.path.getsize(path) == 0:
            # mid-rotation kill: created but never seeded — nothing to
            # read, and nothing before it was skipped to get here
            out_cursor = (base, start)
            continue
        es, end = scan_wal_entries(path, start)
        for e in es:
            e["segment"] = base
        entries.extend(es)
        sealed = i < len(segs) - 1
        if sealed and end >= os.path.getsize(path):
            out_cursor = (segs[i + 1][0], 0)
        else:
            out_cursor = (base, end)
            if sealed:
                break  # torn sealed segment: hold, never skip
    return entries, out_cursor


def seek_segmented(directory, after_version: int) -> Tuple[int, int]:
    """Cursor positioned so the next *batch* record read has
    ``version > after_version`` — the bounded-tail entry point after a
    checkpoint restore.  Raises :class:`WalTruncatedError` when the needed
    history was truncated away."""
    segs = list_segments(directory)
    after_version = int(after_version)
    if not segs:
        if after_version > 0:
            raise WalTruncatedError(
                f"no segments under {os.fspath(directory)!r} but history "
                f"after version {after_version} was requested")
        return (0, 0)
    if segs[0][0] > after_version + 1:
        raise WalTruncatedError(
            f"oldest retained segment starts at version {segs[0][0]} but "
            f"history from {after_version + 1} was requested")
    idx = max(i for i, (b, _) in enumerate(segs) if b <= after_version + 1)
    base, path = segs[idx]
    es, end = scan_wal_entries(path)
    for e in es:
        if e["kind"] == "batch" and e["version"] > after_version:
            return (base, e["offset"])
    if idx < len(segs) - 1:
        return (segs[idx + 1][0], 0)
    return (base, end)


def read_segmented_records(
    directory, after_version: int = 0
) -> List[Tuple[int, UpdateBatch]]:
    """``(version, batch)`` across all retained segments with
    ``version > after_version`` (replay/recovery entry point)."""
    cursor = seek_segmented(directory, after_version)
    entries, _ = scan_segmented_entries(directory, cursor)
    return [(e["version"], e["batch"]) for e in entries
            if e["kind"] == "batch" and e["version"] > int(after_version)]


class SegmentedWriteAheadLog:
    """A WAL split into rotated ``GWAL1`` segments named by base version.

    Same append/digest/sync surface as :class:`WriteAheadLog` (the async
    service and scrubber consume either through duck typing), plus:

    * **rotation** — a new segment starts once the active one holds
      ``rotate_records`` records or ``rotate_bytes`` bytes (checked before
      each batch append, so a record and its digest always share a
      segment); sealed segments are complete by construction (the active
      file is synced before the new one is created);
    * **truncation** — :meth:`truncate_upto` deletes sealed segments whose
      entire version range is ``<= version``; callers must pick ``version
      = min(slowest live replica, newest checkpoint)`` so no reader's
      cursor and no recovery path is stranded;
    * **resume** — sealed segments are validated end-to-end and a torn one
      raises (history must never be silently skipped); only the *last*
      segment gets the single-file torn-tail truncation, and an empty
      trailing segment left by a kill mid-rotation is adopted as the
      active segment.
    """

    def __init__(self, directory, *, rotate_bytes: int = 1 << 20,
                 rotate_records: Optional[int] = None,
                 fsync_every: int = 8, fsync_interval_s: float = 0.05,
                 obs=None):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.rotate_bytes = int(rotate_bytes) if rotate_bytes else 0
        self.rotate_records = int(rotate_records) if rotate_records else 0
        self.fsync_every = int(fsync_every)
        self.fsync_interval_s = float(fsync_interval_s)
        self._obs_explicit = obs
        self.rotations = 0
        self.truncated_segments = 0
        # counters folded in from sealed (closed) segments
        self._sealed = {"appends": 0, "digest_appends": 0, "fsyncs": 0,
                        "bytes_written": 0, "resumed_records": 0,
                        "torn_truncations": 0}
        segs = list_segments(self.directory)
        for base, path in segs[:-1]:  # sealed: validate, never truncate
            if os.path.getsize(path) == 0:
                continue  # empty non-trailing segment: nothing to lose
            records, end = read_wal_records(path)
            if end < os.path.getsize(path):
                raise ValueError(
                    f"sealed WAL segment {path!r} is torn/corrupt at byte "
                    f"{end} — refusing to resume past missing history")
            self._sealed["resumed_records"] += len(records)
        if segs:
            active_base = segs[-1][0]
        else:
            active_base = 1
        self._active_base = active_base
        self._active = WriteAheadLog(
            os.path.join(self.directory, segment_filename(active_base)),
            fsync_every=self.fsync_every,
            fsync_interval_s=self.fsync_interval_s, obs=obs)
        if self._active.last_version is None and active_base > 1:
            # empty/fresh trailing segment: history continues from the
            # sealed predecessor (base = its last version + 1)
            self.last_version: Optional[int] = active_base - 1
        else:
            self.last_version = self._active.last_version

    # ------------------------------------------------------------------ #
    @property
    def obs(self):
        """Registry resolved at call time so rotation-created segments and
        truncation counters land in a registry enabled after construction."""
        return (self._obs_explicit if self._obs_explicit is not None
                else _obs.get_registry())

    @property
    def path(self) -> str:
        """The active segment's path (scrubber/debug compatibility)."""
        return self._active.path

    @property
    def synced_size(self) -> int:
        return self._active.synced_size

    @property
    def active_base(self) -> int:
        return self._active_base

    def segments(self) -> List[Tuple[int, str]]:
        return list_segments(self.directory)

    # ------------------------------------------------------------------ #
    def _should_rotate(self) -> bool:
        if self._active.appends == 0:
            return False  # never rotate an empty segment
        if self.rotate_records and self._active.appends >= self.rotate_records:
            return True
        if self.rotate_bytes and self._active._f.tell() >= self.rotate_bytes:
            return True
        return False

    def rotate(self, next_version: Optional[int] = None) -> str:
        """Seal the active segment and start a new one whose base is the
        next version to be appended.  Returns the new segment's path."""
        if next_version is None:
            next_version = (self.last_version or 0) + 1
        for k in self._sealed:
            self._sealed[k] += getattr(self._active, k)
        self._active.close()  # syncs: the sealed segment is complete
        self._active_base = int(next_version)
        self._active = WriteAheadLog(
            os.path.join(self.directory, segment_filename(next_version)),
            fsync_every=self.fsync_every,
            fsync_interval_s=self.fsync_interval_s,
            obs=self._obs_explicit)
        self.rotations += 1
        self.obs.counter("repro_wal_rotations_total",
                         "WAL segment rotations").inc()
        return self._active.path

    def append(self, batch: UpdateBatch, version: Optional[int] = None,
               sync: Optional[bool] = None) -> int:
        if version is None:
            version = (self.last_version or 0) + 1
        if self._should_rotate():
            self.rotate(next_version=int(version))
        v = self._active.append(batch, version=int(version), sync=sync)
        self.last_version = v
        return v

    def append_digest(self, digest: Dict, version: Optional[int] = None,
                      sync: Optional[bool] = None) -> int:
        # digests never trigger rotation: a record and its attestation
        # always land in the same segment
        if version is None:
            version = int(digest.get("version", self.last_version or 0))
        return self._active.append_digest(digest, version=int(version),
                                          sync=sync)

    def sync(self) -> None:
        self._active.sync()

    def close(self) -> None:
        self._active.close()

    def __enter__(self) -> "SegmentedWriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    def replay(self) -> Iterator[Tuple[int, UpdateBatch]]:
        """``(version, batch)`` across every retained segment, in order."""
        self.sync()
        out: List[Tuple[int, UpdateBatch]] = []
        for _, path in self.segments():
            if os.path.getsize(path) == 0:
                continue
            out.extend(read_wal_records(path)[0])
        return iter(out)

    def truncate_upto(self, version: Optional[int]) -> List[Tuple[int, str]]:
        """Delete sealed segments whose entire version range is
        ``<= version``; the active segment is never deleted.  Returns the
        removed ``[(base, path)]``.

        Safety is the *caller's* contract: pass ``min(slowest live
        replica's applied version, newest checkpoint version)`` so every
        tailing cursor stays valid and checkpoint+tail recovery keeps a
        complete tail.
        """
        if version is None:
            return []
        segs = list_segments(self.directory)
        removed: List[Tuple[int, str]] = []
        for i, (base, path) in enumerate(segs[:-1]):
            last_in_seg = segs[i + 1][0] - 1  # next base = its first
            if last_in_seg <= int(version):
                os.remove(path)
                removed.append((base, path))
        if removed:
            self.truncated_segments += len(removed)
            self.obs.counter(
                "repro_wal_segments_truncated_total",
                "sealed WAL segments deleted by retention").inc(len(removed))
        return removed

    @property
    def stats(self) -> Dict:
        segs = self.segments()
        out = dict(self._active.stats)
        for k, v in self._sealed.items():
            out[k] = out.get(k, 0) + v
        out.update(
            directory=self.directory,
            last_version=self.last_version,
            active_base=self._active_base,
            segments=len(segs),
            oldest_base=segs[0][0] if segs else None,
            rotations=self.rotations,
            truncated_segments=self.truncated_segments,
            records=out["appends"],
            bytes=out["bytes_written"],
        )
        return out
