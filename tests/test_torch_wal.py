"""The write-ahead log, checkpoints and crash recovery, port vs reference,
on the CPU.

The port's WAL and checkpoint formats are the reference's byte for byte:
the same stream through either package's ``AsyncWindowService`` writes
identical log files (with and without digest records, single-file and
segmented) and identical checkpoints, and each package replays the
other's log.  ``Session.restore_from_wal`` rebuilds bitwise the live
session's ``run()`` for a full replay, a point-in-time replay
(``upto_version``) and a checkpoint plus its tail.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.serve.checkpoint as r_ckpt  # noqa: E402
import repro.serve.wal as r_wal  # noqa: E402

import repro_torch.serve.checkpoint as p_ckpt  # noqa: E402
import repro_torch.serve.wal as p_wal  # noqa: E402
from repro_torch.core import updates as p_updates  # noqa: E402

from test_torch_service import (  # noqa: E402
    PORT,
    REF,
    _same,
    _specs,
    khop_batch,
    make_session,
)

BATCHES = 5


def _batches(seed=17, count=BATCHES):
    """A fixed stream of (src, dst, op) arrays, drawn against the evolving
    port graph (both packages' graphs evolve identically)."""
    g, _ = make_session(PORT, "khop")
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        arrays = khop_batch(g, rng)
        out.append(arrays)
        g = p_updates.apply_batch(g, p_updates.UpdateBatch(*arrays))
    return out


STREAM = _batches()


def _lead(pkg, wal, digests=True, checkpoint_dir=None, checkpoint_at=None):
    """Stream ``STREAM`` through an ``AsyncWindowService`` (flusher
    started) writing ``wal``; returns the closed service."""
    _, sess = make_session(pkg, "khop")
    svc = pkg.ws.AsyncWindowService(sess, bucket=4, wal=wal, wal_digests=digests).start()
    for v, arrays in enumerate(STREAM, 1):
        svc.update(pkg.batch(arrays))
        if checkpoint_at == v:
            sess.save_checkpoint(checkpoint_dir)
    svc.stop()
    svc.wal.close()
    return svc


def _segmented(mod, path):
    return mod.SegmentedWriteAheadLog(path, rotate_records=2)


def _files(path):
    if os.path.isdir(path):
        return {name: open(os.path.join(path, name), "rb").read()
                for name in sorted(os.listdir(path))}
    return {"": open(path, "rb").read()}


@pytest.mark.parametrize("digests", [True, False])
@pytest.mark.parametrize("layout", ["file", "segmented"])
def test_wal_bytes_identical_to_reference(tmp_path, layout, digests):
    paths = {}
    for name, pkg, mod in (("ref", REF, r_wal), ("port", PORT, p_wal)):
        path = str(tmp_path / f"{name}.wal")
        wal = _segmented(mod, path) if layout == "segmented" else path
        _lead(pkg, wal, digests=digests)
        paths[name] = path
    ref, got = _files(paths["ref"]), _files(paths["port"])
    assert ref == got
    assert len(got) == (3 if layout == "segmented" else 1)
    kinds = [e["kind"] for e in p_wal.scan_segmented_entries(paths["port"])[0]] \
        if layout == "segmented" else [e["kind"] for e in p_wal.scan_wal_entries(paths["port"])[0]]
    assert kinds == (["batch", "digest"] if digests else ["batch"]) * BATCHES


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("reader", ["ref", "port"])
def test_each_package_replays_the_others_wal(tmp_path, writer, reader):
    """A log written by either package restores in either, bitwise the
    live session's ``run()``, with equal graph digests."""
    path = str(tmp_path / "leader.wal")
    lead = _lead({"ref": REF, "port": PORT}[writer], path)
    pkg = {"ref": REF, "port": PORT}[reader]
    g, _ = make_session(pkg, "khop")
    restored = pkg.api.Session.restore_from_wal(g, _specs(pkg, "khop"), path,
                                                **pkg.session_kw, plan_headroom=1.0)
    assert restored.version == lead.session.version == BATCHES
    for x, y in zip(restored.run(), lead.session.run()):
        assert _same(x, y)
    assert restored.digest()["graph_crc"] == lead.session.digest()["graph_crc"]


@pytest.mark.parametrize("mode", ["full", "upto", "checkpoint"])
def test_restore_from_wal_bitwise_live(tmp_path, mode):
    """Full replay, point-in-time (``upto_version=3``: bitwise the live
    session's run at version 3) and checkpoint at version 4 plus the tail
    (the base graph is ignored then)."""
    wal_dir, ckpt_dir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    live_at = {}
    g, sess = make_session(PORT, "khop")
    specs = sess.compiled.specs
    svc = PORT.ws.AsyncWindowService(sess, bucket=4, wal=_segmented(p_wal, wal_dir))
    for v, arrays in enumerate(STREAM, 1):
        svc.update(PORT.batch(arrays))
        live_at[v] = sess.run()
        if v == 4:
            sess.save_checkpoint(ckpt_dir)
    svc.wal.close()
    kw = dict(torch_device="cpu", plan_headroom=1.0)
    if mode == "full":
        restored = PORT.api.Session.restore_from_wal(g, specs, wal_dir, **kw)
    elif mode == "upto":
        restored = PORT.api.Session.restore_from_wal(g, specs, wal_dir, upto_version=3, **kw)
    else:
        restored = PORT.api.Session.restore_from_wal(None, specs, wal_dir,
                                                     checkpoint=ckpt_dir, **kw)
        assert p_ckpt.latest_checkpoint(ckpt_dir)[0] == 4
    want = 3 if mode == "upto" else BATCHES
    assert restored.version == want
    for x, y in zip(restored.run(), live_at[want]):
        assert _same(x, y)


def test_checkpoint_bytes_identical_and_cross_loadable(tmp_path):
    """The same session state writes the same checkpoint file from either
    package, and each package loads the other's."""
    dirs = {}
    for name, pkg in (("ref", REF), ("port", PORT)):
        dirs[name] = str(tmp_path / name)
        _lead(pkg, str(tmp_path / f"{name}.wal"), checkpoint_dir=dirs[name],
              checkpoint_at=3)
    (rv, rpath), = r_ckpt.list_checkpoints(dirs["ref"])
    (pv, ppath), = p_ckpt.list_checkpoints(dirs["port"])
    assert rv == pv == 3 and os.path.basename(rpath) == os.path.basename(ppath)
    assert open(rpath, "rb").read() == open(ppath, "rb").read()
    v1, g1, d1 = p_ckpt.load_checkpoint(rpath)
    v2, g2, d2 = r_ckpt.load_checkpoint(ppath)
    assert v1 == v2 == 3 and d1 == d2
    assert np.array_equal(g1.src, g2.src) and np.array_equal(g1.dst, g2.dst)
    assert _same(g1.attrs["val"], g2.attrs["val"])


def test_checkpoint_damage_is_attributed(tmp_path):
    _, sess = make_session(PORT, "khop")
    _, path = sess.save_checkpoint(str(tmp_path))
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF  # a byte of the last array section
    bad = str(tmp_path / "bad.gckp")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(p_ckpt.CheckpointCorruptError, match="crc mismatch"):
        p_ckpt.load_checkpoint(bad)
    g = sess.graph.with_attr("val", np.asarray(sess.graph.attrs["val"]) + 1)
    lie = p_ckpt.write_checkpoint(str(tmp_path / "lie.gckp"), 0, g,
                                  digest={"graph_crc": sess.digest()["graph_crc"]})
    with pytest.raises(p_ckpt.CheckpointDigestError, match="graph_crc"):
        p_ckpt.load_checkpoint(lie)


@pytest.mark.parametrize("pkg_name", ["ref", "port"])
def test_torn_tail_is_ignored_then_truncated_on_resume(tmp_path, pkg_name):
    """Half a record at the end of a log (a crash mid-append): both
    packages' readers stop at the valid prefix, the port's writer resumes
    by truncating it, and recovery replays the prefix."""
    path = str(tmp_path / "torn.wal")
    _lead({"ref": REF, "port": PORT}[pkg_name], path, digests=False)
    whole = open(path, "rb").read()
    with open(path, "ab") as f:
        f.write(whole[8:8 + 30])  # the start of a record header + payload
    records, end = p_wal.read_wal_records(path)
    assert [v for v, _ in records] == list(range(1, BATCHES + 1)) and end == len(whole)
    assert [v for v, _ in r_wal.read_wal_records(path)[0]] == list(range(1, BATCHES + 1))
    wal = p_wal.WriteAheadLog(path)
    assert wal.torn_truncations == 1 and wal.last_version == BATCHES
    wal.close()
    assert open(path, "rb").read() == whole
    g, sess = make_session(PORT, "khop")
    restored = PORT.api.Session.restore_from_wal(g, sess.compiled.specs, path,
                                                 torch_device="cpu", plan_headroom=1.0)
    assert restored.version == BATCHES


def test_segmented_seek_and_truncation(tmp_path):
    """``seek_segmented`` positions past a version; ``truncate_upto``
    drops whole sealed segments and a cursor below them raises."""
    wal_dir = str(tmp_path / "wal")
    _lead(PORT, _segmented(p_wal, wal_dir))
    assert [b for b, _ in p_wal.list_segments(wal_dir)] == [1, 3, 5]
    assert [v for v, _ in p_wal.read_segmented_records(wal_dir, 2)] == [3, 4, 5]
    wal = p_wal.SegmentedWriteAheadLog(wal_dir, rotate_records=2)
    assert wal.last_version == BATCHES
    removed = wal.truncate_upto(2)
    wal.close()
    assert [b for b, _ in removed] == [1]
    with pytest.raises(p_wal.WalTruncatedError):
        p_wal.seek_segmented(wal_dir, 0)
    assert [v for v, _ in p_wal.read_segmented_records(wal_dir, 2)] == [3, 4, 5]
