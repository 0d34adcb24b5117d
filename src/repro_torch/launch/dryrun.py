"""Multi-pod dry-run: build every (arch x shape x mesh) step and run one
rank's share of it on fake tensors, with nothing allocated and no card.

Run as ``python -m repro_torch.launch.dryrun``.  ``main`` starts a fake
process group of 256 ranks (512 for the 2-pod mesh) in this process
(``torch.testing._internal.distributed.fake_pg``: its collectives return
at once) and builds the reference's production mesh over it
(:func:`~repro_torch.launch.mesh.make_production_mesh`).  For every cell:

* build the step (meta stand-ins of the whole arguments);
* make rank 0's piece of each argument as a fake tensor at its shard
  shape (a spec whose axes do not divide a dimension raises, as the
  reference's shardings do);
* run the step's ``fn`` under :class:`StepCounter`, a ``FakeTensorMode``
  that sees every local op the rank dispatches.  A fake tensor takes the
  card's route in every kernel wrapper (``kernels.build.plain_route``):
  the hand-written kernels' registered fake implementations (K1, K3 and K4
  with their backwards) stand in for their launches, so the card's route
  is the one counted.  The fake tensors lie on the CPU device type (a
  CPU-only PyTorch cannot run autograd over fake CUDA tensors), so the
  mesh is built on the ``"cpu"`` device type; nothing runs either way;
* record, as the reference does, the status, seconds, argument bytes,
  temp bytes (the peak of live storage above the arguments), output
  bytes, FLOPs and the roofline (:func:`~repro_torch.launch.roofline.
  analyze_step`) to ``<report-dir>/dryrun_<1pod|2pod>.jsonl``.  A cell
  whose arguments and temps pass 80 GB a device (one H100 80GB HBM3) is
  marked ``over_80gb``; it is not failed.

The GNN and paper-gwq steps build their K1 plans on the host from a
rank's edge or row arrays; the dry-run builds each from seeded arrays of
the rank's shard size (uniform ids; the plan's sizes follow from the
shard's length and the segment count) and hands it to the step as fake
tensors, so the plan's host time is not in the count.

Usage:
  python -m repro_torch.launch.dryrun --arch minitron-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--cells a:s,b:t]
  python -m repro_torch.launch.dryrun --all --both-meshes --report-dir reports
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch.roofline import COLLECTIVE_KINDS, analyze_step

#: bytes a device holds (H100 80GB HBM3)
DEVICE_BYTES = 80e9
#: ops that move no bytes of their own (their outputs alias their inputs,
#: or they only allocate)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "wait_tensor", "device", "lift_fresh", "_to_copy_meta"}


class StepCounter(FakeTensorMode):
    """A ``FakeTensorMode`` that counts, over the local ops one rank
    dispatches: FLOPs (``FlopCounterMode``'s formulas on the local shapes),
    bytes accessed (each op's input and output bytes), collective result
    bytes by kind, and live storage bytes (their peak).  It tracks
    storages as ``MemTracker`` does (a weak reference a storage); it does so
    from inside the fake mode because ``MemTracker``, a mode above it, sees
    a DTensor op and not the local allocations under it."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=False)
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._seen = set()

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n, counter=weakref.ref(self)):
            c = counter()
            if c is not None and key in c._seen:
                c._seen.discard(key)
                c.live -= n

        weakref.finalize(st, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        from torch.utils._pytree import tree_leaves
        from torch.utils.flop_counter import flop_registry

        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        name = func._overloadpacket.__name__
        kind = COLLECTIVE_KINDS.get((func.namespace, name))
        if kind is not None:
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                t.numel() * t.element_size() for t in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **(kwargs or {}), out_val=out))
        if name not in _NO_TRAFFIC and not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def _counting(counter: StepCounter):
    """``counter`` entered, with DTensor's bookkeeping run outside it: its
    sharding propagation (global shapes; it runs ops in a fake mode of its
    own to learn output shapes) and the index arithmetic of a strided
    shard's sizes (small integer tensors it reads back), none of which is
    the rank's work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.placement_types import _StridedShard

    def outside(fn):
        def run(*args, **kwargs):
            with unset_fake_temporarily():
                return fn(*args, **kwargs)
        return run

    dispatcher = DTensor._op_dispatcher
    slow = dispatcher._propagate_op_sharding_dispatch_slow_path
    sizes = _StridedShard.local_shard_size_and_offset

    class _Ctx:
        def __enter__(self):
            dispatcher._propagate_op_sharding_dispatch_slow_path = outside(slow)
            _StridedShard.local_shard_size_and_offset = outside(sizes)
            counter.__enter__()
            return counter

        def __exit__(self, *exc):
            counter.__exit__(*exc)
            del dispatcher._propagate_op_sharding_dispatch_slow_path
            _StridedShard.local_shard_size_and_offset = sizes

    return _Ctx()


# ---------------------------------------------------------------------- #
#  cells
# ---------------------------------------------------------------------- #
_GNN_CONFIGS = {
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "gcn-cora": "repro_torch.configs.gcn_cora",
    "gat-cora": "repro_torch.configs.gat_cora",
}


def build_step_for(arch_name: str, shape_name: str, mesh, torch_device="cuda"):
    """The cell's step.  The dry-run builds it with ``torch_device="cpu"``
    (a step's device is where :meth:`BuiltStep.shard` puts whole
    arguments; the dry-run hands ``fn`` fake pieces itself)."""
    from repro_torch.launch import steps

    arch = get_arch(arch_name)
    case = arch.shapes[shape_name]
    dev = {"torch_device": torch_device}
    if arch.family in ("lm-dense", "lm-moe"):
        cfg = arch.model_cfg
        if case.kind == "train":
            return steps.build_lm_train(cfg, mesh, case.dims, **dev)
        if case.kind == "prefill":
            return steps.build_lm_prefill(cfg, mesh, case.dims, **dev)
        if case.kind == "decode":
            return steps.build_lm_decode(cfg, mesh, case.dims, **dev)
    if arch.family == "gnn":
        import importlib

        cfg = importlib.import_module(_GNN_CONFIGS[arch_name]).cfg_for(case.dims)
        return steps.build_gnn_train(cfg, mesh, case.dims, **dev)
    if arch.family == "recsys":
        return steps.build_fm_step(arch.model_cfg, mesh, case.kind, case.dims, **dev)
    if arch.family == "paper":
        return steps.build_gwq_step(case.dims, mesh, **dev)
    raise ValueError((arch_name, shape_name))


def shard_shape(shape, spec, mesh):
    """This rank's piece of a ``shape`` laid out by ``spec`` over ``mesh``;
    raises where the spec's axes do not divide a dimension (as ``_piece``
    does, and the reference's shardings)."""
    from repro_torch.distributed.sharding_rules import entry_axes

    names = tuple(mesh.mesh_dim_names)
    out = list(shape)
    for dim, entry in enumerate(spec):
        count = 1
        for a in entry_axes(entry):
            count *= mesh.size(names.index(a))
        if out[dim] % count:
            raise ValueError(f"dim {dim} of size {out[dim]} does not split "
                             f"{count} ways ({spec})")
        out[dim] //= count
    return tuple(out)


def _pieces(built, mesh, dev):
    """Rank 0's piece of every argument as a fake tensor (call under the
    fake mode)."""
    from repro_torch.launch.steps import _map_specs2

    return tuple(_map_specs2(
        lambda t, sp: torch.empty(shard_shape(t.shape, sp, mesh), dtype=t.dtype, device=dev),
        a, s) for a, s in zip(built.args, built.in_specs))


def _host_plan(arch_name, shape_name, built, mesh):
    """The GNN or gwq step's K1 plan from seeded arrays of rank 0's shard
    size, on the host (``None`` for the other families)."""
    arch = get_arch(arch_name)
    dims = arch.shapes[shape_name].dims
    rng = np.random.default_rng(0)
    cpu = torch.device("cpu")
    if arch.family == "gnn":
        from repro_torch.launch import steps

        n = dims.get("sub_n", dims["n"] * dims.get("batch", 1))
        e_local = built.args[2]["edge_src"].shape[0] // mesh.size()
        batch = {"edge_src": torch.from_numpy(rng.integers(0, n, e_local, dtype=np.int32)),
                 "edge_dst": torch.from_numpy(rng.integers(0, n, e_local, dtype=np.int32))}
        axes = tuple(mesh.mesh_dim_names)
        plan = steps.gnn_edge_plan(batch, n, torch_device=cpu)
        plan.source()  # the backward's layout, built on the host now
        return dataclasses.replace(plan, group=steps._mesh_group(mesh, axes)[2])
    if arch.family == "paper":
        from repro_torch.launch.steps import _rows_plan

        n, nb = dims["n"], dims["nb"]
        ndp = built.args[0].shape[0] // shard_shape(built.args[0].shape, built.in_specs[0],
                                                    mesh)[0]

        def rows(length, n_seg, n_rows):
            real = min(length, max(0, -(-dims["m" if n_seg == nb else "l"] // ndp)))
            seg = np.full(length, -1, np.int32)
            seg[:real] = np.sort(rng.integers(0, n_seg, real))
            return rng.integers(0, n_rows, length, dtype=np.int32), seg

        m_loc = built.args[0].shape[0] // ndp
        l_loc = built.args[2].shape[0] // ndp
        p1g, p1s = rows(m_loc, nb, n)
        p2g, p2s = rows(l_loc, n, nb)
        return (_rows_plan(p1g, p1s, nb, n, cpu), _rows_plan(p2g, p2s, n, nb, cpu))
    return None


def _to_fake(obj, mode: FakeTensorMode, dev):
    """``obj`` (tensors in tuples, dicts and dataclasses) with each tensor
    a fake tensor on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return mode.from_tensor(obj).to(dev)
    if isinstance(obj, torch.device):
        return dev
    if isinstance(obj, tuple):
        return tuple(_to_fake(o, mode, dev) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_fake(v, mode, dev) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to_fake(getattr(obj, f.name), mode, dev)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def run_cell(arch_name: str, shape_name: str, mesh, mesh_tag: str,
             report_dir: Path, verbose: bool = True, device: str = "cpu"):
    arch = get_arch(arch_name)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag, "status": ""}
    if shape_name in arch.skip:
        rec["status"] = "skipped"
        rec["reason"] = arch.skip[shape_name]
        if verbose:
            print(f"[SKIP] {arch_name} x {shape_name}: {rec['reason']}")
        return _write(rec, report_dir, mesh_tag)
    t0 = time.perf_counter()
    try:
        built = build_step_for(arch_name, shape_name, mesh, torch_device="cpu")
        plan = _host_plan(arch_name, shape_name, built, mesh)
        t_build = time.perf_counter() - t0
        counter = StepCounter()
        dev = torch.device(device)
        with _counting(counter):
            pieces = _pieces(built, mesh, dev)
            kw = {} if plan is None else {"plan": _to_fake(plan, counter, dev)}
            arg_bytes = counter.live
            counter.flops = counter.bytes = 0
            counter.collectives = {}
            counter.peak = counter.live
            out = built.fn(*pieces, **kw)
            out_bytes = _nbytes(out)
            del out
        t_run = time.perf_counter() - t0 - t_build
        counts = {"flops": counter.flops, "bytes": counter.bytes,
                  "collectives": counter.collectives}
        roof = analyze_step(counts, mesh.size(), arch_name, shape_name)
        temp = counter.peak - arg_bytes
        rec.update(
            status="ok",
            t_build_s=round(t_build, 1),
            t_run_s=round(t_run, 1),
            bytes_per_device=temp,
            argument_bytes=_nbytes(pieces),
            output_bytes=out_bytes,
            flops=counter.flops,
            over_80gb=bool(arg_bytes + temp > DEVICE_BYTES),
            roofline=roof,
        )
        if verbose:
            print(
                f"[OK]   {arch_name} x {shape_name} ({mesh_tag}) "
                f"build {t_build:.1f}s run {t_run:.1f}s | "
                f"args/dev {rec['argument_bytes'] / 2**30:.2f} GiB "
                f"temp/dev {temp / 2**30:.2f} GiB{' (over 80 GB)' if rec['over_80gb'] else ''}"
                f" | flops {counter.flops:.3g}"
            )
            print("       roofline:", json.dumps(roof["terms"]))
    except Exception as e:  # noqa: BLE001
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        if verbose:
            print(f"[FAIL] {arch_name} x {shape_name}: {rec['error']}")
            traceback.print_exc(limit=4)
    return _write(rec, report_dir, mesh_tag)


def _write(rec, report_dir: Path, mesh_tag: str):
    report_dir.mkdir(parents=True, exist_ok=True)
    with open(report_dir / f"dryrun_{mesh_tag}.jsonl", "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def start_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, rank 0
    (replacing any group already started)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None, help="comma list arch:shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--report-dir", default="reports")
    args = ap.parse_args(argv)

    if args.both_meshes:
        meshes = [(False, "1pod"), (True, "2pod")]
    else:
        meshes = [(args.multi_pod, "2pod" if args.multi_pod else "1pod")]

    cells = []
    if args.cells:
        for c in args.cells.split(","):
            a, s = c.split(":")
            cells.append((a, s))
    elif args.all:
        for a in ARCHS():
            for s in get_arch(a).shapes:
                cells.append((a, s))
    else:
        cells.append((args.arch, args.shape))

    from repro_torch.launch.mesh import make_production_mesh

    report_dir = Path(args.report_dir)
    n_ok = n_fail = n_skip = 0
    t0 = time.perf_counter()
    for multi_pod, tag in meshes:
        start_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        for a, s in cells:
            rec = run_cell(a, s, mesh, tag, report_dir)
            n_ok += rec["status"] == "ok"
            n_fail += rec["status"] == "fail"
            n_skip += rec["status"] == "skipped"
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"in {time.perf_counter() - t0:.1f} s")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
