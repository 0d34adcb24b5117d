"""The port's dry-run and its reports (``repro_torch.launch.{dryrun,
analytic,roofline,report}``) against the reference on the CPU.

* Analytic terms: for every (arch, shape) of ``ARCHS()`` the port's FLOP,
  byte and collective-byte counts equal the reference's exactly, and its
  times are the same counts over the H100 constants; ``model_flops_for``
  equals the reference's.
* The dry-run, run as ``python -m repro_torch.launch.dryrun`` in a
  subprocess (it starts a fake process group of 256 and 512 ranks), on a
  few cells per family on both production meshes: every cell ``ok``, and
  each cell's per-device argument bytes equal those the reference's specs
  imply (``NamedSharding(AbstractMesh(...), spec).shard_shape`` of each
  argument of the reference's builder, no devices needed).
* ``report.render`` over the same records gives the reference's dry-run
  matrix and collective breakdown line for line, and its roofline table
  the same rows.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
DRYRUN_TIMEOUT_S = 400
CELLS = ("qwen3-0.6b:decode_32k", "fm:train_batch", "fm:retrieval_cand",
         "gcn-cora:full_graph_sm", "paper-gwq:query_lj")


def _cells():
    from repro_torch.configs.registry import ARCHS, get_arch

    return [(a, s) for a in ARCHS() for s in get_arch(a).shapes]


def test_constants_are_h100s():
    from repro_torch.launch import roofline

    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.NET_BW == 50e9


@pytest.mark.parametrize("chips", [256, 512])
def test_analytic_counts_equal_reference(chips):
    from repro.launch import analytic as ra
    from repro.launch import roofline as rr
    from repro_torch.launch import analytic as pa
    from repro_torch.launch import roofline as pr

    for arch, shape in _cells():
        want = ra.analytic_terms(arch, shape, chips)
        got = pa.analytic_terms(arch, shape, chips)
        for k in ("flops_per_chip", "bytes_per_chip", "coll_bytes_per_chip"):
            assert got[k] == want[k], (arch, shape, k)
        t, w = got["terms"], want["terms"]
        assert t["compute_s"] == got["flops_per_chip"] / pr.PEAK_FLOPS
        assert t["memory_s"] == got["bytes_per_chip"] / pr.HBM_BW
        assert t["collective_s"] == got["coll_bytes_per_chip"] / pr.NET_BW
        np.testing.assert_allclose(w["compute_s"] * rr.PEAK_FLOPS, got["flops_per_chip"])
        from repro.configs.registry import get_arch

        dims = get_arch(arch).shapes[shape].dims
        assert pr.model_flops_for(arch, shape, dims) == rr.model_flops_for(arch, shape, dims)


def _reference_arg_bytes(arch, shape, multi_pod):
    """Per-device argument bytes the reference's specs imply on its
    production mesh, as an abstract mesh (no devices)."""
    import jax
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs.registry import get_arch
    from repro.launch import steps as rsteps

    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    amesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16), axes)
    spec = get_arch(arch)
    case = spec.shapes[shape]
    if spec.family in ("lm-dense", "lm-moe"):
        build = {"train": rsteps.build_lm_train, "prefill": rsteps.build_lm_prefill,
                 "decode": rsteps.build_lm_decode}[case.kind]
        built = build(spec.model_cfg, amesh, case.dims)
    elif spec.family == "gnn":
        import importlib

        from repro_torch.launch.dryrun import _GNN_CONFIGS

        cfg = importlib.import_module(_GNN_CONFIGS[arch].replace("repro_torch.", "repro.")
                                      ).cfg_for(case.dims)
        built = rsteps.build_gnn_train(cfg, amesh, case.dims)
    elif spec.family == "recsys":
        built = rsteps.build_fm_step(spec.model_cfg, amesh, case.kind, case.dims)
    else:
        built = rsteps.build_gwq_step(case.dims, amesh)
    total = 0
    for arg, shard in zip(built.args, built.in_shardings):
        leaves = jax.tree_util.tree_leaves(arg)
        shards = jax.tree_util.tree_leaves(shard, is_leaf=lambda x: hasattr(x, "spec"))
        if len(shards) == 1 and len(leaves) > 1:
            shards = shards * len(leaves)
        for leaf, sh in zip(leaves, shards):
            shape_ = NamedSharding(amesh, sh.spec).shard_shape(leaf.shape)
            total += int(np.prod(shape_)) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry-run's records of ``CELLS`` on both meshes (a subprocess)."""
    out = tmp_path_factory.mktemp("reports")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cells", ",".join(CELLS),
         "--both-meshes", "--report-dir", str(out)],
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    recs = {}
    for tag in ("1pod", "2pod"):
        for line in open(out / f"dryrun_{tag}.jsonl"):
            r = json.loads(line)
            recs[(tag, r["arch"], r["shape"])] = r
    return out, recs


def test_dryrun_cells_ok_with_the_reference_specs_argument_bytes(records):
    _, recs = records
    assert len(recs) == 2 * len(CELLS)
    for (tag, arch, shape), r in recs.items():
        assert r["status"] == "ok", r
        want = _reference_arg_bytes(arch, shape, tag == "2pod")
        assert r["argument_bytes"] == want, (tag, arch, shape, r["argument_bytes"], want)
        assert r["flops"] >= 0 and r["roofline"]["chips"] == (512 if tag == "2pod" else 256)


def test_report_renders_the_reference_tables(records):
    from repro.launch import report as rrep
    from repro_torch.launch import report as prep

    out, _ = records
    got = prep.render(str(out)).split("\n")
    want = rrep.render(str(out)).split("\n")

    def table(lines, title):
        start = next(i for i, l in enumerate(lines) if l.startswith(title))
        rows = []
        for line in lines[start + 1:]:
            if line.startswith("###"):
                break
            if line.startswith("| ") and not line.startswith("| arch"):
                rows.append(line)
        return rows

    assert table(got, "### Dry-run matrix") == table(want, "### Dry-run matrix")
    assert table(got, "### Collective breakdown") == table(want, "### Collective breakdown")
    roof_got, roof_want = table(got, "### Roofline terms"), table(want, "### Roofline terms")
    assert [r.split("|")[1:3] for r in roof_got] == [r.split("|")[1:3] for r in roof_want]
    assert len(roof_got) == len(CELLS)


_COUNT_PROBE = r"""
import json, torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.kernels.flash_attention.flash_attention import attention_flops, flash_attention
from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction
D.start_fake_world(256)
mesh = make_production_mesh(device_type="cpu")
c = D.StepCounter()
out = {}
with D._counting(c):
    x = DTensor.from_local(torch.empty(8, 64), mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(64, 32), mesh, [Replicate(), Shard(1)], run_check=False)
    with FlopCounterMode(display=False) as fc:
        x @ w
    out["flop_counter_mode"] = fc.get_total_flops()
    out["step_counter"] = c.flops
    c.flops = 0
    q = torch.empty(2, 4, 64, 64, dtype=torch.bfloat16)
    flash_attention(q, q[:, :2].contiguous(), q[:, :2].contiguous())
    out["k3"] = c.flops
    c.flops = 0
    fm_interaction(torch.empty(16, 39, 10))
    out["k4"] = c.flops
out["k3_formula"] = attention_flops(2, 4, 64, 64, True)
print(json.dumps(out))
"""


def test_flops_are_per_device_and_the_kernels_count():
    """``FlopCounterMode`` over DTensors counts the global product (the
    whole mesh's FLOPs); the dry-run's ``StepCounter`` counts each local
    op, one device's; K3 and K4 on fake tensors take their custom ops,
    whose registered formulas count."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", _COUNT_PROBE], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    # x [16 x 8, 64] over data, w [64, 32 x 16] over model
    assert got["flop_counter_mode"] == 2 * (16 * 8) * 64 * (32 * 16)
    assert got["step_counter"] == 2 * 8 * 64 * 32
    assert got["k3"] == got["k3_formula"] > 0
    assert got["k4"] == 16 * 10 * (3 * 39 + 2)


def test_uneven_splits_raise_on_the_same_cells():
    """The reference's specs split every dimension of every non-skipped
    cell evenly on both production meshes (``shard_shape`` raises where one
    does not), so the port's dry-run, whose ``shard_shape`` raises where a
    spec does not divide a dimension, runs every cell; on a spec that does
    not divide, both raise."""
    from jax.sharding import AbstractMesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_arch
    from repro_torch.distributed.sharding_rules import Spec
    from repro_torch.launch.dryrun import shard_shape

    for multi_pod in (False, True):
        for arch, shape in _cells():
            if shape not in get_arch(arch).skip:
                assert _reference_arg_bytes(arch, shape, multi_pod) > 0

    class _Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 16

    amesh = AbstractMesh((16, 16), ("data", "model"))
    for spec, shape in (((("data", "model"),), (512,)), (("data", None), (8, 3)),
                        ((None, "model"), (4, 24))):
        want = _raises(lambda: NamedSharding(amesh, P(*spec)).shard_shape(shape))
        got = _raises(lambda: shard_shape(shape, Spec(*spec), _Mesh()))
        assert got == want, (spec, shape)


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False
