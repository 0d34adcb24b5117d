"""The port stands alone: importing it loads no JAX, no Triton and nothing
of the reference package."""

import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "triton", "repro"))
print(len(names), bad)
"""


def test_import_loads_no_jax_triton_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=120, cwd=PKG.parents[1],
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20  # every module of the package was imported
    assert bad == "[]"


def test_no_source_imports_jax_or_reference():
    offenders = [
        f"{path.relative_to(PKG)}:{i}"
        for path in PKG.rglob("*.py")
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if "import jax" in line or "from repro." in line
        or "import repro." in line or "from repro import" in line
    ]
    assert offenders == []


@pytest.mark.parametrize("module", ["repro_torch.serve", "repro_torch.obs.audit",
                                    "repro_torch.serve.cluster", "repro_torch.obs.explain",
                                    "repro_torch.obs.profile", "repro_torch.distributed",
                                    "repro_torch.models.gnn", "repro_torch.configs.registry",
                                    "repro_torch.configs.gcn_cora", "repro_torch.configs.gat_cora",
                                    "repro_torch.configs.graphsage_reddit",
                                    "repro_torch.configs.meshgraphnet",
                                    "repro_torch.configs.minitron_4b",
                                    "repro_torch.configs.minitron_8b",
                                    "repro_torch.models.moe",
                                    "repro_torch.configs.qwen2_moe_a2p7b",
                                    "repro_torch.configs.grok1_314b",
                                    "repro_torch.optim", "repro_torch.data",
                                    "repro_torch.train", "repro_torch.launch.train",
                                    "repro_torch.tree", "repro_torch.launch.steps",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.distributed.sharding_rules",
                                    "repro_torch.configs.paper_gwq",
                                    "repro_torch.distributed.actshard",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.analytic",
                                    "repro_torch.launch.roofline",
                                    "repro_torch.launch.report"])
def test_serving_tier_imports_stand_alone(module):
    """The serving tier (service, WAL, checkpoints, replicas, the cluster,
    health), the audit, EXPLAIN and ANALYZE modules, the sharded runtime,
    the GNN family, the MoE model, the configs and the training modules
    (optimizers, data streams, the trainer, the driver), the step builders,
    the mesh, the sharding rules and activation layouts, and the dry-run
    with its roofline and reports load neither JAX nor the reference
    package on their own (nor Triton)."""
    probe = (f"import sys, {module}\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'triton', 'repro')))")
    out = subprocess.run(
        [sys.executable, "-c", probe], capture_output=True, text=True,
        timeout=120, cwd=PKG.parents[1],
        env={**os.environ, "PYTHONPATH": str(PKG.parent)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
