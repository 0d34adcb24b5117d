"""Roofline terms of a step on the production mesh, at H100 SXM constants.

Three terms per (arch x shape x mesh), in seconds on one GPU:

  compute    = FLOPs a device            / 989e12 FLOP/s (dense bf16)
  memory     = bytes a device accesses   / 3.35e12 B/s (HBM3)
  collective = collective bytes a device / 50e9 B/s (one 400 Gb/s port)

The counts come from the dry-run (:mod:`repro_torch.launch.dryrun`), which
runs a step's ``fn`` on one rank's pieces as fake tensors and sees each
local op that rank dispatches:

* FLOPs from ``FlopCounterMode``'s formulas (``torch.utils.flop_counter``),
  applied to each local op, so the count is per device.  (``FlopCounterMode``
  itself, over DTensors, sees the global op and counts the whole mesh's
  FLOPs.)  The hand-written kernels register theirs (K1, K3 and K3's
  backward, K4 and its backward), so the dry-run runs the card's route;
* bytes accessed: each op's input and output bytes, summed: an upper
  bound, as if no two ops were fused and no operand stayed in cache;
* collective bytes by kind: the result bytes of each collective
  (``c10d_functional``'s and ``c10d``'s), under the reference's kind names (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), as the reference sums result shapes per kind
  from its HLO.

The collective term charges every collective at the inter-node rate: the
production mesh's 16-wide ``"model"`` axis spans two 8-GPU NVLink domains,
so its collectives leave NVLink, and a DGX H100 gives each GPU one 400
Gb/s NDR InfiniBand port.  Collectives inside one NVLink domain would run
~9x faster (450 GB/s a direction); the term is an upper bound for them.
Each device's own collective bytes are charged at its own port's rate
(the reference divides its per-program bytes by the chip count once
more).  ``MODEL_FLOPS`` (6 N D dense, 6 N_active D MoE) is attached per LM arch so
the useful share of the counted FLOPs is visible.
"""

from __future__ import annotations

from typing import Dict, Optional

#: dense bf16 tensor-core FLOP/s of one H100 SXM5 (NVIDIA H100 datasheet,
#: 1,979 TFLOP/s with sparsity)
PEAK_FLOPS = 989e12
#: HBM3 bytes/s of one H100 SXM5 80GB (NVIDIA H100 datasheet)
HBM_BW = 3.35e12
#: bytes/s a GPU across nodes: one 400 Gb/s NDR InfiniBand port per GPU
#: (DGX H100: eight ConnectX-7 ports for eight GPUs)
NET_BW = 50e9

#: collective op (``c10d_functional``: DTensor's; ``c10d``: the in-place
#: ``torch.distributed`` calls of the GNN and gwq steps) -> the reference's
#: kind name
COLLECTIVE_KINDS = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
}


def model_flops_for(arch_name: str, shape_name: str, dims: Dict) -> Optional[float]:
    """6*N*D (dense) / 6*N_active*D (MoE) for LM train; 2*N*D for inference."""
    try:
        from repro_torch.configs.registry import get_arch

        arch = get_arch(arch_name)
        if arch.family == "lm-dense":
            n = arch.model_cfg.n_params()
        elif arch.family == "lm-moe":
            n = arch.model_cfg.n_active_params()
        else:
            return None
        tokens = dims.get("batch", 1) * dims.get("seq", 1)
        case = arch.shapes[shape_name]
        if case.kind == "train":
            return 6.0 * n * tokens
        if case.kind == "prefill":
            return 2.0 * n * tokens
        if case.kind == "decode":
            return 2.0 * n * dims.get("batch", 1)
    except Exception:  # noqa: BLE001
        return None
    return None


def analyze_step(counts: Dict, chips: int, arch_name: str, shape_name: str) -> Dict:
    """The roofline of one step from the dry-run's per-device ``counts``
    (``flops``, ``bytes``, ``collectives``: bytes by kind) on ``chips``
    devices."""
    flops = float(counts["flops"])
    bytes_accessed = float(counts["bytes"])
    coll = dict(counts["collectives"])
    coll_device = float(sum(coll.values()))
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_coll = coll_device / NET_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    from repro_torch.configs.registry import get_arch

    dims = get_arch(arch_name).shapes[shape_name].dims
    mf = model_flops_for(arch_name, shape_name, dims)
    useful = (mf / chips) / flops if (mf and flops) else None
    return {
        "chips": int(chips),
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        # one device's collectives, as the reference's HLO of one device's
        # program holds them
        "collective_bytes_total": coll_device,
        "collective_breakdown": coll,
        "terms": {
            "compute_s": t_compute,
            "memory_s": t_memory,
            "collective_s": t_coll,
        },
        "dominant": dominant,
        "model_flops": mf,
        "useful_compute_ratio": useful,
    }
