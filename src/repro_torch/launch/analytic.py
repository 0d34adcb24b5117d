"""Analytic roofline terms per (arch x shape): first-principles FLOP,
byte and collective-byte models, beside the dry-run's counts.

The dry-run counts what one rank's step dispatches (:mod:`.roofline`); the
terms below are the reference's models, letter for letter, stated
explicitly:

LM train   : flops = 8*N_active*T (6ND + remat refwd 2ND)
             + attention 12*L*T*(S/2)*d_model (fwd+bwd+remat)
             bytes = weights 2 reads + 1 write (bf16 compute copies)
             + opt state rw (f32/bf16) + activations ~14*L*T*d bytes
             coll  = FSDP allgather 2P + grad RS/AG 6P (bf16)
             + TP psum 4*L*T*d/chips (bf16, ring-counted once)
LM prefill : flops = 2*N_active*T + 6*L*T*(S/2)*d; no opt traffic
LM decode  : flops = 2*N_active*B + 4*L*B*S*d (cache read dominates bytes:
             2*L*B*S*hkv*hd*2 per step)
GNN train  : flops = 3 * L * (4*E*d + 2*N*d_in*d_out) (fwd+bwd)
             bytes = 3 * L * (2*E*d*4 + 3*N*d*4)
             coll  = L * N * d * 4 * 2 (edge-sharded psum per layer)
FM train   : flops = 3 * (2*B*F*K + B*F); bytes = 3*B*F*(K+1)*4*2
             coll  = B*F*K*4 (row-sharded gather) + B*4
paper-gwq  : flops = 2*(m + l)/chips adds; bytes = (m+l)*8 + n*8
             coll  = 2*(nb + n)*4 (two psums)

All terms are per GPU, in seconds, at H100 SXM constants (989 TFLOP/s
dense bf16, 3.35 TB/s HBM3, 50 GB/s a GPU across nodes; see
:mod:`.roofline`).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.launch.roofline import HBM_BW, NET_BW, PEAK_FLOPS


def analytic_terms(arch_name: str, shape_name: str, chips: int) -> Dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.moe import MoEConfig

    arch = get_arch(arch_name)
    case = arch.shapes[shape_name]
    dims = case.dims
    fam = arch.family

    if fam in ("lm-dense", "lm-moe"):
        cfg = arch.model_cfg
        n_active = cfg.n_active_params() if isinstance(cfg, MoEConfig) else cfg.n_params()
        n_total = cfg.n_params()
        L, d = cfg.n_layers, cfg.d_model
        hkv, hd = cfg.n_kv_heads, cfg.head_dim
        if case.kind == "train":
            T = dims["batch"] * dims["seq"]
            S = dims["seq"]
            flops = 8.0 * n_active * T + 12.0 * L * T * (S / 2) * d
            bytes_ = (
                3 * n_total * 2  # weight traffic (bf16 compute copies)
                + n_total * (4 + 2 + 2 + 4)  # opt read/write (f32 + bf16 moments)
                + 14.0 * L * T * d * 2 / 1  # activations (bf16, remat-bounded)
            )
            coll = 2 * n_total * 2 + 6 * n_total * 2 + 4.0 * L * T * d * 2 / chips
            return _pack(flops / chips, bytes_ / chips, coll / chips, chips)
        if case.kind == "prefill":
            T = dims["batch"] * dims["seq"]
            S = dims["seq"]
            flops = 2.0 * n_active * T + 6.0 * L * T * (S / 2) * d
            bytes_ = n_total * 2 + 6.0 * L * T * d * 2
            coll = n_total * 2 / 4 + 2.0 * L * T * d * 2 / chips
            return _pack(flops / chips, bytes_ / chips, coll / chips, chips)
        if case.kind == "decode":
            B = dims["batch"]
            S = dims["seq"]
            flops = 2.0 * n_active * B + 4.0 * L * B * S * hkv * hd
            cache = 2.0 * L * B * S * hkv * hd * 2
            bytes_ = n_total * 2 + cache
            coll = 2.0 * L * B * d * 2  # per-layer TP psums of the token
            return _pack(flops / chips, bytes_ / chips, coll / chips, chips)

    if fam == "gnn":
        import importlib

        mod = importlib.import_module(
            {
                "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
                "meshgraphnet": "repro_torch.configs.meshgraphnet",
                "gcn-cora": "repro_torch.configs.gcn_cora",
                "gat-cora": "repro_torch.configs.gat_cora",
            }[arch_name]
        )
        cfg = mod.cfg_for(dims)
        n = dims.get("sub_n", dims["n"] * dims.get("batch", 1))
        e = dims.get("sub_e", dims["e"] * dims.get("batch", 1))
        L, dh = cfg.n_layers, cfg.d_hidden
        flops = 3.0 * L * (4.0 * e * dh + 2.0 * n * dh * dh) + 3.0 * 2 * n * dims["d_feat"] * dh
        bytes_ = 3.0 * L * (2.0 * e * dh * 4 + 3.0 * n * dh * 4) + n * dims["d_feat"] * 4
        coll = L * n * dh * 4 * 2
        return _pack(flops / chips, bytes_ / chips, coll / chips, chips)

    if fam == "recsys":
        cfg = arch.model_cfg
        B = dims.get("batch", 1)
        F, K = cfg.n_fields, cfg.embed_dim
        mult = 3.0 if case.kind == "train" else 1.0
        if case.kind == "retrieval":
            nc = dims["n_candidates"]
            flops = 2.0 * nc * K
            bytes_ = nc * K * 4
            coll = nc * 4
        else:
            flops = mult * (2.0 * B * F * K + B * F)
            bytes_ = mult * B * F * (K + 1) * 4 * 2
            coll = B * F * K * 4 + B * 4
        return _pack(flops / chips, bytes_ / chips, coll / chips, chips)

    if fam == "paper":
        m, l, n, nb = dims["m"], dims["l"], dims["n"], dims["nb"]
        flops = 2.0 * (m + l)
        bytes_ = (m + l) * 8.0 + n * 8.0
        coll = 2.0 * (nb + n) * 4.0
        return _pack(flops / chips, bytes_ / chips, coll / chips, chips)

    raise ValueError((arch_name, shape_name))


def _pack(flops, bytes_, coll_bytes, chips):
    t_c = flops / PEAK_FLOPS
    t_m = bytes_ / HBM_BW
    t_l = coll_bytes / NET_BW
    dominant = max(
        ("compute", t_c), ("memory", t_m), ("collective", t_l), key=lambda kv: kv[1]
    )[0]
    bound = max(t_c, t_m, t_l)
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_,
        "coll_bytes_per_chip": coll_bytes,
        "terms": {"compute_s": t_c, "memory_s": t_m, "collective_s": t_l},
        "dominant": dominant,
        "roofline_bound_s": bound,
        "roofline_fraction": t_c / bound if bound > 0 else 0.0,  # compute utilization at the bound
    }
