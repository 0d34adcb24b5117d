"""paper-gwq — the paper's own workload as a servable architecture.

Graph window queries over a LiveJournal/Orkut-scale graph: the sharded
two-stage DBIndex data plane (pass 1 blocks, combine T, pass 2 owners;
``repro_torch.launch.steps.build_gwq_step``).  Plan dimensions are the
reference's, extrapolated from measured index statistics at bench scale
(members ~= total window size, links ~= 1.5/vertex, blocks ~= n/2).

Shapes:
* query_lj    — LiveJournal1 (4.0M vertices), 2-hop windows, avg |W|=214
* query_orkut — Orkut (3.07M vertices), 2-hop windows, avg |W|=650
* query_1b    — extrapolated 1e9-member plan (pod-scale stress)
* query_1b_part — the same plan with blocks co-located with their owner
  shards: only the boundary fraction crosses devices
"""

from repro_torch.configs.registry import ArchSpec, ShapeCase

SHAPES = {
    "query_lj": ShapeCase(
        "query_lj", "serve",
        dict(n=3_997_962, nb=2_000_000, m=855_000_000 // 16, l=6_000_000),
        "members scaled 1/16 (matches measured dense-block compression at k=2)",
    ),
    "query_orkut": ShapeCase(
        "query_orkut", "serve",
        dict(n=3_072_441, nb=1_536_000, m=1_997_000_000 // 16, l=4_600_000),
    ),
    "query_1b": ShapeCase(
        "query_1b", "serve",
        dict(n=100_000_000, nb=50_000_000, m=1_000_000_000, l=150_000_000),
        "pod-scale stress plan",
    ),
    "query_1b_part": ShapeCase(
        "query_1b_part", "serve",
        dict(n=100_000_000, nb=50_000_000, m=1_000_000_000, l=150_000_000,
             boundary_frac=10),
        "locality-partitioned plan: 1/10 of blocks/owners are boundary",
    ),
}


def spec() -> ArchSpec:
    return ArchSpec(
        name="paper-gwq",
        family="paper",
        model_cfg=dict(SHAPES),
        smoke_cfg=None,
        shapes=SHAPES,
        skip={},
        notes="the paper's contribution as a first-class servable workload",
    )
