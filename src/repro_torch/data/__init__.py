"""Data pipelines: deterministic synthetic streams, shard-aware loaders."""

from repro_torch.data.pipeline import (  # noqa: F401
    TokenStream,
    GraphBatcher,
    RecsysStream,
    NeighborSampler,
)
