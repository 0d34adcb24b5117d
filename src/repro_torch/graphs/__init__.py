"""Graph data substrate: generators."""

from repro_torch.graphs.generators import (  # noqa: F401
    erdos_renyi,
    barabasi_albert,
    random_dag,
    grid_mesh,
    batched_molecules,
    with_random_attrs,
)
