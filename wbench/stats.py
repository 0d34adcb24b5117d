"""Statistics over raw samples.

The port's ``obs/metrics.py`` ``Histogram`` gives only bucketed quantiles,
so a tail read from it moves with the bucket edges; these work on the raw
samples.
"""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: the smallest
    sample with at least ``q`` % of the samples at or below it."""
    if not values:
        raise ValueError("no samples")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]

