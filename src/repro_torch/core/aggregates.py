"""Open aggregate registry: distributive / algebraic aggregates (paper §3).

Each distributive aggregate is a commutative monoid ``(op, identity)`` — that
is exactly what both the DBIndex two-stage evaluation and the I-Index
inheritance evaluation require (partial aggregates must compose).  Algebraic
aggregates (``avg``, ``var``, ...) are expressed as a tuple of distributive
*channels* plus a pure finalizer, per the classic Gray et al. decomposition
the paper leans on.

The registry is **open**: :func:`register_aggregate` adds a new aggregate as
a set of monoid channels over the three channel *sources* — ``"value"`` (the
attribute vector), ``"ones"`` (cardinality), ``"square"`` (the squared
attribute) — plus a pure ``finalize(xp, *chans)`` where ``xp`` is ``numpy``
or :data:`TORCH_XP` (torch with a numpy-style ``maximum``).  Because every engine executes aggregates through the
shared channel machinery (:class:`ChannelPack`), a registered aggregate
immediately compiles to extra fused channels on the device executors, the
sharded runtime and the serving layer — no core file edits.

Dtype discipline: monoid channels preserve the integer/float class of the
input attribute.  Integer attributes ride int64 channels with per-dtype
identities (``iinfo.min``/``max`` for idempotent monoids) so the host paths
the serving layer's bitwise oracle relies on never silently upcast to
float; only a finalizer (a division, a sqrt) may change the dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

CHANNEL_SOURCES = ("value", "ones", "square")


@dataclasses.dataclass(frozen=True)
class Monoid:
    name: str
    np_op: Callable  # ufunc with .reduceat / .at
    identity: float  # float-channel identity (kept for compatibility)

    def identity_for(self, dtype):
        """Dtype-safe identity: integer channels use the dtype's own
        extrema instead of ``±inf`` (which would force a float upcast)."""
        dtype = np.dtype(dtype)
        if np.issubdtype(dtype, np.integer):
            if self.name == "sum":
                return dtype.type(0)
            info = np.iinfo(dtype)
            return dtype.type(info.max if self.name == "min" else info.min)
        return dtype.type(self.identity)


SUM = Monoid("sum", np.add, 0.0)
MIN = Monoid("min", np.minimum, np.inf)
MAX = Monoid("max", np.maximum, -np.inf)

MONOIDS = {"sum": SUM, "min": MIN, "max": MAX}


def promote_channel_dtype(values: np.ndarray) -> np.dtype:
    """Channel accumulator dtype for an attribute vector: integer (and bool)
    attributes stay integer (int64 — no silent float upcast on the paths
    the service's bitwise oracle rides), floats widen to float64."""
    dt = np.asarray(values).dtype
    if np.issubdtype(dt, np.integer) or dt == np.bool_:
        return np.dtype(np.int64)
    return np.dtype(np.float64)


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """An aggregate = monoid channels over named sources + a pure finalizer.

    ``channel_sources`` names what feeds each monoid channel — ``"value"``
    (the attribute vector itself), ``"ones"`` (an all-ones vector, i.e.
    cardinality) or ``"square"`` (the squared attribute).  The source labels
    are what lets a multi-aggregate plan dedup channels: ``sum`` and ``avg``
    share the (sum, value) channel, ``count`` and ``avg`` share (sum, ones),
    ``var`` and ``l2`` share (sum, square).

    ``finalize(xp, *chans)`` must be pure array code written against the
    ``xp`` namespace (``numpy`` on host, :data:`TORCH_XP` on the device
    executors) so one definition serves both bit-identically.
    """

    name: str
    monoids: Tuple[Monoid, ...]
    channel_sources: Tuple[str, ...] = ("value",)
    finalize: Optional[Callable] = None  # (xp, *channel_results) -> result

    def __post_init__(self):
        assert len(self.monoids) == len(self.channel_sources)
        for src in self.channel_sources:
            assert src in CHANNEL_SOURCES, src

    def prepare(self, values: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Per-channel input vectors, dtype-preserving (see module doc)."""
        values = np.asarray(values)
        dt = promote_channel_dtype(values)
        v = values.astype(dt)
        return tuple(_channel_input(v, src) for src in self.channel_sources)

    def finalize_np(self, *chans):
        return self.finalize_xp(np, *chans)

    def finalize_xp(self, xp, *chans):
        return self.finalize(xp, *chans) if self.finalize else chans[0]


def _channel_input(v: np.ndarray, src: str) -> np.ndarray:
    if src == "ones":
        return np.ones(v.shape[0], dtype=v.dtype)
    if src == "square":
        return v * v
    return v


AGGREGATES: Dict[str, Aggregate] = {}


def register_aggregate(
    name: str,
    monoids: Sequence,
    sources: Sequence[str] = ("value",),
    finalize: Optional[Callable] = None,
    overwrite: bool = False,
) -> Aggregate:
    """Register an aggregate with the open registry.

    ``monoids`` is a sequence of monoid names (``"sum"``/``"min"``/``"max"``)
    or :class:`Monoid` objects; ``sources`` the matching channel sources;
    ``finalize`` an optional pure ``(xp, *chans) -> result``.  The aggregate
    is immediately servable by every engine capability declaring the dynamic
    aggregate set, and its channels fuse with other aggregates sharing a
    window (dedup by ``(monoid, source)``).
    """
    if name in AGGREGATES and not overwrite:
        raise ValueError(f"aggregate {name!r} is already registered "
                         f"(pass overwrite=True to replace it)")
    ms = tuple(m if isinstance(m, Monoid) else MONOIDS[m] for m in monoids)
    if len(ms) != len(tuple(sources)):
        raise ValueError("monoids and sources must have equal length")
    for src in sources:
        if src not in CHANNEL_SOURCES:
            raise ValueError(f"unknown channel source {src!r} "
                             f"(have {CHANNEL_SOURCES})")
    agg = Aggregate(name=name, monoids=ms, channel_sources=tuple(sources),
                    finalize=finalize)
    AGGREGATES[name] = agg
    return agg


class RegisteredAggregates:
    """Live view over the registry for engine capability declarations:
    membership / subset checks consult :data:`AGGREGATES` at query time, so
    a capability declared with ``ALL_REGISTERED`` serves aggregates
    registered *after* the engine was."""

    def __contains__(self, name) -> bool:
        return name in AGGREGATES

    def __iter__(self):
        return iter(AGGREGATES)

    def __len__(self) -> int:
        return len(AGGREGATES)

    def __ge__(self, other) -> bool:  # set(aggs) <= ALL_REGISTERED
        return all(a in AGGREGATES for a in other)

    def issuperset(self, other) -> bool:
        return self.__ge__(other)

    def __hash__(self):  # capabilities are frozen dataclasses
        return hash(type(self))

    def __eq__(self, other):
        return isinstance(other, RegisteredAggregates)


ALL_REGISTERED = RegisteredAggregates()


class _TorchNamespace:
    """``torch`` as a finalizer namespace.  ``torch.maximum`` rejects a
    Python scalar, which the registered finalizers pass (``xp.maximum(c,
    1e-30)``); ``torch.clamp(x, min=...)`` computes the same value exactly,
    so the finalizers run unchanged on tensors.  ``sqrt`` is correctly
    rounded, as NumPy's and ``jnp``'s are: torch's vectorized float32
    ``sqrt`` on the CPU can be one ulp off, while the float64 root rounded
    once to float32 is exact (53 >= 2 * 24 + 2 bits)."""

    def maximum(self, x, y):
        import torch

        if isinstance(y, (int, float)):
            return torch.clamp(x, min=y)
        return torch.maximum(x, y)

    def sqrt(self, x):
        import torch

        if x.dtype == torch.float32:
            return torch.sqrt(x.double()).float()
        return torch.sqrt(x)

    def __getattr__(self, name):
        import torch

        return getattr(torch, name)


#: the ``xp`` the device executors hand to :meth:`ChannelPack.finalize`
TORCH_XP = _TorchNamespace()


# -------------------------- built-in aggregates ------------------------ #
register_aggregate("sum", ("sum",), ("value",))
register_aggregate("count", ("sum",), ("ones",))
register_aggregate("min", ("min",), ("value",))
register_aggregate("max", ("max",), ("value",))
register_aggregate(
    "avg", ("sum", "sum"), ("value", "ones"),
    finalize=lambda xp, s, c: s / xp.maximum(c, 1e-30),
)
# derived aggregates compile to extra fused channels with pure finalizers —
# the registration API at work (no engine edits):
register_aggregate("sum_sq", ("sum",), ("square",))
register_aggregate(
    "mean_sq", ("sum", "sum"), ("square", "ones"),
    finalize=lambda xp, s2, c: s2 / xp.maximum(c, 1e-30),
)
register_aggregate(
    "var", ("sum", "sum", "sum"), ("square", "value", "ones"),
    finalize=lambda xp, s2, s, c: s2 / xp.maximum(c, 1e-30)
    - (s / xp.maximum(c, 1e-30)) * (s / xp.maximum(c, 1e-30)),
)
register_aggregate(
    "l2", ("sum",), ("square",), finalize=lambda xp, s2: xp.sqrt(s2),
)


# -------------------------------------------------------------------- #
#  Multi-aggregate channel packing (fused query plans)
# -------------------------------------------------------------------- #
#: canonical aggregate name per (monoid, source) channel — what the
#: algebraic fast paths request from materialized terms to reassemble a
#: composite window's channels (inclusion–exclusion / idempotent combine)
CHANNEL_AGG = {
    ("sum", "value"): "sum",
    ("sum", "ones"): "count",
    ("sum", "square"): "sum_sq",
    ("min", "value"): "min",
    ("max", "value"): "max",
}


@dataclasses.dataclass(frozen=True)
class ChannelPack:
    """Deduped monoid channels for a set of aggregates over one window.

    ``channels[i]`` is ``(monoid_name, source)``; each distinct pair appears
    once no matter how many aggregates reference it, so k aggregates over
    the same window collapse to a handful of segment reduces sharing a
    single gather.  ``agg_channels[j]`` maps aggregate j back to its channel
    indices for finalization.
    """

    aggs: Tuple[str, ...]
    channels: Tuple[Tuple[str, str], ...]
    agg_channels: Tuple[Tuple[int, ...], ...]

    def monoid(self, i: int) -> Monoid:
        return MONOIDS[self.channels[i][0]]

    def channels_of(self, monoid_name: str, source: str = None):
        """Channel indices with the given monoid (and source, if given)."""
        return tuple(
            i for i, (m, s) in enumerate(self.channels)
            if m == monoid_name and (source is None or s == source)
        )

    def prepare_np(self, values: np.ndarray) -> Tuple[np.ndarray, ...]:
        values = np.asarray(values)
        v = values.astype(promote_channel_dtype(values))
        return tuple(_channel_input(v, src) for _, src in self.channels)

    def finalize(self, agg_i: int, chans: Sequence, xp=np):
        """Finalize aggregate ``agg_i`` from the reduced channel results.

        ``xp`` is ``numpy`` or :data:`TORCH_XP` so the registered pure
        finalizer (the Gray et al. algebraic decomposition) serves both the
        host and device executors bit-identically.
        """
        picked = [chans[j] for j in self.agg_channels[agg_i]]
        return AGGREGATES[self.aggs[agg_i]].finalize_xp(xp, *picked)


def pack_channels(aggs: Sequence[str]) -> ChannelPack:
    """Collapse a list of aggregates into deduped monoid channels."""
    channels: list = []
    seen = {}
    agg_channels = []
    for name in aggs:
        a = AGGREGATES[name]
        idxs = []
        for m, src in zip(a.monoids, a.channel_sources):
            key = (m.name, src)
            if key not in seen:
                seen[key] = len(channels)
                channels.append(key)
            idxs.append(seen[key])
        agg_channels.append(tuple(idxs))
    return ChannelPack(tuple(aggs), tuple(channels), tuple(agg_channels))
