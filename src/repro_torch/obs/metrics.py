"""Zero-dependency, thread-safe metrics registry for the serving stack.

Three instrument kinds, the classic trio:

* :class:`Counter` — monotonically increasing totals (requests served,
  bytes written, recompiles).
* :class:`Gauge` — last-write-wins point-in-time values (replica lag,
  staleness pressure, queue depth).
* :class:`Histogram` — fixed-bucket distributions (request latency, fsync
  latency, group-commit sizes) with quantile estimation by linear
  interpolation inside the landing bucket.

The write path is designed for the serving hot path: counters and
histograms accumulate into **per-thread shards** (a plain attribute add on
a cell only its owning thread ever writes), so concurrent writers never
contend on a lock and never lose updates — ``+=`` on a shared float is NOT
atomic across CPython bytecodes, but a per-thread cell is single-writer by
construction.  The only lock is taken on a thread's *first* touch of an
instrument (shard creation) and on reads (merge over shards).  Gauges are
last-write-wins and use a single atomic attribute store.

Labels follow the Prometheus model: an instrument family is declared once
with ``labelnames``; :meth:`_Family.labels` returns (and memoizes) the
child for one label-value tuple.  A family declared with no labels *is*
its own child — ``registry.counter("x").inc()`` just works.

:class:`NullRegistry` is the compile-it-out switch: the same API where
every method is a no-op returning a shared singleton, so instrumented code
pays one dict-free method call per event and the tier-1 fast path stays
untouched.  ``registry.enabled`` distinguishes the two.

Exports: :meth:`MetricsRegistry.snapshot` (nested, JSON-able dict) and
:meth:`MetricsRegistry.prometheus` (text exposition format).
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "DEFAULT_LATENCY_BUCKETS_S",
    "DEFAULT_SIZE_BUCKETS",
]

#: latency histogram bound defaults, in seconds: 100us .. 10s, log-ish
DEFAULT_LATENCY_BUCKETS_S = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 10.0,
)

#: size/count histogram bound defaults (records per commit, batch sizes, …)
DEFAULT_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384)


# ---------------------------------------------------------------------- #
#  Per-thread shard cells
# ---------------------------------------------------------------------- #
class _Cell:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * nbuckets
        self.sum = 0.0
        self.count = 0


# ---------------------------------------------------------------------- #
#  Children (one per label-value tuple)
# ---------------------------------------------------------------------- #
class Counter:
    """Sharded monotonic counter.  ``inc`` is lock-free after a thread's
    first touch (its shard cell is single-writer)."""

    __slots__ = ("_lock", "_cells", "_local")

    def __init__(self):
        self._lock = threading.Lock()
        self._cells: List[_Cell] = []
        self._local = threading.local()

    def _bind(self) -> _Cell:
        cell = _Cell()
        with self._lock:
            self._cells.append(cell)
        self._local.cell = cell
        return cell

    def inc(self, v: float = 1.0) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = self._bind()
        cell.value += v

    @property
    def value(self) -> float:
        with self._lock:
            return sum(c.value for c in self._cells)


class Gauge:
    """Last-write-wins gauge: ``set`` is one atomic attribute store (no
    read-modify-write on the fast path); ``inc``/``dec`` take the lock."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket sharded histogram.

    ``buckets`` are the inclusive upper bounds of the finite buckets; one
    overflow bucket (+Inf) is implicit.  ``observe`` costs one bisect plus
    three single-writer cell updates.  Quantiles are estimated by linear
    interpolation inside the landing bucket (exact at bucket edges), which
    is the standard fixed-bucket trade: cheap, mergeable, and bounded error
    set by the bucket layout.
    """

    __slots__ = ("buckets", "_lock", "_cells", "_local")

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        b = tuple(float(x) for x in buckets)
        assert b and all(b[i] < b[i + 1] for i in range(len(b) - 1)), \
            "histogram buckets must be strictly increasing"
        self.buckets = b
        self._lock = threading.Lock()
        self._cells: List[_HistCell] = []
        self._local = threading.local()

    def _bind(self) -> _HistCell:
        cell = _HistCell(len(self.buckets) + 1)
        with self._lock:
            self._cells.append(cell)
        self._local.cell = cell
        return cell

    def observe(self, x: float) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = self._bind()
        cell.counts[bisect_left(self.buckets, x)] += 1
        cell.sum += x
        cell.count += 1

    # ------------------------------ reads ----------------------------- #
    def merged(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. overflow, sum, count) over all shards."""
        counts = [0] * (len(self.buckets) + 1)
        total, n = 0.0, 0
        with self._lock:
            for cell in self._cells:
                for i, c in enumerate(cell.counts):
                    counts[i] += c
                total += cell.sum
                n += cell.count
        return counts, total, n

    @property
    def count(self) -> int:
        return self.merged()[2]

    @property
    def sum(self) -> float:
        return self.merged()[1]

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); 0.0 when empty.  Values in
        the overflow bucket clamp to the last finite bound."""
        counts, _, n = self.merged()
        if n == 0:
            return 0.0
        target = q * n
        seen = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if seen + c >= target:
                if i >= len(self.buckets):  # overflow bucket
                    return self.buckets[-1]
                lo = 0.0 if i == 0 else self.buckets[i - 1]
                hi = self.buckets[i]
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
        return self.buckets[-1]


_CHILD_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


# ---------------------------------------------------------------------- #
#  Families (name + labelnames -> children)
# ---------------------------------------------------------------------- #
class _Family:
    """One named instrument family.  With ``labels=()`` the family proxies
    its single default child, so unlabeled metrics skip the lookup."""

    __slots__ = ("name", "kind", "help", "labelnames", "_children", "_lock",
                 "_default", "_hist_buckets")

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._hist_buckets = buckets
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        self._default = self._make() if not self.labelnames else None

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self._hist_buckets or DEFAULT_LATENCY_BUCKETS_S)
        return _CHILD_TYPES[self.kind]()

    def labels(self, *values, **kw):
        """The child for one label-value tuple (memoized)."""
        if kw:
            values = tuple(kw[n] for n in self.labelnames)
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {key}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make())
        return child

    # unlabeled convenience: the family IS its default child
    def inc(self, v: float = 1.0) -> None:
        self._default.inc(v)

    def dec(self, v: float = 1.0) -> None:
        self._default.dec(v)

    def set(self, v: float) -> None:
        self._default.set(v)

    def observe(self, x: float) -> None:
        self._default.observe(x)

    @property
    def value(self):
        return self._default.value

    def quantile(self, q: float) -> float:
        return self._default.quantile(q)

    @property
    def count(self) -> int:
        return self._default.count

    @property
    def sum(self) -> float:
        return self._default.sum

    def merged(self):
        return self._default.merged()

    def children(self) -> Dict[Tuple[str, ...], object]:
        if self._default is not None:
            return {(): self._default}
        with self._lock:
            return dict(self._children)


# ---------------------------------------------------------------------- #
#  Registries
# ---------------------------------------------------------------------- #
class MetricsRegistry:
    """The live registry.  Declaring the same name twice returns the same
    family (so call sites need no shared setup); re-declaring with a
    different kind or label set raises — a schema clash must fail loudly.
    """

    enabled = True

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()
        self._collectors: Dict[str, object] = {}

    # ----------------------------- collect ---------------------------- #
    def collect(self, fn, name: str = "") -> None:
        """Register ``fn(registry)`` to run at the top of every
        :meth:`snapshot` / :meth:`prometheus` call.

        This is the collect-on-scrape hook for values that live outside
        the registry (jit-cache recompile counts, tracer drop counters):
        instead of relying on call sites remembering to fold the latest
        value in, the export path pulls a fresh reading.  ``name`` dedupes
        — re-registering the same name replaces the previous collector, so
        repeated ``enable()`` round-trips don't stack duplicates.
        """
        key = name or f"anon-{id(fn)}"
        with self._lock:
            self._collectors[key] = fn

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            try:
                fn(self)
            except Exception:
                # a broken collector must not take down the scrape path
                pass

    # ----------------------------- declare ---------------------------- #
    def _get(self, name: str, kind: str, help: str, labels: Sequence[str],
             buckets=None) -> _Family:
        fam = self._families.get(name)  # dict read: safe under the GIL
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = _Family(name, kind, help=help, labelnames=labels,
                                  buckets=buckets)
                    self._families[name] = fam
        if fam.kind != kind or fam.labelnames != tuple(labels):
            raise ValueError(
                f"metric {name!r} already declared as {fam.kind}"
                f"{fam.labelnames}, redeclared as {kind}{tuple(labels)}")
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._get(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._get(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = None) -> _Family:
        return self._get(name, "histogram", help, labels, buckets=buckets)

    # ----------------------------- export ----------------------------- #
    def snapshot(self) -> Dict:
        """Nested JSON-able dict: ``{name: {type, help, values: [{labels,
        ...}]}}``.  Histogram entries carry count/sum/buckets plus p50/p95/
        p99 estimates so the snapshot is self-contained in bench artifacts.
        """
        self._run_collectors()
        out: Dict = {}
        with self._lock:
            families = list(self._families.values())
        for fam in sorted(families, key=lambda f: f.name):
            values = []
            for key, child in sorted(fam.children().items()):
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    counts, total, n = child.merged()
                    cum, buckets = 0, {}
                    for bound, c in zip(child.buckets, counts):
                        cum += c
                        buckets[repr(bound)] = cum
                    buckets["+Inf"] = n
                    values.append({
                        "labels": labels, "count": n, "sum": total,
                        "buckets": buckets,
                        "p50": child.quantile(0.50),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99),
                    })
                else:
                    values.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "values": values}
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        self._run_collectors()
        lines: List[str] = []
        with self._lock:
            families = list(self._families.values())
        for fam in sorted(families, key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                pairs = list(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    counts, total, n = child.merged()
                    cum = 0
                    for bound, c in zip(child.buckets, counts):
                        cum += c
                        lab = _fmt_labels(pairs + [("le", _fmt_num(bound))])
                        lines.append(f"{fam.name}_bucket{lab} {cum}")
                    lab = _fmt_labels(pairs + [("le", "+Inf")])
                    lines.append(f"{fam.name}_bucket{lab} {n}")
                    lines.append(
                        f"{fam.name}_sum{_fmt_labels(pairs)} {_fmt_num(total)}")
                    lines.append(f"{fam.name}_count{_fmt_labels(pairs)} {n}")
                else:
                    lines.append(
                        f"{fam.name}{_fmt_labels(pairs)} "
                        f"{_fmt_num(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------- #
class _NullMetric:
    """Absorbs every instrument call; ``labels`` returns itself, so one
    shared instance serves every family, child, and label combination."""

    __slots__ = ()

    def labels(self, *a, **kw):
        return self

    def inc(self, v: float = 1.0) -> None:
        pass

    def dec(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, x: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def quantile(self, q: float) -> float:
        return 0.0

    def merged(self):
        return [], 0.0, 0


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """The no-op registry: same surface as :class:`MetricsRegistry`, every
    instrument is the shared null metric.  Instrumented code constructed
    against it pays one attribute call per event and records nothing —
    this is the default, so un-enabled obs never touches tier-1 perf."""

    enabled = False

    def counter(self, name: str, help: str = "", labels=()) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, name: str, help: str = "", labels=()) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets=None) -> _NullMetric:
        return _NULL_METRIC

    def collect(self, fn, name: str = "") -> None:
        pass

    def snapshot(self) -> Dict:
        return {}

    def prometheus(self) -> str:
        return ""


# ---------------------------------------------------------------------- #
def _fmt_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _escape_label_value(v) -> str:
    """Escape one label value per the Prometheus text exposition format:
    backslash first (so the other escapes aren't double-escaped), then
    double-quote, then newline — a raw newline inside a label value would
    otherwise split the sample line and corrupt the whole scrape body."""
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _unescape_label_value(v: str) -> str:
    """Inverse of :func:`_escape_label_value` (round-trip tests / parsers)."""
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _fmt_labels(pairs) -> str:
    if not pairs:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, _escape_label_value(v)) for k, v in pairs
    )
    return "{" + body + "}"
