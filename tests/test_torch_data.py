"""The data streams, port vs reference, on the CPU: every batch bitwise,
including after a restore from the other package's cursor."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.graph import Graph as RGraph  # noqa: E402
from repro.data import pipeline as RD  # noqa: E402
from repro.graphs.generators import erdos_renyi  # noqa: E402

from repro_torch.convert import data_cursor  # noqa: E402
from repro_torch.core.graph import Graph as PGraph  # noqa: E402
from repro_torch.data import pipeline as PD  # noqa: E402


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _graphs(directed):
    g = erdos_renyi(200, 4.0, directed=directed, seed=7)
    return g, PGraph(n=g.n, src=g.src.copy(), dst=g.dst.copy(), directed=g.directed)


def _streams(kind, seed):
    if kind == "token":
        return (RD.TokenStream(vocab=500, batch=3, seq=17, seed=seed),
                PD.TokenStream(vocab=500, batch=3, seq=17, seed=seed))
    if kind == "recsys":
        return (RD.RecsysStream(n_fields=39, batch=64, seed=seed),
                PD.RecsysStream(n_fields=39, batch=64, seed=seed))
    if kind == "graph":
        rg, pg = _graphs(directed=False)
        return (RD.GraphBatcher(rg, d_feat=6, classes=5, seed=seed),
                PD.GraphBatcher(pg, d_feat=6, classes=5, seed=seed))
    rg, pg = _graphs(directed=True)
    return (RD.NeighborSampler(rg, fanouts=(4, 3), seed=seed),
            PD.NeighborSampler(pg, fanouts=(4, 3), seed=seed))


def _next(stream):
    return stream.sample(16) if hasattr(stream, "sample") else stream.next()


@pytest.mark.parametrize("kind", ["token", "recsys", "graph", "sampler"])
@pytest.mark.parametrize("seed", [0, 11])
def test_stream_bitwise_and_restore(kind, seed):
    ref, port = _streams(kind, seed)
    for _ in range(3):
        _same(_next(ref), _next(port))
    assert port.state() == ref.state()
    # a fresh port stream restored from the reference's cursor, and back
    _, port2 = _streams(kind, seed + 1)
    port2.restore(data_cursor(ref.state()))
    ref2, _ = _streams(kind, seed + 2)
    ref2.restore(data_cursor(port.state()))
    for _ in range(2):
        want = _next(ref)
        _same(want, _next(port2))
        _same(want, _next(ref2))
    assert port2.state() == ref.state() == ref2.state()


def test_sampler_reads_the_ports_graph():
    _, pg = _graphs(directed=True)
    assert isinstance(pg, PGraph) and not isinstance(pg, RGraph)
    out = PD.NeighborSampler(pg, fanouts=(2,), seed=3).sample(5)
    assert out["sub_n"] == 5 + 10 and out["edge_src"].shape == (10,)
