"""NumPy model of K1's wide route (``csrc/segment_sum.cu``:
``segment_reduce_kernel_wide``, then ``segment_reduce_wide_fixup``).

The same work split as the kernels: work items of ``slice_rows`` plan rows
times a tile of 128 columns; each walks its slice in row order (ids 128
rows at a time, jumping to the next input tile after a pad row), keeps the
open run's combine, and writes it at a segment-id change; a run cut by slice
edges leaves a partial a slice (``head[k]``: the slice's first run when it
began before the slice; ``tail[k]``: its last run when it goes on past it),
and the slice holding the run's last row combines them in slice order.
Float32 arithmetic in the kernels' order, so on the card the kernels agree
with it bit for bit.  Each output cell and scratch slot counts its writes, so
a test can check that every cell is written exactly once and that the fixup
reads only slots the first pass wrote.
"""

import numpy as np

TILE = 128  # columns a work item
IDS = 128  # plan rows whose ids one warp load brings
IDENTITY = np.array([0.0, np.inf, -np.inf], np.float32)


def _combine(code, a, b):
    """``a`` first in row order; min/max keep a NaN from either side."""
    with np.errstate(invalid="ignore", over="ignore"):
        added = a + b
    lo = np.where((a < b) | np.isnan(a), a, b)
    hi = np.where((a > b) | np.isnan(a), a, b)
    return np.where(code == 0, added, np.where(code == 1, lo, hi)).astype(np.float32)


def wide_model(values, gather, seg_tiles, m2out, monoids, num_out_tiles, tm, ts,
               slice_rows):
    """``(out, writes)``: the wide route's ``[num_out_tiles * ts, C]``
    float32 result over NumPy plan arrays (``gather=None``: ``values`` holds
    the gathered rows), and how many times each cell was written."""
    values = np.asarray(values, np.float32)
    seg = np.asarray(seg_tiles).reshape(-1)
    m2out = np.asarray(m2out)
    rows, c = seg.size, values.shape[1]
    n_sum, n_min, _ = monoids
    cols = np.arange(c)
    codes = np.where(cols < n_sum, 0, np.where(cols < n_sum + n_min, 1, 2))
    out = np.zeros((num_out_tiles * ts, c), np.float32)
    writes = np.zeros(out.shape, np.int64)
    n_slices = -(-rows // slice_rows)
    head = np.zeros((n_slices, c), np.float32)
    tail = np.zeros((n_slices, c), np.float32)
    head_w = np.zeros(head.shape, np.int64)
    tail_w = np.zeros(tail.shape, np.int64)

    def value(r, cs):
        return values[r if gather is None else gather[r], cs]

    def main_item(k, cs):
        code, ident = codes[cs], IDENTITY[codes[cs]]

        def put(dst, dst_w, i, v):
            dst[i, cs] = v
            dst_w[i, cs] += 1

        def fill(a, b):
            for s in range(a, b):
                put(out, writes, s, ident)

        r0 = k * slice_rows
        end = min(r0 + slice_rows, rows)
        # groups with no valid rows whose first input tile starts here
        for r in range(-(-r0 // tm) * tm, end, tm):
            t = r // tm
            if seg[r] < 0 and (t == 0 or m2out[t - 1] != m2out[t]):
                fill(m2out[t] * ts, (m2out[t] + 1) * ts)
        state = {"prev": seg[r0 - 1] if r0 > 0 else -1, "cur": -1, "cut": False,
                 "acc": None}

        def finish(nxt):
            cur = state["cur"]
            if state["cut"]:
                put(head, head_w, k, state["acc"])
            else:
                put(out, writes, cur, state["acc"])
            g = cur // ts
            fill(cur + 1, nxt if nxt >= 0 and nxt // ts == g else (g + 1) * ts)

        r = r0
        while r < end:
            nb = min(IDS, end - r)
            for i in range(r, r + nb):
                sid = seg[i]
                if sid >= 0 and sid == state["cur"]:
                    state["acc"] = _combine(code, state["acc"], value(i, cs))
                elif sid >= 0:
                    if state["cur"] >= 0:
                        finish(sid)
                    prev = state["prev"]
                    state["cut"] = sid == prev
                    if not state["cut"] and (prev < 0 or prev // ts != sid // ts):
                        fill(sid // ts * ts, sid)
                    state["cur"], state["acc"] = sid, value(i, cs).copy()
                state["prev"] = sid
            rn = r + nb
            if seg[r + nb - 1] < 0:  # the rest of that input tile is pad
                rn = min(-(-rn // tm) * tm, end)
            r = rn
        if state["cur"] >= 0:
            nxt = seg[end] if end < rows else -1
            if nxt == state["cur"]:
                if state["cut"]:
                    put(head, head_w, k, state["acc"])
                else:
                    put(tail, tail_w, k, state["acc"])
            else:
                finish(nxt)

    def fixup_item(k, cs):
        r = k * slice_rows
        if k == 0 or seg[r] < 0 or seg[r - 1] != seg[r]:
            return
        run = seg[r]
        if r + slice_rows < rows and seg[r + slice_rows] == run:
            return  # a later slice owns it
        a = k - 1
        while a > 0 and seg[a * slice_rows] == run and seg[a * slice_rows - 1] == run:
            a -= 1
        assert (tail_w[a, cs] == 1).all() and (head_w[a + 1:k + 1, cs] == 1).all()
        acc = tail[a, cs]
        for p in range(a + 1, k + 1):
            acc = _combine(codes[cs], acc, head[p, cs])
        out[run, cs] = acc
        writes[run, cs] += 1

    tiles = [slice(lo, min(c, lo + TILE)) for lo in range(0, c, TILE)]
    for cs in tiles:
        for k in range(n_slices):
            main_item(k, cs)
    for cs in tiles:
        for k in range(n_slices):
            fixup_item(k, cs)
    return out, writes
