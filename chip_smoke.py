#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py    # full width: ER n=45k, degree 10, KHop(2),
                             # served by the window service with a WAL;
                             # the topological window on a 60k DAG;
                             # qwen3-0.6b, minitron-8b, qwen2-moe-a2.7b
                             # and grok-1-314b (depth 2) serving; the
                             # Criteo-shaped FM; GCN, GAT, GraphSAGE and
                             # MeshGraphNet at full width, served and
                             # trained (K1 as its own backward); the
                             # paper's gwq data plane at LiveJournal
                             # scale; training
                             # qwen3-0.6b, the FM and qwen2-moe-a2.7b
                             # (depth 2) through build_trainer, with K3's
                             # and K4's backward kernels; a two-follower
                             # cluster on ER n=30k; the sharded runtime on
                             # ER n=30k at world sizes 1 (NCCL) and 2
                             # (gloo), served by the window service

Phases, one JSON object per line:

1. ``env``     — the card (``nvidia-smi`` name and power limit), torch, CUDA.
2. ``build``   — compiles every kernel of ``src/repro_torch/csrc`` with nvcc
                 for sm_90a (eight libraries, one nvcc per source, all started
                 together); registers and spills from each ptxas log (none
                 allowed in K1's, K2's or the scan's).
3. ``index``   — the graph, the host EMC DBIndex build and the device plan,
                 built by constructing the ``Session``.
4. ``kernel:segment_sum`` — K1 against its plain PyTorch version on the
   card at the main path's shapes (bitwise on integer values; on normal
   float32 values within 1e-5 of each segment's sum of |terms|, min/max
   bitwise; bitwise across two launches), and timed with CUDA events
   around single calls (the median; a short call's time holds the host's
   enqueue, which the card waits for): kernel, plain version, one PyTorch
   library call, and the bound.  K1 in two forms: sum-only (C = 1 and 2,
   the shapes of earlier runs) and the main path's (C = 3 and 4: sum,
   count, min, max), which also checks NaN and the identity of empty
   segments and times the masked ``scatter_reduce`` route K1 replaced.  A
   form's ``ms`` per ``run()`` is its two passes' times added, as earlier
   runs timed K1; beside it, the two passes called back to back as
   ``run()`` calls them.
5. ``session`` — the port's main path: ``Session.run``, ``run_many`` (B=8)
   and a stream of 10 ``UpdateBatch``es (``--batches``, 20 before minitron,
   the GNNs and sharded serving joined the run) with phase 2 deferred, then one batch
   under the default ``StalenessPolicy`` (which reorganizes: a full EMC
   rebuild and a fresh plan upload), each result checked bit for bit
   against the session's own host index and against the set-evaluation
   oracle; the kernels' launch counts are reset just before and read just
   after (K1: 2 per ``run()`` and per ``run_many()``); ``run_many`` is also
   timed warm, beside eight warm ``run()``s of its rows.  Then the
   device-BFS leg of one more batch's ``update()``, piece by piece: the
   expand plan's build and upload, the seeds' write, one K2 hop, the mask's
   copy back.
6. ``profile`` — one more ``update()``, ``run()`` and ``run_many()`` under
   ``torch.profiler``: device time by kernel and the device's idle share,
   K1's and K2's device time by launch; the ``update()`` runs K2 once, the
   ``run()`` and the ``run_many()`` each run K1 twice and no ``scatter``
   kernel.
7. ``serve_window`` — the serving tier on the same k-hop ``Session``, at
   full width (K1's and K2's counts reset just before, read just after):
   ``WindowService(bucket=8, auto_flip=False)``, each flush 256 point reads
   and 16 explicit-values full-graph reads (two padded chunks), readers
   pinned while 3 update batches land, then ``flip()``: every served value
   bitwise the host index of the version it reports (the pinned view's own
   index), K1's launches per flush equal to 2 per group query plus 2 per
   padded chunk, the clones per update (1, 0, 0) with their bytes and a
   clone's device time; then ``AsyncWindowService`` with its flusher thread,
   a segmented WAL (digest records on) and a client thread submitting point
   and explicit-values reads while 5 more batches land (every ticket bitwise
   its version's host index, no error): per-class latency, K1 launches per
   flush, padded rows, ``wal.append`` and fsync times, ``digest`` time; a
   checkpoint after the fourth batch; then recovery,
   ``Session.restore_from_wal(..., checkpoint=...)`` (one more host EMC
   build and the WAL's tail), bitwise the live ``run()`` with an equal
   ``graph_crc``: checkpoint write and load, rebuild and replay times.
7b. ``explain_analyze`` — ``Session.explain()`` on the same session (engine
   ``torch``, every other candidate's reason, the footprint equal to the
   plan tensors' ``numel() * element_size()``, the anatomy), then
   ``Session.analyze()`` twice, the second counted (K1's and the scan's
   counts reset just before, read just after): the phases ``host_prep``,
   ``pass1_reduce``, ``pass2_reduce``, ``finalize``, exactly 2 K1 launches,
   no new plan signature, results bitwise ``run()``'s (the serving phase's
   result cache detached first); each phase's ms, the attribution and the
   wall ms.  The same on the topological session after phase 11
   (``host_prep``, ``wd_reduce``, ``inherit``, ``finalize``; 1 K1 and 1
   scan launch).
7c. (no line of its own) ``khop_aggregate`` on the same session's plan
   over integer ``[n, 32]`` features from a generator of their own:
   exactly 2 K1 launches, bitwise the host index column by column; timed
   (reported in ``serve_gnn``).
8. ``topo_index`` — the topological window's DAG (``TOPO_DAG``: random_dag
   n = 60,000, degree 10, locality 200, the graph of
   ``benchmarks/bench_iindex.py``; integer attributes in [0, 100) from a
   generator of its own, so no draw of the k-hop path shifts) and its
   ``Session`` (sum, count, avg, min, max on ``TopologicalWindow()``,
   which selects ``torch-iindex``): the host I-Index build, the PID forest's
   depth, the window-difference entries and the plan's bytes; the host
   chain layout's time and shape (chains, the longest, the most light
   edges on a root-to-leaf path).
9. ``kernel:inherit_scan`` — K1 on the ``wd_plan`` (a third form: C = 3,
   sum, min, max, and B = 8 x 3) checked and timed as above; the
   inheritance scan's chain-walk kernel at the main path's columns (C = 4:
   sum, count, min, max) and at B = 8 x C on the DAG's partials, and at
   C = 4 on a path and a star of the same n, bitwise against its plain
   level loop on the card and across two launches, also with NaN in the
   min/max columns; timed beside the plain loop (not on the path: 60,000
   levels of eager launches), the doubling schedule, its bytes bound and
   its dependency bound (depth x one dependent add at the SM clock's
   maximum from ``nvidia-smi``).
10. ``topo_session`` — the topological main path: ``run()``, ``run_many()``
   (B = 8), 10 tail batches (``--batches``; 100 inserts and 25 deletes, every head among
   the last 1 % of topological ranks, every insert from a lower rank to a
   higher one), then one batch drawn like ``tests/test_updates.py``'s (10
   random DAG inserts, 5 deletes), which trips the cone > n/2 rebuild;
   each result bitwise against the session's host I-Index and against set
   evaluation on 256 vertices; exactly 1 K1 and 1 scan launch per ``run()``
   and per ``run_many()``; cone sizes, update times, plan signatures and
   ``wd_plan`` shape changes; the chain layout after the stream.
11. ``topo_profile`` — one topological ``run()`` under ``torch.profiler``:
    one K1 and one scan kernel, device time and idle share.
12. ``kernel:flash_attention`` — K3's tensor-core route (bf16, D 64 and
    128; ``csrc/flash_attention_sm90.cu``): no spills and setmaxnreg
    honoured in its ptxas log, HGMMA in its SASS (``cuobjdump -sass``);
    then against ``flash_torch`` on unit-normal q/k/v at the qwen3 serve
    prefill's shape (B 8, Hq 16, Hkv 8, S 2048, D 64), at S = 32,768 (B
    1), at the D = 128 prefills of minitron-8b (Hq 32, Hkv 8),
    qwen2-moe-a2.7b (Hq = Hkv = 16: the odd-group pairing) and grok-1-314b
    (Hq 48, Hkv 8), each B 8, S 2048, and at the ragged S = 2065, and the CUDA-core route on one float32 case; each checks the
    route its launches took and is bitwise across two launches; timed
    beside the plain version, ``scaled_dot_product_attention`` and the bound
    (bytes of q, k, v, o; causal FLOPs at the bf16 peak, or the float32 peak
    for float32), with TFLOP/s and the ratios to the library and the bound.
13. ``kernel:fm_interaction`` — K4 against its plain version at B = 512 and
    262,144 (F 39, K 10); bitwise across two launches; timed likewise.
14. ``serve_lm`` — qwen3-0.6b at full width (28 layers, d 1024, vocab
    151,936, random seeded weights), then minitron-8b (32 layers, d 4096,
    vocab 256,000, head_dim 128, ~20 GB in bf16), qwen2-moe-a2.7b (24
    layers, 60 routed experts top-4 and a shared SwiGLU, 28.6 GB) and
    grok-1-314b at full width with its depth cut to 2 of 64 layers
    (``LM_DEPTH``; 8 experts top-2, ~23 GB), each freed before the next,
    each: ``ServeEngine.generate`` on 8 requests
    of 2048 tokens, 32 new each, twice (bitwise equal); K3's counts reset
    just before the first and read just after (one per layer, all on
    the tensor-core route); the
    kernel prefill against the plain one (``flash_torch`` with p rounded
    to bf16 before PV, as the kernel rounds it): each layer's attention on
    the model's own q, k, v within K3's bound; the logits within 0.06 +
    0.05 |logit|, all of qwen3's and all but ``LM_LOGITS_SPREAD`` of
    minitron's and the MoE archs'; top-1 equal where the margin is clear;
    PyTorch's SDPA prefill read beside it; for the MoE archs each layer's
    routing (choices dropped by capacity, the most tokens an expert took,
    tokens routed otherwise by the kernel prefill than by the plain one,
    each row's first such flip a near tie); prefill and decode
    timed and profiled (device time by kernel, idle share; the profiled
    prefill must show one K3 launch a layer).
15. ``serve_fm`` — the FM at full width (80.31 M rows): ``forward`` with the
    kernel on 512 and 262,144 id rows over the whole int32 range; K4's count
    reset just before and read just after (one per forward); each result
    against the plain forward, a small batch against float64 NumPy.
15a. ``serve_gnn`` — the GNN family at full width, seeded weights, graphs
    and features (the published counts; the datasets are not in the repo):
    gcn-cora and gat-cora at ``full_graph_sm`` (n 2,708, e 10,556, d_feat
    1,433, 7 classes), graphsage-reddit at ``minibatch_lg``'s device
    subgraph (169,984 nodes, 168,960 edges, d_feat 602, 41 classes) and at
    ``ogb_products`` (n 2,449,029, e 61,859,140, d_feat 100, 47 classes;
    not cut), meshgraphnet at ``molecule`` x 128 (3,840 nodes,
    8,192 edges, 15 steps, d_hidden 128).  Each: the graph's K1 plan built
    once (host s), the forward's K1 launches counted (GCN, SAGE 1 a layer,
    GAT 3, MGN 1 a step), two forwards bitwise equal, the output against
    the plain forward (K1's plain version in the kernel's place) within
    ``GNN_TOL`` * (|plain| + rms(plain)) in every element, timed beside it,
    one forward profiled, K1's bound summed over one more forward's
    launches, and ``index_add_`` timed on each of those launches' gathered
    rows and segment ids (K1's library yardstick; none for GAT's max
    launches); TF32 off.  With it the k-hop ``khop_aggregate``
    result of 7c.
15a'. ``train_gnn`` — each case of 15a trained right after it is served,
    on its graph, ``EdgePlan``, params and features, through
    ``launch/steps.build_gnn_train`` at world 1 (the reference's
    ``gnn_loss``, AdamW on its cosine schedule): labels with Cora's and
    ogbn-products' training-split sizes (140, 196,615 seeded nodes) or the
    sampled subgraph's 1,024 seeds, MeshGraphNet's node targets.  The
    source-sorted layout built (host s, bytes); step 1 on the kernel route
    with K1's forward, recomputed-forward and backward launches counted
    (reset just before, read just after; GCN and SAGE 1 a layer forward
    and 1 backward for the second layer, GAT 3 and 4 a layer, MGN 1, 1 and
    2 a step: its backward recomputes each processor step's forward under
    chunked remat; the recomputed launches are told apart by a wrapper of
    ``models/gnn.py``'s ``checkpoint``, which also times each chunk's body
    on the host) against the
    plain route (K1's sums forward, so that both routes differentiate at the
    same point; backward, the gradient of K1's plain version under PyTorch's
    autograd, chunked as 15a's, and ``index_select``'s own backward for
    the gathers): loss within 1e-5, gnorm within 1e-4, each gradient
    element within 1e-4 (|plain| + rms(plain)); the free plain route (K1's
    plain version forward too) read beside, its loss within 1e-5; two
    step 1s from one state bitwise
    equal (loss, gradients, params, moments); each case's step but
    graphsage-reddit's at ogb_products over a one-device ``DeviceMesh``
    (NCCL) bitwise the one-card step, and so is its step on an edge plan
    over that world of one, which takes the node-sharded path (NCCL's
    all-gathers and reduce-scatters, counted, MeshGraphNet's reissued by
    its remat); 5 steps timed (median of steps 2-5, nodes and edges a
    second, peak memory); one step profiled: K1 forward, recomputed
    forward and backward, cuBLAS, elementwise and the rest of the device
    time, the idle share, and no kernel that adds with atomics
    (``index_add_``, the backward of ``x[idx]``, ``scatter_add_``).
    MeshGraphNet's remat on the host: steps with and without it
    (``checkpoint`` replaced by a plain call), alternating, each split
    into forward, backward and optimizer on the host's clock, the
    recomputed chunks' host time, the garbage collector's time, and each
    one's peak memory.
    ``kernel:segment_sum_bwd`` — K1 as its own backward at ogbn-products'
    layer 2 (C = 128, the source-sorted layout's ``by_src_dst``; the wide
    route, counted): bitwise across two launches, within ``GNN_TOL`` of its
    plain version; timed beside it, ``index_add_`` on its gathered rows,
    its bound and its streamed bound (every valid row's gathered row read
    from HBM).  15a and 15a' report the routes their K1 launches took; K1's
    device time there holds the wide route's fixup kernel, whose share is
    reported beside it.
    ``kernel:segment_sum_routes`` — K1's two routes (the route table,
    ``NARROW_MAX_C``) on plans the run already builds: Cora's GCN plan
    over per-edge rows (C = 32, 33, 64, 100, 128, 1,433) and
    ogbn-products' SAGE plan (C = 100, 128): each route at each C
    bitwise the plain version on integer values, within ``GNN_TOL`` *
    (|plain| + rms) on normal ones, bitwise across two launches, its
    launches counted on its route; timed beside ``index_add_``, the bound
    and the streamed bound; ptxas's registers and spills of each route's
    kernels.
    ``gwq`` — ``launch/steps.build_gwq_step`` at ``query_lj``'s full dims
    (n 3,997,962, nb 2,000,000, m 53,437,500, l 6,000,000) on one card,
    on a seeded plan with integer attributes: 2 K1 launches, bitwise
    NumPy's int64 sums; the host plan s, each pass's K1 ms against its
    bound and ``index_add_``, the step ms; the shapes not run on the card
    named in ``reduced``.
15b'. ``kernel:flash_attention_bwd`` — K3's backward kernels (row
    statistics, dK/dV, dQ) on their two routes: bf16 with D 64 / 128 on
    the tensor cores (``csrc/flash_attention_bwd_sm90.cu``; its ptxas log
    checked for 0 spill bytes and setmaxnreg honoured, its SASS for HGMMA),
    the rest on the CUDA cores (``csrc/flash_attention_bwd.cu``), against
    autograd through ``flash_torch`` at qwen3-0.6b's and qwen2-moe-a2.7b's
    training shapes (one microbatch: (4, 16, 8, 4096, 64) and (4, 16, 16,
    2048, 128), bf16, both checked to take ``sm90``: a relative L2 error
    of at most 2e-2 for each of dq, dk, dv) and at (2, 4, 2, 1000, 128)
    float32 (``simt``; each element within 1e-4 (|plain| + rms(plain)));
    bitwise across two launches; timed beside the plain backward, SDPA's
    backward through ``torch.autograd`` and the bound (five causal products
    at the bf16 or float32 peak).
    ``kernel:fm_interaction_bwd`` — K4's backward at B = 65,536, F 39, K 10,
    within 1e-5 of |g| (sum_f |e| + |e|), bitwise across launches; timed
    beside the plain version and its bytes bound.
    ``train`` — the training path through ``build_trainer(..., smoke=False)``
    (``TRAIN_LM``, ``TRAIN_FM``, ``TRAIN_MOE``), each model freed before the
    next: qwen3-0.6b at full width and depth (remat) at S = 4096, batch 8 as
    2 microbatches of 4 (cut from train_4k's 256), AdamW with bf16 moments
    and the reference's cosine schedule: its first step by hand on the
    kernel route and on the plain route (``attn_backend="flash_torch"``)
    from the same params and batches (loss within 1e-3, gnorm within 2e-2,
    every layer's wq, wk, wv gradient nonzero and within a relative L2 of
    2e-2); 6 steps with the counts reset just before and read just after
    (112 K3 forward launches and 56 backward calls a step: two forwards a
    layer and microbatch under remat), a checkpoint at step 3 in a
    temporary directory, a fresh trainer resumed from it whose losses equal
    the uninterrupted run's at rtol 1e-6; step ms, tokens a second, peak
    memory, checkpoint save and restore s, one more step profiled (device
    time by kernel, idle share).  The FM at full width, B = 65,536, 5 steps
    (one K4 forward and one backward launch a step; the first loss within
    1e-5 of the plain interaction's, the emb gradient within 1e-5 relative
    L2).  qwen2-moe-a2.7b at full width, depth 2 of 24, B x S = 4 x 2048, 2
    steps: finite losses and gnorms, the first loss within 1e-3 of the
    plain route replaying the kernel route's experts.
15b. ``cluster`` — the cluster tier on a graph and a generator of its own
    (ER n = 30,000, degree 10, ``CLUSTER_N``: cut from 100,000 by the
    run's time, four host EMC builds): ``ReplicaSet(n_replicas=2,
    rotate_records=2, checkpoint_every=4, wal_digests=True)`` under the
    deferred-phase-2 policy, started; a client thread routes point reads
    and explicit-values full-graph reads (1 in 8) through the
    ``WindowRouter``, every 4th with ``min_version`` the writer's version,
    while 6 batches of 100 inserts and 25 deletes land; ``r1`` is killed
    with 3 tickets in flight after the second (exactly those fail with
    ``ReplicaFailedError``) and rejoins by checkpoint and tail after the
    fifth.  Every served ticket bitwise the writer's host index of its
    pinned version; after ``sync()`` every follower's ``run()`` bitwise
    the writer's with an equal ``graph_crc``, digest checks > 0 and no
    divergence; a sealed segment truncated and no cursor below the oldest
    kept one; K1 and K2 launched (counts reset just before the load, read
    just after); a ``HealthMonitor`` ready, failed while ``r1`` is dead
    (quorum), ready after the rejoin; a ``HealthServer`` answering
    ``/readyz`` 200, ``/metrics`` with ``repro_router_*`` and
    ``repro_replica_*`` lines and ``/debug`` JSON.  Reads a second, p50 /
    p99 by class and by target, lag, digest ms, each EMC build, the
    rejoin's load, rebuild and tail, the phase's seconds.
15c. ``sharded`` — the sharded runtime (``Session(mesh=...)``) on a graph
    and generators of its own: ER n = 30,000, degree 10, ``KHop(2)``, five
    aggregates (``SHARDED_N``: cut from 100,000 by the run's time), the
    deferred-phase-2 policy, the device BFS, plan headroom 1.0.  World
    size 1 over NCCL in this process: ``run()``; ``SHARDED_WARMUP``
    batches of 100 inserts + 25 deletes, in which the plan may rebuild
    (k = 2's early link growth, R2); ``run_many()`` (B = 8, rows bitwise
    ``run()``); then the stream, ``SHARDED_BATCHES`` batches that must
    each patch the plan in place, with patch bytes below the whole plan's
    and no new plan signature over them.  Every result is bitwise the
    port's single-host ``Session`` on the same stream, the host index and
    set evaluation; 2 K1 launches per ``run()`` and ``run_many()``; one
    more ``run()`` under ``torch.profiler`` (2 K1 kernels; the
    collectives', fills' and copies' device time, the idle share); a NaN
    in a member of a block it reduces kept in min/max.  Then two ranks
    spawned over gloo, both on this one card (NCCL refuses two ranks on
    one card): every result bitwise world 1's, 2 K1 launches a rank per
    ``run()``, each rank's device bytes below the whole plan's, a NaN that
    only rank 1 reduces kept, one digest.  NCCL at world size 2 where
    there are two cards (else a line says it was skipped).  Then the
    serving sub-phase at each world size: ``WindowService(bucket=4)`` over
    the ``ShardedSession`` (at world 2 on rank 0, which ``lead()``s while
    rank 1 ``follow()``s and replays every op): a 3-ticket
    explicit-values flush in one batched launch (2 K1 launches), 3 update
    batches each followed by point reads of every spec at 8 vertices that
    must hit the cache; world 1's tickets bitwise the single-host session
    on the same stream, world 2's bitwise world 1's, both ranks exit, one
    digest after.  ``run_ms``,
    ``run_many_ms``, ``update_ms`` of the stream's batches and of the
    warm-up's apart, each pass's combine inside ``run()`` (CUDA events
    around the run's own collectives), patch and full bytes, build s per
    rank.
16. ``kernel:bitset_expand`` — K2 (last, so the 2 M-vertex graph of its
    shape (c) is not in the process while the paths above are timed) at
    three shapes, words and occupancy masks bitwise against its
    plain version: (a) one hop from one batch's endpoints (what every
    ``update()`` runs), (b) hop 2 from 4096 seeds at ``--n``, (c) the same
    on ER n = 2,000,000; each timed per call as K1 is and on the card
    (events around back-to-back launches of the library's entry point: the
    wrapper's host time exceeds the kernel's at ``--n``), with its input's
    nonzero shares, the plain version, ``sparse.mm`` at (a) and (b), the
    mask pre-pass, a memset of the output, the wrapper's host time alone
    (its entry point stubbed), its bound (the bytes the masked design must
    move) and the dense bound of the first K2 design.  (b)'s seeds come
    from the run's generator before phase 5, as the first K2 phase drew
    them; the K2 phase and phase 5's BFS leg draw from a generator of their
    own, so neither shifts a draw of the main path.
17. ``done`` — the run's seconds; then ``kernels``, one line per the
    repo's reporting contract (K1's and K1 backward's launches by route
    are ``launches_by_route``'s counts, reset and read with ``launches``
    phase by phase (:func:`k1_counts`) and added up as it is; the window
    path's all narrow, each split adding up to its launches); then the
    card line from ``nvidia-smi``;
    then the ``{"ok": true, ...}`` line.

Any failed check raises and the script exits non-zero; without CUDA it
exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

AGGS = ("sum", "count", "avg", "min", "max")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# cycles of one dependent float32 add (FADD's latency on the SM): the
# inheritance scan's dependency bound is depth x this at the SM clock
DEP_COMBINE_CYCLES = 4
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
# normal float32 values: kernel and plain version add in different orders,
# and the rounding of any order of a segment's adds is bounded by a multiple
# of the sum of its terms' magnitudes, so |kernel - plain| <= TOL * sum|x|
TOL = 1e-5

_LINES = []


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print ``obj`` as one JSON line, with ``t_s``, the seconds since the
    script started."""
    line = json.dumps({**obj, "t_s": time.perf_counter() - _T0})
    _LINES.append(line)
    print(line, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def time_ms(fn, dev, reps: int) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls after two
    warm-up calls: CUDA events around each call on the card."""
    import torch

    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def back_to_back_ms(fn, dev, reps: int) -> float:
    """Milliseconds per call of ``reps`` calls of ``fn()`` issued back to
    back between two CUDA events (after one warm-up call): the card's rate
    when the host's enqueue runs ahead of it."""
    import torch

    fn()
    torch.cuda.synchronize(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize(dev)
    return a.elapsed_time(b) / reps


def nbytes(*ts) -> int:
    return sum(int(t.numel() * t.element_size()) for t in ts)


def bound_ms(bytes_moved: int, ops: int, peak: float = F32_OPS_PER_S) -> tuple:
    """(least ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over ``peak`` (operations per second)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------- #
def _k1_pass(name, tp, x, monoids, dev, reps, rng, nan_case):
    """K1 at one pass: ``x`` ``[S, C]`` whose columns are ``monoids =
    (n_sum, n_min, n_max)`` sum, min and max groups.  Checks (integer values
    bitwise equal to the plain version, two launches bitwise equal, normal
    values within TOL of each segment's sum of |terms| on the sum columns
    and bitwise on the min/max columns, NaN kept by min/max as the CPU's
    plain version keeps it, the identity in every empty segment) and times
    it beside the plain version, its library yardsticks and its bound."""
    import torch

    from repro_torch.kernels.segment_reduce.segment_reduce import (
        segment_reduce_plain,
        segment_reduce_tiled,
    )

    n_sum, n_min, n_max = monoids
    args = (tp.gather_padded, tp.seg_tiles, tp.m2out)
    kw = dict(monoids=monoids, num_out_tiles=tp.num_out_tiles, tm=tp.tm, ts=tp.ts)

    def kernel(v):
        return segment_reduce_tiled(v, *args, **kw)

    def plain(v, gather=tp.gather_padded, seg=tp.seg_tiles):
        return segment_reduce_plain(v, gather, seg, monoids=monoids,
                                    num_out_tiles=tp.num_out_tiles, ts=tp.ts)

    k1, k2, p = kernel(x), kernel(x), plain(x)
    torch.cuda.synchronize(dev)
    check(torch.equal(k1, p), f"K1 {name}: integer values not bitwise equal")
    check(torch.equal(k1, k2), f"K1 {name}: two launches differ")
    xn = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype("float32")).to(dev)
    kn, pn = kernel(xn), plain(xn)
    mass = segment_reduce_plain(xn.abs(), tp.gather_padded, tp.seg_tiles,
                                monoids=(x.shape[1], 0, 0),
                                num_out_tiles=tp.num_out_tiles, ts=tp.ts)
    diff = (kn[:, :n_sum] - pn[:, :n_sum]).abs()
    err = float(diff.max()) if n_sum else 0.0
    check(bool((diff <= TOL * mass[:, :n_sum]).all()),
          f"K1 {name}: normal values off by {err} (> {TOL} of sum|x|)")
    check(torch.equal(kn[:, n_sum:], pn[:, n_sum:]),
          f"K1 {name}: normal values' min/max not bitwise equal")
    sid = tp.seg_tiles.reshape(-1)
    ok = sid >= 0
    empty = torch.bincount(sid[ok].long(), minlength=k1.shape[0]) == 0
    ident = torch.tensor([0.0] * n_sum + [float("inf")] * n_min
                         + [float("-inf")] * n_max, device=dev)
    check(torch.equal(k1[empty], ident.expand(int(empty.sum()), x.shape[1])),
          f"K1 {name}: an empty segment does not hold the identity")
    if nan_case:
        xq = x.clone()
        xq[torch.from_numpy(rng.integers(0, x.shape[0], 64)).to(dev),
           n_sum + torch.from_numpy(rng.integers(0, n_min + n_max, 64)).to(dev)] = float("nan")
        want = plain(xq.cpu(), tp.gather_padded.cpu(), tp.seg_tiles.cpu())
        got = kernel(xq).cpu()
        check(bool(torch.isnan(want).any()), f"K1 {name}: the NaN case reached no segment")
        check(torch.equal(torch.isnan(got), torch.isnan(want))
              and torch.equal(got.nan_to_num(0.0), want.nan_to_num(0.0)),
              f"K1 {name}: NaN not kept as the plain version keeps it")
    # the library yardsticks: one index_add over the pre-gathered rows for
    # the sum columns; for min/max the masked scatter_reduce route the
    # executor took before K1 carried them (timed here, used nowhere)
    sink = tp.num_out_tiles * tp.ts
    sid_l = torch.where(ok, sid, sink).long()
    rows = torch.where(ok[:, None], x[tp.gather_padded.long(), :n_sum], 0.0)
    zeros = torch.zeros((sink + 1, n_sum), dtype=torch.float32, device=dev)
    check(torch.equal(zeros.index_add(0, sid_l, rows)[:sink], p[:, :n_sum]),
          f"K1 {name}: library call disagrees")

    def scatter_route():
        outs = []
        for lo, n, red, fill in ((n_sum, n_min, "amin", float("inf")),
                                 (n_sum + n_min, n_max, "amax", float("-inf"))):
            if n:
                src = torch.where(ok[:, None], x[tp.gather_padded.long(), lo:lo + n], fill)
                out = torch.full((sink + 1, n), fill, device=dev)
                outs.append(out.scatter_reduce_(0, sid_l[:, None].expand_as(src), src,
                                                reduce=red, include_self=True))
        return outs

    if n_min + n_max:
        check(torch.equal(torch.cat(scatter_route(), dim=1)[:sink], p[:, n_sum:]),
              f"K1 {name}: the scatter_reduce route disagrees")
    valid_rows = int(ok.sum())
    b, by = k1_bound(tp, x, k1)
    out = {
        "rows": int(sid.numel()), "valid_rows": valid_rows,
        "channels": int(x.shape[1]), "monoids": list(monoids),
        "segments": int(tp.num_segments), "max_abs_err": err,
        "ms": time_ms(lambda: kernel(x), dev, reps),
        "plain_ms": time_ms(lambda: plain(x), dev, reps),
        "index_add_ms": time_ms(lambda: zeros.index_add(0, sid_l, rows), dev, reps),
        "bound_ms": b, "bound_by": by,
    }
    out["library_ms"] = out["index_add_ms"]
    if n_min + n_max:
        out["scatter_reduce_ms"] = time_ms(scatter_route, dev, reps)
        out["library_ms"] += out["scatter_reduce_ms"]
    return out


def k1_bound(tp, x, out) -> tuple:
    """K1's least time for one launch on tile plan ``tp`` over values ``x``
    [N, C] into ``out`` (:func:`bound_ms`): the bytes are each valid row's
    gather index and segment id, each value row the valid rows gather
    (once), ``m2out`` and the output; the operations one per valid row and
    column."""
    import torch

    ok = tp.seg_tiles.reshape(-1) >= 0
    valid_rows = int(ok.sum())
    gathered = int(torch.unique(tp.gather_padded.reshape(-1)[ok]).numel())
    moved = (2 * valid_rows * 4 + gathered * x.shape[1] * x.element_size()
             + nbytes(tp.m2out, out))
    return bound_ms(moved, valid_rows * x.shape[1])


def k1_streamed_bound(tp, x, out) -> tuple:
    """K1's least time for one launch if every valid plan row's gathered
    row comes from device memory (no reuse; :func:`bound_ms`): each valid
    row's gather index, segment id and 4 C value bytes, ``m2out`` and the
    output; the operations one per valid row and column."""
    ok = tp.seg_tiles.reshape(-1) >= 0
    valid_rows = int(ok.sum())
    moved = valid_rows * (8 + x.shape[1] * x.element_size()) + nbytes(tp.m2out, out)
    return bound_ms(moved, valid_rows * x.shape[1])


# K1's keys in a phase's ``launches``: all its launches, then by route
K1_KEYS = ("segment_sum", "segment_sum_narrow", "segment_sum_wide")


def k1_counts() -> dict:
    """K1's launch counter and its split by route
    (``segment_sum_tiled.launches_by_route``), read together, under
    ``K1_KEYS``."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    by_route = segment_sum_tiled.launches_by_route
    return {"segment_sum": segment_sum_tiled.launches,
            "segment_sum_narrow": by_route["narrow"], "segment_sum_wide": by_route["wide"]}


def k1_since(before: dict) -> dict:
    """K1's launches, all and by route, since ``before`` (:func:`k1_counts`)."""
    return {key: n - before[key] for key, n in k1_counts().items()}


def k1_set(counts: dict | None = None) -> None:
    """Set K1's launch counter and its split by route to ``counts``
    (:func:`k1_counts`), or to 0."""
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    counts = counts or dict.fromkeys(K1_KEYS, 0)
    segment_sum_tiled.launches = counts["segment_sum"]
    segment_sum_tiled.launches_by_route.update(narrow=counts["segment_sum_narrow"],
                                               wide=counts["segment_sum_wide"])


def add_counts(into: dict, more: dict) -> dict:
    """Add each count of ``more`` to ``into`` (a missing key from 0)."""
    for key, n in more.items():
        into[key] = into.get(key, 0) + n
    return into


def kernel_segment_sum(plan, vals, dev, reps, rng):
    """K1 at the two passes of one ``run()`` for (sum, count, avg, min, max),
    in two forms.  ``sum``: the sum channels alone, as K1 carried them until
    it took min and max (pass 1 sums the value column, pass 2 the stacked
    (sum, count) partials; kept at these shapes so its times stay
    comparable).  ``minmax``: the main path's form on a plan without ELL
    layouts (pass 1 the value's sum, min and max; pass 2 the stacked (sum,
    count, min, max) partials)."""
    import torch

    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_tiled

    tp1, tp2 = plan.pass1, plan.pass2
    v = torch.from_numpy(vals.astype("float32")).to(dev)[:, None].contiguous()
    v3 = v.expand(-1, 3).contiguous()
    t = segment_reduce_tiled(v3, tp1.gather_padded, tp1.seg_tiles, tp1.m2out,
                             monoids=(1, 1, 1), num_out_tiles=tp1.num_out_tiles,
                             tm=tp1.tm, ts=tp1.ts)[: plan.block_capacity]
    sizes = plan.block_sizes[:, None]
    forms = {
        "sum": {"pass1": (tp1, v, (1, 0, 0)),
                "pass2": (tp2, torch.cat([t[:, :1], sizes], dim=1).contiguous(), (2, 0, 0))},
        "minmax": {"pass1": (tp1, v3, (1, 1, 1)),
                   "pass2": (tp2, torch.cat([t[:, :1], sizes, t[:, 1:]], dim=1).contiguous(),
                             (2, 1, 1))},
    }
    out = {}
    for form, passes in forms.items():
        per_pass = {name: _k1_pass(f"{form} {name}", tp, x, m, dev, reps, rng,
                                   nan_case=form == "minmax")
                    for name, (tp, x, m) in passes.items()}
        # per run(): the two passes' times added, as earlier runs timed K1
        total = {k: sum(p[k] for p in per_pass.values())
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms")}

        def both_passes():  # as run() issues them: pass 1, then pass 2
            for tp, x, m in passes.values():
                segment_reduce_tiled(x, tp.gather_padded, tp.seg_tiles, tp.m2out,
                                     monoids=m, num_out_tiles=tp.num_out_tiles,
                                     tm=tp.tm, ts=tp.ts)

        # beside it: the two passes back to back, so the host's enqueue of
        # pass 2 overlaps pass 1 on the card as in run()
        total["back_to_back_ms"] = time_ms(both_passes, dev, reps)
        total["bound_by"] = ("bytes" if all(p["bound_by"] == "bytes"
                                            for p in per_pass.values())
                             else "operations")
        total["max_abs_err"] = max(p["max_abs_err"] for p in per_pass.values())
        out[form] = {"per_pass": per_pass, **total}
    return out


# K2 at n = 2,000,000 (ER degree 10, undirected: ~20 M symmetrized edges),
# the smallest graph of the paper's Fig. 11
K2_PAPER_N = 2_000_000


def popcount(t):
    """Set bits of each int32 word, as int64 (SWAR, no large temporaries)."""
    v = t.long() & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _k2_shape(name, plan, x, xm, dev, reps, library=True):
    """K2 on one input ``x`` (with its occupancy mask ``xm``): words and
    masks bit for bit against the plain version on the card; timed beside
    it, the library call (where timed), the wrapper's host time and both
    bounds."""
    import torch

    from repro_torch.kernels.bitset_expand import bitset_expand as k2_lib
    from repro_torch.kernels.bitset_expand.bitset_expand import (
        bitset_expand_plain,
        bitset_expand_tiled,
        bitset_mask,
    )

    args = (plan.gather_padded, plan.seg_tiles, plan.row_ptr, plan.pad_before)
    kw = dict(num_out_tiles=plan.num_out_tiles, tm=plan.tm, ts=plan.ts)

    def kernel():
        return bitset_expand_tiled(x, *args, mask=xm, **kw)

    (out, om), (again, am) = kernel(), kernel()
    p, pm = bitset_expand_plain(x, plan.gather_padded, plan.seg_tiles)
    torch.cuda.synchronize(dev)
    err = int(((out.long() & 0xFFFFFFFF) - (p.long() & 0xFFFFFFFF)).abs().max())
    check(err == 0, f"K2 {name}: differs from its plain version by {err} in a word")
    check(torch.equal(om, pm), f"K2 {name}: its mask differs from the plain version's")
    check(torch.equal(out, again) and torch.equal(om, am), f"K2 {name}: two launches differ")
    check(torch.equal(bitset_mask(out), om), f"K2 {name}: the pre-pass mask differs")
    n, words = x.shape
    groups = words // 4
    per_row = popcount(xm).sum(dim=1)  # nonzero groups a row
    nz_groups = int(per_row.sum())
    ok = plan.seg_tiles.reshape(-1) >= 0
    src, dst = plan.gather_padded[ok], plan.seg_tiles.reshape(-1)[ok]
    edge_groups = int(per_row[src.long()].sum())  # groups the edges OR in
    valid = int(src.numel())
    # the first K2 design's dense bound, kept for comparison: every row of
    # reach (each is its own row's base) and of the output, each edge's
    # source index, one run boundary per row, m2out
    dense, _ = bound_ms(nbytes(x, out, plan.m2out) + valid * 4 + (n + 1) * 4, valid * words)
    # what the masked design must move: the output and its mask written
    # once, the input mask read once, each edge's source, the run offsets,
    # and the nonzero 16-byte groups of reach; its operations, one OR a word
    # of each group an edge or a base row brings in
    occ_bytes = (nbytes(out, om, xm, plan.row_ptr, plan.pad_before) + valid * 4
                 + nz_groups * 16)
    b, by = bound_ms(occ_bytes, (edge_groups + nz_groups) * 4)
    slow = max(3, reps // 4) if n > 500_000 else reps
    ms = time_ms(kernel, dev, slow)
    # the kernel's time on the card: events around back-to-back launches of
    # the library's entry point into fixed outputs, without the wrapper's
    # host time (which exceeds the kernel's at the main graph's n)
    raw = k2_lib._lib("bitset_expand_u32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (x, xm, plan.gather_padded, plan.row_ptr, plan.pad_before)]

    def launch():
        check(raw(*ptrs, n, x.shape[1], plan.ts, again.data_ptr(), am.data_ptr(),
                  stream) == 0, f"K2 {name}: launch failed")

    out_d = {
        "rows": n, "words": words, "edges": valid,
        "input_rows_nonzero_share": float((xm != 0).any(dim=1).float().mean()),
        "input_groups_nonzero_share": nz_groups / (n * groups),
        "edge_groups_gathered": edge_groups,
        "output_rows_nonzero": int((om != 0).any(dim=1).sum()),
        "max_abs_err": err, "ms": ms, "device_ms": back_to_back_ms(launch, dev, 4 * slow),
        "plain_ms": time_ms(lambda: bitset_expand_plain(
            x, plan.gather_padded, plan.seg_tiles), dev, slow),
        "bound_ms": b, "bound_by": by, "bound_bytes": occ_bytes, "bound_dense_ms": dense,
        # a call without a mask adds the pre-pass, which reads all of reach
        "mask_prepass_ms": time_ms(lambda: bitset_mask(x), dev, slow),
        "mask_prepass_bound_ms": bound_ms(nbytes(x, xm), 0)[0],
        # the card writing the output's bytes alone (a memset), for scale
        "memset_out_ms": back_to_back_ms(lambda: again.zero_(), dev, 4 * slow),
    }
    # the wrapper's host time alone, by the method of ``ms``: the same calls
    # with the library's entry point replaced by one that returns at once
    # (the launch count is restored: nothing was launched)
    real_lib, count = k2_lib._lib, bitset_expand_tiled.launches
    k2_lib._lib = lambda _name: (lambda *_a: 0)
    try:
        out_d["wrapper_host_ms"] = time_ms(kernel, dev, slow)
    finally:
        k2_lib._lib, bitset_expand_tiled.launches = real_lib, count
    if library:
        # one sparse product (A + I) @ membership, whose non-zeros are the
        # next hop's bits (dense [n, 32 W] float32: 32 GB at n = 2 M, so it
        # is timed at the main graph's n only)
        eye = torch.arange(n, device=dev)
        a = torch.sparse_coo_tensor(
            torch.stack([torch.cat([dst.long(), eye]), torch.cat([src.long(), eye])]),
            torch.ones(valid + n, device=dev), (n, n)).coalesce().to_sparse_csr()
        shifts = torch.arange(32, device=dev)
        dense_x = ((x.long()[:, :, None] >> shifts) & 1).reshape(n, words * 32).float()
        y = torch.sparse.mm(a, dense_x)
        packed = ((y > 0).long().reshape(n, words, 32) << shifts).sum(dim=2)
        check(torch.equal(packed, out.long() & 0xFFFFFFFF), f"K2 {name}: library call disagrees")
        out_d["library_ms"] = time_ms(lambda: torch.sparse.mm(a, dense_x), dev, slow)
        del a, dense_x, y, packed
    else:
        out_d["library_ms"] = None
        out_d["library"] = ("not timed: sparse.mm needs the membership as a dense "
                            f"[n, {32 * words}] float32 matrix, {n * words * 128 / 1e9:.1f} GB")
    del out, om, again, am, p, pm
    return out_d


def kernel_bitset_expand(g, args, dev, rng, b_seeds):
    """K2 at three shapes, each checked bit for bit (words and masks)
    against its plain version: (a) the main path's, one hop from the
    endpoints of one ``make_batch`` batch over the session's graph, what
    every ``update()`` runs; (b) hop 2 from the 4096 ``b_seeds`` on the same
    plan, the shape the first K2 design was timed at; (c) hop 2 from 4096
    seeds on ER n = 2,000,000, degree 10, undirected."""
    import numpy as np
    import torch

    from repro_torch.core.updates import _khop_seeds, _reverse_expand_plan
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.kernels.bitset_expand.ops import bitset_expand, khop_reach_masked

    # the update BFS's expand plan over the reverse edges, as update() builds it
    plan = _reverse_expand_plan(g.reverse_view(), dev)
    seeds = np.unique(_khop_seeds(g, make_batch(g, args, rng)))
    out = {"main_path_seeds": int(seeds.size), "per_shape": {}}
    r0, m0 = khop_reach_masked(plan, g.n, seeds, 0)
    out["per_shape"]["a_main_path"] = _k2_shape("(a)", plan, r0, m0, dev, args.reps)
    h1, hm = bitset_expand(plan, *khop_reach_masked(plan, g.n, b_seeds, 0))
    out["per_shape"]["b_hop2_4096"] = _k2_shape("(b)", plan, h1, hm, dev, args.reps)
    del plan, r0, m0, h1, hm
    t = time.perf_counter()
    big = erdos_renyi(K2_PAPER_N, args.degree, directed=False, seed=args.seed + 2)
    plan = _reverse_expand_plan(big.reverse_view(), dev)
    torch.cuda.synchronize(dev)
    out["paper_graph_and_plan_s"] = time.perf_counter() - t
    seeds = np.sort(rng.choice(big.n, 4096, replace=False))
    h1, hm = bitset_expand(plan, *khop_reach_masked(plan, big.n, seeds, 0))
    out["per_shape"]["c_paper_2m"] = _k2_shape("(c)", plan, h1, hm, dev, args.reps,
                                               library=False)
    del plan, h1, hm, big
    torch.cuda.empty_cache()
    return out


def bfs_leg(sess, args, rng, dev, reps=5):
    """The device-BFS leg of one ``update()`` at the main path's shape,
    timed piece by piece (host clock, each piece ending in a synchronize;
    the median of ``reps``): the expand plan laid out on the host and
    uploaded (``update()`` rebuilds it every batch), the seeds' words and
    masks written on the card, one K2 hop, the final mask's copy back; and
    the whole leg as ``update()`` calls it."""
    import numpy as np

    from repro_torch.core import updates as U
    from repro_torch.kernels.bitset_expand.ops import bitset_expand, khop_reach_masked

    batch = make_batch(sess.graph, args, rng)
    g_new = U.apply_batch(sess.graph, batch)
    rg = g_new.reverse_view()
    seeds = np.unique(U._khop_seeds(g_new, batch))
    plan = U._reverse_expand_plan(rg, dev)
    r, m = khop_reach_masked(plan, rg.n, seeds, 0)
    h, hm = bitset_expand(plan, r, m)
    return {
        "seeds": int(seeds.size),
        "plan_build_upload_ms": wall_ms(lambda: U._reverse_expand_plan(rg, dev), dev, reps),
        "seed_write_ms": wall_ms(lambda: khop_reach_masked(plan, rg.n, seeds, 0), dev, reps),
        "k2_ms": wall_ms(lambda: bitset_expand(plan, r, m), dev, reps),
        "mask_copy_back_ms": wall_ms(lambda: (hm != 0).any(dim=1).cpu().numpy(), dev, reps),
        "leg_ms": wall_ms(lambda: U._device_khop_reach_any(rg, 1, seeds, dev), dev, reps),
        "plan_bytes": plan.plan_nbytes(),
    }


# ---------------------------------------------------------------------- #
def host_expect(index, vals):
    """What the device must return, from the host index (float64 NumPy):
    sum/count/min/max are integers below 2^24, exact in float32; the device
    divides ``avg`` in float32, so its oracle is the float32 quotient."""
    import numpy as np

    out = {a: index.query(vals, a) for a in ("sum", "count", "min", "max")}
    out["avg"] = out["sum"].astype(np.float32) / np.maximum(
        out["count"].astype(np.float32), np.float32(1e-30))
    return out


def check_results(res, expect, what):
    import numpy as np

    for a, r in zip(AGGS, res):
        e = expect[a]
        if a == "avg":
            check(r.dtype == np.float32 and np.array_equal(r, e), f"{what}: avg")
        else:
            check(np.array_equal(r.astype(np.float64), e), f"{what}: {a}")


def set_eval_expect(g, vals, verts):
    import numpy as np

    from repro_torch.core.windows import khop_window_single

    cols = {a: [] for a in AGGS}
    for v in verts:
        w = vals[khop_window_single(g, 2, int(v))]
        cols["sum"].append(w.sum())
        cols["count"].append(w.size)
        cols["min"].append(w.min())
        cols["max"].append(w.max())
    out = {a: np.asarray(c, np.float64) for a, c in cols.items() if c}
    out["avg"] = out["sum"].astype(np.float32) / np.maximum(
        out["count"].astype(np.float32), np.float32(1e-30))
    return out


def build_session(g, args, dev):
    import numpy as np

    from repro_torch.core.aggregates import promote_channel_dtype
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.core.windows import KHopWindow

    vals = g.attrs["val"]
    check(promote_channel_dtype(vals) == np.float64,
          "host channels of a float64 attribute are float64")
    # phase 2 (a full EMC rebuild) is deferred for the stream: at this
    # batch size the default policy would rebuild on every batch (the
    # phase-1 merges' link growth trips max_link_ratio at once); one batch
    # after the stream runs under the default policy (drive_main_path)
    policy = StalenessPolicy(max_link_ratio=float("inf"),
                             max_block_ratio=float("inf"), max_garbage_ratio=1.0)
    t0 = time.perf_counter()
    sess = Session(g, [QuerySpec(KHopWindow(2), a) for a in AGGS],
                   use_device_bfs=True, policy=policy, torch_device=dev)
    t_session = time.perf_counter() - t0
    (state,) = sess._states.values()
    return sess, state, policy, t_session


def make_batch(g, args, rng):
    """``args.inserts`` random edges plus ``args.deletes`` existing ones."""
    import numpy as np

    from repro_torch.core.updates import UpdateBatch

    ins_s = rng.integers(0, g.n, args.inserts)
    ins_d = rng.integers(0, g.n, args.inserts)
    e = rng.choice(g.n_edges, args.deletes, replace=False)
    return UpdateBatch(np.concatenate([ins_s, g.src[e]]),
                       np.concatenate([ins_d, g.dst[e]]),
                       np.concatenate([np.ones(args.inserts, np.int8),
                                       -np.ones(args.deletes, np.int8)]))


def profile_phase(sess, state, args, rng, dev, unprofiled_ms):
    """One more ``update()``, ``run()`` and ``run_many()`` under
    ``torch.profiler`` (see :func:`device_profile`); the profiled
    ``update()`` ran K2 once (by its counter; the trace gives its device
    time at the main path's shape), the profiled ``run()`` and two rows of
    the ``run_many()`` are checked against the host index, and each ran K1
    twice and no ``scatter`` kernel."""
    import numpy as np

    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled

    out = {}
    batch = make_batch(sess.graph, args, rng)
    before = bitset_expand_tiled.launches
    out["update"] = device_profile(lambda: sess.update(batch), dev,
                                   unprofiled_ms["update"], match=("bitset_expand_kernel",))
    check(bitset_expand_tiled.launches == before + 1,
          f"the profiled update() made {bitset_expand_tiled.launches - before} K2 launches, not 1")
    res = []
    out["run"] = device_profile(lambda: res.append(sess.run()), dev,
                                unprofiled_ms["run"],
                                match=("scatter", "segment_reduce_kernel"))
    check_results(res[0], host_expect(state.index, sess.graph.attrs["val"]),
                  "profiled run vs host index")
    vb = rng.integers(0, 100, (8, sess.graph.n)).astype(np.float64)
    many = []
    out["run_many"] = device_profile(lambda: many.append(sess.run_many(vb)), dev,
                                     unprofiled_ms["run_many"],
                                     match=("scatter", "segment_reduce_kernel"))
    for b in (0, vb.shape[0] - 1):
        check_results([m[b] for m in many[0]], host_expect(state.index, vb[b]),
                      f"profiled run_many row {b} vs host index")
    for call in ("run", "run_many"):
        matched, top = out[call]["matched"], out[call].get("top_device_events")
        check(matched["scatter"]["device_ms"] == 0 and matched["scatter"]["launches"] == 0,
              f"the profiled {call}() ran scatter kernels: {matched['scatter']}")
        check(matched["segment_reduce_kernel"]["launches"] == 2,
              f"the profiled {call}() ran K1 {matched['segment_reduce_kernel']['launches']} "
              f"times; the trace's device events: {top}")
    return out


def drive_main_path(sess, state, args, rng):
    """The main path, counted: run, run_many and the update stream."""
    import numpy as np

    from repro_torch.core.api import recompile_count
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    default_policy = StalenessPolicy()
    verts = np.sort(rng.choice(sess.graph.n, args.oracle_vertices, replace=False))
    vb = rng.integers(0, 100, (8, sess.graph.n)).astype(np.float64)
    k1_set()
    bitset_expand_tiled.launches = 0
    t = time.perf_counter()
    res = sess.run()
    run_ms = [(time.perf_counter() - t) * 1e3]
    check(segment_sum_tiled.launches == 2,
          f"run() made {segment_sum_tiled.launches} K1 launches, not 2")
    count0 = recompile_count()
    check_results(res, host_expect(state.index, sess.graph.attrs["val"]), "run v0")
    t = time.perf_counter()
    many = sess.run_many(vb)
    run_many_first = (time.perf_counter() - t) * 1e3
    check(segment_sum_tiled.launches == 4,
          f"run_many() made {segment_sum_tiled.launches - 2} K1 launches, not 2")
    for b in range(vb.shape[0]):
        for a, m, r in zip(AGGS, many, sess.run(vb[b])):
            check(np.array_equal(m[b], r), f"run_many row {b} differs from run: {a}")
    # warm: run_many again, beside the eight run()s of its rows
    run_many_ms, eight_runs_ms = [], []
    for _ in range(5):
        t = time.perf_counter()
        sess.run_many(vb)
        run_many_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        for b in range(vb.shape[0]):
            sess.run(vb[b])
        eight_runs_ms.append((time.perf_counter() - t) * 1e3)
    def step(version):
        """One ``update()`` then one checked ``run()``: (report, update ms)."""
        batch = make_batch(sess.graph, args, rng)
        t = time.perf_counter()
        (rep,) = sess.update(batch).values()
        ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        res = sess.run()
        run_ms.append((time.perf_counter() - t) * 1e3)
        vals = sess.graph.attrs["val"]
        check_results(res, host_expect(state.index, vals), f"run v{version} vs host index")
        oracle = set_eval_expect(sess.graph, vals, verts)
        check_results([r[verts] for r in res], oracle, f"run v{version} vs set evaluation")
        return rep, ms

    update_ms, affected, reorganized, would_reorg = [], [], 0, 0
    for i in range(args.batches):
        rep, ms = step(i + 1)
        update_ms.append(ms)
        affected.append(int(rep["affected"]))
        reorganized += bool(rep["reorganized"])
        would_reorg += bool(default_policy.should_reorganize(
            state.index, state._base_links, state._base_blocks,
            state.batches_since_reorg))
    # one batch under the default policy: after the stream's link growth it
    # reorganizes (a full host EMC build and a fresh plan upload to the card)
    links_after = int(state.index.stats.get("num_links", 0))
    blocks_after = int(state.index.num_blocks)
    deferred, state.policy = state.policy, default_policy
    rep, reorg_ms = step(args.batches + 1)
    state.policy = deferred
    check(bool(rep["reorganized"]), "the default-policy batch did not reorganize")
    launches = {**k1_counts(),
                "bitset_expand": bitset_expand_tiled.launches}
    return {
        "run_ms": statistics.median(run_ms), "run_ms_first": run_ms[0],
        "run_many_ms": statistics.median(run_many_ms), "run_many_ms_first": run_many_first,
        "run_many_ms_all": run_many_ms, "eight_runs_ms": statistics.median(eight_runs_ms),
        "run_many_batch": int(vb.shape[0]),
        "update_ms": statistics.median(update_ms), "update_ms_all": update_ms,
        "batches": args.batches, "edits_per_batch": args.inserts + args.deletes,
        "affected_owners": affected, "reorganized": reorganized,
        "default_policy_would_reorganize": would_reorg,
        "links_after_stream": links_after, "blocks_after_stream": blocks_after,
        "default_policy_update_ms": reorg_ms,
        "default_policy_reorganized": bool(rep["reorganized"]),
        # the EMC rebuild plus the plan upload
        "default_policy_rebuild_s": rep["t_plan_s"],
        "recompile_count_delta": recompile_count() - count0,
        "plan_shapes_constant": recompile_count() == count0,
        "plan_bytes_after": state.plan.plan_nbytes(),
        "links_after": int(state.index.stats.get("num_links", 0)),
        "blocks_after": int(state.index.num_blocks),
        "launches": launches,
        "oracle_vertices": int(verts.size),
    }


# ---------------------------------------------------------------------- #
# The serving tier on the k-hop session: per pinned flush, 256 point reads
# and 16 explicit-values full-graph reads (two padded chunks of 8); 3 update
# batches under pinned readers, then 5 under concurrent service (a
# checkpoint after the fourth)
SERVE_POINTS = 256
SERVE_FULL = 16
SERVE_BUCKET = 8
SERVE_BATCHES = (3, 5)


def served_ok(agg, got, want) -> bool:
    """A served value (float32 scalar or vector) against the host index's:
    sum/count/min/max exact, avg the float32 quotient, bit for bit."""
    import numpy as np

    got = np.asarray(got)
    if got.dtype != np.float32:
        return False
    if agg == "avg":
        return got.tobytes() == np.asarray(want, np.float32).tobytes()
    return np.array_equal(got.astype(np.float64), want)


def serve_window(sess, state, policy, args, rng, dev):
    """The serving tier over the k-hop ``Session`` (see the module note):
    pinned reads across updates, concurrent service with a WAL, recovery
    from a checkpoint and the WAL's tail.  Every served value is checked
    bit for bit against the host index of the version it reports; K1's
    launches per flush against the service's own count of group queries
    and padded chunks (2 each)."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.api import Session, recompile_count
    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled
    from repro_torch.obs.audit import graph_crc
    from repro_torch.serve import (
        AsyncWindowService,
        SegmentedWriteAheadLog,
        WindowService,
        scan_segmented_entries,
    )
    from repro_torch.serve.checkpoint import load_checkpoint

    n, specs = sess.graph.n, sess.compiled.specs
    check([s.agg for s in specs] == list(AGGS), "serve_window expects the AGGS specs")
    full_vals = rng.integers(0, 100, (SERVE_FULL, n)).astype(np.float64)
    expected = {}

    def expect(version, index, graph, vals, key):
        if (version, key) not in expected:
            expected[(version, key)] = host_expect(
                index, graph.attrs["val"] if vals is None else vals)
        return expected[(version, key)]

    k1_set()
    bitset_expand_tiled.launches = 0
    signatures0 = recompile_count()
    out = {}

    # ---- 1. pinned reads: WindowService(auto_flip=False) --------------- #
    svc = WindowService(sess, bucket=SERVE_BUCKET, auto_flip=False)
    flushes = []

    def pinned_flush(what):
        view = svc._active
        ((index, _),) = view.artifacts[0]
        verts = rng.integers(0, n, SERVE_POINTS)
        points = [svc.submit(i % len(specs), vertex=int(v)) for i, v in enumerate(verts)]
        fulls = [svc.submit(j % len(specs), values=full_vals[j]) for j in range(SERVE_FULL)]
        k1, misses, chunks = (segment_sum_tiled.launches, svc.cache.misses,
                              svc.batched_launches)
        hits0 = svc.point_hits
        t = time.perf_counter()
        svc.flush()
        ms = (time.perf_counter() - t) * 1e3
        made, groups = segment_sum_tiled.launches - k1, svc.cache.misses - misses
        chunks = svc.batched_launches - chunks
        check(chunks == SERVE_FULL // SERVE_BUCKET,
              f"{what}: {chunks} padded chunks for {SERVE_FULL} explicit reads")
        check(made == 2 * groups + 2 * chunks,
              f"{what}: {made} K1 launches, expected 2 per group query ({groups}) "
              f"and 2 per padded chunk ({chunks})")
        for t in points:
            check(t.error is None and t.version == view.version, f"{what}: ticket {t.rid}")
            agg = AGGS[t.spec_index]
            want = expect(view.version, index, view.graph, None, None)[agg][t.vertex]
            check(served_ok(agg, t.result, want),
                  f"{what}: point read {agg}@{t.vertex} = {t.result}, host index {want}")
        for j, t in enumerate(fulls):
            check(t.error is None and t.version == view.version, f"{what}: ticket {t.rid}")
            agg = AGGS[t.spec_index]
            check(served_ok(agg, t.result, expect(view.version, index, view.graph,
                                                  full_vals[j], j)[agg]),
                  f"{what}: explicit-values read {j} ({agg})")
        flushes.append({"what": what, "version": view.version, "head": sess.version,
                        "ms": ms, "k1_launches": made, "group_queries": groups,
                        "padded_chunks": chunks, "point_hits": svc.point_hits - hits0})

    v0 = sess.version
    pinned_flush("cold cache")
    pinned_flush("warm cache")
    updates = []
    for _ in range(SERVE_BATCHES[0]):
        batch = make_batch(sess.graph, args, rng)
        t = time.perf_counter()
        (rep,) = svc.update(batch).values()
        updates.append({"ms": (time.perf_counter() - t) * 1e3,
                        "affected": int(rep["affected"]),
                        "plan_clone_bytes": int(rep["plan_clone_bytes"])})
        pinned_flush(f"pinned at v{v0}, head v{sess.version}")
    check([u["plan_clone_bytes"] > 0 for u in updates] == [True, False, False],
          f"clones per update {[u['plan_clone_bytes'] for u in updates]}: the first "
          "update under the pinned view clones, the next two patch the clone in place")
    check(svc.flip() == sess.version, "flip did not publish the head")
    pinned_flush("after flip")
    clone = state.plan.clone()
    check(clone.shape_signature() == state.plan.shape_signature(), "a clone moved a shape")
    del clone
    out["pinned"] = {
        "flushes": flushes, "updates": updates,
        "plan_clones": sess.plan_clones, "plan_clone_bytes": sess.plan_clone_bytes,
        "plan_clone_ms": time_ms(lambda: state.plan.clone(), dev, 5),
        "cache": svc.cache.stats, "point_hits": svc.point_hits,
        "point_misses": svc.point_misses, "padded_rows": svc.padded_rows,
    }
    sess._result_cache = None  # the async service attaches a cache of its own
    del svc

    # ---- 2. concurrent service: AsyncWindowService + segmented WAL ----- #
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="serve_window_", dir=os.path.join(ROOT, "build"))
    reg, tracer = obs.MetricsRegistry(), obs.Tracer()
    wal_dir, ckpt_dir = os.path.join(tmp, "wal"), os.path.join(tmp, "ckpt")
    base = sess.version
    versions = {base: (state.index, sess.graph)}
    cvals = rng.integers(0, 100, (4, n)).astype(np.float64)
    asvc = AsyncWindowService(sess, bucket=SERVE_BUCKET, wal=SegmentedWriteAheadLog(
        wal_dir, obs=reg), wal_digests=True, policy=policy, obs=reg, tracer=tracer)
    tickets, stop, client_errors = [], threading.Event(), []
    crng = np.random.default_rng(args.seed + 5)

    def client():
        try:
            client_reads()
        except Exception as exc:  # reported and failed by the phase below
            client_errors.append(repr(exc))
            raise

    def client_reads():
        i = 0
        while not stop.is_set():
            si, v, j = int(crng.integers(len(specs))), int(crng.integers(n)), i % len(cvals)
            if i % 8 == 7:  # a full-graph read on the caller's values
                tickets.append((asvc.submit(si, values=cvals[j], request_class="interactive"), j))
            elif i % 8 == 3:  # a point read on the caller's values
                tickets.append((asvc.submit(si, vertex=v, values=cvals[j]), j))
            else:  # a point read of the current attributes (the cache)
                tickets.append((asvc.submit(si, vertex=v), None))
            i += 1
            time.sleep(0.01)

    k1, flushes0 = segment_sum_tiled.launches, asvc.flushes
    asvc.start()
    th = threading.Thread(target=client, name="serve-window-client", daemon=True)
    th.start()
    cupdates, ckpt = [], None
    try:
        for i in range(SERVE_BATCHES[1]):
            time.sleep(0.25)  # readers run at this version
            batch = make_batch(sess.graph, args, rng)
            t = time.perf_counter()
            (rep,) = asvc.update(batch).values()
            cupdates.append({"ms": (time.perf_counter() - t) * 1e3,
                             "affected": int(rep["affected"]),
                             "plan_clone_bytes": int(rep["plan_clone_bytes"])})
            versions[sess.version] = (state.index, sess.graph)
            if i == 3:
                t = time.perf_counter()
                ckpt = sess.save_checkpoint(ckpt_dir)
                ckpt_write_s = time.perf_counter() - t
        time.sleep(0.25)
    finally:
        stop.set()
        th.join(timeout=60)
        asvc.stop()
    check(not th.is_alive(), "the client thread did not stop")
    check(not client_errors, f"the client thread failed: {client_errors}")
    made, nflush = segment_sum_tiled.launches - k1, asvc.flushes - flushes0
    lat = {}
    for t, j in tickets:
        check(t.done and t.error is None, f"ticket {t.rid} failed: {t.error!r}")
        index, graph = versions[t.version]
        agg = AGGS[t.spec_index]
        want = expect(t.version, index, graph, None if j is None else cvals[j], ("c", j))[agg]
        got_ok = served_ok(agg, t.result, want if t.vertex is None else want[t.vertex])
        check(got_ok, f"ticket {t.rid} ({agg}, vertex {t.vertex}, values {j}) at "
                      f"v{t.version} differs from the host index")
        lat.setdefault(t.class_name, []).append(t.latency_s * 1e3)
    served_versions = sorted({t.version for t, _ in tickets})
    check(len(served_versions) >= 2, f"tickets served at versions {served_versions} only")
    entries, _ = scan_segmented_entries(wal_dir)
    check([(e["kind"], e["version"]) for e in entries]
          == [(k, base + i) for i in range(1, SERVE_BATCHES[1] + 1) for k in ("batch", "digest")],
          "the WAL holds each batch and its digest, in version order")
    check(entries[-1]["digest"] == sess.digest(), "the last WAL digest is not the session's")
    appends = [e["dur"] / 1e3 for e in tracer.events() if e["name"] == "wal.append"]
    _, fsync_sum, fsyncs = reg.histogram("repro_wal_fsync_seconds").merged()
    stats = asvc.stats
    out["concurrent"] = {
        "tickets": len(tickets), "served_versions": served_versions, "updates": cupdates,
        "latency_ms": {c: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)),
                           "count": len(v)} for c, v in sorted(lat.items())},
        "flushes": nflush, "k1_launches": made,
        "k1_launches_per_flush": made / max(nflush, 1),
        "fill_flushes": stats["fill_flushes"], "deadline_flushes": stats["deadline_flushes"],
        "batched_launches": stats["batched_launches"], "padded_rows": stats["padded_rows"],
        "cache": stats["cache"], "shed": stats["shed"],
        "wal_append_ms": {"median": statistics.median(appends), "max": max(appends),
                          "count": len(appends)},
        "fsync_ms_mean": fsync_sum / max(fsyncs, 1) * 1e3, "fsyncs": fsyncs,
        "wal_bytes": stats["wal"]["bytes_written"],
        "digest_ms": wall_ms(lambda: sess.digest(), dev, 3),
        "checkpoint_write_s": ckpt_write_s,
    }
    del asvc, tickets

    # ---- 3. recovery: checkpoint + the WAL's tail ---------------------- #
    t = time.perf_counter()
    ckpt_version, _, _ = load_checkpoint(ckpt[1])
    load_s = time.perf_counter() - t
    check(ckpt_version == base + 4, f"checkpoint at v{ckpt_version}, expected v{base + 4}")
    rtracer = obs.Tracer()
    t = time.perf_counter()
    restored = Session.restore_from_wal(
        versions[base][1], specs, wal_dir, checkpoint=ckpt_dir, torch_device=dev,
        use_device_bfs=True, policy=policy, tracer=rtracer)
    restore_s = time.perf_counter() - t
    replay_s = sum(e["dur"] for e in rtracer.events() if e["name"] == "session.update") / 1e6
    check(restored.version == sess.version, f"restored v{restored.version}, live v{sess.version}")
    for a, x, y in zip(AGGS, restored.run(), sess.run()):
        check(x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"restored run() differs: {a}")
    check(graph_crc(restored.graph) == graph_crc(sess.graph), "restored graph_crc differs")
    out["recovery"] = {
        "checkpoint_version": ckpt_version, "checkpoint_write_s": ckpt_write_s,
        "checkpoint_load_s": load_s, "restore_s": restore_s,
        "rebuild_s": restore_s - replay_s - load_s, "tail_replay_s": replay_s,
        "tail_batches": sess.version - ckpt_version,
        "checkpoint_bytes": os.path.getsize(ckpt[1]),
    }
    del restored
    shutil.rmtree(tmp, ignore_errors=True)
    out["signatures_delta"] = recompile_count() - signatures0
    out["launches"] = {**k1_counts(),
                       "bitset_expand": bitset_expand_tiled.launches}
    return out


# ---------------------------------------------------------------------- #
# The topological window: a DAGGER-style random DAG (the graph of
# benchmarks/bench_iindex.py): n, degree, locality.  n is cut from the k-hop
# phase's 100,000 to 60,000, the paper's Fig. 14 size: at 100,000 the host
# I-Index build (35 s on the H100 machine's host), the 20 tail batches' host
# maintenance (6-17 s each) and the rebuild batch (37 s) held the whole run
# at ~800 s of its 1200
TOPO_DAG = (60_000, 10.0, 200)
# tail batches: every edge's head among the last 1 % of topological ranks
TOPO_TAIL = 0.01
TOPO_AGGS = ("sum", "count", "min", "max")  # the scan's columns, in K1's order


def topo_members(g, verts):
    """``[n, len(verts)]`` bool: is ``u`` in ``W_t(verts[i])`` (``u`` itself
    or an ancestor) — set evaluation independent of the I-Index: one sweep
    in reverse topological order ORs each vertex's children's bits."""
    import numpy as np

    words = (len(verts) + 63) // 64
    bits = np.zeros((g.n, words), np.uint64)
    i = np.arange(len(verts))
    bits[np.asarray(verts), i // 64] |= np.uint64(1) << (i % 64).astype(np.uint64)
    for v in g.topological_order()[::-1]:
        ch = g.out_neighbors(v)
        if ch.size:
            bits[v] |= np.bitwise_or.reduce(bits[ch], axis=0)
    return np.unpackbits(bits.view(np.uint8), axis=1, bitorder="little")[:, :len(verts)] != 0


def topo_set_eval(members, vals):
    """The oracle's five aggregates of ``vals`` over each column's window."""
    import numpy as np

    out = {"sum": vals @ members, "count": members.sum(axis=0).astype(np.float64),
           "min": np.where(members, vals[:, None], np.inf).min(axis=0),
           "max": np.where(members, vals[:, None], -np.inf).max(axis=0)}
    out["avg"] = out["sum"].astype(np.float32) / np.maximum(
        out["count"].astype(np.float32), np.float32(1e-30))
    return out


def topo_batch(g, rng, ins, dels, tail=None):
    """``ins`` inserts from a lower topological rank to a higher one and
    ``dels`` deletes of existing edges; with ``tail``, every edge's head is
    among the last ``tail`` share of the ranks, else anywhere (drawn as
    ``tests/test_updates.py``'s ``random_dag_insert_batch`` and
    ``random_delete_batch`` draw theirs)."""
    import numpy as np

    from repro_torch.core.updates import UpdateBatch

    order = g.topological_order()
    rank = np.empty(g.n, np.int64)
    rank[order] = np.arange(g.n)
    if tail:
        heads = order[rng.integers(int(g.n * (1 - tail)), g.n, ins * 6)]
        srcs = order[(rng.random(ins * 6) * rank[heads]).astype(np.int64)]
        cand = np.flatnonzero(rank[g.dst] >= int(g.n * (1 - tail)))
    else:
        s, d = rng.integers(0, g.n, ins * 6), rng.integers(0, g.n, ins * 6)
        srcs = np.where(rank[s] < rank[d], s, d)
        heads = np.where(rank[s] < rank[d], d, s)
        cand = np.arange(g.n_edges)
    ok = (rank[srcs] < rank[heads]) & ~g.contains_edges(srcs, heads)
    _, first = np.unique(g.edge_keys(srcs, heads), return_index=True)
    pick = np.intersect1d(np.flatnonzero(ok), first)[:ins]
    e = rng.choice(cand, dels, replace=False)
    return UpdateBatch(np.concatenate([srcs[pick], g.src[e]]).astype(np.int32),
                       np.concatenate([heads[pick], g.dst[e]]).astype(np.int32),
                       np.concatenate([np.ones(pick.size, np.int8),
                                       -np.ones(dels, np.int8)]))


def topo_index(args, dev):
    """The DAG and the topological ``Session`` (sum, count, avg, min, max):
    the host I-Index build and the device plan."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.windows import TopologicalWindow
    from repro_torch.graphs.generators import random_dag, with_random_attrs

    n, degree, locality = TOPO_DAG
    t = time.perf_counter()
    g = with_random_attrs(random_dag(n, degree, seed=args.seed + 5, locality=locality),
                          seed=args.seed + 6)
    t_graph = time.perf_counter() - t
    t = time.perf_counter()
    sess = Session(g, [QuerySpec(TopologicalWindow(), a) for a in AGGS], torch_device=dev)
    t_session = time.perf_counter() - t
    engines = [grp.engine for grp in sess.compiled.groups]
    check(engines == ["torch-iindex"], f"the topological Session selected {engines}")
    (state,) = sess._states.values()
    plan = state.plan
    return sess, state, {
        "n": g.n, "edges": g.n_edges, "degree": degree, "locality": locality,
        "graph_s": t_graph, "session_build_s": t_session,
        "iindex_build_s": state.index.stats["t_total_s"], "depth": plan.max_level,
        "wd_entries": int(state.index.wd_members.size), "plan_bytes": plan.plan_nbytes(),
        "wd_plan_rows": int(plan.wd_plan.seg_tiles.numel()), "engine": engines[0],
        **topo_chains(state.index.pid, state.index.level)}


def light_edges(pid, level, chains):
    """The most chain heads on any root path, the root's own chain not
    counted: the light edges a root-to-leaf path crosses."""
    import numpy as np

    from repro_torch.kernels.inherit_scan.ops import level_layout

    head = np.zeros(pid.size, np.int64)
    head[chains.vertices[chains.ptr[:chains.count]]] = 1
    order, ptr = level_layout(level)
    light = np.zeros(pid.size, np.int64)
    for lv in range(1, int(level.max(initial=0)) + 1):
        idx = order[ptr[lv]:ptr[lv + 1]]
        light[idx] = light[pid[idx]] + head[idx]
    return int(light.max(initial=0))


def chain_stats(pid, level, chains) -> dict:
    """The chain layout's shape: chains, the longest (the spine), chains
    longer than one batch of 32, and the most light edges on a path."""
    import numpy as np

    lens = np.diff(chains.ptr[:chains.count + 1])
    return {"chains": chains.count, "spine": int(lens.max()),
            "chains_over_32": int((lens > 32).sum()),
            "max_light_edges": light_edges(pid, level, chains)}


def topo_chains(pid, level, reps: int = 3) -> dict:
    """The host chain layout of the index's PID forest: its build time
    (median of ``reps``; what every plan build and patch adds) and shape."""
    from repro_torch.kernels.inherit_scan.ops import chain_layout

    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        chains = chain_layout(pid, level)
        ms.append((time.perf_counter() - t) * 1e3)
    return {"chain_layout_ms": statistics.median(ms), **chain_stats(pid, level, chains)}


def sm_clock_mhz() -> float:
    """The SM clock's maximum, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def scan_forest(kind, n, dev):
    """A PID forest of ``n`` vertices (``path``: one chain of depth
    n - 1; ``star``: one root, n - 1 children) as :func:`forest_on` gives
    it, ids relabelled by a seeded permutation."""
    import numpy as np

    parent = np.arange(-1, n - 1) if kind == "path" else np.r_[-1, np.zeros(n - 1, np.int64)]
    level = np.arange(n) if kind == "path" else np.r_[0, np.ones(n - 1, np.int64)]
    perm = np.random.default_rng(n).permutation(n)
    pid = np.full(n, -1, np.int32)
    pid[perm[parent >= 0]] = perm[parent[parent >= 0]]
    lv = np.empty(n, np.int32)
    lv[perm] = level
    return forest_on(pid, lv, dev)


def forest_on(pid, level, dev):
    """``(forest, shape)``: the forest of ``pid`` / ``level`` in both
    layouts, as the scan takes it on ``dev``, and its chain layout's shape."""
    import torch

    from repro_torch.kernels.inherit_scan.ops import forest_layout

    host = forest_layout(pid, level)
    return (host.map(lambda a: torch.from_numpy(a).to(dev)),
            chain_stats(pid, level, host.chains))


def plan_forest(plan):
    """``(forest, shape)``: the main path's own forest, as the plan hands it
    to the scan, and its chain layout's shape."""
    host = plan.forest.map(lambda t: t.cpu().numpy())
    return plan.forest, chain_stats(host.pid, plan.level.cpu().numpy(), host.chains)


def _same_bits(a, b) -> bool:
    """NaN in the same places, the same bits everywhere else (so +0.0 and
    -0.0 differ)."""
    import torch

    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a.view(torch.int32)[~nan],
                                                           b.view(torch.int32)[~nan])


def _scan_case(name, forest, shape, wdp, monoids, dev, reps, rng, clock_mhz, plain_reps=2,
               nan_case=True):
    """The scan kernel on ``wdp`` against its plain level loop on the card
    (bitwise, and bitwise across two launches; with ``nan_case``, also on
    normal values with NaN in the min/max columns and -0.0 in 30 % of the
    entries), timed beside the plain loop (``plain_reps`` calls; None: not
    timed), the doubling schedule and its bounds: bytes (``wdp`` and the
    forest, one int32 a vertex, read once, the output written once; one
    combine a value at the float32 rate) and the dependency bound (depth x
    one dependent combine at the SM clock).  ``shape`` is the chain
    layout's, from :func:`chain_stats`."""
    import torch

    from repro_torch.kernels.inherit_scan.inherit_scan import (
        inherit_scan,
        inherit_scan_doubling,
        inherit_scan_plain,
    )

    levels = (forest.pid, forest.order, forest.level_ptr)
    kw = dict(max_level=forest.max_level, monoids=monoids)

    def kernel(x):
        return inherit_scan(x, forest, monoids=monoids)

    k1, k2 = kernel(wdp), kernel(wdp)
    p = inherit_scan_plain(wdp, *levels, **kw)
    torch.cuda.synchronize(dev)
    err = float((k1 - p).nan_to_num(0.0).abs().max())
    check(_same_bits(k1, p), f"scan {name}: differs from its plain version by {err}")
    check(_same_bits(k2, p), f"scan {name}: two launches differ")
    if nan_case:
        gen = torch.Generator(device=dev).manual_seed(7)
        xq = torch.randn(wdp.shape, generator=gen, device=dev)
        xq[torch.rand(wdp.shape, generator=gen, device=dev) < 0.3] = -0.0
        cols = monoids[0] + torch.from_numpy(
            rng.integers(0, monoids[1] + monoids[2], 64)).to(dev)
        xq[torch.from_numpy(rng.integers(0, wdp.shape[0], 64)).to(dev), cols] = float("nan")
        got, want = kernel(xq), inherit_scan_plain(xq, *levels, **kw)
        check(bool(torch.isnan(want).any()) and bool((torch.signbit(want) & (want == 0)).any())
              and _same_bits(got, want) and _same_bits(kernel(xq), want),
              f"scan {name}: normal values with NaN and -0.0 not bitwise its plain version's")
    b, by = bound_ms(nbytes(wdp, k1) + 4 * wdp.shape[0], wdp.numel())
    return {
        "columns": int(wdp.shape[1]), "monoids": list(monoids), "depth": forest.max_level,
        **shape, "max_abs_err": err, "ms": time_ms(lambda: kernel(wdp), dev, reps),
        "plain_ms": (time_ms(lambda: inherit_scan_plain(wdp, *levels, **kw), dev, plain_reps)
                     if plain_reps else "not measured"),
        "doubling_ms": time_ms(lambda: inherit_scan_doubling(wdp, forest.pid, **kw),
                               dev, reps),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "dependency_bound_ms": forest.max_level * DEP_COMBINE_CYCLES / (clock_mhz * 1e3),
        "sm_clock_max_mhz": clock_mhz,
    }


def kernel_inherit_scan(sess, state, dev, reps, rng):
    """The scan at the main path's columns (C = 4: sum, count, min, max) and
    at B = 8 x C, on this graph's window-difference partials, and at C = 4
    on a path and a star of the same n; and K1 on the ``wd_plan`` (the
    topological path's form: C = 3, sum, min, max, and B = 8 x 3), checked
    and timed as K1's other forms are."""
    import numpy as np
    import torch

    from repro_torch.kernels.segment_reduce.ops import segment_reduce_multi

    plan = state.plan
    clock = sm_clock_mhz()
    forest, shape = plan_forest(plan)
    vals = sess.graph.attrs["val"]
    vb = rng.integers(0, 100, (8, sess.graph.n)).astype(np.float32)
    forms, scans = {}, {}
    for name, v in (("run", vals[None, :].astype(np.float32)), ("run_many", vb)):
        b = v.shape[0]
        cols = torch.from_numpy(np.ascontiguousarray(v.T)).to(dev)
        x = torch.cat([cols, cols, cols], dim=1).contiguous()
        forms[name] = _k1_pass(f"wd_plan {name}", plan.wd_plan, x, (b, b, b), dev, reps,
                               rng, nan_case=True)
        wd = segment_reduce_multi(plan.wd_plan, x, (b, b, b))
        wdp = torch.cat([wd[:, :b], plan.wd_sizes[:, None].expand(-1, b), wd[:, b:]],
                        dim=1).contiguous()
        scans[name] = _scan_case(name, forest, shape, wdp, (2 * b, b, b), dev, reps, rng,
                                 clock)
    # normal values with -0.0 in 30 % of the entries and NaN in the min and
    # max columns, one plain call each to check against (the path's is
    # 60,000 levels of eager launches)
    gen = torch.Generator(device=dev).manual_seed(11)
    for kind, plain_reps in (("path", None), ("star", 2)):
        wdp = torch.randn((sess.graph.n, 4), generator=gen, device=dev)
        wdp[torch.rand(wdp.shape, generator=gen, device=dev) < 0.3] = -0.0
        wdp[torch.randint(0, sess.graph.n, (64,), generator=gen, device=dev),
            torch.randint(2, 4, (64,), generator=gen, device=dev)] = float("nan")
        scans[kind] = _scan_case(kind, *scan_forest(kind, sess.graph.n, dev), wdp, (2, 1, 1),
                                 dev, reps, rng, clock, plain_reps, nan_case=False)
    return forms, scans


def topo_session(sess, state, args, rng, dev):
    """The topological main path, counted: ``run()`` and ``run_many()``
    (B = 8), ``args.batches`` tail batches, then one batch drawn like
    ``tests/test_updates.py``'s (10 random DAG inserts, 5 deletes), which
    trips the cone > n/2 rebuild.  Every result is checked bit for bit
    against the host I-Index and, on ``args.oracle_vertices`` vertices,
    against set evaluation; K1's and the scan's launches are counted."""
    import numpy as np

    from repro_torch.core.api import recompile_count
    from repro_torch.kernels.inherit_scan.inherit_scan import inherit_scan
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    verts = np.sort(rng.choice(sess.graph.n, args.oracle_vertices, replace=False))
    vb = rng.integers(0, 100, (8, sess.graph.n)).astype(np.float64)

    calls = [0]  # run() and run_many() calls: each 1 K1 and 1 scan launch

    def checked_run(version):
        calls[0] += 1
        t = time.perf_counter()
        res = sess.run()
        ms = (time.perf_counter() - t) * 1e3
        vals = sess.graph.attrs["val"]
        check_results(res, host_expect(state.index, vals), f"topo run v{version} vs host index")
        check_results([r[verts] for r in res],
                      topo_set_eval(topo_members(sess.graph, verts), vals),
                      f"topo run v{version} vs set evaluation")
        return ms

    k1_set()
    inherit_scan.launches = 0
    run_ms = [checked_run(0)]
    check(segment_sum_tiled.launches == 1 and inherit_scan.launches == 1,
          f"topological run() made {segment_sum_tiled.launches} K1 and "
          f"{inherit_scan.launches} scan launches, not 1 and 1")
    t = time.perf_counter()
    many = sess.run_many(vb)
    run_many_first = (time.perf_counter() - t) * 1e3
    calls[0] += 1
    check(segment_sum_tiled.launches == 2 and inherit_scan.launches == 2,
          f"topological run_many() made {segment_sum_tiled.launches - 1} K1 and "
          f"{inherit_scan.launches - 1} scan launches, not 1 and 1")
    members = topo_members(sess.graph, verts)
    for b in range(vb.shape[0]):
        row = [m[b] for m in many]
        check_results(row, host_expect(state.index, vb[b]), f"topo run_many row {b} vs host")
        check_results([r[verts] for r in row], topo_set_eval(members, vb[b]),
                      f"topo run_many row {b} vs set evaluation")
    run_many_ms = []
    for _ in range(5):
        t = time.perf_counter()
        sess.run_many(vb)
        run_many_ms.append((time.perf_counter() - t) * 1e3)
        calls[0] += 1
    count0 = recompile_count()
    shape_changes, cones, update_ms = 0, [], []
    for i in range(args.batches):
        batch = topo_batch(sess.graph, rng, args.inserts, args.deletes, tail=TOPO_TAIL)
        before = tuple(state.plan.wd_plan.seg_tiles.shape)
        t = time.perf_counter()
        (rep,) = sess.update(batch).values()
        update_ms.append((time.perf_counter() - t) * 1e3)
        cones.append(int(rep["affected"]))
        shape_changes += tuple(state.plan.wd_plan.seg_tiles.shape) != before
        run_ms.append(checked_run(i + 1))
    count_after = recompile_count()
    batch = topo_batch(sess.graph, rng, 10, 5)
    t = time.perf_counter()
    (rep,) = sess.update(batch).values()
    rebuild_ms = (time.perf_counter() - t) * 1e3
    run_ms.append(checked_run(args.batches + 1))
    runs = calls[0]
    check(segment_sum_tiled.launches == runs and inherit_scan.launches == runs,
          f"{runs} topological run()/run_many() calls made {segment_sum_tiled.launches} "
          f"K1 and {inherit_scan.launches} scan launches")
    return {
        "run_ms": statistics.median(run_ms), "run_ms_first": run_ms[0],
        "run_many_ms": statistics.median(run_many_ms), "run_many_ms_first": run_many_first,
        "run_many_ms_all": run_many_ms, "run_many_batch": int(vb.shape[0]),
        "update_ms": statistics.median(update_ms), "update_ms_all": update_ms,
        "batches": args.batches, "edits_per_batch": args.inserts + args.deletes,
        "tail_share": TOPO_TAIL, "cone_sizes": cones,
        "signatures_before_stream": count0, "signatures_after_stream": count_after,
        "wd_plan_shape_changes": shape_changes,
        "random_batch_cone": int(rep["affected"]),
        "random_batch_rebuilt": int(rep["affected"]) == sess.graph.n,
        "random_batch_update_ms": rebuild_ms, "depth_after": state.plan.max_level,
        "plan_bytes_after": state.plan.plan_nbytes(),
        "chains_after": topo_chains(state.index.pid, state.index.level),
        "launches": {**k1_counts(),
                     "inherit_scan": inherit_scan.launches},
        "oracle_vertices": int(verts.size),
    }


def topo_profile(sess, state, dev, unprofiled_ms):
    """One topological ``run()`` under ``torch.profiler``: one K1 and one
    scan kernel, checked against the host index."""
    res = []
    out = device_profile(lambda: res.append(sess.run()), dev, unprofiled_ms,
                         match=("segment_reduce_kernel", "inherit_scan_kernel"))
    check_results(res[0], host_expect(state.index, sess.graph.attrs["val"]),
                  "profiled topological run vs host index")
    for sub in ("segment_reduce_kernel", "inherit_scan_kernel"):
        check(out["matched"][sub]["launches"] == 1,
              f"the profiled topological run() ran {sub} "
              f"{out['matched'][sub]['launches']} times; the trace's device events: "
              f"{out.get('top_device_events')}")
    return out


def explain_analyze(sess, state, dev, phases, k1_per_run, scans_per_run):
    """EXPLAIN and ANALYZE on a full-width session: the report's engine,
    candidates and anatomy, its footprint against the plan's tensors; then
    ``analyze()`` twice, the second counted (K1's and the scan's launches
    reset just before, read just after) and checked: the port's phase set,
    ``run()``'s launches, no new plan signature, results bitwise
    ``run()``'s (the session's result cache detached, so ``run()``
    launches too)."""
    from repro_torch.core.api import recompile_count
    from repro_torch.kernels.inherit_scan.inherit_scan import inherit_scan

    sess._result_cache = None  # the serving phase's cache: run() launches again
    t = time.perf_counter()
    rep = sess.explain()
    explain_ms = (time.perf_counter() - t) * 1e3
    (grp,) = rep.groups
    engine = {"khop": "torch", "topological": "torch-iindex"}[grp.window_kind]
    check(grp.engine == engine, f"explain chose {grp.engine}, not {engine}")
    check(all(c["reason"] for c in grp.candidates), "a candidate without a reason")
    tensors = state.plan.named_arrays().values()
    check(rep.total_plan_nbytes == sum(a.numel() * a.element_size() for a in tensors),
          "explain's footprint is not the plan tensors' bytes")
    (term,) = grp.terms
    want = sess.run()
    c0 = recompile_count()
    sess.analyze()
    k1_set()
    inherit_scan.launches = 0
    arep = sess.analyze()
    launches = {**k1_counts(),
                "inherit_scan": inherit_scan.launches}
    check((launches["segment_sum"], launches["inherit_scan"]) == (k1_per_run, scans_per_run),
          f"analyze() made {launches}, not {k1_per_run} K1 and {scans_per_run} scan launches")
    check(recompile_count() == c0, "analyze() recorded a plan signature")
    got = {p["phase"] for p in arep.phases}
    check(got == set(phases), f"analyze() phases {sorted(got)}, not {sorted(phases)}")
    for (gi, ai), w in zip(sess.compiled.spec_slots, want):
        r = arep.results[gi][sess.compiled.groups[gi].aggs[ai]]
        check(r.dtype == w.dtype and r.tobytes() == w.tobytes(),
              f"analyze() result {grp.aggs[ai]} differs from run()")
    return {
        "explain_ms": explain_ms, "engine": grp.engine,
        "candidates": {c["name"]: c["reason"] for c in grp.candidates},
        "lowering": grp.lowering["choice"], "total_plan_nbytes": rep.total_plan_nbytes,
        "index": term.index, "plan": term.plan,
        "analyze": {"wall_ms": arep.wall_s * 1e3, "attributed_ms": arep.attributed_s * 1e3,
                    "attribution": arep.attribution,
                    "phase_ms": {k: v * 1e3 for k, v in arep.phase_totals.items()},
                    "rows": [[p["term"], p["phase"], p["seconds"] * 1e3] for p in arep.phases]},
        "launches": launches,
    }


# ---------------------------------------------------------------------- #
# K3 against flash_torch.  float32: within 1e-4 (the same float32
# algorithm, summed in another order).  bf16: the kernel rounds p to bf16
# before the PV product, as the TPU kernel does, and flash_torch keeps p in
# float32; rounding each p by at most 2**-8 of itself moves an output by at
# most 2**-8 of the attention-weighted mean of |v| (flash_torch on |v|);
# both then round their float32 result to bf16, at most one step (2**-7 of
# the value) apart; and 1e-4 for the float32 sums' order, as in float32
K3_TOL = {"p_round": 2.0**-8, "out_round": 2.0**-7, "f32": 1e-4}
# (name, B, Hq, Hkv, S, D): the serve phase's qwen3 prefill, the sequence
# length of LM_SHAPES["prefill_32k"] at batch 1 instead of 32, and the
# serve phase's minitron-8b, qwen2-moe (Hq = Hkv: the kernel's odd-group
# pairing of two query tiles of one head) and grok-1 (a group of 6)
# prefills (head_dim 128)
K3_SHAPES = (("serve_prefill", 8, 16, 8, 2048, 64),
             ("prefill_32k_b1", 1, 16, 8, 32768, 64),
             ("minitron_prefill", 8, 32, 8, 2048, 128),
             ("moe_prefill", 8, 16, 16, 2048, 128),
             ("grok_prefill", 8, 48, 8, 2048, 128))
# bf16 with S a multiple of neither the 64-row query tile nor the 128-key
# tile; and the float32 case, which takes the CUDA-core route
K3_RAGGED = ("ragged_2065", 2, 16, 8, 2065, 64)
K3_F32 = ("float32", 2, 4, 2, 1000, 128)
# serve_lm: (requests, prompt tokens, new tokens each), for each arch in
# LM_ARCHS, one after the other (each freed before the next)
LM_SERVE = (8, 2048, 32)
LM_ARCHS = ("qwen3-0.6b", "minitron-8b", "qwen2-moe-a2.7b", "grok-1-314b")
# archs served with their depth cut (full width): grok-1's 64 layers are
# ~628 GB in bf16, on no one card; 2 layers and the embeddings are ~23 GB
LM_DEPTH = {"grok-1-314b": 2}
# kernel prefill against plain prefill.  The plain prefill is flash_torch
# with the kernel's rounding: p rounded to bf16 before the PV product, the
# row sums unrounded (``_plain_attention``).  Every layer's attention of the
# kernel prefill is held to K3's bound (``_k3_close``) against the plain
# version on the same q, k, v.  The last-token logits take the repo's bf16
# logits tolerance (tests/test_arch_smoke.py), as (atol, rtol), against the
# plain prefill's, with at most LM_LOGITS_SPREAD[arch] = (share of logits
# outside it, largest delta) allowed: none for qwen3.  minitron-8b's 32
# layers of d 4096 with random weights carry a one-step bf16 difference of
# an attention output into the logits, where correct prefills already
# differ (the kernel's against this plain one: 270 of 2,048,000 outside,
# largest delta 0.098; PyTorch's SDPA against flash_torch with p in
# float32: 398, 0.117; H100 80GB HBM3, 700 W), so it may have 1e-3 of them
# outside, none by more than 0.25.  The MoE archs' plain prefill takes the
# kernel prefill's experts (else nearly every token of qwen2-moe routes
# otherwise somewhere in 24 layers, at near ties, and 55 % of the logits
# leave the tolerance): qwen2-moe's 24 layers of d 2048 then carry the
# attention's one-step differences as minitron's do (813 of 1,215,488
# outside, largest delta 0.125; SDPA 808, 0.113; H100 80GB HBM3, 700 W),
# so it takes minitron's allowance; grok-1 at depth 2 had none outside
# (largest delta 0.0625) and is allowed none.  PyTorch's SDPA prefill is
# read beside it and gates nothing
LM_LOGITS_TOL = (0.06, 0.05)
LM_LOGITS_SPREAD = {"qwen3-0.6b": (0.0, None), "minitron-8b": (1e-3, 0.25),
                    "qwen2-moe-a2.7b": (1e-3, 0.25), "grok-1-314b": (0.0, None)}


def _k3_close(got, want, vbar=None):
    """K3's tolerance: 1e-4 for float32; for bf16 (``vbar``, the
    attention-weighted mean of |v| per output) the rounding bound above."""
    diff = (got.float() - want.float()).abs()
    tol = K3_TOL["f32"]
    if vbar is not None:
        tol = tol + K3_TOL["p_round"] * vbar + K3_TOL["out_round"] * want.float().abs()
    return bool((diff <= tol).all()), float(diff.max()), float((diff / tol).max())


def k3_build_report():
    """What the build of K3's tensor-core route says: registers and spills
    per instance from the ptxas log (0 spill bytes, setmaxnreg honoured,
    checked), and the count of HGMMA (wgmma) instructions in its SASS."""
    from repro_torch.kernels import build

    rep = build.ptxas_report("flash_attention_sm90")
    check(len(rep["functions"]) == 2, "K3 sm90: the ptxas log does not list "
          f"the D = 64 and 128 instances ({list(rep['functions'])})")
    for fn, r in rep["functions"].items():
        check(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0,
              f"K3 sm90: {fn} spills ({r})")
    check(rep["setmaxnreg_ignored"] == 0, "K3 sm90: ptxas ignored setmaxnreg")
    hgmma = build.sass("flash_attention_sm90").count("HGMMA")
    check(hgmma > 0, "K3 sm90: no HGMMA in the SASS")
    simt = build.ptxas_report("flash_attention")
    return {"sm90": {**rep, "sass_hgmma": hgmma}, "simt": simt}


def kernel_flash_attention(dev, reps, seed):
    """K3 against its plain version (``flash_torch``) on unit-normal q/k/v:
    the tensor-core route (bf16, D 64) at the serve prefill's shape, at
    S = 32,768 and at a ragged S; the CUDA-core route at the float32 case.
    Each case checks the route it took, is bitwise across two launches,
    and is timed beside the plain version, ``scaled_dot_product_attention``
    (same dtype) and the bound: bytes of q, k, v, o against causal FLOPs at
    the bf16 tensor-core peak, or the float32 peak for float32."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention,
        route,
    )
    from repro_torch.kernels.flash_attention.ref import flash_torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    cases = ([(c, torch.bfloat16) for c in K3_SHAPES + (K3_RAGGED,)]
             + [(K3_F32, torch.float32)])
    per_shape, max_err = {}, 0.0
    for (name, b, hq, hkv, s, d), dtype in cases:
        q, k, v = [torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   for h in (hq, hkv, hkv)]
        path = route(dtype, d)
        before = flash_attention.launches_by_route[path]
        k1 = flash_attention(q, k, v)
        k2 = flash_attention(q, k, v)
        check(flash_attention.launches_by_route[path] == before + 2,
              f"K3 {name}: the two launches did not take the {path} route")
        plain = flash_torch(q, k, v)
        torch.cuda.synchronize(dev)
        check(torch.equal(k1, k2), f"K3 {name}: two launches differ")
        check(bool(torch.isfinite(k1).all()), f"K3 {name}: non-finite output")
        vbar = (flash_torch(q.float(), k.float(), v.float().abs())
                if dtype == torch.bfloat16 else None)
        ok, err, _ = _k3_close(k1, plain, vbar)
        check(ok, f"K3 {name}: off from flash_torch by {err}")
        if dtype == torch.bfloat16:
            max_err = max(max_err, err)
        try:
            def lib():
                return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                      enable_gqa=True)
            lib_out = lib()
        except TypeError:  # a torch without enable_gqa: repeat k, v untimed
            kr, vr = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))

            def lib():
                return F.scaled_dot_product_attention(q, kr, vr, is_causal=True)
            lib_out = lib()
        lib_err = float((lib_out.float() - plain.float()).abs().max())
        slow = max(2, reps // 5) if s > 4096 else reps
        flops = 2 * b * hq * d * s * (s + 1)
        b_ms, by = bound_ms(nbytes(q, k, v, k1), flops,
                            BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
        ms = time_ms(lambda: flash_attention(q, k, v), dev, slow)
        lib_ms = time_ms(lib, dev, slow)
        per_shape[name] = {
            "b": b, "hq": hq, "hkv": hkv, "s": s, "d": d,
            "dtype": str(dtype).replace("torch.", ""), "route": path,
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": ms,
            "plain_ms": time_ms(lambda: flash_torch(q, k, v), dev, max(2, slow // 4)),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
            "tflops": flops / ms / 1e9, "ms_over_library": ms / lib_ms,
            "ms_over_bound": ms / b_ms,
        }
        del q, k, v, k1, k2, plain, vbar, lib_out
    return per_shape, max_err


def kernel_fm_interaction(dev, reps, seed):
    """K4 against its plain version at RECSYS_SHAPES serve_p99 and
    serve_bulk (F = 39, K = 10, float32): within 1e-5 of each row's sum of
    |terms|, bitwise across two launches; timed beside the plain version
    and the bound (bytes: emb read once, the output written once)."""
    import torch

    from repro_torch.configs.registry import RECSYS_SHAPES
    from repro_torch.kernels.fm_interaction.fm_interaction import (
        fm_interaction,
        fm_interaction_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(seed)
    per_shape, max_err = {}, 0.0
    for name in ("serve_p99", "serve_bulk"):
        b = RECSYS_SHAPES[name].dims["batch"]
        emb = torch.randn((b, 39, 10), generator=gen, device=dev)
        k1, k2 = fm_interaction(emb), fm_interaction(emb)
        plain = fm_interaction_plain(emb)
        torch.cuda.synchronize(dev)
        check(torch.equal(k1, k2), f"K4 {name}: two launches differ")
        ok, err = fm_close(k1, plain, emb)
        check(ok, f"K4 {name}: off from its plain version by {err}")
        max_err = max(max_err, err)
        b_ms, by = bound_ms(nbytes(emb, k1), 3 * emb.numel())
        per_shape[name] = {
            "b": b, "f": 39, "k": 10, "max_abs_err": err,
            "ms": time_ms(lambda: fm_interaction(emb), dev, reps),
            "plain_ms": time_ms(lambda: fm_interaction_plain(emb), dev, reps),
            "library_ms": None, "bound_ms": b_ms, "bound_by": by,
        }
    return per_shape, max_err


def fm_close(got, want, emb):
    """K4's tolerance: |got - want| <= 1e-5 * 0.5 * sum_k((sum_f |e|)^2 +
    sum_f e^2), the magnitude of the row's terms, which bounds the
    rounding of any order of its float32 sums."""
    mass = 0.5 * (emb.abs().sum(1).square() + emb.square().sum(1)).sum(-1)
    diff = (got - want).abs()
    return bool((diff <= TOL * mass).all()), float(diff.max())


#: short spin kernels launched before and after each profiled call: a
#: session opened minutes into the process loses the device records of its
#: first launches (on the H100 machine, more the longer the process ran),
#: so without the pad a short call can vanish from its trace
PROFILE_PAD_LAUNCHES = 2000
# K1's kernels by name: each launch's kernel (either route's), and the
# fixup kernel that the wide route's entry point launches right after it
K1_EVENT, K1_FIXUP = "segment_reduce_kernel", "segment_reduce_wide_fixup"


def device_profile(fn, dev, unprofiled_ms, match=(), names=False):
    """Run ``fn`` once under ``torch.profiler``: the device-side events
    (kernels and copies; the aten rows that carry their kernels' time again
    are left out, and so are the pad's spin kernels) against
    ``unprofiled_ms``, the unprofiled median wall time of the same call,
    which gives the device's idle share; for each substring in ``match``,
    the device time and share of the events whose name holds it, and each
    such event's device time in launch order (for ``K1_EVENT``, a wide
    launch's time holds the ``K1_FIXUP`` kernel that follows it, and
    ``fixup_ms`` the fixups' share); with ``names``, every device event's
    time by name.  The profiler's own host overhead is
    inside ``wall_ms_profiled`` only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PROFILE_PAD_LAUNCHES):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall_ms_profiled = (time.perf_counter() - t) * 1e3
        pad()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
              and "spin_kernel" not in e.key]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    launches = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                       and "spin_kernel" not in e.name),
                      key=lambda e: e.time_range.start)
    matched = {}
    for sub in match:
        by_launch, fixup_ms = [], 0.0
        for e in launches:
            if sub in e.name:
                by_launch.append(e.self_device_time_total / 1e3)
            elif sub == K1_EVENT and K1_FIXUP in e.name:
                check(bool(by_launch), "a K1 fixup kernel ran before any K1 kernel")
                by_launch[-1] += e.self_device_time_total / 1e3
                fixup_ms += e.self_device_time_total / 1e3
        ms = sum(e.self_device_time_total for e in events if sub in e.key) / 1e3 + fixup_ms
        matched[sub] = {"device_ms": ms, "launches": sum(e.count for e in events
                                                         if sub in e.key),
                        "share_of_device": ms / device_ms if events else "not measured",
                        "by_launch_ms": by_launch}
        if sub == K1_EVENT:
            matched[sub]["fixup_ms"] = fixup_ms
    out = {
        "matched": matched,
        "wall_ms_profiled": wall_ms_profiled,
        "wall_ms_unprofiled_median": unprofiled_ms,
        "device_ms": device_ms if events else "not measured",
        "device_idle_share": (max(0.0, 1 - device_ms / unprofiled_ms)
                              if events else "not measured"),
        "top_device_events": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                              for e in top],
    }
    if names:
        out["names"] = {e.key: e.self_device_time_total / 1e3 for e in events}
    return out


def wall_ms(fn, dev, reps: int):
    """Median host wall milliseconds of ``fn()`` ending in a synchronize."""
    import torch

    out = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def _sdpa_attention(q, k, v, **_):
    """PyTorch's ``scaled_dot_product_attention`` in the attention's place:
    the library's prefill, read beside the logits check (never the port's
    path)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)


def _plain_attention(q, k, v, **_):
    """K3's plain version in the attention's place: ``flash_torch`` with p
    rounded to v's dtype before the PV product, as the kernel rounds it."""
    from repro_torch.kernels.flash_attention.ref import flash_torch

    return flash_torch(q, k, v, causal=True, p_dtype=v.dtype)


def serve_lm(arch, args, dev):
    """``arch`` (qwen3-0.6b, minitron-8b, qwen2-moe-a2.7b; grok-1-314b with
    its depth cut to ``LM_DEPTH``) at full width from a seeded generator:
    ``ServeEngine`` serves 8 requests of 2048 random tokens, 32 new tokens
    each.  K3's count is reset just before the first ``generate`` and read
    just after (one launch a layer, all on the tensor-core route); the
    kernel prefill is then held against the plain one, layer by layer
    within K3's bound and at the logits within ``LM_LOGITS_TOL`` and
    ``LM_LOGITS_SPREAD`` (PyTorch's SDPA prefill read beside it).  For the
    MoE archs the plain and SDPA prefills take the kernel prefill's experts
    at every layer; a fourth prefill, plain and routing on its own, gives
    the routing check (:func:`moe_routing`)."""
    import dataclasses
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine

    cfg = get_arch(arch).model_cfg
    if arch in LM_DEPTH:
        cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[arch],
                                  name=f"{cfg.name}-depth{LM_DEPTH[arch]}-of-{cfg.n_layers}")
    mod = moe if isinstance(cfg, moe.MoEConfig) else T
    b, plen, new = LM_SERVE
    t = time.perf_counter()
    params = mod.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=new) for i in range(b)]
    eng = ServeEngine(params, cfg, mod, max_seq=plen + new, slots=b)

    flash_attention.launches = 0
    flash_attention.launches_by_route.update(sm90=0, simt=0)
    t = time.perf_counter()
    out = eng.generate(reqs)
    gen_s = time.perf_counter() - t
    launches = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    check(launches == cfg.n_layers,
          f"K3 launched {launches} times in one generate, not {cfg.n_layers}")
    check(by_route["sm90"] == cfg.n_layers,
          f"K3's launches in one generate took the routes {by_route}, "
          f"not {cfg.n_layers} x sm90")
    t = time.perf_counter()
    again = eng.generate(reqs)
    gen2_s = time.perf_counter() - t
    toks = np.stack([out[i] for i in range(b)])
    check(toks.shape == (b, new), f"generate returned {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "token outside the vocabulary")
    check(all(np.array_equal(out[i], again[i]) for i in range(b)),
          "two generate calls differ")

    tok_t = torch.from_numpy(prompts).to(dev)
    kernel_attention, layers = T.attention, []
    routes = {"kernel": [], "plain": []}  # MoE: each layer's router logits, experts

    def routed(into=None, follow=()):
        """``moe._route`` taking ``follow``'s experts in turn while there
        are any (a replay of the kernel prefill's routing), else its own,
        recorded into ``into``; no effect on a dense model."""
        real, queue = moe._route, list(follow)

        def route(xt, router, c):
            if queue:
                return real(xt, router, c, queue.pop(0).view(*xt.shape[:2], c.top_k))
            got = real(xt, router, c)
            if into is not None:
                into.append(((xt @ router).float().reshape(-1, router.shape[1]),
                             got[0].reshape(-1, c.top_k)))
            return got
        return mock.patch.object(moe, "_route", route)

    def checked_attention(q, k, v, **kw):
        # the kernel's output goes on; the plain version on the same inputs
        o = kernel_attention(q, k, v, **kw)
        vbar = flash_torch(q.float(), k.float(), v.float().abs())
        layers.append(_k3_close(o, _plain_attention(q, k, v), vbar))
        return o

    with mock.patch.object(T, "attention", checked_attention), routed(routes["kernel"]):
        kv, logits = mod.prefill(params, tok_t, cfg)
    check(len(layers) == cfg.n_layers and all(ok for ok, _, _ in layers),
          f"kernel prefill: a layer's attention is off from its plain version "
          f"(largest share of K3's bound {max((r for _, _, r in layers), default=0)})")
    # an MoE's plain and SDPA prefills take the kernel prefill's experts, so
    # the logits differ by the attention's rounding alone
    kernel_experts = [e for _, e in routes["kernel"]]
    with mock.patch.object(T, "attention", _plain_attention), routed(follow=kernel_experts):
        _, plain = mod.prefill(params, tok_t, cfg)
    with mock.patch.object(T, "attention", _sdpa_attention), \
            routed(follow=kernel_experts):  # a reading only
        _, lib = mod.prefill(params, tok_t, cfg)
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")
    check(logits.argmax(-1).tolist() == toks[:, 0].tolist(),
          "generate's first token is not the prefill's argmax")
    atol, rtol = LM_LOGITS_TOL

    def outside(x):
        diff = (x - plain).abs()
        return int((diff > atol + rtol * plain.abs()).sum()), float(diff.max())

    over, delta = outside(logits)
    lib_over, lib_delta = outside(lib)
    share, most = LM_LOGITS_SPREAD[arch]
    check(over <= share * plain.numel() and (most is None or delta <= most),
          f"kernel prefill logits: {over} outside the bf16 tolerance of the plain "
          f"prefill's, largest delta {delta} (allowed: {share} of them, {most})")
    # top-1 must agree on every row whose top-2 margin exceeds what the
    # tolerance lets each of the two logits move
    top2 = plain.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * (atol + rtol * top2[:, 0].abs())
    agree = logits.argmax(-1) == plain.argmax(-1)
    check(bool(agree[decided].all()),
          "kernel and plain prefill disagree on a row with a clear top-1")
    routing = None
    if mod is moe:  # the plain prefill routing on its own
        with mock.patch.object(T, "attention", _plain_attention), routed(routes["plain"]):
            _, free = mod.prefill(params, tok_t, cfg)
        routing = moe_routing(cfg, routes, b)
        routing["own_routing_logits_outside_tol"], \
            routing["own_routing_logits_max_abs_delta"] = outside(free)
        del free
    del routes, kernel_experts

    prefill_ms = wall_ms(lambda: mod.prefill(params, tok_t, cfg), dev, 3)
    kv = {k: torch.nn.functional.pad(v, (0, 0, 0, new)) for k, v in kv.items()}
    nxt = logits.argmax(-1)
    steps = min(8, new - 1)

    def decode_steps():
        for i in range(steps):
            mod.decode_step(params, nxt, kv, plen + i, cfg)

    decode_ms = wall_ms(decode_steps, dev, 3) / steps
    # the trace must still see K3 after the earlier phases' profiler sessions
    prefill_prof = device_profile(lambda: mod.prefill(params, tok_t, cfg), dev, prefill_ms,
                                  match=("flash_fwd",))
    check(prefill_prof["matched"]["flash_fwd"]["launches"] == cfg.n_layers,
          f"the profiled prefill shows {prefill_prof['matched']['flash_fwd']['launches']} "
          f"K3 launches, not {cfg.n_layers}")
    return {
        "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
        "vocab": cfg.vocab, "params": cfg.n_params(),
        "weight_bytes": sum(int(t.numel() * t.element_size()) for t in _leaves(params)),
        "init_s": init_s,
        "batch": b, "prompt": plen, "new_tokens": new,
        "generate_s": gen_s, "generate_s_second": gen2_s,
        "generate_tokens_per_s": b * new / gen2_s,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "decode_tokens_per_s": b / decode_ms * 1e3,
        "k3_launches_per_prefill": launches, "k3_launches_by_route": by_route,
        "attention_max_abs_err_by_layer": [e for _, e, _ in layers],
        "attention_share_of_k3_bound": max(r for _, _, r in layers),
        "logits_max_abs_delta_vs_plain": delta, "logits_outside_tol": over,
        "logits_allowed_outside": [share, most],
        "sdpa_logits_max_abs_delta_vs_plain": lib_delta, "sdpa_logits_outside_tol": lib_over,
        "logits": int(plain.numel()),
        "rows_with_clear_top1": int(decided.sum()), "top1_agree_rows": int(agree.sum()),
        **({"routing": routing} if routing else {}),
        "profile_prefill": prefill_prof,
        "profile_decode_step": device_profile(
            lambda: mod.decode_step(params, nxt, kv, plen, cfg), dev, decode_ms),
        "first_tokens": toks[:2, :8].tolist(),
    }, launches


def moe_routing(cfg, routes, b) -> dict:
    """The MoE prefill's routing, from each layer's router logits and
    experts recorded in the kernel and the plain prefill
    (``routes["kernel"]``, ``routes["plain"]``, ``b`` rows): per layer, the
    (token, expert) choices dropped by capacity, the most tokens one expert
    took over all groups and the most one expert drew in a group, and the
    tokens whose expert set differs between the two prefills.  Checked: at
    each row's first layer where a token's set differs, the plain
    prefill's gap between its k-th and (k+1)-th logit is a near tie, no
    more than both logits moved between the prefills at that layer by
    rounding alone (``moe.route_flips``: twice the largest router-logit
    difference over the tokens still clean there).  Each such gap is also
    read in bf16 steps (``moe.router_gap_steps``), as is each token's own
    first differing layer."""
    import torch

    from repro_torch.models import moe

    def stacked(run, i):
        return torch.stack([r[i] for r in routes[run]])

    plain_logits, kernel_experts = stacked("plain", 0), stacked("kernel", 1)
    flips = moe.route_flips(plain_logits, stacked("plain", 1), stacked("kernel", 0),
                            kernel_experts, b)
    n_layers, t, k = kernel_experts.shape
    g = moe.group_count(t, cfg)
    cap, ep = moe.capacity(t // g, cfg), cfg.n_experts_padded
    per_layer = []
    for layer in range(n_layers):
        experts = kernel_experts[layer].view(g, t // g, k)
        kept = moe._slots(experts, cap, ep) < ep * g * cap
        drew = torch.zeros((g, ep), device=experts.device).scatter_add_(
            1, experts.reshape(g, -1), torch.ones_like(experts.reshape(g, -1), dtype=torch.float))
        per_layer.append({
            "dropped": int((~kept).sum()),
            "most_tokens_an_expert_took": int(torch.bincount(experts[kept], minlength=ep).max()),
            "most_an_expert_drew_in_a_group": int(drew.max()),
            "tokens_routed_otherwise": int(flips["differ"][layer].sum()),
            "router_logit_drift": float(flips["drift"][layer]),
        })
    steps = moe.router_gap_steps(plain_logits, k, cfg.cdtype).view(flips["gap"].shape)
    firsts = flips["first_flips"]
    first_steps = [float(steps[layer, row, pos]) for layer, row, pos, _, _ in firsts]
    differ = flips["differ"]
    own = differ & ~(differ.cumsum(0) > 1)  # each token's own first differing layer
    own_steps = steps[own]
    check(all(ratio <= 1 for *_, ratio in firsts),
          f"{cfg.name}: a row's first route flip was no near tie: "
          f"{[f for f in firsts if f[4] > 1][:5]} (layer, row, position, gap, share of "
          f"twice the layer's drift)")
    return {
        "experts": cfg.n_experts, "top_k": k, "groups": g, "tokens_a_group": t // g,
        "capacity": cap, "per_layer": per_layer,
        "dropped_all_layers": sum(p["dropped"] for p in per_layer),
        "tokens_routed_otherwise_all_layers": int(differ.sum()),
        "rows_clean_at_last_token": int(flips["clean"][:, -1].sum()),
        "first_flips_by_row": firsts,
        "first_flips_gap_bf16_steps": first_steps,
        "first_flips_within_one_step": sum(x <= 1 for x in first_steps),
        "tokens_first_flip_gap_steps_max": float(own_steps.max()) if own_steps.numel() else None,
        "tokens_first_flips": int(own_steps.numel()),
        "tokens_first_flips_within_one_step": int((own_steps <= 1).sum()),
    }


def serve_fm(args, dev):
    """The FM at full width (80.31 M rows) from a seeded generator:
    ``forward`` on 512 and 262,144 examples of ids drawn over the whole
    int32 range.  K4's count is reset just before the two forwards and read
    just after; each result is held against the same forward with the FM
    term from the plain version, and the row hash and a small batch against
    NumPy."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import RECSYS_SHAPES, get_arch
    from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction
    from repro_torch.kernels.fm_interaction.ref import fm_interaction_ref
    from repro_torch.models import recsys as R

    cfg = get_arch("fm").model_cfg
    t = time.perf_counter()
    params = R.init(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed)
    xs = {name: rng.integers(-(2**31), 2**31, (RECSYS_SHAPES[name].dims["batch"],
                                               cfg.n_fields)).astype(np.int32)
          for name in ("serve_p99", "serve_bulk")}
    xd = {name: torch.from_numpy(x).to(dev) for name, x in xs.items()}

    fm_interaction.launches = 0
    ys = {name: R.forward(params, x, cfg) for name, x in xd.items()}
    torch.cuda.synchronize(dev)
    launches = fm_interaction.launches
    check(launches == len(xd), f"K4 launched {launches} times in {len(xd)} forwards")

    out = {"model": cfg.name, "fields": cfg.n_fields, "embed_dim": cfg.embed_dim,
           "rows": cfg.total_rows, "table_bytes": nbytes(params["emb"], params["w1"]),
           "init_s": init_s, "k4_launches": launches, "per_shape": {}}
    for name, x in xd.items():
        y = ys[name]
        check(y.shape == (x.shape[0],) and bool(torch.isfinite(y).all()),
              f"serve_fm {name}: bad output")
        rows = R._rows(cfg, x)
        emb = params["emb"][rows]
        plain = (params["bias"] + params["w1"][rows].sum(dim=-1)
                 + fm_interaction_ref(emb))
        ok, err = fm_close(y, plain, emb)
        check(ok, f"serve_fm {name}: off from the plain forward by {err}")
        ms = time_ms(lambda: R.forward(params, x, cfg), dev, args.reps)
        out["per_shape"][name] = {
            "batch": int(x.shape[0]), "ms": ms, "max_abs_err": err,
            "examples_per_s": x.shape[0] / ms * 1e3,
            "profile": device_profile(
                lambda: R.forward(params, x, cfg), dev, ms),
        }
    # the repo's own means on a small input: the row hash as uint32 NumPy
    # arithmetic and the score in float64 from the gathered rows
    x = xs["serve_p99"][:64]
    rows = (cfg.offsets[None, :].astype(np.uint64)
            + x.astype(np.uint32).astype(np.uint64)
            % np.asarray(cfg.table_sizes, np.uint64)[None, :]).astype(np.int64)
    check(np.array_equal(R._rows(cfg, xd["serve_p99"][:64]).cpu().numpy(), rows),
          "row hash differs from uint32 NumPy")
    rows_d = torch.from_numpy(rows).to(dev)
    e = params["emb"][rows_d].cpu().numpy().astype(np.float64)
    lin = params["w1"][rows_d].cpu().numpy().astype(np.float64).sum(-1)
    ref = lin + 0.5 * (e.sum(1) ** 2 - (e * e).sum(1)).sum(-1)
    err64 = float(np.abs(ys["serve_p99"][:64].cpu().numpy() - ref).max())
    check(err64 < 1e-6, f"serve_fm: off from float64 NumPy by {err64}")
    out["max_abs_err_vs_float64"] = err64
    return out, launches


# ---------------------------------------------------------------------- #
# serve_gnn: the GNN family at full width on seeded graphs with the
# published counts (Cora, Reddit and ogbn-products are not in the repo):
# (arch, GNN_SHAPES entry).  graphsage-reddit runs minibatch_lg's device
# subgraph (its sub_n, sub_e) and whole-graph inference at ogb_products.
GNN_CASES = (("gcn-cora", "full_graph_sm"), ("gat-cora", "full_graph_sm"),
             ("graphsage-reddit", "minibatch_lg"), ("graphsage-reddit", "ogb_products"),
             ("meshgraphnet", "molecule"))
# ogb_products' host graph and plan must build within this (not cut)
GNN_OGB_BUDGET_S = 120.0
GNN_PAD = 1024  # the padded edge list's length is a multiple of this
# K1 forward against the plain forward (K1's plain version in its place):
# the two add each segment in another order, and the float32 rounding of
# any order is a few ulps of the segment's sum of |terms|, carried through
# the layers' float32 matmuls.  Each element: |d| <= GNN_TOL * (|plain| +
# rms(plain)), rms over the whole output.  On an H100 the kernel forward
# reaches at most 0.114 of this bound (meshgraphnet, whose output has rms
# 3,591 and median 141; 0.004-0.008 for the others)
GNN_TOL = 1e-4
GNN_K1_PER_LAYER = {"gcn": 1, "sage": 1, "gat": 3, "meshgraphnet": 1}
GNN_KHOP_D = 32  # khop_aggregate's feature columns on the k-hop session
GNN_PLAIN_ROWS = 1 << 22  # plan rows per chunk of the plain version


def gnn_graph(shape: str, dims: dict, rng):
    """A seeded padded edge list of ``shape`` as the reference lays it out
    (edges sorted by destination, then sink-row edges up to a multiple of
    ``GNN_PAD``): ``(src, dst, n, valid edges)`` as int32 NumPy.
    ``minibatch_lg``: the sampled subgraph of 1024 seeds, 15 hop-1 and 10
    hop-2 neighbours each, every sampled node distinct; ``molecule``:
    ``batch`` molecules of ``n`` atoms and ``e`` random bonds each; the
    rest: ``e`` edges uniform over ``n`` nodes."""
    import numpy as np

    if shape == "minibatch_lg":
        b, f1, f2 = dims["batch_nodes"], dims["fan1"], dims["fan2"]
        n, hop1 = dims["sub_n"], b * f1
        dst = np.concatenate([np.repeat(np.arange(b), f1),
                              np.repeat(b + np.arange(hop1), f2)])
        src = np.concatenate([b + np.arange(hop1), b + hop1 + np.arange(hop1 * f2)])
    elif shape == "molecule":
        per, bonds, batch = dims["n"], dims["e"], dims["batch"]
        n = per * batch
        off = np.repeat(np.arange(batch) * per, bonds)
        src = off + rng.integers(0, per, bonds * batch)
        dst = off + rng.integers(0, per, bonds * batch)
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    else:
        n, e = dims["n"], dims["e"]
        dst = np.sort(rng.integers(0, n, e, dtype=np.int32))
        src = rng.integers(0, n, e, dtype=np.int32)
    e = dst.size
    pad = (-e) % GNN_PAD
    return (np.concatenate([src, np.full(pad, n)]).astype(np.int32),
            np.concatenate([dst, np.full(pad, n)]).astype(np.int32), int(n), int(e))


def plain_k1(tp, values, monoids):
    """K1's plain version in place of the kernel for the plain forward:
    ``segment_reduce_plain`` over chunks of ``GNN_PLAIN_ROWS`` plan rows
    (whole tiles), each chunk's partials combined by their monoid, so the
    gathered rows of ogb_products' 62 M edges never sit on the card at
    once."""
    import torch

    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_plain

    n_sum, n_min, _ = monoids
    per = max(1, GNN_PLAIN_ROWS // tp.tm)
    nm = tp.seg_tiles.shape[0]
    out = None
    for lo in range(0, nm, per):
        hi = min(nm, lo + per)
        part = segment_reduce_plain(values.float(), tp.gather_padded[lo * tp.tm:hi * tp.tm],
                                    tp.seg_tiles[lo:hi], monoids=tuple(monoids),
                                    num_out_tiles=tp.num_out_tiles, ts=tp.ts)
        if out is None:
            out = part
            continue
        out[:, :n_sum] += part[:, :n_sum]
        lo_m = n_sum + n_min
        out[:, n_sum:lo_m] = torch.minimum(out[:, n_sum:lo_m], part[:, n_sum:lo_m])
        out[:, lo_m:] = torch.maximum(out[:, lo_m:], part[:, lo_m:])
    return out[: tp.num_segments]


def gnn_case(arch: str, shape: str, args, dev) -> dict:
    """One GNN config at one shape on the card: seeded weights, graph and
    features; the K1 forward timed, checked finite and bitwise across two
    calls, its K1 launches counted (reset just before, read just after),
    held against the plain forward within ``GNN_TOL``, and profiled once
    (device time, idle share, K1's device time).  Returns the case and the
    K1 launches of its two counted forwards (the count taken just before
    the first and read just after the second)."""
    import importlib
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.configs.registry import ARCH_MODULES, GNN_SHAPES
    from repro_torch.models import gnn

    dims = GNN_SHAPES[shape].dims
    cfg = importlib.import_module(ARCH_MODULES[arch]).cfg_for(dims)
    rng = np.random.default_rng(args.seed + 30 + GNN_CASES.index((arch, shape)))
    t = time.perf_counter()
    src, dst, n, e = gnn_graph(shape, dims, rng)
    graph_s = time.perf_counter() - t
    t = time.perf_counter()
    plan = gnn.edge_plan(src, dst, n, torch_device=dev)
    torch.cuda.synchronize(dev)
    plan_s = time.perf_counter() - t
    if shape == "ogb_products":
        check(graph_s + plan_s < GNN_OGB_BUDGET_S,
              f"ogb_products' host graph and plan took {graph_s + plan_s:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    init = {"gcn": gnn.gcn_init, "sage": gnn.sage_init, "gat": gnn.gat_init,
            "meshgraphnet": gnn.mgn_init}[cfg.kind]
    params = init(gen, cfg)
    x = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    src_t, dst_t = (torch.from_numpy(a).to(dev) for a in (src, dst))
    extra = {}
    if cfg.kind == "gcn":
        deg_s = np.bincount(src[:e], minlength=n).astype(np.float32)
        deg_d = np.bincount(dst[:e], minlength=n).astype(np.float32)
        w = np.zeros(src.size, np.float32)
        w[:e] = 1.0 / np.sqrt(np.maximum(deg_s[src[:e]] * deg_d[dst[:e]], 1.0))
        extra["w"] = torch.from_numpy(w).to(dev)
    if cfg.kind == "meshgraphnet":
        extra["ef"] = torch.randn((src.size, 3), generator=gen, device=dev)

    def forward():
        if cfg.kind == "gcn":
            return gnn.gcn_forward(params, x, src_t, dst_t, extra["w"], n, cfg, plan=plan)
        if cfg.kind == "sage":
            return gnn.sage_forward(params, x, src_t, dst_t, n, cfg, plan=plan)
        if cfg.kind == "gat":
            return gnn.gat_forward(params, x, src_t, dst_t, n, cfg, plan=plan)
        return gnn.mgn_forward(params, x, extra["ef"], src_t, dst_t, n, cfg, plan=plan)

    before = k1_counts()
    out = forward()
    torch.cuda.synchronize(dev)
    first = k1_since(before)
    launches = first["segment_sum"]
    want_launches = GNN_K1_PER_LAYER[cfg.kind] * cfg.n_layers
    check(launches == want_launches,
          f"{arch} at {shape}: {launches} K1 launches a forward, not {want_launches}")
    check(tuple(out.shape) == (n, cfg.d_out) and bool(torch.isfinite(out).all()),
          f"{arch} at {shape}: output {tuple(out.shape)} or not finite")
    again = forward()
    torch.cuda.synchronize(dev)
    both = k1_since(before)
    check(both["segment_sum"] == 2 * want_launches,
          f"{arch} at {shape}: {both['segment_sum']} K1 launches in two forwards, not "
          f"{2 * want_launches}")
    check(torch.equal(out, again), f"{arch} at {shape}: two forwards differ")
    with mock.patch.object(gnn, "segment_reduce_multi", plain_k1):
        plain = forward()
        torch.cuda.synchronize(dev)
        plain_ms = wall_ms(forward, dev, 2)
    diff, mag = (out - plain).abs(), plain.abs()
    rms, med, top = (float(mag.pow(2).mean().sqrt()), float(mag.median()),
                     float(mag.max()))
    err = float(diff.max())
    worst = float((diff / (GNN_TOL * (mag + rms))).max())
    check(worst <= 1.0,
          f"{arch} at {shape}: off from the plain forward by {err} (the bound "
          f"{GNN_TOL} * (|plain| + {rms}) exceeded {worst} times)")
    ms = time_ms(forward, dev, max(3, args.reps // 4))
    prof = device_profile(forward, dev, ms, match=(K1_EVENT,))
    traced = prof["matched"][K1_EVENT]["launches"]
    check(traced == launches, f"{arch} at {shape}: the profiled forward ran K1 {traced} times")
    # K1's bound in one more forward: each launch's inputs as it gets them;
    # then index_add_ on each sum launch's gathered rows and segment ids
    real, k1_bounds, k1_streamed, k1_calls = gnn.segment_reduce_multi, [], [], []

    def bounded(tp, values, monoids):
        got = real(tp, values, monoids)
        k1_bounds.append(k1_bound(tp, values, got)[0])
        k1_streamed.append(k1_streamed_bound(tp, values, got)[0])
        k1_calls.append((tp, values, monoids, got))
        return got

    with mock.patch.object(gnn, "segment_reduce_multi", bounded):
        forward()
    index_add_ms = []
    while k1_calls:
        index_add_ms.append(k1_index_add_ms(*k1_calls.pop(0), dev, max(3, args.reps // 4)))
        torch.cuda.empty_cache()
    k1_device_ms = prof["matched"][K1_EVENT]["device_ms"]
    lib_ms = None if None in index_add_ms else sum(index_add_ms)
    n_params = sum(int(t.numel()) for t in _leaves(params))
    del out, again, plain, diff, mag
    torch.cuda.empty_cache()
    # train_gnn on the same graph, plan, params and features
    gen = torch.Generator(device=dev).manual_seed(args.seed + 33)
    batch = gnn_train_batch(cfg, shape, dims, n, x, src_t, dst_t, extra, gen, dev)
    train, train_k1, train_bwd = gnn_train_case(arch, shape, cfg, plan, params, batch,
                                                n, e, args, dev)
    k1_bwd = kernel_k1_bwd(plan, n, args, dev) if shape == "ogb_products" else None
    del x, extra, batch
    torch.cuda.empty_cache()
    if (arch, shape) == ("gcn-cora", "full_graph_sm"):
        k1_routes("cora_gcn_by_edge", plan.by_edge, int(src.size), args, dev)
    if shape == "ogb_products":
        k1_routes("ogb_products_sage_by_src", plan.by_src, n, args, dev)
    serve = {
        "arch": arch, "shape": shape, "n": n, "edges": e, "edges_padded": int(src.size),
        "d_in": cfg.d_in, "d_hidden": cfg.d_hidden, "d_out": cfg.d_out,
        "layers": cfg.n_layers, "heads": cfg.n_heads, "params": n_params,
        "graph_s": graph_s, "plan_s": plan_s, "plan_bytes": plan.plan_nbytes(),
        "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
        "tol": f"{GNN_TOL} * (|plain| + rms)", "plain_rms": rms,
        "plain_median_abs": med, "plain_max_abs": top,
        "share_of_tol": worst,
        "k1_launches_per_forward": launches,
        "k1_launches_by_route": {"narrow": first["segment_sum_narrow"],
                                 "wide": first["segment_sum_wide"]},
        "bitwise_repeat": True,
        "device_ms": prof["device_ms"], "device_idle_share": prof["device_idle_share"],
        "k1_device_ms": k1_device_ms,
        "k1_by_launch_ms": prof["matched"][K1_EVENT]["by_launch_ms"],
        "k1_wide_fixup_device_ms": prof["matched"][K1_EVENT]["fixup_ms"],
        "k1_bound_ms": sum(k1_bounds), "k1_bound_by_launch_ms": k1_bounds,
        "k1_streamed_bound_ms": sum(k1_streamed), "k1_streamed_bound_by_launch_ms": k1_streamed,
        "k1_index_add_ms": lib_ms, "k1_index_add_ms_by_launch": index_add_ms,
        "k1_ms_over_index_add": k1_device_ms / lib_ms if lib_ms else None,
        "top_device_events": prof["top_device_events"][:5],
    }
    return serve, both, train, train_k1, train_bwd, k1_bwd


def k1_index_add_ms(tp, values, monoids, got, dev, reps):
    """The library yardstick of one K1 launch of a GNN forward: the time of
    ``index_add_`` over the launch's gathered rows (pre-gathered, padding
    rows zeroed, outside the timing) and segment ids, checked against K1's
    result ``got`` within ``GNN_TOL`` * (|got| + rms(got)) (float32 sums in
    another order); None for a launch with min or max columns, which no
    one call computes."""
    import torch

    n_sum, n_min, n_max = monoids
    if n_min or n_max:
        return None
    sid = tp.seg_tiles.reshape(-1)
    ok = sid >= 0
    sink = tp.num_out_tiles * tp.ts
    sid_l = torch.where(ok, sid, sink).long()
    rows = values.float().index_select(0, tp.gather_padded.reshape(-1).long())
    rows.masked_fill_(~ok[:, None], 0.0)
    out = torch.zeros((sink + 1, values.shape[1]), dtype=torch.float32, device=dev)
    lib = out.index_add_(0, sid_l, rows)[: got.shape[0]]
    rms = float(got.pow(2).mean().sqrt())
    worst = float(((lib - got).abs() / (GNN_TOL * (got.abs() + rms))).max())
    check(worst <= 1.0, f"index_add_ disagrees with K1 ({worst} of the bound)")
    ms = time_ms(lambda: out.index_add_(0, sid_l, rows), dev, reps)
    del rows, out, lib, sid_l
    return ms


# K1's two routes on plans the run builds anyway, at these column counts:
# on Cora's, each side of NARROW_MAX_C and the GNN widths; on
# ogbn-products', SAGE's two (the sweep that chose NARROW_MAX_C is in
# kernels/segment_reduce/segment_reduce.py and PERF.md)
K1_ROUTE_COLUMNS = {"cora_gcn_by_edge": (32, 33, 64, 100, 128, 1433),
                    "ogb_products_sage_by_src": (100, 128)}
_K1_ROUTES = {}  # what k1_routes measured, by plan: the kernel:segment_sum_routes line


def k1_routes(label, tp, n_values, args, dev) -> None:
    """Both K1 routes on plan ``tp`` over seeded ``[n_values, C]`` values
    at each C of ``K1_ROUTE_COLUMNS[label]``: on integer values bitwise the
    plain version (chunked, :func:`plain_k1`), on normal values within
    ``GNN_TOL`` * (|plain| + rms(plain)), bitwise across two launches, each
    launch counted on its route (the other route than the table's taken
    with ``NARROW_MAX_C`` moved past C); each route timed (:func:`time_ms`)
    beside ``index_add_`` on the pre-gathered rows, the bound and the
    streamed bound.  Kept in ``_K1_ROUTES[label]``."""
    from unittest import mock

    import torch

    from repro_torch.kernels.segment_reduce import segment_reduce as k1mod

    gen = torch.Generator(device=dev).manual_seed(args.seed + 36)
    reps, s, by_route = max(3, args.reps // 4), tp.num_segments, \
        k1mod.segment_sum_tiled.launches_by_route
    rows = {"plan_rows": int(tp.seg_tiles.numel()),
            "valid_rows": int((tp.seg_tiles >= 0).sum()), "values_rows": n_values,
            "wide_slice_rows": k1mod.wide_slice_rows(int(tp.seg_tiles.numel()))}
    for c in K1_ROUTE_COLUMNS[label]:
        monoids = (c, 0, 0)
        xi = torch.randint(0, 100, (n_values, c), generator=gen, device=dev).float()
        x = torch.randn((n_values, c), generator=gen, device=dev)
        plain_i, plain = plain_k1(tp, xi, monoids), plain_k1(tp, x, monoids)
        rms = plain.pow(2).mean().sqrt()
        row = {"table": k1mod.route(c)}
        for kernel in k1mod.ROUTES:
            def call(v):
                return k1mod.segment_reduce_tiled(
                    v, tp.gather_padded, tp.seg_tiles, tp.m2out, monoids=monoids,
                    num_out_tiles=tp.num_out_tiles, tm=tp.tm, ts=tp.ts)

            before = dict(by_route)
            with mock.patch.object(k1mod, "NARROW_MAX_C", c if kernel == "narrow" else c - 1):
                got_i, got, again = call(xi), call(x), call(x)
                torch.cuda.synchronize(dev)
                check(by_route == {**before, kernel: before[kernel] + 3},
                      f"K1 {label} C={c}: launches by route {by_route}, not 3 more {kernel}")
                check(torch.equal(got_i[:s], plain_i),
                      f"K1 {label} C={c} {kernel}: integer values not bitwise the plain "
                      "version")
                check(torch.equal(got, again), f"K1 {label} C={c} {kernel}: two launches "
                      "differ")
                diff = (got[:s] - plain).abs()
                worst = float((diff / (GNN_TOL * (plain.abs() + rms))).max())
                check(worst <= 1.0, f"K1 {label} C={c} {kernel}: off the plain version by "
                      f"{worst} of the bound")
                row[kernel] = {"ms": time_ms(lambda: call(x), dev, reps),
                               "max_abs_err": float(diff.max()), "share_of_tol": worst}
            del got_i, again, diff
        row["bound_ms"], row["bound_by"] = k1_bound(tp, x, got)
        row["streamed_bound_ms"] = k1_streamed_bound(tp, x, got)[0]
        row["library_ms"] = k1_index_add_ms(tp, x, monoids, got, dev, reps)
        row["faster"] = min(k1mod.ROUTES, key=lambda k: row[k]["ms"])
        rows[c] = row
        del xi, x, plain_i, plain, got
        torch.cuda.empty_cache()
    _K1_ROUTES[label] = rows


def k1_ptxas_by_route() -> dict:
    """Registers and spill bytes of each K1 route's kernels from the
    library's ptxas log."""
    from repro_torch.kernels import build

    funcs = build.ptxas_report("segment_sum")["functions"]
    names = {"narrow": ("segment_reduce_kernelI",),
             "wide": ("segment_reduce_kernel_wide", "segment_reduce_wide_fixup")}
    return {route: {name: {key: f.get(key) for key in
                           ("registers", "spill_stores", "spill_loads")}
                    for name, f in funcs.items() if any(sub in name for sub in subs)}
            for route, subs in names.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def khop_features(state, args, dev) -> dict:
    """``khop_aggregate`` on the main k-hop session's plan over integer
    ``[n, GNN_KHOP_D]`` features from a generator of their own: exactly 2
    K1 launches (reset just before, read just after), the result bitwise
    the host index's, column by column; timed."""
    import numpy as np
    import torch

    from repro_torch.models import gnn

    n = state.plan.n
    x = np.random.default_rng(args.seed + 20).integers(0, 100, (n, GNN_KHOP_D))
    xt = torch.from_numpy(x.astype(np.float32)).to(dev)
    before = k1_counts()
    got = gnn.khop_aggregate(state.plan, xt)
    torch.cuda.synchronize(dev)
    launches = k1_since(before)
    check(launches["segment_sum"] == 2,
          f"khop_aggregate made {launches['segment_sum']} K1 launches, not 2")
    check(tuple(got.shape) == (n, GNN_KHOP_D), f"khop_aggregate returned {tuple(got.shape)}")
    got = got.cpu().numpy()
    for j in range(GNN_KHOP_D):
        want = state.index.query(x[:, j], "sum")
        check(np.array_equal(got[:, j].astype(np.float64), want.astype(np.float64)),
              f"khop_aggregate column {j} differs from the host index")
    ms = time_ms(lambda: gnn.khop_aggregate(state.plan, xt), dev, args.reps)
    return {"n": n, "d": GNN_KHOP_D, "k1_launches": launches["segment_sum"], "ms": ms,
            "check": "bitwise the host index, every column"}, launches


def serve_gnn(args, dev, khop) -> tuple:
    """Every GNN case of ``GNN_CASES`` (:func:`gnn_case`), served then
    trained, one after the other, each freed before the next; ``khop`` is
    the k-hop part, run earlier on the main session.  Returns the
    ``serve_gnn`` and ``train_gnn`` lines, the K1 launches of their counted
    runs, those of the training backward alone, K1's backward launch at
    ogbn-products (:func:`kernel_k1_bwd`); launches all and by route
    (``K1_KEYS``, the backward's under ``segment_sum_bwd``)."""
    import torch

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must not run in TF32 (the reference's float32)")
    t_phase = time.perf_counter()
    cases, trains, launches, bwd_launches, k1_bwd = [], [], dict(khop[1]), {}, None
    for arch, shape in GNN_CASES:
        case, k1, train, train_k1, train_bwd, bwd_row = gnn_case(arch, shape, args, dev)
        cases.append(case)
        trains.append(train)
        add_counts(add_counts(launches, k1), train_k1)
        add_counts(bwd_launches, train_bwd)
        k1_bwd = bwd_row or k1_bwd
        torch.cuda.empty_cache()
    mgn = [{"shape": t["shape"], "k1_launches_per_step": t["k1_launches_per_step"],
            "peak_bytes": t["peak_bytes"], "step_ms": t["step_ms"],
            "k1_recompute_ms": t["profile"]["k1_recompute_ms"],
            "remat_host": t["remat_host"]}
           for t in trains if t["arch"] == "meshgraphnet"]
    return ({"cases": cases, "khop_aggregate": khop[0]},
            {"meshgraphnet": mgn, "cases": trains, "seconds": time.perf_counter() - t_phase},
            launches, bwd_launches, k1_bwd)


# ---------------------------------------------------------------------- #
# train_gnn: each GNN case of GNN_CASES trained at full width through
# launch/steps.build_gnn_train at world 1, on the graph, EdgePlan, params
# and features gnn_case built for its forward (nothing built twice)
GNN_TRAIN_STEPS = 5  # steps timed a case (the median of steps 2..5)
# K1 launches a step (two layers; MeshGraphNet a processor step): forward,
# and backward for each layer whose input needs a gradient (GCN's and
# GraphSAGE's first layer reads the features, which need none): the
# transposes of the gathers.  MeshGraphNet's backward also recomputes each
# processor step's forward under its chunked remat: one forward sum more a
# step, counted apart
GNN_K1_BWD_PER_LAYER = {"gcn": 1, "sage": 1, "gat": 4, "meshgraphnet": 2}
GNN_K1_RECOMPUTE_PER_LAYER = {"gcn": 0, "sage": 0, "gat": 0, "meshgraphnet": 1}
# MeshGraphNet's steps with and without remat, alternating, each timed on
# the host by phase
GNN_REMAT_ROUNDS = 6
# step 1 on the kernel route against the plain route (K1's plain version
# under PyTorch's autograd): loss, gnorm, and each gradient element within
# GNN_TRAIN_TOL * (|plain| + rms(plain)) (float32 sums in another order,
# the forward gate's form)
GNN_TRAIN_LOSS_RTOL = 1e-5
GNN_TRAIN_GNORM_RTOL = 1e-4
GNN_TRAIN_TOL = 1e-4
# kernels that add with atomics, by lowercase name substring: none may run
# in a training step (``index_add_``'s ``indexFunc*Index``, the backward of
# ``x[idx]``, ``scatter_add_``; ``ReduceAdd`` is the adding functor of the
# scatter and index kernels, where a gather's is ``TensorAssign``)
GNN_ATOMIC_KERNELS = ("index_add", "indexfunc", "indexing_backward", "scatter_add",
                      "reduceadd")
# the profiled step's device time by kind of kernel, by name substring
GNN_KERNEL_KINDS = (("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                    ("elementwise", ("elementwise",)))
# cases with a train mask of this many nodes (Cora's and ogbn-products'
# public training splits); the sampled subgraph's loss is over its seeds
GNN_TRAIN_NODES = {"full_graph_sm": 140, "ogb_products": 196_615}
# every case's step also runs over a one-device DeviceMesh, but this one's,
# whose host plan (built again for the mesh step) dominates its time
GNN_WORLD1_SKIP = (("graphsage-reddit", "ogb_products"),)


def gnn_train_batch(cfg, shape, dims, n, x, src_t, dst_t, extra, gen, dev) -> dict:
    """The batch ``gnn_loss`` reads, on the case's graph and features:
    labels and a train mask (``GNN_TRAIN_NODES`` seeded nodes; the sampled
    subgraph's ``batch_nodes`` seeds) for the classifiers, float32 node
    targets for MeshGraphNet."""
    import torch

    batch = {"feats": x, "edge_src": src_t, "edge_dst": dst_t}
    if cfg.kind == "gcn":
        batch["edge_w"] = extra["w"]
    if cfg.kind == "meshgraphnet":
        batch["edge_feats"] = extra["ef"]
        batch["targets"] = torch.randn((n, cfg.d_out), generator=gen, device=dev)
        return batch
    batch["labels"] = torch.randint(0, cfg.d_out, (n,), generator=gen, device=dev,
                                    dtype=torch.int32)
    mask = torch.zeros(n, device=dev)
    if shape == "minibatch_lg":
        mask[: dims["batch_nodes"]] = 1.0
    else:
        mask[torch.randperm(n, generator=gen, device=dev)[: GNN_TRAIN_NODES[shape]]] = 1.0
    batch["label_mask"] = mask
    return batch


def _grad_shares(got, want) -> list:
    """For each gradient, the largest share of ``GNN_TRAIN_TOL * (|want| +
    rms(want))`` any of its elements reaches."""
    out = []
    for a, b in zip(got, want):
        rms = b.pow(2).mean().sqrt()
        out.append(float(((a - b).abs() / (GNN_TRAIN_TOL * (b.abs() + rms))).max()))
    return out


def plain_k1_vjp(tp, values, monoids, g):
    """The gradient of :func:`plain_k1`'s sums with respect to ``values``
    under PyTorch's autograd (``index_select``, ``where``, ``index_add_``),
    one chunk of plan rows at a time, the chunks' gradients added in
    order."""
    import torch

    from repro_torch.kernels.segment_reduce.segment_reduce import segment_reduce_plain

    per = max(1, GNN_PLAIN_ROWS // tp.tm)
    nm = tp.seg_tiles.shape[0]
    dv = torch.zeros_like(values)
    for lo in range(0, nm, per):
        hi = min(nm, lo + per)
        with torch.enable_grad():
            v = values.detach().requires_grad_()
            part = segment_reduce_plain(v, tp.gather_padded[lo * tp.tm:hi * tp.tm],
                                        tp.seg_tiles[lo:hi], monoids=tuple(monoids),
                                        num_out_tiles=tp.num_out_tiles, ts=tp.ts)
            (d,) = torch.autograd.grad(part[: tp.num_segments], v, g)
        dv += d
        del part, d
    return dv


_PLAIN_FN = {}  # the autograd Function of the plain routes, made at first use


class RematProbe:
    """Stands in for ``models/gnn.py``'s ``checkpoint``: each chunk's body
    runs under the real one, and each call of it is recorded: whether it
    is the backward's recompute (a body's second call), the index of its
    first K1 launch counted from :meth:`reset`, its K1 launches (and those
    on the wide route) and its host ms."""

    def __init__(self, real):
        self.real, self.calls, self.start = real, [], 0

    def reset(self):
        from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

        self.calls, self.start = [], segment_sum_tiled.launches

    def __call__(self, fn, *args, **kwargs):
        from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

        seen = []

        def body(*a):
            t, before = time.perf_counter(), segment_sum_tiled.launches
            wide = segment_sum_tiled.launches_by_route["wide"]
            try:
                return fn(*a)
            finally:  # a recompute may stop early, by an exception
                self.calls.append({"recompute": bool(seen), "first": before - self.start,
                                   "launches": segment_sum_tiled.launches - before,
                                   "wide": segment_sum_tiled.launches_by_route["wide"] - wide,
                                   "ms": (time.perf_counter() - t) * 1e3})
                seen.append(True)

        return self.real(body, *args, **kwargs)

    def recomputed(self) -> list:
        """The recomputes' K1 launches, by index from :meth:`reset`."""
        return [i for c in self.calls if c["recompute"]
                for i in range(c["first"], c["first"] + c["launches"])]

    def recomputed_wide(self) -> int:
        """The recomputes' K1 launches on the wide route."""
        return sum(c["wide"] for c in self.calls if c["recompute"])


def node_rows_collectives(kind, n_layers) -> tuple:
    """(all-gathers, reduce-scatters) of one node-sharded step: forward, a
    gather of each layer's input rows but the features (every layer's for
    GAT and MeshGraphNet) and a reduce-scatter of each layer's sums;
    backward, the other collective of each pair whose input needs a
    gradient (not GCN's and GraphSAGE's first sums, of the features);
    MeshGraphNet's recomputed forward reissues its pair a step."""
    if kind in ("gcn", "sage"):
        return 2 * (n_layers - 1), 2 * n_layers - 1
    if kind == "gat":
        return 2 * n_layers, 2 * n_layers
    return 3 * n_layers, 3 * n_layers


def _plain_route(pinned: bool):
    """K1's sums on a plain route of a training step, where autograd
    records: forward K1's result (``pinned``: both routes then differentiate
    at the same point) or :func:`plain_k1`'s; backward :func:`plain_k1_vjp`.
    Elsewhere (GAT's max on detached scores) K1's result."""
    import torch

    from repro_torch.kernels.segment_reduce.ops import segment_reduce_multi

    if "fn" not in _PLAIN_FN:
        class PlainK1(torch.autograd.Function):
            @staticmethod
            def forward(ctx, v, plan, m, pin):
                ctx.save_for_backward(v)
                ctx.plan, ctx.m = plan, m
                return segment_reduce_multi(plan, v, m) if pin else plain_k1(plan, v, m)

            @staticmethod
            def backward(ctx, g):
                (v,) = ctx.saved_tensors
                return plain_k1_vjp(ctx.plan, v, ctx.m, g.contiguous()), None, None, None

        _PLAIN_FN["fn"] = PlainK1

    def fn(tp, values, monoids):
        if torch.is_grad_enabled() and values.requires_grad:
            return _PLAIN_FN["fn"].apply(values, tp, tuple(monoids), pinned)
        return segment_reduce_multi(tp, values, monoids)

    return fn


def gnn_train_case(arch, shape, cfg, plan, params, batch, n, e, args, dev) -> tuple:
    """One GNN case trained at world 1 (``build_gnn_train(cfg, None,
    dims)``): the source-sorted layout built and timed; step 1's loss and
    gradients on the kernel route with K1's forward and backward launches
    counted (reset just before, read just after); the same on the plain
    route; step 1 twice from the same state, bitwise; ``GNN_TRAIN_STEPS``
    steps timed with the peak memory; one step profiled (K1 forward and
    backward, cuBLAS, elementwise, the rest, the idle share; no atomic-add
    kernel).  Returns the case's line and its counted K1 launches."""
    import math
    from unittest import mock

    import torch

    from repro_torch.configs.registry import GNN_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.optim.optimizers import _global_norm
    from repro_torch.tree import leaves, unflatten

    dims = GNN_SHAPES[shape].dims
    built = steps.build_gnn_train(cfg, None, dims, torch_device=dev)
    opt0 = steps.gnn_optimizer().init(params)
    t = time.perf_counter()
    plan.source()
    torch.cuda.synchronize(dev)
    layout_s = time.perf_counter() - t

    live = [p.detach().requires_grad_() for p in leaves(params)]
    probe = RematProbe(gnn.checkpoint)
    with mock.patch.object(gnn, "checkpoint", probe):
        probe.reset()
        before = k1_counts()
        loss = steps.gnn_loss(unflatten(params, live), batch, cfg, n, plan=plan)
        torch.cuda.synchronize(dev)
        fwd = k1_since(before)
        grads = torch.autograd.grad(loss, live)
        torch.cuda.synchronize(dev)
    step = k1_since(before)
    rec = len(probe.recomputed())
    # by route: the forward's, the recomputes' (the probe's), the backward's
    rec_wide = probe.recomputed_wide()
    routes = {"forward": {"narrow": fwd["segment_sum_narrow"], "wide": fwd["segment_sum_wide"]},
              "recompute": {"narrow": rec - rec_wide, "wide": rec_wide}}
    routes["backward"] = {r: step[f"segment_sum_{r}"] - fwd[f"segment_sum_{r}"]
                          - routes["recompute"][r] for r in ("narrow", "wide")}
    fwd = fwd["segment_sum"]
    bwd = step["segment_sum"] - fwd - rec
    bwd_layers = cfg.n_layers - 1 if cfg.kind in ("gcn", "sage") else cfg.n_layers
    want = (GNN_K1_PER_LAYER[cfg.kind] * cfg.n_layers,
            GNN_K1_RECOMPUTE_PER_LAYER[cfg.kind] * cfg.n_layers,
            GNN_K1_BWD_PER_LAYER[cfg.kind] * bwd_layers)
    check((fwd, rec, bwd) == want, f"{arch} at {shape}: K1 launches a step (forward, "
          f"recomputed forward, backward) {(fwd, rec, bwd)}, not {want}")
    loss = loss.detach()
    gnorm = float(_global_norm(list(grads)))
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads),
          f"{arch} at {shape}: step 1's loss or gradients not finite")
    # the plain route: the same forward sums (K1's), each differentiated as
    # K1's plain version under PyTorch's autograd, the gathers through
    # index_select's own backward (with K1's plain version in the forward
    # too, the two forwards round their sums differently, and through
    # MeshGraphNet's 15 residual steps, whose activations reach ~1e3, the
    # gradients of the early steps part by several times the bound: the
    # free plain route below is read, not gated)
    with mock.patch.object(gnn, "_record", lambda *ts: False), \
            mock.patch.object(gnn, "segment_reduce_multi", _plain_route(pinned=True)):
        p_loss, p_grads = steps.gnn_value_and_grad(params, batch, cfg, n, plan)
        torch.cuda.synchronize(dev)
    p_gnorm = float(_global_norm(p_grads))
    p_grads = leaves(p_grads)
    loss_rel = abs(float(loss) - float(p_loss)) / abs(float(p_loss))
    gnorm_rel = abs(gnorm - p_gnorm) / p_gnorm
    shares = _grad_shares(grads, p_grads)
    worst = max(shares)
    check(loss_rel <= GNN_TRAIN_LOSS_RTOL, f"{arch} at {shape}: loss {float(loss)} against "
          f"the plain route's {float(p_loss)}")
    check(gnorm_rel <= GNN_TRAIN_GNORM_RTOL, f"{arch} at {shape}: gnorm {gnorm} against "
          f"the plain route's {p_gnorm}")
    check(worst <= 1.0, f"{arch} at {shape}: a gradient off the plain route's by "
          f"{shares} of the bound")
    del p_grads
    # the free plain route: K1's plain version in the forward too; its loss
    # within GNN_TRAIN_LOSS_RTOL, its gradients read beside
    with mock.patch.object(gnn, "_record", lambda *ts: False), \
            mock.patch.object(gnn, "segment_reduce_multi", _plain_route(pinned=False)):
        f_loss, f_grads = steps.gnn_value_and_grad(params, batch, cfg, n, plan)
        torch.cuda.synchronize(dev)
    f_loss_rel = abs(float(loss) - float(f_loss)) / abs(float(f_loss))
    check(f_loss_rel <= GNN_TRAIN_LOSS_RTOL, f"{arch} at {shape}: loss {float(loss)} "
          f"against the free plain route's {float(f_loss)}")
    free = {"loss": float(f_loss), "loss_rel": f_loss_rel,
            "gnorm_rel": abs(gnorm - float(_global_norm(f_grads))) / p_gnorm,
            "grad_share_of_tol_by_leaf": _grad_shares(grads, leaves(f_grads))}
    del f_grads
    # bitwise repeat: gradients, then the whole step twice from one state
    again = steps.gnn_value_and_grad(params, batch, cfg, n, plan)
    check(torch.equal(again[0], loss) and all(torch.equal(a, b) for a, b in
                                             zip(leaves(again[1]), grads)),
          f"{arch} at {shape}: two step-1 gradients differ")
    del again
    first = built.fn(params, opt0, batch, plan=plan)
    second = built.fn(params, opt0, batch, plan=plan)
    torch.cuda.synchronize(dev)
    check(all(torch.equal(a, b) for a, b in zip(leaves(first), leaves(second))),
          f"{arch} at {shape}: two step 1s from one state differ")
    check(torch.equal(first[2]["loss"], loss), f"{arch} at {shape}: the step's loss is "
          "not its gradients' loss")
    del second
    world1 = world1_mesh_step(cfg, dims, params, opt0, batch, first, built, plan, dev) \
        if (arch, shape) not in GNN_WORLD1_SKIP else None
    # GNN_TRAIN_STEPS steps, each timed to its synchronize
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    p, o, history = params, opt0, []
    for _ in range(GNN_TRAIN_STEPS):
        t = time.perf_counter()
        p, o, out = built.fn(p, o, batch, plan=plan)
        torch.cuda.synchronize(dev)
        history.append({"ms": (time.perf_counter() - t) * 1e3, "loss": float(out["loss"]),
                        "gnorm": float(out["gnorm"])})
    peak = torch.cuda.max_memory_allocated(dev)
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["gnorm"]) for h in history),
          f"{arch} at {shape}: a step's loss or gnorm is not finite")
    step_ms = statistics.median(h["ms"] for h in history[1:])
    with mock.patch.object(gnn, "checkpoint", probe):
        prof = device_profile(lambda: (probe.reset(), built.fn(p, o, batch, plan=plan)),
                              dev, step_ms, match=(K1_EVENT,), names=True)
    recomputed = set(probe.recomputed())
    k1 = prof["matched"][K1_EVENT]
    check(k1["launches"] == fwd + rec + bwd and len(recomputed) == rec,
          f"{arch} at {shape}: the profiled step ran K1 {k1['launches']} times, "
          f"{len(recomputed)} of them recomputing")
    atomics = [k for k in prof["names"] if any(a in k.lower() for a in GNN_ATOMIC_KERNELS)]
    check(not atomics, f"{arch} at {shape}: the step launched atomic-add kernels {atomics}")
    by_kind = {name: sum(ms for key, ms in prof["names"].items()
                         if any(s in key.lower() for s in subs))
               for name, subs in GNN_KERNEL_KINDS}
    k1_fwd_ms = sum(k1["by_launch_ms"][:fwd])
    k1_rec_ms = sum(k1["by_launch_ms"][i] for i in sorted(recomputed))
    k1_bwd_by_launch = [ms for i, ms in enumerate(k1["by_launch_ms"])
                        if i >= fwd and i not in recomputed]
    k1_bwd_ms = sum(k1_bwd_by_launch)
    device_ms = prof["device_ms"]
    remat = remat_host_cost(cfg, params, opt0, batch, plan, n, dev) \
        if GNN_K1_RECOMPUTE_PER_LAYER[cfg.kind] else None
    return {
        "arch": arch, "shape": shape, "n": n, "edges": e, "steps": GNN_TRAIN_STEPS,
        "source_layout_s": layout_s, "source_layout_bytes": plan.source_nbytes(),
        "plan_bytes": plan.plan_nbytes(),
        "k1_launches_per_step": {"forward": fwd, "recompute": rec, "backward": bwd},
        "k1_launches_by_route": routes,
        "step1": {"loss": float(loss), "plain_loss": float(p_loss), "loss_rel": loss_rel,
                  "gnorm": gnorm, "plain_gnorm": p_gnorm, "gnorm_rel": gnorm_rel,
                  "grad_share_of_tol": worst, "grad_share_of_tol_by_leaf": shares,
                  "tol": f"{GNN_TRAIN_TOL} * (|plain| + rms(plain))",
                  "free_plain_route": free},
        "bitwise_repeat": True, "atomic_kernels": atomics, "world1_mesh": world1,
        "step_ms": step_ms, "step_ms_all": [h["ms"] for h in history],
        "losses": [h["loss"] for h in history], "gnorms": [h["gnorm"] for h in history],
        "nodes_per_s": n / step_ms * 1e3, "edges_per_s": e / step_ms * 1e3,
        "peak_bytes": peak, "remat_host": remat,
        "profile": {"device_ms": device_ms, "device_idle_share": prof["device_idle_share"],
                    "k1_forward_ms": k1_fwd_ms, "k1_recompute_ms": k1_rec_ms,
                    "k1_backward_ms": k1_bwd_ms,
                    "k1_wide_fixup_ms": k1["fixup_ms"],
                    **{f"{name}_ms": ms for name, ms in by_kind.items()},
                    "other_ms": (device_ms - k1_fwd_ms - k1_rec_ms - k1_bwd_ms
                                 - sum(by_kind.values())
                                 if isinstance(device_ms, float) else "not measured"),
                    "k1_backward_by_launch_ms": k1_bwd_by_launch,
                    "top_device_events": prof["top_device_events"][:6]},
    }, step, {"segment_sum_bwd": bwd, "segment_sum_bwd_narrow": routes["backward"]["narrow"],
              "segment_sum_bwd_wide": routes["backward"]["wide"]}


def world1_mesh_step(cfg, dims, params, opt0, batch, one_card, built, plan, dev) -> dict:
    """The step over a one-device ``DeviceMesh`` (NCCL, a world of one
    started here and ended after): the batch cut by its specs, its own
    plan built; then the one-card step ``built`` on ``plan`` with that
    world's group, which takes the node-sharded path (NCCL's all-gathers
    and reduce-scatters, counted against :func:`node_rows_collectives`).
    Every result of both bitwise ``one_card``'s (the ``mesh=None`` step
    from the same state)."""
    import dataclasses
    from unittest import mock

    import torch
    import torch.distributed as dist

    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import gnn
    from repro_torch.tree import leaves

    counts = {"all_gather": 0, "reduce_scatter": 0}

    def counted(name, real):
        def call(x, rows):
            counts[name] += 1
            return real(x, rows)
        return call

    started = not dist.is_initialized()
    try:
        mesh = make_debug_mesh(1, 1, dev.type)
        got = steps.build_gnn_train(cfg, mesh, dims, torch_device=dev).run(
            params, opt0, batch)
        check(all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(one_card))),
              f"{cfg.name}: the world-1 mesh step differs from the one-card step")
        with mock.patch.object(gnn, "_all_gather", counted("all_gather", gnn._all_gather)), \
                mock.patch.object(gnn, "_reduce_scatter",
                                  counted("reduce_scatter", gnn._reduce_scatter)):
            got = built.fn(params, opt0, batch,
                           plan=dataclasses.replace(plan, group=dist.group.WORLD))
            torch.cuda.synchronize(dev)
        want = node_rows_collectives(cfg.kind, cfg.n_layers)
        check(tuple(counts.values()) == want, f"{cfg.name}: the node-sharded step issued "
              f"{counts} all-gathers and reduce-scatters, not {want}")
        check(all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(one_card))),
              f"{cfg.name}: the node-sharded step over a world of one differs from the "
              "one-card step")
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return {"mesh": "bitwise the one-card step",
            "node_rows": "bitwise the one-card step", "collectives": counts}


def remat_host_cost(cfg, params, opt0, batch, plan, n, dev) -> dict:
    """MeshGraphNet's step with its remat and without (``checkpoint``
    replaced by a plain call), ``GNN_REMAT_ROUNDS`` rounds alternating:
    each step split on the host's clock into forward, backward and
    optimizer (a synchronize at each end), the recomputed chunks' host ms
    (:class:`RematProbe`), the garbage collector's ms and collections
    (``gc.callbacks``) and the peak memory; the medians of each, and each
    step's ms."""
    import gc
    from unittest import mock

    import torch

    from repro_torch.launch import steps
    from repro_torch.models import gnn
    from repro_torch.tree import leaves, unflatten

    opt = steps.gnn_optimizer()
    probe = RematProbe(gnn.checkpoint)
    variants = {"remat": probe, "no_remat": lambda fn, *a, **kw: fn(*a)}
    collected, since = {"ms": 0.0, "count": 0}, [0.0]

    def on_gc(phase, info):
        if phase == "start":
            since[0] = time.perf_counter()
        else:
            collected["ms"] += (time.perf_counter() - since[0]) * 1e3
            collected["count"] += 1

    runs = {name: [] for name in variants}
    gc.callbacks.append(on_gc)
    try:
        for _ in range(GNN_REMAT_ROUNDS):
            for name, ckpt in variants.items():
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                probe.reset()
                collected.update(ms=0.0, count=0)
                live = [p.detach().requires_grad_() for p in leaves(params)]
                with mock.patch.object(gnn, "checkpoint", ckpt):
                    t0 = time.perf_counter()
                    loss = steps.gnn_loss(unflatten(params, live), batch, cfg, n, plan=plan)
                    torch.cuda.synchronize(dev)
                    t1 = time.perf_counter()
                    grads = torch.autograd.grad(loss, live)
                    torch.cuda.synchronize(dev)
                    t2 = time.perf_counter()
                opt.update(unflatten(params, list(grads)), opt0, params)
                torch.cuda.synchronize(dev)
                t3 = time.perf_counter()
                runs[name].append({
                    "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
                    "update_ms": (t3 - t2) * 1e3, "step_ms": (t3 - t0) * 1e3,
                    "recompute_host_ms": sum(c["ms"] for c in probe.calls if c["recompute"]),
                    "gc_ms": collected["ms"], "gc_collections": collected["count"],
                    "peak_bytes": torch.cuda.max_memory_allocated(dev)})
                del loss, grads, live
    finally:
        gc.callbacks.remove(on_gc)
    out = {name: {key: statistics.median(r[key] for r in rs) for key in rs[0]}
           for name, rs in runs.items()}
    out["remat_minus_no_remat_ms"] = {
        key: out["remat"][key] - out["no_remat"][key]
        for key in ("forward_ms", "backward_ms", "update_ms", "step_ms", "gc_ms")}
    out["step_ms_all"] = {name: [r["step_ms"] for r in rs] for name, rs in runs.items()}
    out["rounds"] = GNN_REMAT_ROUNDS
    return out


def kernel_k1_bwd(plan, n, args, dev) -> dict:
    """K1 as its own backward at ogbn-products' layer 2 (C = 128): one
    launch on the source-sorted layout's ``by_src_dst`` over a seeded
    ``[n, 128]`` upstream gradient, against K1's plain version (chunked,
    as ``plain_k1``) within ``GNN_TOL`` * (|plain| + rms), bitwise across
    two launches, both on the route table's route; timed beside the plain
    version, ``index_add_`` on the launch's gathered rows, its bound and
    its streamed bound."""
    import torch

    from repro_torch.kernels.segment_reduce.ops import segment_reduce_multi
    from repro_torch.kernels.segment_reduce.segment_reduce import route, segment_sum_tiled

    tp = plan.source()[1]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 35)
    dout = torch.randn((n, 128), generator=gen, device=dev)
    monoids = (128, 0, 0)
    name, before = route(128), dict(segment_sum_tiled.launches_by_route)
    got = segment_reduce_multi(tp, dout, monoids)
    check(torch.equal(got, segment_reduce_multi(tp, dout, monoids)),
          "K1's backward launch differs across two launches")
    check(segment_sum_tiled.launches_by_route == {**before, name: before[name] + 2},
          f"K1's backward launches took {segment_sum_tiled.launches_by_route}, not {name}")
    plain = plain_k1(tp, dout, monoids)
    rms = plain.pow(2).mean().sqrt()
    diff = (got - plain).abs()
    worst = float((diff / (GNN_TOL * (plain.abs() + rms))).max())
    check(worst <= 1.0, f"K1's backward launch off its plain version by {worst} of the bound")
    reps = max(3, args.reps // 4)
    ms = time_ms(lambda: segment_reduce_multi(tp, dout, monoids), dev, reps)
    plain_ms = time_ms(lambda: plain_k1(tp, dout, monoids), dev, 2)
    bound, by = k1_bound(tp, dout, got)
    streamed = k1_streamed_bound(tp, dout, got)[0]
    err = float(diff.max())
    del plain, diff
    torch.cuda.empty_cache()
    lib_ms = k1_index_add_ms(tp, dout, monoids, got, dev, reps)
    torch.cuda.empty_cache()
    return {"shape": "ogb_products layer 2", "rows": int((tp.seg_tiles >= 0).sum()),
            "columns": 128, "route": name, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "streamed_bound_ms": streamed,
            "library_ms": lib_ms, "max_abs_err": err, "share_of_tol": worst}


# ---------------------------------------------------------------------- #
# gwq: the paper's two-pass data plane (launch/steps.build_gwq_step) on one
# card at query_lj's full dims (LiveJournal: n 3,997,962, nb 2,000,000,
# m 53,437,500 member rows, l 6,000,000 link rows) on a seeded plan:
# members drawn uniformly over the blocks and the vertices, links over the
# owners and the blocks, integer attributes in [0, 100)
GWQ_SHAPE = "query_lj"
# not run on the card: query_orkut (the same data plane, 2.3x the member
# rows; the phase's time), query_1b (1e9 member rows: 8 GB of index arrays
# and minutes of host plan build), query_1b_part (boundary_frac needs a
# world above 1)
GWQ_REDUCED = {"query_orkut": "the run's time (124.8 M member rows, 2.3x query_lj's)",
               "query_1b": "1e9 member rows: 8 GB of index arrays, minutes of host plan",
               "query_1b_part": "its boundary_frac split needs a world above 1"}


def gwq_rows(dims, rng):
    """(p1g, p1s, p2g, p2s, vals) at ``dims``: each pass's rows sorted by
    segment, padded to a multiple of 128 with segment -1."""
    import numpy as np

    n, nb, m, l = dims["n"], dims["nb"], dims["m"], dims["l"]

    def rows(count, n_seg, n_src):
        seg = np.repeat(np.arange(n_seg, dtype=np.int32),
                        np.bincount(rng.integers(0, n_seg, count), minlength=n_seg))
        pad = (-count) % 128
        return (np.concatenate([rng.integers(0, n_src, count, dtype=np.int32),
                                np.zeros(pad, np.int32)]),
                np.concatenate([seg, np.full(pad, -1, np.int32)]))

    p1g, p1s = rows(m, nb, n)
    p2g, p2s = rows(l, n, nb)
    return p1g, p1s, p2g, p2s, rng.integers(0, 100, n).astype(np.float32)


def gwq_phase(args, dev) -> tuple:
    """``build_gwq_step`` at ``GWQ_SHAPE``'s full dims on one card: the
    host plan built and timed, the step's two K1 launches counted (reset
    just before, read just after), the result bitwise NumPy's int64 sums
    of the two passes, each pass's K1 timed against its bound and
    ``index_add_``, the whole step timed.  Returns the line and the
    launches."""
    import numpy as np
    import torch

    from repro_torch.configs.paper_gwq import SHAPES
    from repro_torch.kernels.segment_reduce.ops import segment_sum
    from repro_torch.launch import steps

    t_phase = time.perf_counter()
    dims = SHAPES[GWQ_SHAPE].dims
    rng = np.random.default_rng(args.seed + 40)
    t = time.perf_counter()
    rows = gwq_rows(dims, rng)
    rows_s = time.perf_counter() - t
    built = steps.build_gwq_step(dims, None, torch_device=dev)
    pieces = built.shard(*rows)
    t = time.perf_counter()
    plans = built.plan(*pieces)
    torch.cuda.synchronize(dev)
    plan_s = time.perf_counter() - t
    before = k1_counts()
    got = built.fn(*pieces, plan=plans)
    torch.cuda.synchronize(dev)
    launches = k1_since(before)
    check(launches["segment_sum"] == 2,
          f"gwq made {launches['segment_sum']} K1 launches, not 2")
    p1g, p1s, p2g, p2s, vals = rows
    ok1, ok2 = p1s >= 0, p2s >= 0
    t_host = np.bincount(p1s[ok1], weights=vals[p1g[ok1]], minlength=dims["nb"])
    want = np.bincount(p2s[ok2], weights=t_host[p2g[ok2]], minlength=dims["n"])
    check(tuple(got.shape) == (dims["n"],) and
          np.array_equal(got.cpu().numpy().astype(np.float64), want),
          "gwq differs from NumPy's int64 sums")
    reps = max(3, args.reps // 4)
    vals_t, t_dev = pieces[4], segment_sum(plans[0], pieces[4])
    passes = {}
    for name, tp, x in (("pass1", plans[0], vals_t), ("pass2", plans[1], t_dev)):
        x2 = x[:, None].contiguous()
        out = segment_sum(tp, x)
        bound, by = k1_bound(tp, x2, out[:, None])
        passes[name] = {"rows": int((tp.seg_tiles >= 0).sum()), "segments": tp.num_segments,
                        "ms": time_ms(lambda tp=tp, x=x: segment_sum(tp, x), dev, reps),
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": k1_index_add_ms(tp, x2, (1, 0, 0), out[:, None],
                                                      dev, reps)}
        torch.cuda.empty_cache()
    step_ms = time_ms(lambda: built.fn(*pieces, plan=plans), dev, reps)
    plan_bytes = sum(tp.plan_nbytes() for tp in plans)
    del plans, pieces, got, t_dev
    torch.cuda.empty_cache()
    return {"shape": GWQ_SHAPE, "dims": dict(dims), "world": 1,
            "reduced": GWQ_REDUCED, "rows_s": rows_s, "plan_s": plan_s,
            "plan_bytes": plan_bytes, "k1_launches": launches["segment_sum"],
            "check": "bitwise NumPy's int64 sums", "step_ms": step_ms, "passes": passes,
            "seconds": time.perf_counter() - t_phase}, launches


# ---------------------------------------------------------------------- #
# train: the training path on the card (build_trainer(..., smoke=False)),
# after serve_gnn and before the cluster tier, the card's memory freed on
# either side.  qwen3-0.6b at full width and depth (28 layers, d 1024,
# vocab 151,936, remat) at train_4k's length, S = 4096, its batch cut from
# 256 to 8 (2 microbatches of 4) by the run's time; the FM at full width
# (80.31 M rows) at train_batch's B = 65,536; qwen2-moe-a2.7b at full width
# with its depth cut to 2 of 24 layers (full depth holds 28.6 GB of bf16
# weights, and float32 masters, gradients and AdamW moments would not fit
# on one card), B x S = 4 x 2048
TRAIN_LM = dict(arch="qwen3-0.6b", batch=4, microbatch=2, seq=4096, steps=6)
TRAIN_FM = dict(batch=65536, steps=5)
TRAIN_MOE = dict(arch="qwen2-moe-a2.7b", depth=2, batch=4, seq=2048, steps=2)
# (name, B, Hq, Hkv, S, D, dtype): K3's backward at qwen3's and qwen2-moe's
# training shapes (one microbatch) and at one float32 shape
K3_BWD_SHAPES = (("qwen3_train", 4, 16, 8, 4096, 64, "bfloat16"),
                 ("moe_train", 4, 16, 16, 2048, 128, "bfloat16"),
                 ("float32", 2, 4, 2, 1000, 128, "float32"))
# the route each dtype of K3_BWD_SHAPES must take, and each route's source
K3_BWD_ROUTE = {"bfloat16": "sm90", "float32": "simt"}
K3_BWD_SOURCE = {"sm90": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
                 "simt": "src/repro_torch/csrc/flash_attention_bwd.cu"}
K4_BWD_SHAPE = (65536, 39, 10)  # train_batch's B, the FM's F and K
# gates: float32 each element within 1e-4 (|plain| + rms(plain)); bf16 a
# relative L2 error of at most 2e-2 a tensor (the kernel's p is exact where
# the plain version's forward rounds o to bf16 before autograd sees it);
# the step's loss and gnorm on the kernel route against the plain route
# (flash_torch under autograd) on the same params and batch
TRAIN_BF16_REL_L2 = 2e-2
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GNORM_RTOL = 2e-2
TRAIN_RESUME_RTOL = 1e-6
TRAIN_FM_LOSS_RTOL = 1e-5


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _f32_close(got, want):
    """(ok, largest share of the gate): each element within 1e-4 (|plain|
    + rms(plain))."""
    rms = want.float().square().mean().sqrt()
    share = (got.float() - want.float()).abs() / (1e-4 * (want.float().abs() + rms))
    return bool((share <= 1).all()), float(share.max())


def kernel_flash_attention_bwd(dev, reps, seed):
    """K3's backward kernel against autograd through ``flash_torch`` on the
    same q, k, v, o and dO (unit normals) at ``K3_BWD_SHAPES``: bf16 a
    relative L2 error of at most ``TRAIN_BF16_REL_L2`` for each of dq, dk,
    dv, float32 within 1e-4 (|plain| + rms(plain)); bitwise across two
    launches; timed beside the plain backward, SDPA's backward through
    ``torch.autograd`` (its forward run once, outside the timing) and the
    bound: five causal products (q k^T, dO v^T, p^T dO, ds^T q, ds k) at
    the bf16 or float32 peak against the bytes of q, k, v, o, dO read and
    dq, dk, dv written."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa

    report = k3_bwd_build_report()
    gen = torch.Generator(device=dev).manual_seed(seed + 30)
    per_shape, worst = {}, 0.0
    for name, b, hq, hkv, s, d, dt in K3_BWD_SHAPES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))
        do = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
        o = fa.flash_attention(q, k, v)
        path = fa.bwd_route(dtype, d)
        check(path == K3_BWD_ROUTE[dt], f"K3 bwd {name}: routed to {path}, not "
              f"{K3_BWD_ROUTE[dt]}")
        before = dict(fa.flash_attention_bwd.launches_by_route)
        got = fa.flash_attention_bwd(q, k, v, o, do)
        again = fa.flash_attention_bwd(q, k, v, o, do)
        check(fa.flash_attention_bwd.launches_by_route == {**before, path: before[path] + 2},
              f"K3 bwd {name}: the two calls did not take the {path} route")
        plain = fa.flash_attention_bwd_plain(q, k, v, do)
        torch.cuda.synchronize(dev)
        errs = {}
        for x, y, w, t in zip(got, again, plain, ("dq", "dk", "dv")):
            check(torch.equal(x, y), f"K3 bwd {name}: two launches differ in {t}")
            check(bool(torch.isfinite(x).all()) and float(x.float().abs().sum()) > 0,
                  f"K3 bwd {name}: {t} non-finite or zero")
            if dtype == torch.bfloat16:
                err = _rel_l2(x, w)
                check(err <= TRAIN_BF16_REL_L2, f"K3 bwd {name}: {t} relative L2 {err}")
            else:
                ok, err = _f32_close(x, w)
                check(ok, f"K3 bwd {name}: {t} off its plain version ({err} of the gate)")
            errs[t] = err
            worst = max(worst, float((x.float() - w.float()).abs().max()))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)

        def lib():
            return torch.autograd.grad(sdpa, (qg, kg, vg), do, retain_graph=True)
        lib_err = max(_rel_l2(x, w) for x, w in zip(lib(), plain))
        flops = 5 * b * hq * d * s * (s + 1)
        b_ms, by = bound_ms(nbytes(q, k, v, o, do, *got), flops,
                            BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S)
        ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, do), dev, reps)
        lib_ms = time_ms(lib, dev, reps)
        per_shape[name] = {
            "b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "dtype": dt, "route": path,
            "source": K3_BWD_SOURCE[path], "errors": errs, "max_abs_err": float(max((x.float() - w.float()).abs().max()
                                                     for x, w in zip(got, plain))),
            "library_rel_l2_vs_plain": lib_err,
            "ms": ms, "plain_ms": time_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, do),
                                          dev, 3),
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
            "tflops_of_five_products": flops / ms / 1e9,
            "ms_over_library": ms / lib_ms, "ms_over_bound": ms / b_ms,
        }
        del q, k, v, o, do, got, again, plain, qg, kg, vg, sdpa
        torch.cuda.empty_cache()
    return per_shape, worst, report


def k3_bwd_build_report():
    """What the builds of K3's two backward routes say: the tensor-core
    route's registers and spills per kernel from its ptxas log (0 spill
    bytes, setmaxnreg honoured, checked) and its count of HGMMA (wgmma)
    instructions in the SASS (checked > 0); the CUDA-core route's ptxas
    report."""
    from repro_torch.kernels import build

    rep = build.ptxas_report("flash_attention_bwd_sm90")
    check(len(rep["functions"]) == 6, "K3 bwd sm90: the ptxas log does not list the "
          f"three kernels at D = 64 and 128 ({list(rep['functions'])})")
    for fn, r in rep["functions"].items():
        check(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0,
              f"K3 bwd sm90: {fn} spills ({r})")
    check(rep["setmaxnreg_ignored"] == 0, "K3 bwd sm90: ptxas ignored setmaxnreg")
    hgmma = build.sass("flash_attention_bwd_sm90").count("HGMMA")
    check(hgmma > 0, "K3 bwd sm90: no HGMMA in the SASS")
    return {"sm90": {**rep, "sass_hgmma": hgmma},
            "simt": build.ptxas_report("flash_attention_bwd")}


def kernel_fm_interaction_bwd(dev, reps, seed):
    """K4's backward kernel against autograd through the oracle at
    ``K4_BWD_SHAPE``: each element within 1e-5 of |g| (sum_f |e| + |e|)
    (float32 sums in another order); bitwise across two launches; timed
    beside the plain version and the bound (bytes: emb and g read once,
    the gradient written once)."""
    import torch

    from repro_torch.kernels.fm_interaction import fm_interaction as fm

    b, f, k = K4_BWD_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    emb = torch.randn((b, f, k), generator=gen, device=dev)
    g = torch.randn((b,), generator=gen, device=dev)
    got, again = fm.fm_interaction_bwd(emb, g), fm.fm_interaction_bwd(emb, g)
    plain = fm.fm_interaction_bwd_plain(emb, g)
    torch.cuda.synchronize(dev)
    check(torch.equal(got, again), "K4 bwd: two launches differ")
    mass = g.abs()[:, None, None] * (emb.abs().sum(1, keepdim=True) + emb.abs())
    diff = (got - plain).abs()
    check(bool((diff <= 1e-5 * mass + 1e-30).all()), f"K4 bwd: off by {float(diff.max())}")
    b_ms, by = bound_ms(nbytes(emb, g, got), 2 * emb.numel())
    return {"b": b, "f": f, "k": k, "max_abs_err": float(diff.max()),
            "ms": time_ms(lambda: fm.fm_interaction_bwd(emb, g), dev, reps),
            "plain_ms": time_ms(lambda: fm.fm_interaction_bwd_plain(emb, g), dev, reps),
            "library_ms": None, "bound_ms": b_ms, "bound_by": by}


def _train_counts():
    """The training kernels' counters, by name."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.fm_interaction import fm_interaction as fm

    return {"flash_attention": fa.flash_attention, "flash_attention_bwd": fa.flash_attention_bwd,
            "fm_interaction": fm.fm_interaction, "fm_interaction_bwd": fm.fm_interaction_bwd}


def _reset_counts() -> None:
    from repro_torch.kernels.flash_attention import flash_attention as fa

    for fn in _train_counts().values():
        fn.launches = 0
    fa.flash_attention_bwd.launches_by_route.update(sm90=0, simt=0)


def _read_counts() -> dict:
    """The counters of ``_train_counts``, and K3's backward calls by route
    as ``flash_attention_bwd_sm90`` and ``flash_attention_bwd_simt``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    counts = {name: fn.launches for name, fn in _train_counts().items()}
    for route, n in fa.flash_attention_bwd.launches_by_route.items():
        counts[f"flash_attention_bwd_{route}"] = n
    return counts


def _first_step(loss_fn, params, stream, microbatch, dev):
    """(loss, gnorm, grads) of a trainer's first step by hand: the mean
    over ``microbatch`` batches of ``stream`` and the global norm of the
    averaged float32 gradients (what AdamW reports before clipping)."""
    import numpy as np
    import torch

    from repro_torch.optim.optimizers import _global_norm
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import leaves, unflatten

    loss_sum, acc = 0.0, None
    for _ in range(microbatch):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in stream.next().items()}
        loss, grads = value_and_grad(loss_fn, params, batch)
        loss_sum += float(loss)
        g = leaves(grads)
        acc = g if acc is None else [a + x for a, x in zip(acc, g)]
        del grads, g
    grads = unflatten(params, [a / microbatch for a in acc])
    return loss_sum / microbatch, float(_global_norm(grads)), grads


def _median_step_ms(history):
    import statistics

    return statistics.median(h["dt"] for h in history[1:]) * 1e3


def train_lm(args, dev) -> dict:
    """qwen3-0.6b at full width and depth: its first step by hand on the
    kernel route and on the plain route (``attn_backend="flash_torch"``, the
    same params and batches): loss within ``TRAIN_LOSS_RTOL``, gnorm within
    ``TRAIN_GNORM_RTOL``, and every layer's wq, wk and wv gradient nonzero
    and within ``TRAIN_BF16_REL_L2`` (relative L2); then ``Trainer.run``
    for ``TRAIN_LM["steps"]`` steps (K3's counts reset just before, read
    just after: two forward launches a layer and microbatch, the step's
    and the remat recompute's, and one backward call), its first loss and
    gnorm those of the step by hand (rtol 1e-6), a checkpoint at the
    midpoint into a temporary directory; a fresh trainer resumes from it
    and its losses equal the uninterrupted run's at ``TRAIN_RESUME_RTOL``;
    one more step under ``torch.profiler``."""
    import math
    import shutil
    import tempfile

    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import transformer as T

    p = TRAIN_LM
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def make():
            tr = build_trainer(p["arch"], smoke=False, batch=p["batch"], seq=p["seq"],
                               steps=p["steps"], microbatch=p["microbatch"], ckpt_dir=ckpt,
                               torch_device=dev)
            tr.cfg.checkpoint_every = p["steps"] // 2  # the midpoint's checkpoint
            return tr

        t = time.perf_counter()
        tr = make()
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t
        cfg = get_cfg(p["arch"])

        def stream():
            return TokenStream(vocab=cfg.vocab, batch=p["batch"], seq=p["seq"])

        _reset_counts()
        k_loss, k_gnorm, k_grads = _first_step(lambda q, b: T.loss_fn(q, b, cfg), tr.params,
                                               stream(), p["microbatch"], dev)
        by_hand_counts = _read_counts()
        check(by_hand_counts["flash_attention_bwd"] == cfg.n_layers * p["microbatch"]
              == by_hand_counts["flash_attention_bwd_sm90"],
              f"the step by hand made {by_hand_counts} K3 backward calls (all sm90 expected)")
        kernel_qkv = [{w: lp[w] for w in ("wq", "wk", "wv")} for lp in k_grads["layers"]]
        del k_grads
        p_loss, p_gnorm, p_grads = _first_step(
            lambda q, b: T.loss_fn(q, b, cfg, attn_backend="flash_torch"), tr.params,
            stream(), p["microbatch"], dev)
        qkv_errs = []
        for layer, (kg, pg) in enumerate(zip(kernel_qkv, p_grads["layers"])):
            for w in ("wq", "wk", "wv"):
                check(float(kg[w].abs().sum()) > 0, f"layer {layer}: no gradient in {w}")
                qkv_errs.append(_rel_l2(kg[w], pg[w]))
        del p_grads, kernel_qkv
        check(max(qkv_errs) <= TRAIN_BF16_REL_L2,
              f"wq/wk/wv gradients off the plain route's: relative L2 {max(qkv_errs)}")
        check(abs(k_loss - p_loss) <= TRAIN_LOSS_RTOL * abs(p_loss),
              f"step-1 loss {k_loss} against the plain route's {p_loss}")
        check(abs(k_gnorm - p_gnorm) <= TRAIN_GNORM_RTOL * abs(p_gnorm),
              f"step-1 gnorm {k_gnorm} against the plain route's {p_gnorm}")
        torch.cuda.empty_cache()

        saves = []
        real_save = tr.ckpt.save

        def timed_save(*a, **kw):
            t = time.perf_counter()
            out = real_save(*a, **kw)
            saves.append(time.perf_counter() - t)
            return out

        tr.ckpt.save = timed_save  # this trainer's manager only
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        tr.run(p["steps"] // 2)  # one run: the second call carries on its trajectory
        tr.ckpt = None  # no checkpoint after the midpoint's
        tr.run(p["steps"] - p["steps"] // 2)
        counts = _read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        steps = p["steps"]
        want_fwd = steps * cfg.n_layers * p["microbatch"] * (2 if cfg.remat else 1)
        want_bwd = steps * cfg.n_layers * p["microbatch"]
        check(counts["flash_attention"] == want_fwd and counts["flash_attention_bwd"] == want_bwd
              and counts["flash_attention_bwd_sm90"] == want_bwd,
              f"K3 launches in {steps} steps: {counts}, expected {want_fwd} forward and "
              f"{want_bwd} backward, all on the sm90 route")
        losses = [h["loss"] for h in tr.history]
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        first = tr.history[0]
        check(abs(first["loss"] - k_loss) <= 1e-6 * abs(k_loss)
              and abs(first["gnorm"] - k_gnorm) <= 1e-5 * k_gnorm,
              f"the trainer's first step ({first}) is not the step by hand ({k_loss}, {k_gnorm})")
        check(len(saves) == 1, f"{len(saves)} checkpoints written, not 1")

        tr2 = make()
        t = time.perf_counter()
        resumed_at = tr2.resume()
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t
        tr2.run(steps - resumed_at)
        resumed = [h["loss"] for h in tr2.history]
        check(resumed_at == steps // 2 and len(resumed) == steps - resumed_at,
              f"resumed at {resumed_at} and ran {len(resumed)} steps")
        check(all(abs(a - b) <= TRAIN_RESUME_RTOL * abs(b)
                  for a, b in zip(resumed, losses[resumed_at:])),
              f"resumed losses {resumed} against the uninterrupted {losses[resumed_at:]}")
        del tr2
        torch.cuda.empty_cache()

        step_ms = _median_step_ms(tr.history)
        prof = device_profile(lambda: tr.run(1), dev, step_ms,
                              match=("flash_fwd", "flash_bwd", "nvjet", "gemm"))
        tokens = p["batch"] * p["microbatch"] * p["seq"]
        return {
            "model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab, "params": cfg.n_params(), "remat": cfg.remat,
            "seq": p["seq"], "batch": p["batch"] * p["microbatch"],
            "microbatch": p["microbatch"], "steps": steps, "init_s": init_s,
            "reduced": ["batch 256 -> 8 (2 microbatches of 4): the run's time limit"],
            "losses": losses, "gnorms": [h["gnorm"] for h in tr.history],
            "step_ms": [h["dt"] * 1e3 for h in tr.history], "step_ms_median": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3,
            "peak_memory_bytes": peak,
            "k3_launches_per_step": {"forward": counts["flash_attention"] / steps,
                                     "backward": counts["flash_attention_bwd"] / steps,
                                     "backward_sm90": counts["flash_attention_bwd_sm90"] / steps},
            "checkpoint_save_s": saves[0], "checkpoint_restore_s": restore_s,
            "resumed_at": resumed_at, "resumed_losses": resumed,
            "step1_vs_plain": {"loss": k_loss, "plain_loss": p_loss, "gnorm": k_gnorm,
                               "plain_gnorm": p_gnorm,
                               "wq_wk_wv_rel_l2_max": max(qkv_errs)},
            "profile_step": prof,
        }, counts
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def get_cfg(arch):
    from repro_torch.configs.registry import get_arch

    return get_arch(arch).model_cfg


def train_fm(args, dev) -> dict:
    """The FM at full width: ``Trainer.run`` for ``TRAIN_FM["steps"]``
    steps at B = 65,536 (K4's counts reset just before, read just after:
    one forward and one backward launch a step); the first step's loss
    within ``TRAIN_FM_LOSS_RTOL`` of the same loss with the plain
    interaction, on the initial params and batch; the emb gradient of that
    batch nonzero and within 1e-5 relative L2 of the plain route's."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.data.pipeline import RecsysStream
    from repro_torch.kernels.fm_interaction.fm_interaction import fm_interaction_plain
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import recsys as R
    from repro_torch.train.trainer import value_and_grad

    p = TRAIN_FM
    tr = build_trainer("fm", smoke=False, batch=p["batch"], steps=p["steps"], torch_device=dev)
    cfg = get_cfg("fm")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             RecsysStream(n_fields=cfg.n_fields, batch=p["batch"]).next().items()}
    _, k_grads = value_and_grad(lambda q, b: R.loss_fn(q, b, cfg), tr.params, batch)
    k_emb = k_grads["emb"]
    del k_grads
    with mock.patch.object(R, "fm_second_order",
                           lambda e: fm_interaction_plain(e.float().contiguous())):
        p_loss, p_grads = value_and_grad(lambda q, b: R.loss_fn(q, b, cfg), tr.params, batch)
    emb_err = _rel_l2(k_emb, p_grads["emb"])
    check(float(k_emb.abs().sum()) > 0 and emb_err <= 1e-5,
          f"FM emb gradient: relative L2 {emb_err} against the plain interaction's")
    del k_emb, p_grads
    torch.cuda.empty_cache()
    _reset_counts()
    tr.run(p["steps"])
    counts = _read_counts()
    check(counts["fm_interaction"] == p["steps"] and counts["fm_interaction_bwd"] == p["steps"],
          f"K4 launches in {p['steps']} steps: {counts}")
    losses = [h["loss"] for h in tr.history]
    check(bool(np.isfinite(losses).all()), f"FM losses {losses}")
    check(abs(losses[0] - float(p_loss)) <= TRAIN_FM_LOSS_RTOL * abs(float(p_loss)),
          f"FM step-1 loss {losses[0]} against the plain interaction's {float(p_loss)}")
    step_ms = _median_step_ms(tr.history)
    return {"model": cfg.name, "rows": cfg.total_rows, "batch": p["batch"],
            "steps": p["steps"], "losses": losses, "plain_step1_loss": float(p_loss),
            "emb_grad_rel_l2_vs_plain": emb_err,
            "step_ms": [h["dt"] * 1e3 for h in tr.history], "step_ms_median": step_ms,
            "examples_per_s": p["batch"] / step_ms * 1e3,
            "k4_launches_per_step": {"forward": counts["fm_interaction"] / p["steps"],
                                     "backward": counts["fm_interaction_bwd"] / p["steps"]}
            }, counts


def train_moe(args, dev) -> dict:
    """qwen2-moe-a2.7b at full width, depth cut to ``TRAIN_MOE["depth"]``:
    the first batch's loss on the kernel route (its experts recorded at
    every layer) and on the plain route replaying those experts
    (``moe._route(experts=)``, so no near-tie route flip decides it), then
    ``Trainer.run`` for ``TRAIN_MOE["steps"]`` steps (K3's counts reset
    just before, read just after): finite losses and gnorms, the first
    step's loss within ``TRAIN_LOSS_RTOL`` of the plain route's."""
    import dataclasses
    import math
    from unittest import mock

    import torch

    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch.train import build_trainer
    from repro_torch.models import moe

    p = TRAIN_MOE
    full = get_cfg(p["arch"])
    cfg = dataclasses.replace(full, n_layers=p["depth"],
                              name=f"{full.name}-depth{p['depth']}-of-{full.n_layers}")
    tr = build_trainer(p["arch"], cfg=cfg, batch=p["batch"], seq=p["seq"], steps=p["steps"],
                       torch_device=dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             TokenStream(vocab=cfg.vocab, batch=p["batch"], seq=p["seq"]).next().items()}
    real, recorded = moe._route, []

    def record(xt, router, c, experts=None):
        out = real(xt, router, c, experts)
        recorded.append(out[0])
        return out

    with torch.no_grad(), mock.patch.object(moe, "_route", record):
        k_loss = float(moe.loss_fn(tr.params, batch, cfg))
    check(len(recorded) == cfg.n_layers, f"{len(recorded)} routings for {cfg.n_layers} layers")
    queue = list(recorded)

    def replay(xt, router, c, experts=None):
        return real(xt, router, c, queue.pop(0))

    with torch.no_grad(), mock.patch.object(moe, "_route", replay):
        p_loss = float(moe.loss_fn(tr.params, batch, cfg, attn_backend="flash_torch"))
    check(not queue, "the plain route did not take every recorded routing")
    del recorded
    _reset_counts()
    tr.run(p["steps"])
    counts = _read_counts()
    steps = p["steps"]
    want_fwd = steps * cfg.n_layers * (2 if cfg.remat else 1)
    check(counts["flash_attention"] == want_fwd
          and counts["flash_attention_bwd"] == steps * cfg.n_layers
          == counts["flash_attention_bwd_sm90"],
          f"K3 launches in {steps} MoE steps: {counts} (backward all sm90 expected)")
    losses = [h["loss"] for h in tr.history]
    gnorms = [h["gnorm"] for h in tr.history]
    check(all(math.isfinite(x) for x in losses + gnorms), f"MoE losses {losses}, gnorms {gnorms}")
    check(abs(losses[0] - p_loss) <= TRAIN_LOSS_RTOL * abs(p_loss),
          f"MoE step-1 loss {losses[0]} against the plain route's {p_loss}")
    step_ms = _median_step_ms(tr.history) if steps > 1 else tr.history[0]["dt"] * 1e3
    return {"model": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "params": cfg.n_params(), "batch": p["batch"], "seq": p["seq"], "steps": steps,
            "reduced": [f"depth 24 -> {p['depth']}: float32 masters, gradients and moments "
                        "of all 24 layers would not fit on one card"],
            "losses": losses, "gnorms": gnorms, "kernel_loss_no_grad": k_loss,
            "plain_loss_replayed_experts": p_loss,
            "step_ms": [h["dt"] * 1e3 for h in tr.history], "step_ms_median": step_ms,
            "tokens_per_s": p["batch"] * p["seq"] / step_ms * 1e3,
            "k3_launches_per_step": {"forward": counts["flash_attention"] / steps,
                                     "backward": counts["flash_attention_bwd"] / steps,
                                     "backward_sm90": counts["flash_attention_bwd_sm90"] / steps}
            }, counts


def train_phase(args, dev) -> tuple:
    """The training path: qwen3-0.6b, the FM, qwen2-moe-a2.7b at depth 2,
    each freed before the next.  Returns the phase's line and the main
    path's launches by kernel (the three runs' counts added)."""
    import torch

    torch.cuda.empty_cache()
    t = time.perf_counter()
    out, counts = {}, {}
    for name, fn in (("qwen3", train_lm), ("fm", train_fm), ("moe", train_moe)):
        out[name], c = fn(args, dev)
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t
    return out, counts


# ---------------------------------------------------------------------- #
# The mesh step builders at world 1: a 1 x 1 NCCL mesh, whose steps run
# plain tensors, each held against the same builder with no mesh
MESH_LM = dict(arch="qwen3-0.6b", batch=TRAIN_LM["batch"], seq=TRAIN_LM["seq"])
MESH_MOE = dict(arch="qwen2-moe-a2.7b", depth=TRAIN_MOE["depth"], batch=TRAIN_MOE["batch"],
                seq=TRAIN_MOE["seq"])
MESH_FM = dict(train=TRAIN_FM["batch"], serve=262_144, candidates=1_000_000)
MESH_REPS = 3


def _tree_diff(a, b) -> dict:
    """The leaves of two like trees that are not bitwise equal, each with
    its largest difference over its largest magnitude."""
    import torch

    from repro_torch.tree import flatten_with_paths

    out = {}
    for (key, x), (_, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        if not (x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)):
            out[key or "value"] = float((x.float() - y.float()).abs().max()
                                        / y.float().abs().max().clamp_min(1e-30))
    return out


def _check_bitwise(what, **pairs):
    """Each named (mesh, one-card) pair of trees bitwise equal."""
    for name, (a, b) in pairs.items():
        off = _tree_diff(a, b)
        check(not off, f"{what}: {name} of the 1 x 1 mesh step off the one-card step's: {off}")


def mesh_steps(args, dev) -> tuple:
    """The LM and FM step builders (``repro_torch.launch.steps``) at world 1
    on a 1 x 1 NCCL mesh (``make_debug_mesh(1, 1, "cuda")``), each step once
    on the mesh and once with ``mesh=None``, the same inputs: qwen3-0.6b at
    full width and depth (``build_lm_train`` at ``TRAIN_LM``'s batch and
    seq, the train phase's seeded params and first batch; ``build_lm_prefill``
    on it; ``build_lm_decode`` on its cache at the last position), qwen2-moe
    at depth 2 (``build_lm_train``: on the mesh the expert-TP branch,
    ``acts["moe_shard"]``; without one the batched dispatch), and the FM's
    train, serve and retrieval steps at full width.  The dense and FM steps
    must be bitwise; the MoE step's loss within ``TRAIN_LOSS_RTOL`` and
    gnorm within ``TRAIN_GNORM_RTOL``.  K3's and K4's counts (forward and backward) are
    reset just before the phase's steps and read just after; each must be
    nonzero.  Each step's wall time is the median of ``MESH_REPS`` calls
    (the MoE step's: one call; its branch dispatches its 512 groups one at a
    time, as the reference's scan does), beside its one-card counterpart's;
    the decode's includes a copy of the cache a call (it is written in
    place)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe as M
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T

    t0 = time.perf_counter()
    started = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, "cuda")
    out, timing = {}, {}

    def both(name, make, *inputs, copy=None, reps=MESH_REPS):
        """(mesh result, one-card result) of a builder's step; times each
        (the median of ``reps`` more calls)."""
        res = {}
        for tag, m in (("mesh", mesh), ("one_card", None)):
            built = make(m)
            fresh = (lambda: copy(*inputs)) if copy else (lambda: inputs)
            res[tag] = built.fn(*fresh())
            torch.cuda.synchronize(dev)
            timing.setdefault(name, {})[f"{tag}_ms"] = wall_ms(
                lambda: built.fn(*fresh()), dev, reps)
        return res["mesh"], res["one_card"]

    try:
        _reset_counts()
        # qwen3-0.6b: train, prefill, decode
        cfg = get_arch(MESH_LM["arch"]).model_cfg
        b, s = MESH_LM["batch"], MESH_LM["seq"]
        params = steps.stack_layers(T.init_master(torch.Generator(device=dev).manual_seed(0),
                                                  cfg))
        opt = steps._lm_optimizer(cfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 TokenStream(vocab=cfg.vocab, batch=b, seq=s).next().items()}
        (pm, om, lm), (p1, o1, l1) = both(
            "qwen3_train", lambda m: steps.build_lm_train(cfg, m, dict(batch=b, seq=s),
                                                          torch_device=dev),
            params, opt.init(params), batch)
        _check_bitwise("qwen3 train", params=(pm, p1), opt_state=(om, o1), out=(lm, l1))
        out["qwen3_train"] = {"loss": float(lm["loss"]), "gnorm": float(lm["gnorm"])}
        check(bool(torch.isfinite(lm["loss"])), f"qwen3 mesh train loss {lm['loss']}")
        del pm, om, p1, o1
        torch.cuda.empty_cache()
        (kvm, lgm), (kv1, lg1) = both(
            "qwen3_prefill", lambda m: steps.build_lm_prefill(cfg, m, dict(batch=b, seq=s - 1),
                                                              torch_device=dev),
            params, batch["tokens"][:, :s - 1])
        _check_bitwise("qwen3 prefill", kv=(kvm, kv1), logits=(lgm, lg1))
        out["qwen3_prefill"] = {}
        del kvm, lgm, lg1
        cache = {k: torch.cat([v, v.new_zeros((*v.shape[:3], 1, v.shape[4]))], 3)
                 for k, v in kv1.items()}
        del kv1
        (dlm, dkvm), (dl1, dkv1) = both(
            "qwen3_decode", lambda m: steps.build_lm_decode(cfg, m, dict(batch=b, seq=s),
                                                            torch_device=dev),
            params, batch["tokens"][:, -1], cache,
            copy=lambda p, tok, kv: (p, tok, {k: v.clone() for k, v in kv.items()}))
        _check_bitwise("qwen3 decode", logits=(dlm, dl1), kv=(dkvm, dkv1))
        out["qwen3_decode"] = {}
        del params, cache, dlm, dkvm, dl1, dkv1
        torch.cuda.empty_cache()

        # qwen2-moe at depth 2: the expert-TP branch against the batched dispatch
        full = get_arch(MESH_MOE["arch"]).model_cfg
        mcfg = dataclasses.replace(full, n_layers=MESH_MOE["depth"],
                                   name=f"{full.name}-depth{MESH_MOE['depth']}")
        b, s = MESH_MOE["batch"], MESH_MOE["seq"]
        params = steps.stack_layers(M.init_master(torch.Generator(device=dev).manual_seed(0),
                                                  mcfg))
        opt = steps._lm_optimizer(mcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 TokenStream(vocab=mcfg.vocab, batch=b, seq=s).next().items()}
        (pm, om, lm), (p1, o1, l1) = both(
            "moe_train", lambda m: steps.build_lm_train(mcfg, m, dict(batch=b, seq=s),
                                                        torch_device=dev),
            params, opt.init(params), batch, reps=1)  # the branch loops over 512 groups
        loss_m, loss_1 = float(lm["loss"]), float(l1["loss"])
        gn_m, gn_1 = float(lm["gnorm"]), float(l1["gnorm"])
        check(abs(loss_m - loss_1) <= TRAIN_LOSS_RTOL * abs(loss_1)
              and abs(gn_m - gn_1) <= TRAIN_GNORM_RTOL * abs(gn_1),
              f"MoE expert-TP branch: loss {loss_m}, gnorm {gn_m} against the batched "
              f"dispatch's {loss_1}, {gn_1}")
        out["moe_train"] = {"model": mcfg.name, "loss": loss_m, "one_card_loss": loss_1,
                            "gnorm": gn_m, "one_card_gnorm": gn_1,
                            "params_max_rel_diff": max(_tree_diff(pm, p1).values(), default=0.0)}
        del params, pm, om, p1, o1
        torch.cuda.empty_cache()

        # the FM: train, serve, retrieval at full width
        fcfg = get_arch("fm").model_cfg
        params = R.init(torch.Generator(device=dev).manual_seed(args.seed), fcfg)
        rng = np.random.default_rng(args.seed + 7)

        def ids(n):
            return torch.from_numpy(rng.integers(0, 2**31 - 1, (n, fcfg.n_fields),
                                                 dtype=np.int32)).to(dev)

        fb = MESH_FM["train"]
        fbatch = {"x": ids(fb), "y": torch.from_numpy(
            (rng.random(fb) < 0.25).astype(np.float32)).to(dev)}
        fopt = steps.fm_optimizer()
        (pm, om, lm), (p1, o1, l1) = both(
            "fm_train", lambda m: steps.build_fm_step(fcfg, m, "train", dict(batch=fb),
                                                      torch_device=dev),
            params, fopt.init(params), fbatch)
        _check_bitwise("FM train", params=(pm, p1), opt_state=(om, o1), out=(lm, l1))
        out["fm_train"] = {"loss": float(lm["loss"])}
        del pm, om, p1, o1
        x = ids(MESH_FM["serve"])
        sm, s1 = both("fm_serve", lambda m: steps.build_fm_step(
            fcfg, m, "serve", dict(batch=MESH_FM["serve"]), torch_device=dev), params, x)
        _check_bitwise("FM serve", scores=(sm, s1))
        out["fm_serve"] = {}
        cand = torch.from_numpy(rng.integers(0, fcfg.total_rows, MESH_FM["candidates"],
                                             dtype=np.int32)).to(dev)
        rm, r1 = both("fm_retrieval", lambda m: steps.build_fm_step(
            fcfg, m, "retrieval", dict(n_candidates=MESH_FM["candidates"]),
            torch_device=dev), params, x[:1], cand)
        _check_bitwise("FM retrieval", scores=(rm, r1))
        out["fm_retrieval"] = {}
        del params, x, cand
        counts = _read_counts()
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
        torch.cuda.empty_cache()
    for name in ("flash_attention", "flash_attention_bwd", "fm_interaction",
                 "fm_interaction_bwd"):
        check(counts[name] > 0, f"the mesh steps launched no {name}: {counts}")
    for name, t in timing.items():
        out[name].update(t)
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t0
    return out, counts


# ---------------------------------------------------------------------- #
# The cluster tier: one writer, two followers tailing its segmented WAL,
# reads placed by the router.  ER n = 30,000, degree 10, KHop(2), cut from
# the k-hop phase's 100,000 by the run's time: the phase makes four host
# EMC builds (the writer, two followers, one checkpoint rejoin), 67-88 s
# each at n = 100,000
CLUSTER_N = 30_000
CLUSTER_BATCHES = 6
CLUSTER_KILL_AFTER = 2  # r1 is killed after this many batches ...
CLUSTER_REJOIN_AFTER = 5  # ... and rejoins after this many


def cluster_phase(args, dev):
    """The cluster tier on a graph and a generator of its own (no draw of
    another phase shifts): ``ReplicaSet(n_replicas=2, rotate_records=2,
    checkpoint_every=4, wal_digests=True)`` under the deferred-phase-2
    policy, started; a client thread routes point reads and explicit-values
    full-graph reads (1 in 8), every 4th read-your-writes, while 6 batches
    land; ``r1`` is killed with tickets in flight after the second batch
    and rejoins by checkpoint and tail after the fifth.  Every served
    ticket is held bit for bit against the writer's host index of its
    pinned version; the health monitor and its HTTP endpoint are read
    along the way.  K1's and K2's counts are reset just before the load and
    read just after."""
    import shutil
    import tempfile
    import threading
    import urllib.request

    import numpy as np

    from repro_torch import obs
    from repro_torch.core.api import QuerySpec
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.core.windows import KHopWindow
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs
    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled
    from repro_torch.obs.audit import graph_crc
    from repro_torch.serve import (
        HealthMonitor,
        HealthServer,
        ReplicaFailedError,
        ReplicaSet,
        latest_checkpoint,
        load_checkpoint,
        list_segments,
    )

    t_phase = time.perf_counter()
    rng = np.random.default_rng(args.seed + 6)
    g = with_random_attrs(erdos_renyi(CLUSTER_N, args.degree, directed=False,
                                      seed=args.seed + 6), seed=args.seed + 7)
    n = g.n
    specs = [QuerySpec(KHopWindow(2), a) for a in AGGS]
    policy = StalenessPolicy(max_link_ratio=float("inf"),
                             max_block_ratio=float("inf"), max_garbage_ratio=1.0)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cluster_", dir=os.path.join(ROOT, "build"))
    reg = obs.MetricsRegistry()
    t = time.perf_counter()
    rs = ReplicaSet(g, specs, tmp, n_replicas=2, rotate_records=2, checkpoint_every=4,
                    wal_digests=True, obs=reg, policy=policy, use_device_bfs=True,
                    torch_device=dev)
    build_s = time.perf_counter() - t

    def emc_s(session):
        (st,) = session._states.values()
        return st.index.stats.get("t_total_s")

    emc = {"writer": emc_s(rs.writer.session),
           **{name: emc_s(rep.session) for name, rep in rs.replicas.items()}}
    (wstate,) = rs.writer.session._states.values()
    versions = {0: (wstate.index, rs.writer.session.graph)}
    mon = HealthMonitor(cluster=rs)
    health = {"before_kill": mon.check()["state"]}
    check(health["before_kill"] == "ready", f"health before the kill: {mon.last_report}")
    full_vals = rng.integers(0, 100, (4, n)).astype(np.float64)
    tickets, stop, client_lock = [], threading.Event(), threading.Lock()
    client_errors = []
    crng = np.random.default_rng(args.seed + 9)

    def client():
        try:
            client_reads()
        except Exception as exc:  # reported and failed by the phase below
            client_errors.append(repr(exc))
            raise

    def client_reads():
        i = 0
        while not stop.is_set():
            with client_lock:
                for _ in range(4):
                    si = int(crng.integers(len(specs)))
                    # read-your-writes at the writer's published version (the
                    # session's head moves first, mid-update)
                    ryw = rs.writer.version if i % 4 == 3 else None
                    if i % 8 == 7:  # a full-graph read on the caller's values
                        j = i // 8 % len(full_vals)
                        tk = rs.router.submit(si, values=full_vals[j], min_version=ryw,
                                              request_class="interactive")
                        tickets.append((tk, "interactive", j))
                    else:
                        tk = rs.router.submit(si, vertex=int(crng.integers(n)),
                                              min_version=ryw, request_class="point")
                        tickets.append((tk, "point", None))
                    i += 1
                rs.router.flush()
            time.sleep(0.01)

    k1_set()
    bitset_expand_tiled.launches = 0
    rs.start(tail_interval_s=0.05)
    th = threading.Thread(target=client, name="cluster-client", daemon=True)
    lags, failover, rejoin, update_ms = [], None, None, []
    t_load = time.perf_counter()
    th.start()
    try:
        for b in range(1, CLUSTER_BATCHES + 1):
            time.sleep(0.25)  # reads run at this version
            batch = make_batch(rs.writer.session.graph, args, rng)
            t = time.perf_counter()
            rs.update(batch)
            update_ms.append((time.perf_counter() - t) * 1e3)
            versions[rs.version] = (wstate.index, rs.writer.session.graph)
            lags.append({name: rep.lag for name, rep in rs.live_replicas.items()})
            if b == CLUSTER_KILL_AFTER:
                with client_lock:  # tickets in flight on r1 when it dies
                    doomed = [rs.router.submit(0, vertex=v, target="r1") for v in range(3)]
                    failed = rs.kill("r1")
                health["r1_dead"] = mon.check()
                check(health["r1_dead"]["state"] == "failed"
                      and "quorum" in health["r1_dead"]["failing"],
                      f"health with r1 dead: {health['r1_dead']}")
                health["r1_dead"] = health["r1_dead"]["state"]
                failover = {"failed": failed, "doomed_failed": all(d.failed for d in doomed)}
                check(failover["doomed_failed"], "a ticket in flight on r1 did not fail over")
            if b == CLUSTER_REJOIN_AFTER:
                t = time.perf_counter()
                _, _, _ = load_checkpoint(latest_checkpoint(rs.checkpoint_dir)[1])
                load_s = time.perf_counter() - t
                t = time.perf_counter()
                rep = rs.rejoin("r1", catch_up=False)
                rebuild_s = time.perf_counter() - t
                t = time.perf_counter()
                rs.wal.sync()
                tail = rep.catch_up()
                tail_s = time.perf_counter() - t
                rep.start_tailing(interval_s=0.05)
                emc["r1_rejoin"] = emc_s(rep.session)
                rejoin = {"from_version": rep.restored_from_version, "tail_batches": tail,
                          "load_s": load_s, "rebuild_s": rebuild_s, "tail_s": tail_s,
                          "rejoin_s": rebuild_s + tail_s}
                health["after_rejoin"] = mon.check()["state"]
                check(health["after_rejoin"] == "ready",
                      f"health after the rejoin: {mon.last_report}")
        time.sleep(0.25)
    finally:
        stop.set()
        th.join(timeout=60)
    load_s_total = time.perf_counter() - t_load
    check(not th.is_alive(), "the client thread did not stop")
    check(not client_errors, f"the client thread failed: {client_errors}")
    for rep in rs.replicas.values():
        rep.stop_tailing()
    rs.writer.stop(drain=True)
    rs.router.flush()
    rs.sync()
    lags.append({name: rep.lag for name, rep in rs.live_replicas.items()})
    launches = {**k1_counts(),
                "bitset_expand": bitset_expand_tiled.launches}
    check(launches["segment_sum"] > 0, "the cluster's routed reads launched no K1")
    check(launches["bitset_expand"] > 0, "the cluster's updates launched no K2")

    # every served ticket against the writer's host index of its version
    expected, lat, by_target, failed_tickets = {}, {}, {}, 0
    for tk, cls, j in tickets:
        check(tk.done, f"ticket {tk.rid} never finished")
        if tk.error is not None:
            check(isinstance(tk.error, ReplicaFailedError) and tk._route_target == "r1",
                  f"ticket {tk.rid} on {tk._route_target} failed: {tk.error!r}")
            failed_tickets += 1
            continue
        key = (tk.version, j)
        if key not in expected:
            index, graph = versions[tk.version]
            expected[key] = host_expect(index, graph.attrs["val"] if j is None else full_vals[j])
        agg = AGGS[tk.spec_index]
        want = expected[key][agg]
        check(served_ok(agg, tk.result, want if tk.vertex is None else want[tk.vertex]),
              f"ticket {tk.rid} ({agg}, {cls}) from {tk._route_target or 'writer'} at "
              f"v{tk.version} differs from the host index")
        lat.setdefault(cls, []).append(tk.latency_s * 1e3)
        by_target.setdefault(tk._route_target or "writer", []).append(tk.latency_s * 1e3)
    failover["client_tickets_failed"] = failed_tickets

    # the followers equal the writer; truncation left every cursor readable
    wrun = rs.writer.session.run()
    for name, rep in rs.replicas.items():
        check(rep.alive and rep.version == rs.version, f"{name} at v{rep.version}")
        check(rep.digest_checks > 0 and rep.divergence is None,
              f"{name}: {rep.digest_checks} digest checks, divergence {rep.divergence}")
        for a, x, y in zip(AGGS, rep.session.run(), wrun):
            check(x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"{name} run() differs: {a}")
        check(graph_crc(rep.session.graph) == graph_crc(rs.writer.session.graph),
              f"{name} graph_crc differs")
    truncated_in_load = rs.wal.truncated_segments
    rs.truncate()  # the checkpoint's truncation, now that every follower is past it
    oldest = list_segments(rs.wal_dir)[0][0]
    check(rs.wal.truncated_segments >= 1, "no sealed segment was truncated")
    for name, rep in rs.replicas.items():
        check(rep.cursor["segment"] >= oldest,
              f"{name}'s cursor {rep.cursor} points below the oldest segment {oldest}")
    health["after_sync"] = mon.check()["state"]
    check(health["after_sync"] == "ready", f"health after sync: {mon.last_report}")
    with HealthServer(mon, registry=reg) as hs:
        r = urllib.request.urlopen(hs.url + "/readyz", timeout=30)
        ready = (r.status, json.loads(r.read()))
        metrics = urllib.request.urlopen(hs.url + "/metrics", timeout=30).read().decode()
        debug = json.loads(urllib.request.urlopen(hs.url + "/debug", timeout=120).read())
    check(ready[0] == 200 and ready[1]["ready"], f"/readyz answered {ready}")
    for prefix in ("repro_router_", "repro_replica_"):
        check(any(ln.startswith(prefix) for ln in metrics.splitlines()),
              f"/metrics has no {prefix}* line")
    check(set(debug["cluster"]["replicas"]) == {"r0", "r1"}, "/debug lacks the replicas")
    check(not hs.running, "the health server did not stop")
    served = sum(len(v) for v in lat.values())
    out = {
        "n": n, "edges": g.n_edges, "replicas": 2, "batches": CLUSTER_BATCHES,
        "edits_per_batch": args.inserts + args.deletes,
        "build_s": build_s, "emc_build_s": emc,
        "reads": served, "reads_per_s": served / load_s_total, "load_s": load_s_total,
        "latency_ms": {c: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)),
                           "count": len(v)} for c, v in sorted(lat.items())},
        "latency_ms_by_target": {c: {"p50": float(np.percentile(v, 50)),
                                     "p99": float(np.percentile(v, 99)), "count": len(v)}
                                 for c, v in sorted(by_target.items())},
        "update_ms": update_ms, "failover": failover, "rejoin": rejoin,
        "lag_after_each_update": lags[:-1], "lag_after_sync": lags[-1],
        "digest_checks": {name: rep.digest_checks for name, rep in rs.replicas.items()},
        "digest_ms": wall_ms(lambda: rs.writer.session.digest(), dev, 3),
        "truncated_segments": {"during_load": truncated_in_load,
                               "after_sync": rs.wal.truncated_segments},
        "checkpoints": rs.checkpoints_written, "rotations": rs.wal.rotations,
        "router": rs.router.stats, "health": health,
        "writer_slo": rs.writer.slo.report(), "launches": launches,
    }
    rs.close()
    shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------- #
# The sharded runtime: ER n = 30,000, degree 10, KHop(2), five aggregates,
# batches of 100 inserts + 25 deletes, run_many at B = SHARDED_B.  The
# plan is laid out with SHARDED_HEADROOM (the CPU tests' streaming slack).
# Under the deferred policy the first batches after an EMC build grow
# k = 2's links fastest (R2) and outgrow the tile groups' slack, so the
# plan rebuilds during SHARDED_WARMUP batches (the output lists which);
# the SHARDED_BATCHES batches after them are the stream, which must patch
# in place (cut these first if the run nears its limit)
SHARDED_N = 30_000
SHARDED_HEADROOM = 1.0
SHARDED_WARMUP = 5
SHARDED_BATCHES = 6
SHARDED_B = 8


def _sharded_graph(args):
    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs

    return with_random_attrs(erdos_renyi(SHARDED_N, args.degree, directed=False,
                                         seed=args.seed + 10), seed=args.seed + 11)


def _sharded_session(g, mesh, dev):
    """``Session(mesh=...)`` (or single-host without a mesh) under the
    deferred-phase-2 policy, the device BFS pinned, the plan laid out
    with ``SHARDED_HEADROOM``."""
    from repro_torch.core.api import QuerySpec, Session
    from repro_torch.core.streaming import StalenessPolicy
    from repro_torch.core.windows import KHopWindow

    policy = StalenessPolicy(max_link_ratio=float("inf"),
                             max_block_ratio=float("inf"), max_garbage_ratio=1.0)
    t = time.perf_counter()
    sess = Session(g, [QuerySpec(KHopWindow(2), a) for a in AGGS], mesh=mesh,
                   plan_headroom=SHARDED_HEADROOM, use_device_bfs=True, policy=policy,
                   torch_device=dev)
    return sess, time.perf_counter() - t


def _combine_ms(sess, dev, reps: int) -> dict:
    """Milliseconds of each pass's combine inside ``reps`` sharded
    ``run()`` calls: the run's own ``_combine`` (the NaN-count columns,
    the SUM, MIN and MAX ``all_reduce``s, the NaN restore) on the run's
    own partials, between CUDA events after a synchronize (on the CPU, the
    host clock); the median per pass."""
    import torch

    from repro_torch.distributed import window_runtime as wr

    inner, took = wr._combine, []

    def timed(*a, **k):
        if dev.type != "cuda":
            t = time.perf_counter()
            out = inner(*a, **k)
            took.append((time.perf_counter() - t) * 1e3)
            return out
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*a, **k)
        end.record()
        end.synchronize()
        took.append(start.elapsed_time(end))
        return out

    wr._combine = timed
    try:
        for _ in range(reps):
            sess.run()
    finally:
        wr._combine = inner
    check(len(took) == 2 * reps, f"{len(took)} combines in {reps} sharded runs")
    return {"pass1": statistics.median(took[0::2]), "pass2": statistics.median(took[1::2]),
            "runs": reps}


def sharded_stream(sess, args, dev, check_step):
    """The sharded main path, counted: ``run()``; ``SHARDED_WARMUP``
    updates, in which the plan may still rebuild; ``run_many()`` at B =
    ``SHARDED_B`` (rows bitwise ``run()``); then the stream,
    ``SHARDED_BATCHES`` updates that must each patch the plan in place
    (no rebuild, patch bytes below the whole plan's) with no new plan
    signature over them.  Every update is followed by a ``run()``, and
    ``check_step(label, results, batch)`` holds every result (``batch``:
    the update just applied).  K1's and K2's counts are reset just before
    and read just after; K1 must launch twice a ``run()`` and a
    ``run_many()``.  Returns the results in order and the phase's
    numbers."""
    import numpy as np

    from repro_torch.distributed.window_runtime import sharded_signature_count
    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled
    from repro_torch.kernels.segment_reduce.segment_reduce import segment_sum_tiled

    rng = np.random.default_rng(args.seed + 12)
    vb = rng.integers(0, 100, (SHARDED_B, sess.graph.n)).astype(np.float64)
    (state,) = sess._states.values()
    outputs, run_ms, reports = [], [], []

    def counted_run():
        before = segment_sum_tiled.launches
        t = time.perf_counter()
        res = sess.run()
        run_ms.append((time.perf_counter() - t) * 1e3)
        check(segment_sum_tiled.launches - before == 2,
              f"a sharded run() made {segment_sum_tiled.launches - before} K1 launches, not 2")
        return res

    def update(label, warmup):
        batch = make_batch(sess.graph, args, rng)
        t = time.perf_counter()
        (rep,) = sess.update(batch).values()
        ms = (time.perf_counter() - t) * 1e3
        res = counted_run()
        check_step(label, res, batch)
        outputs.append(res)
        reports.append({"warmup": warmup, "update_ms": ms, **{key: rep[key] for key in (
            "affected", "affected_per_shard", "patch_bytes", "patch_bytes_per_shard",
            "full_plan_bytes", "plan_bytes", "plan_rebuilt", "compacted")}})
        return rep

    k1_set()
    bitset_expand_tiled.launches = 0
    res = counted_run()
    check_step("run v0", res, None)
    outputs.append(res)
    for i in range(SHARDED_WARMUP):
        update(f"warm-up v{i + 1}", True)
    before = segment_sum_tiled.launches
    many = sess.run_many(vb)
    check(segment_sum_tiled.launches - before == 2,
          f"a sharded run_many() made {segment_sum_tiled.launches - before} K1 launches")
    for b in range(SHARDED_B):
        for a, m, r in zip(AGGS, many, sess.run(vb[b])):
            check(np.array_equal(m[b], r), f"sharded run_many row {b} differs from run: {a}")
    check_step("run_many", many, None)
    outputs.append(many)
    run_many_ms = []
    for _ in range(3):
        t = time.perf_counter()
        sess.run_many(vb)
        run_many_ms.append((time.perf_counter() - t) * 1e3)
    sigs = sharded_signature_count()
    for i in range(SHARDED_BATCHES):
        rep = update(f"run v{SHARDED_WARMUP + i + 1}", False)
        check(not rep["plan_rebuilt"], f"stream batch {i + 1} rebuilt the plan")
        check(0 < rep["patch_bytes"] < rep["full_plan_bytes"],
              f"stream batch {i + 1}: patch {rep['patch_bytes']} B, full plan "
              f"{rep['full_plan_bytes']} B")
    new_sigs = sharded_signature_count() - sigs
    check(new_sigs == 0, f"{new_sigs} new plan signatures over the stream")
    warm = [r for r in reports if r["warmup"]]
    return outputs, {
        "run_ms": statistics.median(run_ms), "run_ms_all": run_ms,
        "run_many_ms": statistics.median(run_many_ms), "run_many_batch": SHARDED_B,
        "plan_headroom": SHARDED_HEADROOM,
        "update_ms": statistics.median(r["update_ms"] for r in reports if not r["warmup"]),
        "warmup_update_ms": [r["update_ms"] for r in warm],
        "warmup_rebuilt": [r["plan_rebuilt"] for r in warm],
        "batches": reports, "new_plan_signatures": new_sigs,
        "plan_bytes_on_rank": state.plan.plan_nbytes(),
        "plan_bytes_whole": state.plan.size_bytes(),
        "rows_per_shard": [state.plan.rows1, state.plan.rows2],
        "launches": {**k1_counts(),
                     "bitset_expand": bitset_expand_tiled.launches},
    }


def _nan_case(sess, shard: int, dev) -> dict:
    """A NaN in a member of a block that ``shard`` reduces in pass 1: the
    sharded min/max keep it as the port's single-host executor does on
    the same index (a plan of it laid out whole, on ``dev``), also in
    windows only ``shard`` reduced in pass 2."""
    import numpy as np

    from repro_torch.core import engine_torch as et

    (state,) = sess._states.values()
    plan, index = state.plan, state.index
    on = np.flatnonzero(plan.reducing_shard(index.member_block_ids, 1) == shard)
    check(on.size > 0, f"shard {shard} reduces no block")
    v = int(index.block_members[on[0]])
    vals = np.array(sess.graph.attrs["val"], np.float64)
    vals[v] = np.nan
    got = sess.run(vals)
    whole = et.plan_from_dbindex(index, plan.tm, plan.ts, torch_device=dev)
    want = [o.cpu().numpy() for o in et.query_dbindex_multi(whole, vals, AGGS)]
    for a, x, y in zip(AGGS, got, want):
        check(np.array_equal(x, y, equal_nan=True), f"NaN case: {a} differs from single-host")
    kept = {}
    for a in ("min", "max"):
        lost = np.flatnonzero(np.isnan(got[AGGS.index(a)]))
        on_shard = int((plan.reducing_shard(lost, 2) == shard).sum())
        check(lost.size > 0 and on_shard > 0, f"NaN case: no {a} window of shard {shard} holds it")
        kept[a] = {"nan_windows": int(lost.size), "reduced_on_shard": on_shard}
    return {"vertex": v, "shard": shard, **kept}


SERVICE_UPDATES = 3  # update batches of the sharded serving sub-phase
SERVICE_POINTS = 8  # vertices point-read for every spec after each batch


def sharded_service(sess, args, dev) -> tuple:
    """The serving sub-phase on a ``ShardedSession`` (on rank 0 when it
    leads followers): ``WindowService(bucket=4)``; 3 explicit-values
    tickets in one flush, which must be one batched launch (2 K1 launches);
    then ``SERVICE_UPDATES`` batches, each followed by point reads of
    every spec at ``SERVICE_POINTS`` vertices through the affected-owner
    cache, which must hit.  Returns the tickets' results in order, the
    explicit values, the batches and the numbers."""
    import numpy as np

    from repro_torch.serve import WindowService

    rng = np.random.default_rng(args.seed + 14)
    n = sess.graph.n
    verts = np.sort(rng.choice(n, SERVICE_POINTS, replace=False))
    vb = rng.integers(0, 100, (3, n)).astype(np.float64)
    svc = WindowService(sess, bucket=4)
    k1 = k1_counts()
    t = time.perf_counter()
    tickets = [svc.submit(0, values=vb[i]) for i in range(3)]
    svc.flush()
    flush_ms = (time.perf_counter() - t) * 1e3
    flush_k1 = k1_since(k1)["segment_sum"]
    check(svc.batched_launches == 1,
          f"the 3-ticket flush took {svc.batched_launches} batched launches")
    check(flush_k1 == 2, f"the 3-ticket flush made {flush_k1} K1 launches, not 2")
    results = [np.asarray(t.result) for t in tickets]
    batches, update_ms, read_ms = [], [], []
    for _ in range(SERVICE_UPDATES):
        batch = make_batch(sess.graph, args, rng)
        batches.append(batch)
        t = time.perf_counter()
        svc.update(batch)
        update_ms.append((time.perf_counter() - t) * 1e3)
        for si in range(len(AGGS)):
            for v in verts:
                t = time.perf_counter()
                results.append(np.asarray(svc.query(si, vertex=int(v))))
                read_ms.append((time.perf_counter() - t) * 1e3)
    check(svc.point_hits > 0, "no point read hit the cache")
    return results, vb, verts, batches, {
        "bucket": 4, "flush_tickets": 3, "flush_batched_launches": svc.batched_launches,
        "flush_k1_launches": flush_k1, "flush_ms": flush_ms,
        "update_ms": update_ms, "point_reads": len(read_ms),
        "point_hits": svc.point_hits, "point_misses": svc.point_misses,
        "point_read_ms_p50": statistics.median(read_ms), "point_read_ms_max": max(read_ms),
        "k1_launches": k1_since(k1),
    }


def sharded_rank(rank: int, args, world: int, backend: str, dev_type: str, store: str,
                 expect: str, out: str) -> None:
    """One spawned rank of the sharded phase: the world-1 stream again on
    this rank's mesh, every result bitwise the world-1 results in
    ``expect``, then the NaN case on shard 1; its numbers go to
    ``out``.``rank``.json."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device("cpu")
    if dev_type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    mesh = init_device_mesh("cuda" if backend == "nccl" else "cpu", (world,),
                            mesh_dim_names=("data",))
    g = _sharded_graph(args)
    sess, build_s = _sharded_session(g, mesh, dev)
    want = np.load(expect)
    seen = iter(range(sum(1 for f in want.files if f.startswith("o"))))

    def check_step(label, res, batch):
        for a, r in zip(AGGS, res):
            w = want[f"o{next(seen)}"]
            check(r.dtype == w.dtype and r.tobytes() == w.tobytes(),
                  f"rank {rank}, {label}: {a} differs from world 1")

    _, stream = sharded_stream(sess, args, dev, check_step)
    (state,) = sess._states.values()
    check(stream["plan_bytes_on_rank"] < stream["plan_bytes_whole"],
          f"rank {rank} holds {stream['plan_bytes_on_rank']} B of a "
          f"{stream['plan_bytes_whole']} B plan")
    report = {"rank": rank, "backend": backend, "device": str(dev), "build_s": build_s,
              "emc_build_s": state.index.stats.get("t_total_s"), **stream,
              "combine_ms": _combine_ms(sess, dev, args.reps),
              "nan_case": _nan_case(sess, 1, dev),
              "digest": sess.digest()["plan_crc"]}
    # the serving sub-phase: rank 0 leads the service, the others replay
    k1 = k1_counts()
    if rank == 0:
        sess.lead()
        try:
            served, _, _, _, report["service"] = sharded_service(sess, args, dev)
        finally:
            sess.stop_followers()
        check(len(served) == sum(1 for f in want.files if f.startswith("s")),
              "rank 0 service: ticket count")
        for i, x in enumerate(served):
            w = want[f"s{i}"]
            check(x.dtype == w.dtype and x.tobytes() == w.tobytes(),
                  f"rank 0 service ticket {i} differs from world 1")
    else:
        t = time.perf_counter()
        replayed = sess.follow()  # a replay error raises here and fails the rank
        report["service"] = {"replayed_ops": replayed,
                             "follow_s": time.perf_counter() - t}
    report["service"]["rank_k1_launches"] = k1_since(k1)
    add_counts(report["launches"], report["service"]["rank_k1_launches"])
    report["service_digest"] = sess.digest()["plan_crc"]
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


def _spawn_ranks(args, backend: str, dev, expect: str, tmp: str, timeout_s: float) -> list:
    """Two ranks (``sharded_rank``) on ``backend``, spawned processes;
    their JSON reports.  Every rank is stopped before this returns."""
    import torch.multiprocessing as mp

    # ranks of one host: rendezvous and traffic on the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    out = os.path.join(tmp, f"rank_{backend}")
    ctx = mp.start_processes(
        sharded_rank, args=(args, 2, backend, dev.type, os.path.join(tmp, f"store_{backend}"),
                            expect, out),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"the {backend} ranks still ran after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    reports = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            reports.append(json.load(f))
    return reports


def sharded_phase(args, dev):
    """The sharded runtime on the card, on a graph and generators of its
    own: a ``ShardedSession`` at world size 1 over NCCL in this process,
    bitwise the port's single-host ``Session`` on the same stream, the
    host index and set evaluation after every batch, the stream after the
    warm-up patch-only; then two spawned ranks over gloo on this one
    card, every result bitwise world 1's and a NaN held only by rank 1
    kept; NCCL at world size 2 where there are two cards.  Each rank's
    K1 launches per ``run()`` are counted; K1's and K2's counts of every
    rank add to the kernels line."""
    import datetime
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.bitset_expand.bitset_expand import bitset_expand_tiled

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sharded_", dir=os.path.join(ROOT, "build"))
    out = {"n": SHARDED_N, "window": "KHop(2)", "aggs": list(AGGS),
           "warmup_batches": SHARDED_WARMUP, "batches": SHARDED_BATCHES,
           "edits_per_batch": args.inserts + args.deletes}
    try:
        t = time.perf_counter()
        g = _sharded_graph(args)
        out["graph_s"] = time.perf_counter() - t
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":  # the mesh's communicator on this card
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store1"), 1),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=300))
        try:
            mesh = init_device_mesh(dev.type, (1,), mesh_dim_names=("data",))
            sess, build_s = _sharded_session(g, mesh, dev)
            host, host_build_s = _sharded_session(g, None, dev)
            check(sess.compiled.groups[0].engine == "torch-sharded",
                  f"the mesh session chose {sess.compiled.groups[0].engine}")
            (state,) = sess._states.values()
            (hstate,) = host._states.values()
            verts = np.sort(np.random.default_rng(args.seed + 13).choice(
                g.n, args.oracle_vertices, replace=False))

            def check_step(label, res, batch):
                # the single-host session is the comparison: its launches
                # are not the path's
                k1, k2 = k1_counts(), bitset_expand_tiled.launches
                if label == "run_many":
                    want = host.run_many(np.random.default_rng(args.seed + 12).integers(
                        0, 100, (SHARDED_B, g.n)).astype(np.float64))
                else:
                    if batch is not None:
                        host.update(batch)
                    want = host.run()
                k1_set(k1)
                bitset_expand_tiled.launches = k2
                for a, x, y in zip(AGGS, res, want):
                    check(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                          f"world 1 {label}: {a} differs from single-host")
                if label == "run_many":
                    return
                vals = sess.graph.attrs["val"]
                check_results(res, host_expect(state.index, vals), f"world 1 {label} vs host index")
                check_results([r[verts] for r in res], set_eval_expect(sess.graph, vals, verts),
                              f"world 1 {label} vs set evaluation")

            outputs, w1 = sharded_stream(sess, args, dev, check_step)
            if dev.type == "cuda":
                # one more run() under torch.profiler: K1 twice, the
                # collectives, the fills, the copies back
                prof_res = []
                w1["profile_run"] = device_profile(
                    lambda: prof_res.append(sess.run()), dev, w1["run_ms"],
                    match=("segment_reduce_kernel", "nccl", "Fill", "CatArray", "index_copy",
                           "Memcpy"))
                check_step("profiled run", prof_res[0], None)
                k1_traced = w1["profile_run"]["matched"]["segment_reduce_kernel"]["launches"]
                check(k1_traced == 2, f"the profiled sharded run() ran K1 {k1_traced} times")
            w1.update(build_s=build_s, host_session_build_s=host_build_s,
                      emc_build_s=state.index.stats.get("t_total_s"),
                      combine_ms=_combine_ms(sess, dev, args.reps),
                      nan_case=_nan_case(sess, 0, dev),
                      digest=sess.digest()["plan_crc"],
                      host_plan_bytes=hstate.plan.plan_nbytes())
            served, vb, sverts, sbatches, w1["service"] = sharded_service(sess, args, dev)
            add_counts(w1["launches"], w1["service"]["k1_launches"])
            # every ticket bitwise the single-host session on the same stream
            # (its launches are the comparison's, not the path's)
            k1, k2 = k1_counts(), bitset_expand_tiled.launches
            want = [host.run(vb[i])[0] for i in range(3)]
            for batch in sbatches:
                host.update(batch)
                res = host.run()
                want += [r[v] for r in res for v in sverts]
            k1_set(k1)
            bitset_expand_tiled.launches = k2
            for i, (x, y) in enumerate(zip(served, want)):
                check(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                      f"world 1 service ticket {i} differs from single-host")
            check(len(served) == len(want), "world 1 service: ticket count")
            out[f"world1_{backend}"] = w1
            expect = os.path.join(tmp, "world1.npz")
            np.savez(expect, **{f"o{i}": o for i, o in enumerate(
                x for res in outputs for x in res)},
                **{f"s{i}": x for i, x in enumerate(served)})
            del sess, host, state, hstate
        finally:
            dist.destroy_process_group()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        launches = dict(w1["launches"])
        t = time.perf_counter()
        ranks = _spawn_ranks(args, "gloo", dev, expect, tmp, 600)
        out["world2_gloo_s"] = time.perf_counter() - t
        out["world2_gloo"] = ranks
        check(len({r["digest"] for r in ranks}) == 1, "the gloo ranks' digests differ")
        check(len({r["service_digest"] for r in ranks}) == 1,
              "the gloo ranks' digests differ after the service's updates")
        for r in ranks:
            for name in launches:
                launches[name] += r["launches"][name]
        if dev.type == "cuda" and torch.cuda.device_count() >= 2:
            nccl = _spawn_ranks(args, "nccl", dev, expect, tmp, 600)
            out["world2_nccl"] = nccl
            for r in nccl:
                for name in launches:
                    launches[name] += r["launches"][name]
        else:
            out["world2_nccl"] = (f"skipped: {torch.cuda.device_count()} card(s); NCCL "
                                  "refuses two ranks on one card")
        out["launches"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def run(args, dev) -> None:
    import numpy as np
    import torch

    from repro_torch.graphs.generators import erdos_renyi, with_random_attrs
    from repro_torch.kernels import build
    from repro_torch.kernels.segment_reduce.segment_reduce import NARROW_MAX_C

    t_run = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    smi = smi_line()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})

    t = time.perf_counter()
    secs = build.build()
    ptxas = {name: build.ptxas_report(name) for name in secs}
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "per_kernel_s": secs, "ptxas": ptxas})
    for name, what in (("segment_sum", "K1"), ("bitset_expand", "K2"),
                       ("inherit_scan", "the scan")):
        funcs = ptxas[name]["functions"]
        check(bool(funcs) and all(f.get("spill_stores") == 0 and f.get("spill_loads") == 0
                                  for f in funcs.values()),
              f"{what}'s ptxas report shows spills: {funcs}")

    t = time.perf_counter()
    g = with_random_attrs(erdos_renyi(args.n, args.degree, directed=False,
                                      seed=args.seed), seed=args.seed + 1)
    t_graph = time.perf_counter() - t
    sess, state, policy, t_session = build_session(g, args, dev)
    plan = state.plan
    emit({"phase": "index", "n": g.n, "edges": g.n_edges, "window": "KHop(2)",
          "method": "emc", "graph_s": t_graph, "session_build_s": t_session,
          "emc_build_s": state.index.stats.get("t_total_s"),
          "blocks": int(state.index.num_blocks),
          "members": int(state.index.block_members.size),
          "links": int(state.index.stats.get("num_links", 0)),
          "plan_bytes": plan.plan_nbytes(), "block_capacity": plan.block_capacity,
          "pass1_rows": int(plan.pass1.seg_tiles.numel()),
          "pass2_rows": int(plan.pass2.seg_tiles.numel()),
          "p1_ell_is_none": plan.p1_ell is None, "policy": str(policy)})

    k1_forms = kernel_segment_sum(plan, g.attrs["val"], dev, args.reps, rng)
    emit({"phase": "kernel:segment_sum", "check": "ok", **k1_forms})
    k1 = k1_forms["sum"]
    # K2's shape (b) seeds, drawn where the first K2 phase drew them, so that
    # the main path's draws below match that version's; K2's other phases
    # draw from a generator of their own and shift no draw of the main path
    b_seeds = np.sort(rng.choice(g.n, min(4096, g.n), replace=False))
    k2_rng = np.random.default_rng(args.seed + 3)
    main = drive_main_path(sess, state, args, rng)
    main["device_bfs_leg"] = bfs_leg(sess, args, k2_rng, dev)
    emit({"phase": "session", **main})
    prof = profile_phase(sess, state, args, rng, dev,
                         {"run": main["run_ms"], "run_many": main["run_many_ms"],
                          "update": main["update_ms"]})
    emit({"phase": "profile", **prof})
    k2_traced = prof["update"]["matched"]["bitset_expand_kernel"]
    launches = main["launches"]
    check(launches["segment_sum"] > 0, "the main path launched no K1")
    check(launches["bitset_expand"] > 0, "the main path launched no K2")
    served = serve_window(sess, state, policy, args, rng, dev)
    emit({"phase": "serve_window", **served})
    check(served["launches"]["segment_sum"] > 0, "the serving path launched no K1")
    check(served["launches"]["bitset_expand"] > 0, "the serving path launched no K2")
    for name, count in served["launches"].items():
        launches[name] += count
    ea = explain_analyze(sess, state, dev, ("host_prep", "pass1_reduce", "pass2_reduce",
                                            "finalize"), 2, 0)
    emit({"phase": "explain_analyze", "window": "KHop(2)", **ea})
    for key in K1_KEYS:
        launches[key] += ea["launches"][key]
    # the GNN feature operator on this session's plan; serve_gnn reports it
    khop = khop_features(state, args, dev)
    del sess, state, plan

    # the topological window, on a generator of its own (no draw of the
    # k-hop path above or of K2's phase below shifts)
    topo_rng = np.random.default_rng(args.seed + 4)
    tsess, tstate, topo = topo_index(args, dev)
    emit({"phase": "topo_index", **topo})
    k1_wd, scans = kernel_inherit_scan(tsess, tstate, dev, args.reps, topo_rng)
    emit({"phase": "kernel:inherit_scan", "check": "ok", "k1_wd_plan": k1_wd, **scans})
    tmain = topo_session(tsess, tstate, args, topo_rng, dev)
    emit({"phase": "topo_session", **tmain})
    tprof = topo_profile(tsess, tstate, dev, tmain["run_ms"])
    emit({"phase": "topo_profile", "run": tprof})
    tea = explain_analyze(tsess, tstate, dev, ("host_prep", "wd_reduce", "inherit",
                                               "finalize"), 1, 1)
    emit({"phase": "explain_analyze", "window": "TopologicalWindow()", **tea})
    for key in K1_KEYS:
        launches[key] += tmain["launches"][key] + tea["launches"][key]
    # the window path's K1 launches are at C <= 4 (run), 24 / 32 (run_many)
    # and 3 / 24 (wd_plan): on the narrow route, by its counter
    check(launches["segment_sum_wide"] == 0,
          f"the window path made {launches['segment_sum_wide']} wide K1 launches")
    launches["inherit_scan"] = (tmain["launches"]["inherit_scan"]
                                + tea["launches"]["inherit_scan"])
    check(launches["inherit_scan"] > 0, "the topological path launched no scan")
    del tsess, tstate

    k3_build = k3_build_report()
    k3, k3_err = kernel_flash_attention(dev, args.reps, args.seed)
    emit({"phase": "kernel:flash_attention", "check": "ok", "max_abs_err": k3_err,
          "build": k3_build, "per_shape": k3})
    k4, k4_err = kernel_fm_interaction(dev, args.reps, args.seed)
    emit({"phase": "kernel:fm_interaction", "check": "ok", "max_abs_err": k4_err,
          "per_shape": k4})
    launches["flash_attention"] = 0
    for arch in LM_ARCHS:
        lm, k3_launches = serve_lm(arch, args, dev)
        emit({"phase": "serve_lm", **lm})
        launches["flash_attention"] += k3_launches
        del lm
        torch.cuda.empty_cache()
    fm, launches["fm_interaction"] = serve_fm(args, dev)
    emit({"phase": "serve_fm", **fm})
    gnn_out, gnn_train, gnn_k1, gnn_k1_bwd, k1_bwd = serve_gnn(args, dev, khop)
    emit({"phase": "serve_gnn", **gnn_out})
    emit({"phase": "train_gnn", **gnn_train})
    emit({"phase": "kernel:segment_sum_bwd", "check": "ok", **k1_bwd})
    emit({"phase": "kernel:segment_sum_routes", "check": "ok",
          "narrow_max_c": NARROW_MAX_C, "ptxas": k1_ptxas_by_route(),
          "plans": _K1_ROUTES})
    add_counts(add_counts(launches, gnn_k1), gnn_k1_bwd)
    check(launches["segment_sum_bwd"] > 0, "the GNN training path launched no K1 backward")
    gwq, gwq_k1 = gwq_phase(args, dev)
    emit({"phase": "gwq", **gwq})
    add_counts(launches, gwq_k1)
    # the training path: its backward kernels checked first, then the
    # trainers, the card's memory freed on either side
    torch.cuda.empty_cache()
    k3b, k3b_err, k3b_build = kernel_flash_attention_bwd(dev, args.reps, args.seed)
    emit({"phase": "kernel:flash_attention_bwd", "check": "ok", "max_abs_err": k3b_err,
          "build": k3b_build, "per_shape": k3b})
    k4b = kernel_fm_interaction_bwd(dev, args.reps, args.seed)
    emit({"phase": "kernel:fm_interaction_bwd", "check": "ok", **k4b})
    trained, train_counts = train_phase(args, dev)
    emit({"phase": "train", **trained})
    torch.cuda.empty_cache()
    launches["flash_attention"] += train_counts["flash_attention"]
    launches["fm_interaction"] += train_counts["fm_interaction"]
    for name in ("flash_attention_bwd", "fm_interaction_bwd", "flash_attention_bwd_sm90"):
        launches[name] = train_counts[name]
        check(launches[name] > 0, f"the training path launched no {name}")
    launches["flash_attention_bwd_simt"] = train_counts["flash_attention_bwd_simt"]
    meshed, mesh_counts = mesh_steps(args, dev)
    emit({"phase": "mesh_steps", "nvidia_smi": smi, **meshed})
    for name in ("flash_attention", "fm_interaction", "flash_attention_bwd",
                 "fm_interaction_bwd", "flash_attention_bwd_sm90", "flash_attention_bwd_simt"):
        launches[name] += mesh_counts[name]
    # after the timed serving paths, before K2's 2 M-vertex graph: a graph
    # and a generator of its own
    cluster = cluster_phase(args, dev)
    emit({"phase": "cluster", **cluster})
    for name, count in cluster["launches"].items():
        launches[name] += count
    sharded = sharded_phase(args, dev)
    emit({"phase": "sharded", **sharded})
    for name, count in sharded["launches"].items():
        launches[name] += count
    # last: the 2 M-vertex graph of its shape (c) would otherwise sit in
    # this process while the end-to-end paths above are timed
    k2_shapes = kernel_bitset_expand(g, args, dev, k2_rng, b_seeds)
    emit({"phase": "kernel:bitset_expand", "check": "ok", **k2_shapes})
    k2 = k2_shapes["per_shape"]["a_main_path"]
    k3_row, k4_row = k3["serve_prefill"], k4["serve_bulk"]
    # every K1 launch of the run counted once, on one route
    for key in ("segment_sum", "segment_sum_bwd"):
        check(launches[f"{key}_narrow"] + launches[f"{key}_wide"] == launches[key],
              f"{key}'s launches by route do not add up to {launches[key]}: "
              f"{launches[f'{key}_narrow']} narrow, {launches[f'{key}_wide']} wide")
    wide = _K1_ROUTES["ogb_products_sage_by_src"][128]

    rows = [
        {"name": "segment_sum", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": "src/repro/kernels/segment_reduce/segment_reduce.py:69",
         "launches": launches["segment_sum"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"],
         "back_to_back_ms": k1["back_to_back_ms"],
         "minmax_form": {key: k1_forms["minmax"][key] for key in
                         ("ms", "back_to_back_ms", "plain_ms", "bound_ms", "library_ms",
                          "max_abs_err")},
         "wd_plan_form": {key: k1_wd["run"][key] for key in
                          ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err")},
         "routes": {"narrow": f"C <= {NARROW_MAX_C}: segment_reduce_kernel",
                    "wide": (f"C > {NARROW_MAX_C}: segment_reduce_kernel_wide, then "
                             "segment_reduce_wide_fixup")},
         "launches_by_route": {"narrow": launches["segment_sum_narrow"],
                               "wide": launches["segment_sum_wide"]},
         "wide_form": {"shape": "ogb_products SAGE by_src, C = 128",
                       "ms": wide["wide"]["ms"], "narrow_ms": wide["narrow"]["ms"],
                       "max_abs_err": wide["wide"]["max_abs_err"],
                       **{key: wide[key] for key in ("bound_ms", "bound_by",
                                                     "streamed_bound_ms", "library_ms")}},
         "check": "ok"},
        {"name": "segment_sum_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/segment_sum.cu",
         "replaces": ("src/repro/kernels/segment_reduce/segment_reduce.py:69 (the TPU "
                      "kernel has no backward; the reference differentiates "
                      "jax.ops.segment_sum): K1 launched on the source-sorted layout"),
         "launches": launches["segment_sum_bwd"], "max_abs_err": k1_bwd["max_abs_err"],
         "launches_by_route": {"narrow": launches["segment_sum_bwd_narrow"],
                               "wide": launches["segment_sum_bwd_wide"]},
         "k1_route": k1_bwd["route"],
         **{key: k1_bwd[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "streamed_bound_ms", "library_ms", "shape")},
         "check": "ok"},
        {"name": "bitset_expand", "route": "cuda",
         "source": "src/repro_torch/csrc/bitset_expand.cu",
         "replaces": "src/repro/kernels/bitset_expand/bitset_expand.py:81",
         "launches": launches["bitset_expand"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"],
         "bound_dense_ms": k2["bound_dense_ms"], "device_ms": k2["device_ms"],
         "profiled_update_device_ms": (k2_traced["device_ms"] if k2_traced["launches"]
                                       else "not measured"),
         "per_shape": {name: {key: sh.get(key) for key in
                              ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_dense_ms", "wrapper_host_ms", "mask_prepass_ms",
                               "mask_prepass_bound_ms", "memset_out_ms",
                               "input_rows_nonzero_share", "input_groups_nonzero_share")}
                       for name, sh in k2_shapes["per_shape"].items()},
         "check": "ok"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
         "replaces": "src/repro/kernels/flash_attention/flash_attention.py:76",
         "launches": launches["flash_attention"], "max_abs_err": k3_err,
         "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
         "bound_ms": k3_row["bound_ms"], "bound_by": k3_row["bound_by"],
         "library_ms": k3_row["library_ms"],
         **{f"{form}_form": {key: k3[shape][key] for key in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "max_abs_err", "route")}
            for form, shape in (("d128", "minitron_prefill"), ("moe_g1", "moe_prefill"),
                                ("grok_g6", "grok_prefill"))},
         "check": "ok"},
        {"name": "fm_interaction", "route": "cuda",
         "source": "src/repro_torch/csrc/fm_interaction.cu",
         "replaces": "src/repro/kernels/fm_interaction/fm_interaction.py:31",
         "launches": launches["fm_interaction"], "max_abs_err": k4_err,
         "ms": k4_row["ms"], "plain_ms": k4_row["plain_ms"],
         "bound_ms": k4_row["bound_ms"], "bound_by": k4_row["bound_by"],
         "library_ms": None,
         "library": "none: no single PyTorch call computes the FM term",
         "check": "ok"},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": K3_BWD_SOURCE["sm90"],
         "sources": {"sm90 (bf16, D 64 / 128)": K3_BWD_SOURCE["sm90"],
                     "simt (the rest)": K3_BWD_SOURCE["simt"]},
         "replaces": ("src/repro/kernels/flash_attention/flash_attention.py:76 (the TPU "
                      "kernel has no backward; the reference trains through flash_jnp "
                      "autodiff, src/repro/models/attention.py:43)"),
         "launches": launches["flash_attention_bwd"],
         "launches_by_route": {"sm90": launches["flash_attention_bwd_sm90"],
                               "simt": launches["flash_attention_bwd_simt"]},
         "max_abs_err": k3b_err,
         **{key: k3b["qwen3_train"][key] for key in
            ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "route")},
         **{f"{form}_form": {key: k3b[form][key] for key in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "max_abs_err", "errors", "route", "source")}
            for form in ("moe_train", "float32")},
         "check": "ok"},
        {"name": "fm_interaction_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/fm_interaction.cu",
         "replaces": ("src/repro/kernels/fm_interaction/fm_interaction.py:31 (the TPU "
                      "kernel has no backward; the reference trains through the jnp "
                      "interaction)"),
         "launches": launches["fm_interaction_bwd"], "max_abs_err": k4b["max_abs_err"],
         **{key: k4b[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "library": "none: no single PyTorch call computes the FM term's gradient",
         "check": "ok"},
        {"name": "inherit_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/inherit_scan.cu",
         "replaces": "src/repro/core/engine_jax.py:611 (_inherit_scan, jnp; no Pallas kernel)",
         "launches": launches["inherit_scan"], "max_abs_err": scans["run"]["max_abs_err"],
         "ms": scans["run"]["ms"], "plain_ms": scans["run"]["plain_ms"],
         "bound_ms": scans["run"]["bound_ms"], "bound_by": scans["run"]["bound_by"],
         "library_ms": None,
         "library": "none: no single PyTorch call computes the scan",
         "dependency_bound_ms": scans["run"]["dependency_bound_ms"],
         "doubling_ms": scans["run"]["doubling_ms"],
         **{key: scans["run"][key] for key in ("depth", "chains", "spine", "max_light_edges")},
         **{f"{form}_form": {key: scans[form][key] for key in
                             ("ms", "plain_ms", "doubling_ms", "bound_ms",
                              "dependency_bound_ms", "chains", "spine")}
            for form in ("run_many", "path", "star")},
         "check": "ok"},
    ]
    emit({"phase": "done", "seconds": time.perf_counter() - t_run})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(_LINES + [json.dumps({"kernels": rows})]) + "\n")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # the k-hop graph: cut from 100,000 to 60,000 when the MoE archs joined
    # the run (it took 1,154 s of the 1,200 with 100,000: the host EMC build
    # grows ~n^2 and runs three times on it, 114-141 s each on that run's
    # host, 67-88 s on earlier ones), then to 45,000 when GNN training and
    # the gwq data plane joined it (45.1-50.2 s a build at 60,000)
    ap.add_argument("--n", type=int, default=45_000)
    ap.add_argument("--degree", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    # the k-hop and topological streams' batches: cut from 20 to 10 when
    # minitron-8b, the GNN family and sharded serving joined the run (the
    # run took 1,021.7 s with 20; each batch is 5-7 s of host maintenance)
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--inserts", type=int, default=100)
    ap.add_argument("--deletes", type=int, default=25)
    ap.add_argument("--oracle-vertices", type=int, default=256)
    ap.add_argument("--reps", type=int, default=20, help="timed launches")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    # keep CUPTI attached between profiled calls (torch tears it down after
    # each by default; after such a re-attach a trace has been seen to miss
    # every launch of the port's own libraries)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "measures the card and has nothing to run without one",
              file=sys.stderr)
        return 2
    run(args, torch.device("cuda"))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
