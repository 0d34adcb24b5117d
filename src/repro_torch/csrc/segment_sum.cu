// Fused gather + sorted segment reduction over a tile plan (float32), with a
// monoid per column: sum, min or max.
//
// Replaces the TPU kernel `segment_sum_tiled` in
// src/repro/kernels/segment_reduce/segment_reduce.py (body `_seg_sum_kernel`)
// for the sum columns, and the masked segment min/max that the reference
// leaves to XLA (`_segment_minmax_gathered`, src/repro/core/engine_jax.py)
// for the min and max columns, so one launch per pass carries every channel.
//
//   out[s, c] = m[c]-reduce of values[gather[r], c] over the plan rows r with
//               seg[r] == s (gather == NULL: values holds the gathered rows),
//
// with m[c] = sum for c < n_sum, min for c < n_sum + n_min, max after.  An
// empty segment holds its monoid's identity (0, +inf, -inf); min and max
// propagate NaN, as torch.amin/amax and XLA's segment_min/max do.
//
// Layout (built on the host by build_tile_plan): rows are grouped by output
// tile of `ts` segment ids, every output tile has at least one input tile of
// `tm` rows, `m2out[t]` names the output tile of input tile t; within a
// group the valid rows come first, sorted by segment id, and pad rows carry
// seg -1.  So a segment's rows are one contiguous run of plan rows.
//
// Two routes, both reached through segment_reduce_f32; the wrapper's route
// table (`route` in kernels/segment_reduce/segment_reduce.py) picks one by
// the column count C and passes `slice_rows` > 0 for the wide one.
//
// What bounds it on an H100: bytes.  Each plan row is one combine a column;
// the work is reading the plan's index arrays (8 bytes a valid row) and the
// gathered value rows (4 C bytes each).  For the window path's narrow rows
// (C <= 4, a few MB of values) the rows stay in L2 and the index arrays set
// the time.  For the GNN's wide rows (C = 100-1,433; ogbn-products' values
// are 1.0-1.25 GB, 20-25 times the L2) every gathered row streams from HBM,
// and the time is that of moving 4 C bytes a valid plan row.
//
// The narrow route (C at or below the table's threshold;
// `segment_reduce_kernel`):
// - Work is split over input rows, not output tiles, and over warps, not
//   blocks: each warp owns a range of consecutive plan rows and walks it in
//   windows of 128 rows, four neighbouring rows a lane, so segment ids and
//   gather indices come in one 16-byte load a lane.  Warps never wait for
//   each other (no block barrier), so the SM hides one warp's loads behind
//   the others' work; the next window's indices are loaded while the
//   current one is reduced.
// - Pad rows are skipped: inside a group the valid rows come first, so
//   after a pad row the warp goes on at the next input tile's first row.
// - A window is reduced with a segmented scan keyed on segment-id changes
//   (in registers, then warp shuffles); the run still open at the window's
//   end is carried into the next window, and each run is written once, by
//   the lane holding its last row.  Columns go in register chunks of up to
//   four, with vector loads of a row's channels when the row width allows.
// - A run belongs to the warp in which it starts.  A warp skips the run it
//   starts inside of, and reads on past its range for the run it leaves
//   open, window by window, until the segment id changes.
// - Divisions by `tm` and `ts` are shifts when they are powers of two, and
//   an all-sum instance drops the min/max code when every column is a sum.
// - Every output cell is written by the kernel: a run's owner also writes
//   the identity into the empty segments up to the next run of its group
//   (the group's first run, those before it), and a group with no valid
//   rows is filled by the warp holding its first input tile; each such fill
//   is spread over the warp's 32 lanes.
// - No atomics on values.  The order of a segment's combines follows from
//   the plan alone (row positions and the warp's range, chosen from the
//   plan's row count), never from scheduling or from the number of columns,
//   so two launches are bitwise equal and a column's result does not depend
//   on which columns ride along.
// At wide rows this design loses: every 4-column chunk repeats the whole
// segmented scan, a warp load touches 128 different rows, and a long run is
// walked by one warp.
//
// The wide route (C above the threshold; `segment_reduce_kernel_wide`, then
// `segment_reduce_wide_fixup`):
// - Lanes run across columns.  A work item is a slice of `slice_rows`
//   consecutive plan rows (a power of two from 32 to 1,024 that the wrapper
//   picks from the plan's row count alone) times a tile of 128 columns, and
//   one warp does it: lane l holds columns 4l..4l+3 of the tile (one 16-byte
//   load a row where C % 4 == 0 and the values are 16-byte aligned) or
//   l, l+32, l+64, l+96 (four 4-byte loads, each coalesced over the warp).
//   Each gathered row's read is coalesced, and a row wider than 128 columns
//   is covered by ceil(C / 128) work items over the same plan rows.
// - The warp walks its slice in row order; the running combine of the open
//   run stays in registers, and a segment-id change writes it.  No scan over
//   rows: a segment's rows are one contiguous run.
// - Rows in flight: ids come 128 rows at a time in 16-byte loads (four a
//   lane), and the warp issues the loads of 8 gathered rows (8 x 512 bytes
//   at a full tile) before it combines the first of them.  At 86-94
//   registers two blocks of 8 warps fit an SM: up to 64 KB in flight an
//   SM, against the ~18 KB that cover HBM's latency (3.35 TB/s x ~0.7 us /
//   132 SMs).  Registers hold them, so no shared-memory ring is needed.
// - Long runs are split by position.  A run wholly inside a slice is written
//   directly.  A run cut by slice edges leaves one partial a slice in
//   scratch the wrapper allocates (`head[k]`, slice k's first run when it
//   began before the slice; `tail[k]`, its last run when it goes on past
//   it), and the second launch combines them in slice order: the slice
//   holding the run's last row owns it, walks back over the slices the run
//   covers whole, and writes tail[a] + head[a+1] + ... + head[b].  So a
//   high-degree node spreads over many warps, and the order of its combines
//   follows from the plan and `slice_rows` alone.
// - Pad rows are skipped as in the narrow route; every output cell is
//   written by the kernel as there (gaps after a run by the slice holding the
//   run's last row, a group's leading gap by the slice holding its first
//   run's first row, an empty group by the slice holding its first input
//   tile's first row), each over the work item's 128 columns.
// - No atomics on values; two launches are bitwise equal, and a column's
//   result does not depend on which columns ride along.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int IT = 4;        // plan rows per lane and window: one 16-byte load
constexpr int WR = 32 * IT;  // rows per window
constexpr int NT = 128;      // threads per block: four independent warps
constexpr unsigned FULL = 0xffffffffu;
enum { SUM = 0, MIN = 1, MAX = 2 };

// the column count and its split into sum, min and max groups
struct Cols {
  int C, n_sum, n_min;
};

// x / d for x >= 0, by a shift when d is a power of two (as tm and ts are in
// the plans the executor builds)
struct Div {
  unsigned d;
  int shift;  // log2(d), or -1
  __device__ __forceinline__ unsigned operator()(long long x) const {
    return shift >= 0 ? (unsigned)(x >> shift) : (unsigned)x / d;
  }
};

__device__ __forceinline__ int code_of(int c, Cols m) {
  return c < m.n_sum ? SUM : (c < m.n_sum + m.n_min ? MIN : MAX);
}

__device__ __forceinline__ float identity(int code) {
  return code == SUM ? 0.0f : (code == MIN ? CUDART_INF_F : -CUDART_INF_F);
}

// `a` comes first in row order.  min/max keep a NaN from either side.
__device__ __forceinline__ float combine(int code, float a, float b) {
  if (code == SUM) return a + b;
  if (code == MIN) return (a < b || a != a) ? a : b;
  return (a > b || a != a) ? a : b;
}

// Identities into segments [s0, s1) of every lane that `has` a range, the
// whole warp writing each range in turn (a range is at most one group, so
// offsets within it fit 32 bits).
__device__ __forceinline__ void warp_fill(float* out, Cols m, bool has, long long s0,
                                          long long s1, int lane) {
  unsigned todo = __ballot_sync(FULL, has && s1 > s0);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const long long a = __shfl_sync(FULL, s0, l);
    const int count = (int)(__shfl_sync(FULL, s1, l) - a) * m.C;
    float* o = out + a * m.C;
    for (int i = lane; i < count; i += 32) o[i] = identity(code_of(i % m.C, m));
  }
}

template <int CC>
__device__ __forceinline__ void load_row(const float* values, int C, long long g, int c0,
                                         bool vec, float (&v)[CC]) {
  const float* p = values + g * C + c0;
  if constexpr (CC == 4) {
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      return;
    }
  } else if constexpr (CC == 2) {
    if (vec) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x; v[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < CC; ++j)
    if (c0 + j < C) v[j] = __ldg(p + j);
}

// one lane's IT ids from row r on (`fill` past the plan's rows, a multiple of 4)
__device__ __forceinline__ void load_ids(const int* p, long long r, long long rows, int fill,
                                         int (&q)[IT]) {
#pragma unroll
  for (int k = 0; k < IT; k += 4) {
    if (r + k < rows) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(p + r + k));
      q[k] = x.x; q[k + 1] = x.y; q[k + 2] = x.z; q[k + 3] = x.w;
    } else {
      q[k] = q[k + 1] = q[k + 2] = q[k + 3] = fill;
    }
  }
}

// CC columns a register chunk; MONO = SUM when every column is a sum (so
// the compiler drops the min/max code), -1 otherwise
template <int CC, int MONO>
__global__ void __launch_bounds__(NT, 1)
    segment_reduce_kernel(const float* __restrict__ values, const int* __restrict__ gather,
                          const int* __restrict__ seg, const int* __restrict__ m2out,
                          float* __restrict__ out, long long rows, Div tm, Div ts,
                          int windows, Cols m) {
  extern __shared__ float carry_all[];  // [NT / 32][C]: each warp's open run
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int C = m.C;
  float* carry = carry_all + warp * C;
  const long long w0 = ((long long)blockIdx.x * (NT / 32) + warp) * windows * WR;
  if (w0 >= rows) return;
  const long long lim = w0 + (long long)windows * WR;  // end of the owned rows
  const bool vec = (C % CC == 0) && ((reinterpret_cast<uintptr_t>(values) & 15) == 0);

  // the run this warp starts inside of belongs to the warp it started in
  const int head = w0 > 0 ? __ldg(seg + w0 - 1) : -1;
  int prev_raw = head;  // raw id of the row before the window
  int carry_key = -1;   // key of the run open at the end of the last window
  int open_key = -1;    // that run's id once the owned rows are done
  int s[IT], gi[IT];
  load_ids(seg, w0 + lane * IT, rows, -1, s);
#pragma unroll
  for (int i = 0; i < IT; ++i) gi[i] = 0;
  if (gather) load_ids(gather, w0 + lane * IT, rows, 0, gi);

  for (long long r = w0, rn; r < rows; r = rn) {
    const bool owned = r < lim;
    if (!owned && carry_key < 0) break;  // nothing left open
    // ---- the next window's indices, in flight while this one is reduced
    // after a pad row the rest of its input tile is pad: the next window
    // read is then the next tile's first (the owned rows end at lim)
    rn = r + WR;
    const int last_raw = __shfl_sync(FULL, s[IT - 1], 31);
    int sn[IT], gn[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      sn[i] = -1;
      gn[i] = 0;
    }
    if (owned && last_raw < 0 && tm(rn - 1) == tm(rn + WR - 1)) {
      rn = (long long)(tm(rn - 1) + 1) * tm.d;
      if (rn > lim) rn = lim;
    }
    load_ids(seg, rn + lane * IT, rows, -1, sn);
    if (gather) load_ids(gather, rn + lane * IT, rows, 0, gn);

    // ---- keys: a row keeps its id when its run belongs to this warp ----
    int key[IT], praw[IT], nraw[IT];
    bool flag[IT];
    const int up = __shfl_up_sync(FULL, s[IT - 1], 1);
    const int down = __shfl_down_sync(FULL, s[0], 1);
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      key[i] = (s[i] >= 0 && s[i] != head && (owned || s[i] == open_key)) ? s[i] : -1;
      praw[i] = i > 0 ? s[i - 1] : (lane > 0 ? up : prev_raw);
      nraw[i] = i < IT - 1 ? s[i + 1] : down;  // lane 31's last: unused
    }
    const int kup = __shfl_up_sync(FULL, key[IT - 1], 1);
#pragma unroll
    for (int i = 0; i < IT; ++i)
      flag[i] = key[i] != (i > 0 ? key[i - 1] : (lane > 0 ? kup : carry_key));
    // the carried run ends where this window does not continue it
    const int key0 = __shfl_sync(FULL, key[0], 0);
    const bool emit = carry_key >= 0 && key0 != carry_key;

    // ---- segmented scan, one chunk of columns at a time (a window with no
    // row of this warp's runs and no run to close has nothing to reduce) --
    bool mine = false;
#pragma unroll
    for (int i = 0; i < IT; ++i) mine = mine || key[i] >= 0;
    const bool work = emit || __any_sync(FULL, mine);
    for (int c0 = 0; work && c0 < C; c0 += CC) {
      int code[CC];
      float cv[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        code[j] = MONO >= 0 ? MONO : code_of(c0 + j, m);
        cv[j] = (carry_key >= 0 && c0 + j < C) ? carry[c0 + j] : identity(code[j]);
      }
      if (emit && lane == 0) {
#pragma unroll
        for (int j = 0; j < CC; ++j)
          if (c0 + j < C) out[(long long)carry_key * C + c0 + j] = cv[j];
      }
      float inc[IT][CC];
#pragma unroll
      for (int i = 0; i < IT; ++i) {
#pragma unroll
        for (int j = 0; j < CC; ++j) inc[i][j] = identity(code[j]);
        if (key[i] >= 0)
          load_row<CC>(values, C, gather ? (long long)gi[i] : r + lane * IT + i, c0, vec,
                       inc[i]);
      }
      // within the lane: inc[i] folds the rows since the last run start
      int tf = flag[0];
#pragma unroll
      for (int i = 1; i < IT; ++i) {
        if (!flag[i]) {
#pragma unroll
          for (int j = 0; j < CC; ++j)
            inc[i][j] = combine(code[j], inc[i - 1][j], inc[i][j]);
        }
        tf |= flag[i];
      }
      // across the warp: inclusive segmented scan of the lanes' last runs
      float tv[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) tv[j] = inc[IT - 1][j];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int of = __shfl_up_sync(FULL, tf, d);
        float ov[CC];
#pragma unroll
        for (int j = 0; j < CC; ++j) ov[j] = __shfl_up_sync(FULL, tv[j], d);
        if (lane >= d) {
          if (!tf) {
#pragma unroll
            for (int j = 0; j < CC; ++j) tv[j] = combine(code[j], ov[j], tv[j]);
          }
          tf |= of;
        }
      }
      // exclusive prefix of this lane: the carried run, then earlier lanes
      const int lf = __shfl_up_sync(FULL, tf, 1);
      float ev[CC];
#pragma unroll
      for (int j = 0; j < CC; ++j) {
        const float lv = __shfl_up_sync(FULL, tv[j], 1);
        ev[j] = lane == 0 ? cv[j] : (lf ? lv : combine(code[j], cv[j], lv));
      }
      __syncwarp();  // every lane has read the carry before lane 31 replaces it
      bool seen = false;
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        seen = seen || flag[i];
        const bool last = lane == 31 && i == IT - 1;
        if (key[i] < 0 || (!last && nraw[i] == key[i])) continue;
        float res[CC];
#pragma unroll
        for (int j = 0; j < CC; ++j)
          res[j] = seen ? inc[i][j] : combine(code[j], ev[j], inc[i][j]);
        float* dst = last ? carry + c0 : out + (long long)key[i] * C + c0;
#pragma unroll
        for (int j = 0; j < CC; ++j)
          if (c0 + j < C) dst[j] = res[j];
      }
      __syncwarp();
    }

    // ---- identities of the empty segments next to this window's runs ---
    // (a run's start or end, the carried run's end, an empty group's tile)
    // (runs of consecutive ids leave no gap: most windows skip this)
    const long long r0 = r + lane * IT;
    const unsigned t0 = tm(r0);
    const bool empty_tile = owned && r0 < rows && (long long)t0 * tm.d == r0 && s[0] < 0;
    const int n0 = __shfl_sync(FULL, s[0], 0);
    bool edge = (emit && lane == 0 && n0 != carry_key + 1) || empty_tile;
#pragma unroll
    for (int i = 0; i < IT; ++i)
      edge = edge || (key[i] >= 0 && ((flag[i] && praw[i] != key[i] - 1) ||
                                      (nraw[i] != key[i] && nraw[i] != key[i] + 1)));
    if (__any_sync(FULL, edge)) {
      long long a = 0, b = 0;
      // after run k, up to the next run n of its group or the group's end
      auto after = [&](int k, int n) {
        const unsigned g = ts(k);
        a = (long long)k + 1;
        b = (n >= 0 && ts(n) == g) ? n : (long long)(g + 1) * ts.d;
      };
      {  // the carried run, ended by this window's first row
        const bool has = emit && lane == 0;
        if (has) after(carry_key, n0);
        warp_fill(out, m, has, a, b, lane);
      }
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int k = key[i];
        // the group's first run: from the group's start
        bool has = k >= 0 && flag[i] && (praw[i] < 0 || ts(praw[i]) != ts(k));
        if (has) {
          a = (long long)ts(k) * ts.d;
          b = k;
        }
        warp_fill(out, m, has, a, b, lane);
        // a run that ends inside the window
        has = k >= 0 && !(lane == 31 && i == IT - 1) && nraw[i] != k;
        if (has) after(k, nraw[i]);
        warp_fill(out, m, has, a, b, lane);
      }
      // a group with no valid rows: its first input tile starts with a pad row
      bool has = false;
      if (empty_tile) {
        const int o = __ldg(m2out + t0);
        has = t0 == 0 || __ldg(m2out + t0 - 1) != o;
        a = (long long)o * ts.d;
        b = a + ts.d;
      }
      warp_fill(out, m, has, a, b, lane);
    }

    // ---- carry on -------------------------------------------------------
    carry_key = __shfl_sync(FULL, key[IT - 1], 31);
    if (owned && rn >= lim) open_key = carry_key;  // the run left open at the range's end
    prev_raw = last_raw;
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      s[i] = sn[i];
      gi[i] = gn[i];
    }
  }
  // the plan's last run, open at its last row
  if (carry_key >= 0) {
    for (int c = lane; c < C; c += 32) out[(long long)carry_key * C + c] = carry[c];
    warp_fill(out, m, lane == 0, (long long)carry_key + 1,
              (long long)(ts(carry_key) + 1) * ts.d, lane);
  }
}

struct Launch {
  const float* values;
  const int *gather, *seg, *m2out;
  float* out;
  long long rows;
  Div tm, ts;
  Cols m;
};

Div div_by(int d) {
  int shift = -1;
  if ((d & (d - 1)) == 0)
    for (shift = 0; (1 << shift) != d; ++shift) {
    }
  return Div{(unsigned)d, shift};
}

template <int CC, int MONO>
int launch(const Launch& l, cudaStream_t stream) {
  const size_t smem = (size_t)(NT / 32) * l.m.C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(segment_reduce_kernel<CC, MONO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // A warp's range follows from the plan's row count alone (so the order of
  // a segment's combines does too): 8 windows for large plans, 2 below 2^21
  // rows so a small pass still spreads over the card.
  const int windows = l.rows >= (1LL << 21) ? 8 : 2;
  const long long per_block = (long long)(NT / 32) * windows * WR;
  const long long blocks = (l.rows + per_block - 1) / per_block;
  segment_reduce_kernel<CC, MONO><<<(unsigned)blocks, NT, smem, stream>>>(
      l.values, l.gather, l.seg, l.m2out, l.out, l.rows, l.tm, l.ts, windows, l.m);
  return (int)cudaGetLastError();
}

// all-sum columns (sum-only queries, ELL plans) take the instance without
// the min/max code; any other split, all-min and all-max too, the mixed one
template <int CC>
int launch_cc(const Launch& l, cudaStream_t stream) {
  return l.m.n_sum == l.m.C ? launch<CC, SUM>(l, stream) : launch<CC, -1>(l, stream);
}


// ------------------------------------------------------------------------
// The wide route
// ------------------------------------------------------------------------

constexpr int WNT = 256;               // threads per block: eight independent warps
constexpr int WWARPS = WNT / 32;
constexpr int TILE = 128;              // columns per work item: four a lane
constexpr int INFLIGHT = 8;            // gathered rows a warp loads before combining

struct Wide {
  const float* values;
  const int *gather, *seg, *m2out;
  float* out;
  float *head, *tail;  // [n_slices][C] each: the partials of runs cut by slice edges
  long long rows, n_slices;
  Div tm, ts;
  int slice_rows, tiles;
  Cols m;
};

// lane's j-th column of the tile starting at c0
template <bool VEC>
__device__ __forceinline__ int col_of(int c0, int lane, int j) {
  return VEC ? c0 + 4 * lane + j : c0 + lane + 32 * j;
}

// the lane's (up to) four columns of one row; VEC: C % 4 == 0 and the row
// 16-byte aligned, so a lane's four columns are all in the row or all past it
template <bool VEC>
__device__ __forceinline__ void row_load(const float* row, int c0, int lane, int C,
                                         float (&v)[4]) {
  if constexpr (VEC) {
    const int c = c0 + 4 * lane;
    if (c < C) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(row + c));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < C) v[j] = __ldg(row + c);
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void row_store(float* row, int c0, int lane, int C,
                                          const float (&v)[4]) {
  if constexpr (VEC) {
    const int c = c0 + 4 * lane;
    if (c < C) *reinterpret_cast<float4*>(row + c) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < C) row[c] = v[j];
    }
  }
}

// identities into segments [a, b) of the work item's columns
template <bool VEC>
__device__ __forceinline__ void tile_fill(float* out, long long a, long long b, int c0,
                                          int lane, int C, const float (&id)[4]) {
  for (long long s = a; s < b; ++s) row_store<VEC>(out + s * C, c0, lane, C, id);
}

template <int MONO>
__device__ __forceinline__ void combine4(const int (&code)[4], float (&acc)[4],
                                         const float (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = combine(MONO >= 0 ? MONO : code[j], acc[j], v[j]);
}

// One warp per work item (slice k, column tile); runs cut by the slice's
// edges go to head[k] / tail[k], the rest straight to out.
template <bool VEC, int MONO>
__global__ void __launch_bounds__(WNT, 2) segment_reduce_kernel_wide(const Wide w) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WWARPS + (threadIdx.x >> 5);
  if (item >= w.n_slices * w.tiles) return;
  const long long k = item / w.tiles;
  const int c0 = (int)(item % w.tiles) * TILE;
  const int C = w.m.C;
  int code[4];
  float id[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    code[j] = MONO >= 0 ? MONO : code_of(col_of<VEC>(c0, lane, j), w.m);
    id[j] = identity(code[j]);
  }
  const long long r0 = k * w.slice_rows;
  const long long end = min(r0 + w.slice_rows, w.rows);

  // groups with no valid rows whose first input tile starts in this slice
  for (long long r = (long long)w.tm(r0 + w.tm.d - 1) * w.tm.d; r < end; r += w.tm.d) {
    const unsigned t = w.tm(r);
    if (__ldg(w.seg + r) >= 0) continue;
    const int o = __ldg(w.m2out + t);
    if (t == 0 || __ldg(w.m2out + t - 1) != o)
      tile_fill<VEC>(w.out, (long long)o * w.ts.d, (long long)(o + 1) * w.ts.d, c0, lane, C,
                     id);
  }

  int prev = r0 > 0 ? __ldg(w.seg + r0 - 1) : -1;  // raw id of the row before
  int cur = -1;       // the open run's segment
  bool cut = false;   // the open run began before this slice
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // the open run ends before a row of segment `nxt` (-1: pad or the plan's
  // end): its value, then the identities up to the next run of its group
  auto finish = [&](int nxt) {
    row_store<VEC>(cut ? w.head + k * C : w.out + (long long)cur * C, c0, lane, C, acc);
    const unsigned g = w.ts(cur);
    const long long b = (nxt >= 0 && w.ts(nxt) == g) ? nxt : (long long)(g + 1) * w.ts.d;
    tile_fill<VEC>(w.out, (long long)cur + 1, b, c0, lane, C, id);
  };

  for (long long r = r0; r < end;) {
    const int nb = (int)min((long long)WR, end - r);  // a multiple of 4
    int s[IT], gi[IT];
    load_ids(w.seg, r + lane * IT, end, -1, s);
#pragma unroll
    for (int i = 0; i < IT; ++i) gi[i] = 0;
    if (w.gather) load_ids(w.gather, r + lane * IT, end, 0, gi);
    for (int q = 0; q < nb; q += INFLIGHT) {
      int sv[INFLIGHT], gv[INFLIGHT];
      float v[INFLIGHT][4];
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        sv[u] = __shfl_sync(FULL, s[u % IT], (q + u) / IT);
        gv[u] = __shfl_sync(FULL, gi[u % IT], (q + u) / IT);
      }
      // every load of the group issued before the first combine
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[u][j] = 0.0f;
        if (sv[u] >= 0) {
          const long long row = w.gather ? (long long)gv[u] : r + q + u;
          row_load<VEC>(w.values + row * C, c0, lane, C, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < INFLIGHT; ++u) {
        const int sid = sv[u];
        if (sid >= 0 && sid == cur) {
          combine4<MONO>(code, acc, v[u]);
        } else if (sid >= 0) {
          if (cur >= 0) finish(sid);
          // a run starts here, or (at the slice's first row) goes on from
          // the slice before
          cut = sid == prev;
          if (!cut && (prev < 0 || w.ts(prev) != w.ts(sid)))  // its group's first run
            tile_fill<VEC>(w.out, (long long)w.ts(sid) * w.ts.d, sid, c0, lane, C, id);
          cur = sid;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = v[u][j];
        }
        prev = sid;
      }
    }
    // after a pad row the rest of its input tile is pad
    const int last = __shfl_sync(FULL, s[IT - 1], nb / IT - 1);
    long long rn = r + nb;
    if (last < 0) rn = min((long long)w.tm(rn + w.tm.d - 1) * w.tm.d, end);
    r = rn;
  }
  if (cur >= 0) {
    const int nxt = end < w.rows ? __ldg(w.seg + end) : -1;
    if (nxt == cur)  // the run goes on into the next slice
      row_store<VEC>((cut ? w.head : w.tail) + k * C, c0, lane, C, acc);
    else
      finish(nxt);
  }
}

// The runs cut by slice edges, one warp per work item: the slice holding a
// run's last row combines the run's partials in slice order.
template <bool VEC, int MONO>
__global__ void __launch_bounds__(WNT) segment_reduce_wide_fixup(const Wide w) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * WWARPS + (threadIdx.x >> 5);
  if (item >= w.n_slices * w.tiles) return;
  const long long k = item / w.tiles;
  const int c0 = (int)(item % w.tiles) * TILE;
  const int C = w.m.C;
  const long long L = w.slice_rows, r = k * L;
  if (k == 0) return;
  const int run = __ldg(w.seg + r);
  if (run < 0 || __ldg(w.seg + r - 1) != run) return;     // no run cut at this slice's start
  if (r + L < w.rows && __ldg(w.seg + r + L) == run) return;  // a later slice owns it
  // a: the slice where the run starts (the slices between hold it whole)
  long long a = k - 1;
  for (;;) {
    const long long p = a - lane;
    const bool whole = p > 0 && __ldg(w.seg + p * L) == run && __ldg(w.seg + p * L - 1) == run;
    const unsigned stop = __ballot_sync(FULL, !whole);
    if (stop) {
      a -= __ffs(stop) - 1;
      break;
    }
    a -= 32;
  }
  int code[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) code[j] = MONO >= 0 ? MONO : code_of(col_of<VEC>(c0, lane, j), w.m);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  row_load<VEC>(w.tail + a * C, c0, lane, C, acc);
#pragma unroll 4
  for (long long p = a + 1; p <= k; ++p) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    row_load<VEC>(w.head + p * C, c0, lane, C, v);
    combine4<MONO>(code, acc, v);
  }
  row_store<VEC>(w.out + (long long)run * C, c0, lane, C, acc);
}

template <bool VEC, int MONO>
int launch_wide(const Wide& w, cudaStream_t stream) {
  const long long blocks = (w.n_slices * w.tiles + WWARPS - 1) / WWARPS;
  segment_reduce_kernel_wide<VEC, MONO><<<(unsigned)blocks, WNT, 0, stream>>>(w);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  segment_reduce_wide_fixup<VEC, MONO><<<(unsigned)blocks, WNT, 0, stream>>>(w);
  return (int)cudaGetLastError();
}

// all-sum columns take the instance without the min/max code
template <bool VEC>
int launch_wide_vec(const Wide& w, cudaStream_t stream) {
  return w.m.n_sum == w.m.C ? launch_wide<VEC, SUM>(w, stream)
                            : launch_wide<VEC, -1>(w, stream);
}

}  // namespace

// slice_rows == 0: the narrow route; slice_rows > 0 (a multiple of 4): the
// wide route, with `scratch` [2][ceil(rows / slice_rows)][channels] floats
extern "C" int segment_reduce_f32(const float* values, const int* gather, const int* seg,
                                  const int* m2out, long long rows, int tm, int ts,
                                  int channels, int n_sum, int n_min, int slice_rows,
                                  float* scratch, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const Cols m{channels, n_sum, n_min};
  if (slice_rows > 0) {
    const long long n_slices = (rows + slice_rows - 1) / slice_rows;
    const Wide w{values, gather, seg, m2out, out, scratch, scratch + n_slices * channels,
                 rows, n_slices, div_by(tm), div_by(ts), slice_rows,
                 (channels + TILE - 1) / TILE, m};
    const bool vec = channels % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
    return vec ? launch_wide_vec<true>(w, s) : launch_wide_vec<false>(w, s);
  }
  const Launch l{values, gather, seg, m2out, out, rows, div_by(tm), div_by(ts), m};
  switch (channels) {
    case 1: return launch_cc<1>(l, s);
    case 2: return launch_cc<2>(l, s);
    case 3: return launch_cc<3>(l, s);
    default: return launch_cc<4>(l, s);
  }
}
