// The K-point backtracking walk of the part-tree DP, for Hopper (sm_90a).
//
// Replaces partsbaseddetector_tpu/ops/walk_pallas.py:walk_tree_pallas
// (its body _walk_kernel).  For every level l and root seed k it walks
// the parts root to leaf and recomputes, at the parent's position only,
// the argmaxes the reference stores as full tables
// (src/DynamicProgram.cpp:110-151, include/DistanceTransform.hpp:233-244):
//   mc = argmax_first_m( max_h tmp[l,p,m,h,px] - w2*dy^2 - w3*dy
//                        + bias[p,m,mp] ),  dy = py + ay - h;
//   compose 0 ("reference"): x from scores[l,p,mc,py,:], then y from
//                             tmp[l,p,mc,:,x];
//   compose 1 ("correct"):   y from tmp[l,p,mc,:,px], then x from
//                             scores[l,p,mc,y,:].
// Every 1-D argmax is first-wins (largest value, then lowest index), as
// torch.argmax and jnp.argmax are; over mixtures the lower m wins a tie.
// Each candidate value is computed as line + (-w2)*d*d + (-w3)*d rounded
// op by op (__fmul_rn / __fadd_rn; the library is also built with
// --fmad=false): a fused multiply-add rounds differently and could move
// an argmax tie.
//
// Layout.  tmp is stored W-minor, as (L, P, M, W, H) (ops/dp.py writes
// it so and ops/walk.py requires it), so a column tmp[l,p,m,:,x] is H
// contiguous floats, read in coalesced 128-byte pieces; a row of scores
// is W contiguous floats.
//
// Design.  A block owns one level and a chunk of C seeds.  It keeps the
// (x, y, mixture) of every part of those seeds, and the parts'
// parameters, in shared memory, and walks the tree layer by layer: the
// parts of one depth (the table ops/walk.py:depth_layers computes on the
// host), every (seed, part) of the layer one warp's item, and a block
// barrier before the next depth.  So the dependent chain is the tree's
// depth (12 for person-26), not its parts (25).  An item is two
// dependent rounds of loads:
//   A. everything keyed by the parent's (px, py, mp): the M columns at
//      px and, under "reference", the M rows at py.  Every lane issues
//      all its loads into registers (8 bytes at a time where H and W
//      are even) before it uses any; the candidate values of all M
//      columns are then computed one operation at a time across all of
//      them, so that the warp always has independent work to issue, and
//      each column's maximum is one redux.sync on an order-preserving
//      key.  mc is picked in m order, and x comes from row mc
//      ("reference") or y from column mc ("correct") out of the
//      registers;
//   B. the one line keyed by that result: the column at x
//      ("reference") or the row at y ("correct").
// A first-wins argmax across the warp is two redux.sync: the largest
// key, then the lowest index among the lanes that hold it.  A lane
// holds kSH values of a column and kSW of a row (template arguments,
// picked from H and W); longer lines are read in pieces, and then a
// speculative line waits for mc: a third round.  The speculative rows
// cost M*W*4 bytes per (seed, part) instead of W*4 under "reference":
// 2528 instead of 632 bytes at person-26's largest group (M = 4,
// W = 158), about 125 MB instead of 77 MB gathered per launch there;
// under "correct" there are none.
//
// The registers (up to 128 a thread) bound the warps in flight, so a
// block of 4 seeds on 8 warps, several items per warp in the wide
// layers, beats one warp per item on the H100.
//
// Bound.  The larger of two terms.  Bytes: each distinct line the walk
// needs read once, plus seeds, parameters and outputs (about 34 MB at
// the largest person-26 group with B = 8, 10 us at 3.35 TB/s); a few
// flops per byte.  Latency: 2 dependent rounds per depth of the tree, at
// the card's dependent-load latency; chip_smoke.py measures both it (in
// and out of the L2) and the kernel.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxM = 16;        // mixtures per part the kernel takes
// the launch shape: seeds and warps per block
constexpr int kSeeds = 4;
constexpr int kWarps = 8;

struct WalkArgs {
  const float* scores;   // (L, P, M, H, W)
  const float* tmpT;     // (L, P, M, W, H): tmp stored W-minor
  const int* xs;         // (L, K) root seeds
  const int* ys;
  const int* mv;
  const float* defw;     // (P, M, 4)
  const float* anchor;   // (P, M, 2)
  const float* bias;     // (P, M, M)
  const int* parent;     // (P,)
  const int* layers;     // offsets (nlayers + 1,), then parts (P,)
  int* X;                // (L, P, K)
  int* Y;
  int* Mm;
  int L, P, M, H, W, K, nlayers, correct;
};

// An unsigned key in the order of the floats, -0.0 taken as +0.0 (they
// compare equal), so that one redux.sync finds a warp's maximum
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float warp_max(float v) {
  const unsigned k = __reduce_max_sync(kFull, order_key(v));
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// first-wins argmax across the warp: the largest value, then among the
// lanes that hold it the lowest index (each lane holds its own first)
__device__ __forceinline__ int warp_argmax(float v, int i) {
  const unsigned k = order_key(v);
  const unsigned kmax = __reduce_max_sync(kFull, k);
  return static_cast<int>(__reduce_min_sync(
      kFull, k == kmax ? static_cast<unsigned>(i) : 0xffffffffu));
}

// the index, within a piece of a line, of a lane's u-th value: lane j
// holds 32*u + j, or with pairs (8-byte loads) 64*(u/2) + 2*j + u%2;
// either way a lane's values ascend with u
__device__ __forceinline__ int slot(int u, int lane, bool pairs) {
  return pairs ? (u >> 1) * 2 * kWarp + 2 * lane + (u & 1)
               : u * kWarp + lane;
}

// v[m][u] = line m's value at c0 + slot(u), for m < M and c < n; -inf
// elsewhere, which a candidate value (finite maps, finite penalties)
// never ties or loses to, and an index in range is lower than any
// other.  Line m starts at base + m*stride.  pairs: every line starts
// 8-byte aligned and n is even.  Every load is issued before any is
// used: one round of load latency.
template <int kM, int kS>
__device__ __forceinline__ void load_lines(float (&v)[kM][kS],
                                           const float* base,
                                           size_t stride, int M, int n,
                                           int c0, int lane, bool pairs) {
  if (pairs && kS % 2 == 0) {
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int u = 0; u < kS; u += 2) {
        const int c = c0 + slot(u, lane, true);
        const float2 q = m < M && c < n
                             ? *reinterpret_cast<const float2*>(
                                   base + m * stride + c)
                             : make_float2(-INFINITY, -INFINITY);
        v[m][u] = q.x;
        v[m][u + 1] = q.y;
      }
    }
    return;
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int u = 0; u < kS; ++u) {
      const int c = c0 + slot(u, lane, false);
      v[m][u] = m < M && c < n ? base[m * stride + c] : -INFINITY;
    }
  }
}

// t[m][u] = v[m][u] + (-w2[m])*d*d + (-w3[m])*d, d = center[m] - c: one
// rounding per operation, in the order of
// partsbaseddetector_tpu/ops/dp.py:_dt_vals_at, each operation applied
// across all lines and values before the next
template <int kM, int kS>
__device__ __forceinline__ void dt_vals(float (&t)[kM][kS],
                                        const float (&v)[kM][kS],
                                        const float (&cf)[kS], float c0f,
                                        const float (&nw2)[kM],
                                        const float (&nw3)[kM],
                                        const float (&center)[kM]) {
  float d[kM][kS];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u)
      d[m][u] = __fsub_rn(center[m], __fadd_rn(c0f, cf[u]));
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u) t[m][u] = __fmul_rn(nw2[m], d[m][u]);
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u) t[m][u] = __fmul_rn(t[m][u], d[m][u]);
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u) t[m][u] = __fadd_rn(v[m][u], t[m][u]);
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u) d[m][u] = __fmul_rn(nw3[m], d[m][u]);
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int u = 0; u < kS; ++u) t[m][u] = __fadd_rn(t[m][u], d[m][u]);
}

// this lane's first-wins best of one line's values folded into (best,
// besti): ascending u is ascending index, so a later equal value never
// wins
template <int kS>
__device__ __forceinline__ void lane_best(const float (&t)[kS], int c0,
                                          int lane, bool pairs,
                                          float& best, int& besti) {
#pragma unroll
  for (int u = 0; u < kS; ++u) {
    if (t[u] > best || besti == INT_MAX) {
      best = t[u];
      besti = c0 + slot(u, lane, pairs);
    }
  }
}

// the first-wins argmax over c of line[c] + (-w2)*d*d + (-w3)*d,
// d = center - c, for a line whose values a lane holds in v
template <int kS>
__device__ __forceinline__ int held_argmax(const float (&v)[1][kS],
                                           float nw2, float nw3,
                                           float center, int lane,
                                           bool pairs,
                                           const float (&cf)[kS]) {
  const float w2[1] = {nw2}, w3[1] = {nw3}, ce[1] = {center};
  float t[1][kS];
  dt_vals<1, kS>(t, v, cf, 0.0f, w2, w3, ce);
  float best = -INFINITY;
  int besti = INT_MAX;
  lane_best<kS>(t[0], 0, lane, pairs, best, besti);
  return warp_argmax(best, besti);
}

// the same for a line of n values in device memory, read 32*kS values
// at a time
template <int kS>
__device__ __forceinline__ int line_argmax(const float* line, int n,
                                           float nw2, float nw3,
                                           float center, int lane,
                                           bool pairs,
                                           const float (&cf)[kS]) {
  const float w2[1] = {nw2}, w3[1] = {nw3}, ce[1] = {center};
  float best = -INFINITY;
  int besti = INT_MAX;
  for (int c0 = 0; c0 < n; c0 += kWarp * kS) {
    float v[1][kS], t[1][kS];
    load_lines<1, kS>(v, line, 0, 1, n, c0, lane, pairs);
    dt_vals<1, kS>(t, v, cf, static_cast<float>(c0), w2, w3, ce);
    lane_best<kS>(t[0], c0, lane, pairs, best, besti);
  }
  return warp_argmax(best, besti);
}

// line mc of v (mc uniform across the warp), without dynamic indexing
template <int kM, int kS>
__device__ __forceinline__ void pick(const float (&v)[kM][kS], int mc,
                                     float (&out)[1][kS]) {
#pragma unroll
  for (int u = 0; u < kS; ++u) out[0][u] = v[0][u];
#pragma unroll
  for (int m = 1; m < kM; ++m)
    if (m == mc) {
#pragma unroll
      for (int u = 0; u < kS; ++u) out[0][u] = v[m][u];
    }
}

// kM >= M mixtures; kSH values per lane of a column, kSW of a row.  Two
// blocks a multiprocessor cap a thread at 128 registers
template <int kM, int kSH, int kSW>
__global__ void __launch_bounds__(kWarps* kWarp, 2)
    walk_tree_kernel(const WalkArgs a) {
  constexpr int C = kSeeds;
  const int P = a.P, M = a.M, H = a.H, W = a.W;
  const int l = blockIdx.y;
  const int k0 = blockIdx.x * C;
  const int nseed = min(C, a.K - k0);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  // under "reference" the M rows ride along with the columns when a row
  // fits the registers; under "correct" column mc stays there when it
  // fits.  Lines are read 8 bytes at a time where H or W is even: the
  // maps are 8-byte aligned (the caller's allocations)
  const bool rows_ahead = !a.correct && W <= kWarp * kSW;
  const bool col_kept = a.correct && H <= kWarp * kSH;
  const bool cpairs = kSH % 2 == 0 && H % 2 == 0;
  const bool rpairs = kSW % 2 == 0 && W % 2 == 0;
  // each lane's indices within a piece of a line, as (exact) floats
  float cfc[kSH], cfr[kSW];
#pragma unroll
  for (int u = 0; u < kSH; ++u)
    cfc[u] = static_cast<float>(slot(u, lane, cpairs));
#pragma unroll
  for (int u = 0; u < kSW; ++u)
    cfr[u] = static_cast<float>(slot(u, lane, rpairs));

  // shared memory: part parameters, the walk's state, the layer table
  extern __shared__ float smem[];
  float* sw = smem;                       // (P, M, 4)
  float* sa = sw + P * M * 4;             // (P, M, 2)
  float* sb = sa + P * M * 2;             // (P, M, M)
  int* sx = reinterpret_cast<int*>(sb + P * M * M);   // (P, C)
  int* sy = sx + P * C;
  int* sm = sy + P * C;
  int* spar = sm + P * C;                 // (P,)
  int* soff = spar + P;                   // (nlayers + 1,)
  int* sord = soff + a.nlayers + 1;       // (P,)

  for (int i = threadIdx.x; i < P * M * 4; i += blockDim.x)
    sw[i] = a.defw[i];
  for (int i = threadIdx.x; i < P * M * 2; i += blockDim.x)
    sa[i] = a.anchor[i];
  for (int i = threadIdx.x; i < P * M * M; i += blockDim.x)
    sb[i] = a.bias[i];
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    spar[i] = a.parent[i];
    sord[i] = a.layers[a.nlayers + 1 + i];
  }
  for (int i = threadIdx.x; i <= a.nlayers; i += blockDim.x)
    soff[i] = a.layers[i];
  for (int s = threadIdx.x; s < nseed; s += blockDim.x) {
    const size_t seed = static_cast<size_t>(l) * a.K + k0 + s;
    sx[s] = a.xs[seed];       // part 0 is the root: its state is the seed
    sy[s] = a.ys[seed];
    sm[s] = a.mv[seed];
  }
  __syncthreads();

  for (int d = 1; d < a.nlayers; ++d) {
    const int lo = soff[d];
    const int nitems = (soff[d + 1] - lo) * nseed;
    for (int item = warp; item < nitems; item += kWarps) {
      const int p = sord[lo + item / nseed];
      const int s = item % nseed;
      const int par = spar[p];
      const int px = sx[par * C + s];
      const int py = sy[par * C + s];
      const int mp = sm[par * C + s];
      const float pxf = static_cast<float>(px);
      const float pyf = static_cast<float>(py);
      const size_t lpm = (static_cast<size_t>(l) * P + p) * M;
      const size_t plane = static_cast<size_t>(H) * W;
      const float* pw = sw + p * M * 4;
      const float* pa = sa + p * M * 2;
      const float* tcol = a.tmpT + (lpm * W + px) * H;  // + m*plane
      const float* srow = a.scores + (lpm * H + py) * W;

      // ---- round A: the M columns at px (and the M rows at py)
      float cv[kM][kSH], rv[kM][kSW];
      load_lines<kM, kSH>(cv, tcol, plane, M, H, 0, lane, cpairs);
      if (rows_ahead)
        load_lines<kM, kSW>(rv, srow, plane, M, W, 0, lane, rpairs);
      float nw2[kM], nw3[kM], cym[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        const int q = m < M ? m : 0;
        nw2[m] = -pw[q * 4 + 2];
        nw3[m] = -pw[q * 4 + 3];
        cym[m] = __fadd_rn(pyf, pa[q * 2 + 1]);
      }

      // child mixture: max over h of the y-pass value at (py, px) plus
      // the pair bias, the M column maxima side by side
      float cm[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m) cm[m] = -INFINITY;
      for (int c0 = 0; c0 < H; c0 += kWarp * kSH) {
        if (c0 > 0)
          load_lines<kM, kSH>(cv, tcol, plane, M, H, c0, lane, cpairs);
        float t[kM][kSH];
        dt_vals<kM, kSH>(t, cv, cfc, static_cast<float>(c0), nw2, nw3,
                         cym);
#pragma unroll
        for (int m = 0; m < kM; ++m)
#pragma unroll
          for (int u = 0; u < kSH; ++u) cm[m] = fmaxf(cm[m], t[m][u]);
      }
      // the kM reductions back to back (slots m >= M stay -inf), then
      // the first-wins pick over m < M
      float bw[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m)
        bw[m] = m < M ? sb[(p * M + m) * M + mp] : 0.0f;
#pragma unroll
      for (int m = 0; m < kM; ++m) cm[m] = warp_max(cm[m]);
      int mc = 0;
      float bestw = __fadd_rn(cm[0], bw[0]);
#pragma unroll
      for (int m = 1; m < kM; ++m) {
        const float wv = __fadd_rn(cm[m], bw[m]);
        if (m < M && wv > bestw) {
          bestw = wv;
          mc = m;
        }
      }

      const float cx = __fadd_rn(pxf, pa[mc * 2 + 0]);
      const float cy = __fadd_rn(pyf, pa[mc * 2 + 1]);
      const float nw2x = -pw[mc * 4 + 0], nw3x = -pw[mc * 4 + 1];
      const float nw2y = -pw[mc * 4 + 2], nw3y = -pw[mc * 4 + 3];
      int x, y;
      if (!a.correct) {
        // x from the accumulated-score row at PARENT y (the reference's
        // compose quirk), then, round B, y from the x-pass column at x
        if (rows_ahead) {
          float row[1][kSW];
          pick<kM, kSW>(rv, mc, row);
          x = held_argmax<kSW>(row, nw2x, nw3x, cx, lane, rpairs, cfr);
        } else {
          x = line_argmax<kSW>(srow + mc * plane, W, nw2x, nw3x, cx, lane,
                               rpairs, cfr);
        }
        y = line_argmax<kSH>(a.tmpT + ((lpm + mc) * W + x) * H, H, nw2y,
                             nw3y, cy, lane, cpairs, cfc);
      } else {
        // y from column mc at px, then, round B, x from the row at y
        if (col_kept) {
          float col[1][kSH];
          pick<kM, kSH>(cv, mc, col);
          y = held_argmax<kSH>(col, nw2y, nw3y, cy, lane, cpairs, cfc);
        } else {
          y = line_argmax<kSH>(tcol + mc * plane, H, nw2y, nw3y, cy, lane,
                               cpairs, cfc);
        }
        x = line_argmax<kSW>(a.scores + ((lpm + mc) * H + y) * W, W, nw2x,
                             nw3x, cx, lane, rpairs, cfr);
      }
      if (lane == 0) {
        sx[p * C + s] = x;
        sy[p * C + s] = y;
        sm[p * C + s] = mc;
      }
    }
    __syncthreads();   // this depth is done before its children start
  }

  for (int i = threadIdx.x; i < P * nseed; i += blockDim.x) {
    const int p = i / nseed;
    const int s = i % nseed;
    const size_t out = (static_cast<size_t>(l) * P + p) * a.K + k0 + s;
    a.X[out] = sx[p * C + s];
    a.Y[out] = sy[p * C + s];
    a.Mm[out] = sm[p * C + s];
  }
}

template <int kM, int kSH, int kSW>
int launch(const WalkArgs& a, dim3 grid, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        walk_tree_kernel<kM, kSH, kSW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  walk_tree_kernel<kM, kSH, kSW><<<grid, kWarps * kWarp, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// values per lane for a line of n: the fewest even count in {2, 4, 6, 8}
// that holds it (even, so that 8-byte loads fit), 8 beyond 256
int slots(int n) {
  const int need = (n + kWarp - 1) / kWarp;
  return std::min(8, need + need % 2);
}

// the kernel instance for M mixtures and the lines' slot counts; the
// register arrays hold about 64 floats, so more mixtures take fewer
// values per lane and read long lines in more pieces
template <int kSH>
int launch_rows(const WalkArgs& a, int sw, dim3 grid, size_t smem,
                cudaStream_t stream) {
  switch (sw) {
    case 2: return launch<4, kSH, 2>(a, grid, smem, stream);
    case 4: return launch<4, kSH, 4>(a, grid, smem, stream);
    case 6: return launch<4, kSH, 6>(a, grid, smem, stream);
    default: return launch<4, kSH, 8>(a, grid, smem, stream);
  }
}

int dispatch(const WalkArgs& a, dim3 grid, size_t smem,
             cudaStream_t stream) {
  const int sh = slots(a.H), sw = slots(a.W);
  if (a.M <= 4) {
    switch (sh) {
      case 2: return launch_rows<2>(a, sw, grid, smem, stream);
      case 4: return launch_rows<4>(a, sw, grid, smem, stream);
      case 6: return launch_rows<6>(a, sw, grid, smem, stream);
      default: return launch_rows<8>(a, sw, grid, smem, stream);
    }
  }
  if (a.M <= 8) {
    if (sh <= 2 && sw <= 2) return launch<8, 2, 2>(a, grid, smem, stream);
    return launch<8, 4, 4>(a, grid, smem, stream);
  }
  return launch<16, 2, 2>(a, grid, smem, stream);
}

}  // namespace

// scores (L, P, M, H, W) f32; tmpT (L, P, M, W, H) f32, tmp stored
// W-minor; xs/ys/mv (L, K) int32; defw (P, M, 4), anchor (P, M, 2),
// bias (P, M, M) f32; parent (P,) int32 with parent[p] < p; layers
// int32: nlayers + 1 offsets, then the P parts in depth order (layer d
// is parts[offsets[d]:offsets[d+1]], layer 0 the root).  Every array
// is 8-byte aligned.  Writes X/Y/Mm (L, P, K)
// int32, part 0 = the seeds.  compose: 0 = "reference", 1 = "correct".
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int pbd_walk_tree(const float* scores, const float* tmpT,
                             const int* xs, const int* ys, const int* mv,
                             const float* defw, const float* anchor,
                             const float* bias, const int* parent,
                             const int* layers, int* X, int* Y, int* Mm,
                             int L, int P, int M, int H, int W, int K,
                             int nlayers, int compose,
                             cudaStream_t stream) {
  if (L <= 0 || P <= 0 || M <= 0 || M > kMaxM || H <= 0 || W <= 0 ||
      K <= 0 || L > 65535 || nlayers <= 0 ||
      (compose != 0 && compose != 1) ||
      (reinterpret_cast<size_t>(scores) | reinterpret_cast<size_t>(tmpT)) %
          8)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * static_cast<size_t>(P) * M * (6 + M) +
      sizeof(int) * (static_cast<size_t>(P) * (3 * kSeeds + 2) + nlayers + 1);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const WalkArgs a{scores, tmpT, xs, ys, mv, defw, anchor, bias, parent,
                   layers, X, Y, Mm, L, P, M, H, W, K, nlayers, compose};
  return dispatch(a, dim3((K + kSeeds - 1) / kSeeds, L), smem, stream);
}
