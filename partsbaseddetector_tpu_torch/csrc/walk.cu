// The K-point backtracking walk of the part-tree DP, for Hopper (sm_90a).
//
// Replaces partsbaseddetector_tpu/ops/walk_pallas.py:walk_tree_pallas
// (its body _walk_kernel).  For every level l and root seed k it walks
// the parts root to leaf (parent < child, so a parent is always done
// first) and recomputes, at the parent's position only, the argmaxes the
// reference stores as full tables (src/DynamicProgram.cpp:110-151,
// include/DistanceTransform.hpp:233-244):
//   mc = argmax_first_m( max_h tmp[l,p,m,h,px] - w2*dy^2 - w3*dy
//                        + bias[p,m,mp] ),  dy = py + ay - h;
//   compose 0 ("reference"): x from scores[l,p,mc,py,:], then y from
//                             tmp[l,p,mc,:,x];
//   compose 1 ("correct"):   y from tmp[l,p,mc,:,px], then x from
//                             scores[l,p,mc,y,:].
// Every 1-D argmax is first-wins (largest value, then lowest index), as
// torch.argmax and jnp.argmax are.  Each candidate value is computed as
// line + (-w2)*d*d + (-w3)*d rounded op by op (__fmul_rn / __fadd_rn;
// the library is also built with --fmad=false): a fused multiply-add
// rounds differently and could move an argmax tie.
//
// Design.  On the TPU the gathers were one-hot matrix products; here they
// are indexed loads.  One warp owns one (level, seed) and walks the parts
// in sequence, keeping each part's (x, y, mixture) in shared memory for
// its children; the 32 lanes split every line (M*H for the mixture, then
// W and H) and meet in a shuffle reduction.  Four warps share a block.
//
// Bound.  The larger of two terms.  Bytes: the walk reads only the
// gathered lines, per launch about L*(P-1)*K*(M*H + W + H)*4 bytes as
// this kernel reads them (about 77 MB at the largest person-26 group
// with B=8, 23 us at 3.35 TB/s), fewer where seeds share lines, and does
// a few flops per byte.  Latency: each part waits for its parent and is
// at least three dependent load-and-reduce rounds (the mixture's
// columns, then one line, then the other), so (P-1)*3 rounds at the
// card's dependent-load latency, which chip_smoke.py measures and
// prints beside the bytes term.  This simple design falls well short of
// both: it lengthens the chain to (P-1)*(M + 2) rounds, since it reduces
// the M mixture columns one after another; its column gathers are
// strided by W, so each 4-byte value costs a 32-byte sector; and only
// L*K warps are in flight.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// line + (-w2)*d*d + (-w3)*d, one rounding per operation, in the order
// of partsbaseddetector_tpu/ops/dp.py:_dt_vals_at
__device__ __forceinline__ float dt_val(float line, float w2, float w3,
                                        float d) {
  const float quad = __fmul_rn(__fmul_rn(-w2, d), d);
  return __fadd_rn(__fadd_rn(line, quad), __fmul_rn(-w3, d));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// first-wins argmax across the warp: larger value, then lower index
__device__ __forceinline__ int warp_argmax(float v, int i) {
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    if (v2 > v || (v2 == v && i2 < i)) {
      v = v2;
      i = i2;
    }
  }
  return i;
}

// argmax_c line[c*stride] + (-w2)*d*d + (-w3)*d, d = center - c
__device__ __forceinline__ int line_argmax(const float* __restrict__ line,
                                           size_t stride, int n, float w2,
                                           float w3, float center,
                                           int lane) {
  float best = -INFINITY;
  int besti = INT_MAX;
#pragma unroll 4
  for (int c = lane; c < n; c += kWarp) {
    const float d = __fsub_rn(center, static_cast<float>(c));
    const float v = dt_val(line[c * stride], w2, w3, d);
    if (besti == INT_MAX || v > best) {  // ascending c: first wins
      best = v;
      besti = c;
    }
  }
  return warp_argmax(best, besti);
}

__global__ void walk_tree_kernel(
    const float* __restrict__ scores, const float* __restrict__ tmp,
    const int* __restrict__ xs, const int* __restrict__ ys,
    const int* __restrict__ mv, const float* __restrict__ defw,
    const float* __restrict__ anchor, const float* __restrict__ bias,
    const int* __restrict__ parent, int* __restrict__ X,
    int* __restrict__ Y, int* __restrict__ Mm, int L, int P, int M, int H,
    int W, int K, int compose_correct) {
  extern __shared__ int state[];  // per warp: x[P], y[P], m[P]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int k = blockIdx.x * kWarpsPerBlock + warp;
  const int l = blockIdx.y;
  if (k >= K) return;  // uniform across the warp; no block barrier below
  int* sx = state + warp * 3 * P;
  int* sy = sx + P;
  int* sm = sy + P;
  const size_t plane = static_cast<size_t>(H) * W;

  if (lane == 0) {
    const size_t seed = static_cast<size_t>(l) * K + k;
    const size_t out = static_cast<size_t>(l) * P * K + k;
    sx[0] = X[out] = xs[seed];
    sy[0] = Y[out] = ys[seed];
    sm[0] = Mm[out] = mv[seed];
  }
  __syncwarp();

  for (int p = 1; p < P; ++p) {
    const int par = parent[p];
    const int px = sx[par];
    const int py = sy[par];
    const int mp = sm[par];
    const float pxf = static_cast<float>(px);
    const float pyf = static_cast<float>(py);
    const size_t base = (static_cast<size_t>(l) * P + p) * M * plane;
    const float* __restrict__ tp = tmp + base;
    const float* __restrict__ sp = scores + base;
    const float* __restrict__ wp = defw + static_cast<size_t>(p) * M * 4;
    const float* __restrict__ ap = anchor + static_cast<size_t>(p) * M * 2;
    const float* __restrict__ bp = bias + static_cast<size_t>(p) * M * M;

    // ---- child mixture: max over h of the y-pass value at (py, px)
    // plus the pair bias; first-wins over m
    int mc = 0;
    float bestw = 0.0f;
    for (int m = 0; m < M; ++m) {
      const float w2 = wp[m * 4 + 2];
      const float w3 = wp[m * 4 + 3];
      const float center = __fadd_rn(pyf, ap[m * 2 + 1]);
      const float* __restrict__ col = tp + m * plane + px;
      float v = -INFINITY;
#pragma unroll 4
      for (int h = lane; h < H; h += kWarp) {
        const float d = __fsub_rn(center, static_cast<float>(h));
        v = fmaxf(v, dt_val(col[static_cast<size_t>(h) * W], w2, w3, d));
      }
      const float wv = __fadd_rn(warp_max(v), bp[m * M + mp]);
      if (m == 0 || wv > bestw) {
        bestw = wv;
        mc = m;
      }
    }

    const float* __restrict__ tpm = tp + mc * plane;
    const float* __restrict__ spm = sp + mc * plane;
    const float cx = __fadd_rn(pxf, ap[mc * 2 + 0]);
    const float cy = __fadd_rn(pyf, ap[mc * 2 + 1]);
    const float w2x = wp[mc * 4 + 0], w3x = wp[mc * 4 + 1];
    const float w2y = wp[mc * 4 + 2], w3y = wp[mc * 4 + 3];
    int x, y;
    if (!compose_correct) {
      // x from the accumulated-score row at PARENT y, then y from the
      // x-pass column at that x (the reference's compose quirk)
      x = line_argmax(spm + static_cast<size_t>(py) * W, 1, W, w2x, w3x,
                      cx, lane);
      y = line_argmax(tpm + x, W, H, w2y, w3y, cy, lane);
    } else {
      y = line_argmax(tpm + px, W, H, w2y, w3y, cy, lane);
      x = line_argmax(spm + static_cast<size_t>(y) * W, 1, W, w2x, w3x,
                      cx, lane);
    }

    if (lane == 0) {
      const size_t out = (static_cast<size_t>(l) * P + p) * K + k;
      sx[p] = X[out] = x;
      sy[p] = Y[out] = y;
      sm[p] = Mm[out] = mc;
    }
    __syncwarp();
  }
}

}  // namespace

// scores/tmp (L, P, M, H, W) f32; xs/ys/mv (L, K) int32; defw (P, M, 4),
// anchor (P, M, 2), bias (P, M, M) f32; parent (P,) int32 with
// parent[p] < p.  Writes X/Y/Mm (L, P, K) int32, part 0 = the seeds.
// compose: 0 = "reference", 1 = "correct".  Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int pbd_walk_tree(const float* scores, const float* tmp,
                             const int* xs, const int* ys, const int* mv,
                             const float* defw, const float* anchor,
                             const float* bias, const int* parent, int* X,
                             int* Y, int* Mm, int L, int P, int M, int H,
                             int W, int K, int compose,
                             cudaStream_t stream) {
  if (L <= 0 || P <= 0 || M <= 0 || H <= 0 || W <= 0 || K <= 0 ||
      L > 65535 || (compose != 0 && compose != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(int) * 3 * P * kWarpsPerBlock;
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock, L);
  walk_tree_kernel<<<grid, kWarp * kWarpsPerBlock, smem, stream>>>(
      scores, tmp, xs, ys, mv, defw, anchor, bias, parent, X, Y, Mm, L, P,
      M, H, W, K, compose);
  return static_cast<int>(cudaGetLastError());
}
