// The part step of the part-tree DP, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package left the DP to XLA, which
// fused the dense distance transform (partsbaseddetector_tpu/ops/dp.py,
// ops/dt.py).  In eager PyTorch the same chain (ops/dp.py:_part_message
// and index_add_) is about 700 small launches a (group, component) and
// materialises the (..., H, Cx, Q) candidate tensor; on the H100 the
// host's launch rate, not the arithmetic, set the DP's time.  For one
// part p with parent q it computes, per level l and mixture m:
//   x pass: tmp[l,p,m,h,x] = max_cx s[l,p,m,h,cx] + pen_x(d),
//           d = (x + ax) - cx;
//   y pass: sdt[l,m,y,x]   = max_cy tmp[l,p,m,cy,x] + pen_y(d),
//           d = (y + ay) - cy;
//   message: msg[l,mp,y,x] = max_mc sdt[l,mc,y,x] + bias[p,mc,mp];
//   scores[l,q,mp,y,x] += msg[l,mp,y,x],
// with pen(d) = ((-w0)*d)*d - w1*d for the pass's two weights, each
// operation rounded on its own (__fmul_rn / __fadd_rn; the library is
// built with --fmad=false too), in the order of ops/dt.py.  d is a
// whole number, so pen is a table over d, computed once a block; a max
// is exact; so tmp, scores and the root maps equal the plain chain's
// bit for bit.
//
// Schedule.  ops/dp.py:dp_schedule orders the tree by depth, deepest
// first; the parts of one depth depend only on deeper ones.  A depth is
// two launches: the x pass of all its parts, then the y pass of all its
// groups, a group being one parent and its children of that depth.  A
// y block takes a group's children one after the other, in descending
// order, and adds each message into the parent's scores before the
// next: the adds happen in the order of the plain loop over P-1 ... 1.
// A (group, component) call is one C call and 2 x depth launches (24
// for person-26's seeded tree, whose depth is 12).
//
// Layout.  scores (L, P, M, H, W); tmp stored W-minor, (L, P, M, W, H),
// so the x pass writes a column's H values side by side, the y pass
// reads a column as H contiguous floats, and the walk kernel reads tmp
// as it is (csrc/walk.cu).
//
// Design.  x pass: a block holds R rows of one (level, part, mixture) in
// shared memory, padded to an odd stride so that the 32 lanes of a warp,
// one row each, read 32 banks, and the mixture's penalty table; a lane
// computes 4 adjacent outputs of its row, sliding a window of 7 table
// values along the row (two shared loads and eight float operations for
// four candidates), and the lanes of a warp store 32 consecutive h of
// one column.  R follows H: a warp's lanes cover as many rows as H has,
// up to 32.  y pass: a block holds TX = 16 columns of every child
// mixture (M x TX x H floats: 45 KB at M = 6, H = 118) and the
// mixtures' tables, and takes PT = 32 rows of the output: its lanes
// compute, item by item, 4 adjacent rows of one column of one child
// mixture with the same sliding window into shared memory, then, cell
// by cell, each parent mixture's max over child mixtures of that plus
// the pair bias, added into the parent's scores (or written to a buffer,
// for the filter-keyed DP, which adds by filter id itself).  Items over
// (mixture, rows, column) keep every lane busy whatever M is, no lane
// holds M maxima in registers (a first version that did took 244
// registers, one block a multiprocessor), and 32 rows make 80 blocks a
// parent at B = 1 (L = 2).  TX halves while a block's shared memory would
// leave room for fewer than four blocks a multiprocessor.
//
// Bound.  Work: one add and one max for every (output, source) pair of
// both passes, 4.47e9 a 640x480 frame at the plan's groups (about 0.3 ms
// at the float32 issue rate of 132 SMs); bytes: the scores read and
// tmp and scores written, about 94 MB a frame (0.03 ms at 3.35 TB/s).
// The kernel is bound by its instruction issue: shared loads, adds and
// maxes.  chip_smoke.py times it beside that bound.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 4;          // adjacent outputs a lane computes
constexpr int kMaxM = 16;      // mixtures a part, as the walk kernel
constexpr size_t kSmemMax = 227 * 1024;

struct DPArgs {
  float* scores;           // (L, P, M, H, W)
  float* tmpT;             // (L, P, M, W, H): tmp stored W-minor
  float* msg;              // (L, M, H, W), for groups with parent -1
  const float* defw;       // (P, M, 4)
  const int* anchor;       // (P, M, 2)
  const float* bias;       // (P, M, M): [p][mc][mp]
  const int* parts;        // this launch's parts (x pass)
  const int* groups;       // this launch's groups (y pass): parent, lo, hi
  const int* all_parts;    // the schedule's parts; a group's are [lo, hi)
  int L, P, M, H, W;
  int rows;                // x pass: rows a block (R)
  int cols;                // y pass: columns a block (TX)
  int ytile;               // y pass: rows a block (PT)
};

__device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// pen(d) = ((-w0)*d)*d - w1*d, rounded op by op as ops/dt.py computes it
__device__ __forceinline__ float penalty(float nw0, float w1, float d) {
  return __fsub_rn(__fmul_rn(__fmul_rn(nw0, d), d), __fmul_rn(w1, d));
}

// T[i] = pen(d) for d = (i - (n + 2)) + a, i < 2n + 5: every offset
// e = out - src a lane's window reaches, out < n + 3, src < round4(n).
// e and a are whole numbers, so d equals (out + a) - src exactly
__device__ __forceinline__ void fill_table(float* T, int n, float nw0,
                                           float w1, float a, int t,
                                           int nthreads) {
  for (int i = t; i < 2 * n + 5; i += nthreads)
    T[i] = penalty(nw0, w1, __fadd_rn(static_cast<float>(i - (n + 2)), a));
}

// acc[j] = max over src < n4 of line[src] + T[o0 + j - src + n + 2], for
// a line padded with -inf from n to n4 = round4(n) (a padded source
// never wins: the penalties are finite).  The window t[0..6] holds the
// table entries of offsets o0 - c - 3 ... o0 - c + 3 for the chunk of
// sources c ... c + 3; candidate (j, c + u) takes t[j - u + 3]
__device__ __forceinline__ void pass4(const float* line, const float* T,
                                      int n, int n4, int o0,
                                      float (&acc)[kQ]) {
  const int base = o0 + n + 2;
  float t[7];
#pragma unroll
  for (int i = 4; i < 7; ++i) t[i] = T[base - 3 + i];
  for (int c = 0; c < n4; c += 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) t[i] = T[base - c - 3 + i];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float v = line[c + u];
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        acc[j] = fmaxf(acc[j], __fadd_rn(v, t[j - u + 3]));
    }
    t[6] = t[2];
    t[5] = t[1];
    t[4] = t[0];
  }
}

// grid: (ceil(W / QT) * ceil(H / R) * M * L, parts in the layer), QT =
// kThreads / R * kQ outputs of a row a block
__global__ void __launch_bounds__(kThreads)
    dt_x_kernel(const DPArgs a) {
  const int H = a.H, W = a.W, M = a.M, R = a.rows;
  const int W4 = round4(W), S = W4 + 1;
  const int QT = kThreads / R * kQ;
  const int nq = (W + QT - 1) / QT, nr = (H + R - 1) / R;
  int b = blockIdx.x;
  const int qt = b % nq;
  b /= nq;
  const int rt = b % nr;
  b /= nr;
  const int m = b % M;
  const int l = b / M;
  const int p = a.parts[blockIdx.y];
  const int h0 = rt * R;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t lpm = (static_cast<size_t>(l) * a.P + p) * M + m;
  const float* src = a.scores + lpm * plane;

  extern __shared__ float smem[];
  float* rows = smem;                     // (R, S)
  float* T = rows + R * S;                // (2W + 5)
  for (int i = threadIdx.x; i < R * W4; i += kThreads) {
    const int r = i / W4, c = i % W4;
    const int h = h0 + r;
    rows[r * S + c] =
        h < H && c < W ? src[static_cast<size_t>(h) * W + c] : -INFINITY;
  }
  const size_t pm = static_cast<size_t>(p) * M + m;
  fill_table(T, W, -a.defw[pm * 4 + 0], a.defw[pm * 4 + 1],
             static_cast<float>(a.anchor[pm * 2 + 0]), threadIdx.x,
             kThreads);
  __syncthreads();

  const int r = threadIdx.x % R;
  const int q0 = qt * QT + threadIdx.x / R * kQ;
  const int h = h0 + r;
  if (q0 >= W || h >= H) return;
  float acc[kQ];
#pragma unroll
  for (int j = 0; j < kQ; ++j) acc[j] = -INFINITY;
  pass4(rows + r * S, T, W, W4, q0, acc);
  float* dst = a.tmpT + lpm * plane;      // (W, H)
#pragma unroll
  for (int j = 0; j < kQ; ++j)
    if (q0 + j < W) dst[static_cast<size_t>(q0 + j) * H + h] = acc[j];
}

// grid: (ceil(W / TX) * ceil(H / PT) * L, groups in the layer): a block
// takes TX columns and PT rows (PT a multiple of kQ) of the output
__global__ void __launch_bounds__(kThreads)
    dt_y_kernel(const DPArgs a) {
  const int H = a.H, W = a.W, M = a.M, TX = a.cols, PT = a.ytile;
  const int H4 = round4(H), S = H4 + 1, TL = 2 * H + 5, nq = PT / kQ;
  const int nx = (W + TX - 1) / TX, ny = (H + PT - 1) / PT;
  int b = blockIdx.x;
  const int xt = b % nx;
  b /= nx;
  const int yt = b % ny;
  const int l = b / ny;
  const int* g = a.groups + 3 * blockIdx.y;
  const int parent = g[0], lo = g[1], hi = g[2];
  const size_t plane = static_cast<size_t>(H) * W;
  const int x0 = xt * TX, y0 = yt * PT;
  const int ncols = min(TX, W - x0);
  // the parent's scores at mixture 0, or the message buffer's
  float* dst0 = parent >= 0
                    ? a.scores +
                          (static_cast<size_t>(l) * a.P + parent) * M * plane
                    : a.msg + static_cast<size_t>(l) * M * plane;

  extern __shared__ float smem[];
  float* cols = smem;                     // (M, TX, S)
  float* T = cols + M * TX * S;           // (M, 2H + 5)
  float* sb = T + M * TL;                 // (M, M)
  float* sdt = sb + M * M;                // (M, PT, TX)
  for (int i = lo; i < hi; ++i) {
    const int c = a.all_parts[i];
    const size_t lc = (static_cast<size_t>(l) * a.P + c) * M;
    __syncthreads();   // the previous child's lines and maxima are read
    for (int mc = 0; mc < M; ++mc) {
      // the block's columns of mixture mc: ncols * H contiguous floats
      const float* src = a.tmpT + (lc + mc) * plane +
                         static_cast<size_t>(x0) * H;
      for (int k = threadIdx.x; k < TX * H4; k += kThreads) {
        const int xx = k / H4, cy = k % H4;
        cols[(mc * TX + xx) * S + cy] =
            xx < ncols && cy < H ? src[static_cast<size_t>(xx) * H + cy]
                                 : -INFINITY;
      }
    }
    for (int k = threadIdx.x; k < M * TL; k += kThreads) {
      const size_t cm = static_cast<size_t>(c) * M + k / TL;
      const float ay = static_cast<float>(a.anchor[cm * 2 + 1]);
      const float d = __fadd_rn(static_cast<float>(k % TL - (H + 2)), ay);
      T[k] = penalty(-a.defw[cm * 4 + 2], a.defw[cm * 4 + 3], d);
    }
    for (int k = threadIdx.x; k < M * M; k += kThreads)
      sb[k] = a.bias[static_cast<size_t>(c) * M * M + k];
    __syncthreads();

    // the y pass: an item is kQ adjacent rows of one column of one child
    // mixture, the lanes of a warp on adjacent columns
    for (int it = threadIdx.x; it < M * nq * TX; it += kThreads) {
      const int xl = it % TX, q = it / TX % nq, mc = it / (TX * nq);
      const int py0 = y0 + q * kQ;
      if (xl >= ncols || py0 >= H) continue;
      float acc[kQ];
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[j] = -INFINITY;
      pass4(cols + (mc * TX + xl) * S, T + mc * TL, H, H4, py0, acc);
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        sdt[(mc * PT + q * kQ + j) * TX + xl] = acc[j];
    }
    __syncthreads();

    // the message of each parent mixture at each cell: the max over child
    // mixtures of sdt plus the pair bias, added into the parent's scores
    for (int it = threadIdx.x; it < PT * TX; it += kThreads) {
      const int xl = it % TX, r = it / TX;
      if (xl >= ncols || y0 + r >= H) continue;
      float* d = dst0 + static_cast<size_t>(y0 + r) * W + x0 + xl;
      for (int mp = 0; mp < M; ++mp, d += plane) {
        float best = -INFINITY;
        for (int mc = 0; mc < M; ++mc)
          best = fmaxf(best, __fadd_rn(sdt[(mc * PT + r) * TX + xl],
                                       sb[mc * M + mp]));
        *d = parent >= 0 ? __fadd_rn(*d, best) : best;
      }
    }
  }
}

size_t x_smem(int R, int W) {
  return sizeof(float) * (static_cast<size_t>(R) * (((W + 3) & ~3) + 1) +
                          2 * static_cast<size_t>(W) + 5);
}

size_t y_smem(int TX, int PT, int M, int H) {
  return sizeof(float) * static_cast<size_t>(M) *
         (static_cast<size_t>(TX) * (((H + 3) & ~3) + 1) + 2 * H + 5 + M +
          static_cast<size_t>(PT) * TX);
}

// opt a kernel in to more than 48 KB of dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int run(DPArgs a, const int* table, const int* dtable,
        cudaStream_t stream) {
  const int L = a.L, M = a.M, H = a.H, W = a.W;
  // x pass: a warp's lanes over as many rows as H has, up to 32
  a.rows = H > 16 ? 32 : H > 8 ? 16 : 8;
  const int QT = kThreads / a.rows * kQ;
  const size_t xs = x_smem(a.rows, W);
  // y pass: 16 columns a block (64-byte loads and stores) and 32 rows,
  // so that a B = 1 group (L = 2 at 118 x 158) still makes 80 blocks a
  // parent; fewer columns while the lines would keep a multiprocessor
  // under four blocks
  a.ytile = std::min(32, (H + kQ - 1) / kQ * kQ);
  a.cols = 16;
  while (a.cols > 1 && y_smem(a.cols, a.ytile, M, H) > 56 * 1024)
    a.cols /= 2;
  const size_t ys = y_smem(a.cols, a.ytile, M, H);
  if (xs > kSmemMax || ys > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long xblocks = static_cast<long long>((W + QT - 1) / QT) *
                            ((H + a.rows - 1) / a.rows) * M * L;
  const long long yblocks = static_cast<long long>((W + a.cols - 1) / a.cols) *
                            ((H + a.ytile - 1) / a.ytile) * L;
  if (xblocks > 0x7fffffffLL || yblocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(dt_x_kernel, xs);
  if (err == cudaSuccess) err = allow_smem(dt_y_kernel, ys);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nlayers = table[0], ngroups = table[1];
  const int* layers = table + 3;
  const int goff = 3 + 4 * nlayers;
  const int poff = goff + 3 * ngroups;
  a.all_parts = dtable + poff;
  for (int i = 0; i < nlayers; ++i) {
    const int* lay = layers + 4 * i;
    const int nparts = lay[1] - lay[0], ngr = lay[3] - lay[2];
    if (nparts <= 0 || ngr <= 0 || nparts > 65535 || ngr > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    a.parts = dtable + poff + lay[0];
    a.groups = dtable + goff + 3 * lay[2];
    dt_x_kernel<<<dim3(static_cast<unsigned>(xblocks), nparts), kThreads,
                  xs, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dt_y_kernel<<<dim3(static_cast<unsigned>(yblocks), ngr), kThreads, ys,
                   stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// The part steps of one (group, component) in the order of a schedule
// (ops/dp.py:_schedule_table), `table` on the host and `dtable`, the
// same int32 values, on the device: nlayers, ngroups, nparts; per layer
// part_lo, part_hi, group_lo, group_hi; per group parent, lo, hi (its
// children parts[lo:hi], in the order their messages are added); then
// the parts.  A group with parent -1 writes its one child's message to
// msg (L, M, H, W) instead.  defw (P, M, 4) f32, anchor (P, M, 2) int32,
// bias (P, M, M) f32, scores (L, P, M, H, W) f32, tmpT (L, P, M, W, H)
// f32, all on the device.  Launches the x and y pass of each layer on
// `stream` (2 * nlayers launches) and returns a CUDA error code (0 on
// success).
extern "C" int pbd_dp_tree(const float* defw, const int* anchor,
                           const float* bias, const int* table,
                           const int* dtable, float* scores, float* tmpT,
                           float* msg, int L, int P, int M, int H, int W,
                           cudaStream_t stream) {
  if (L <= 0 || P <= 0 || M <= 0 || M > kMaxM || H <= 0 || W <= 0 ||
      table == nullptr || dtable == nullptr || table[0] < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DPArgs a{scores, tmpT, msg, defw, anchor, bias, nullptr, nullptr,
           nullptr, L, P, M, H, W, 0, 0, 0};
  return run(a, table, dtable, stream);
}
