// Dependent-load latency of the card's memory, for the latency term of
// the walk kernel's bound (chip_smoke.py).  One thread follows `steps`
// links of a cyclic permutation `next`, so no load can start before the
// one before it has returned; the time per link is the latency of one
// dependent round of the walk's chain, less its warp reduction.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int steps,
                             int* __restrict__ out) {
  int i = 0;
  for (int s = 0; s < steps; ++s) i = next[i];
  *out = i;
}

}  // namespace

// next: (n,) int32, a permutation of 0..n-1; out: (1,) int32.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pbd_chase(const int* next, int steps, int* out,
                         cudaStream_t stream) {
  if (steps < 0) return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 1, 0, stream>>>(next, steps, out);
  return static_cast<int>(cudaGetLastError());
}
