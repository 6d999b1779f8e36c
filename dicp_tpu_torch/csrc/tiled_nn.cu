// Exact batched 1-NN on Hopper (sm_90a).
//
// Replaces dicp_tpu/ops/pallas_knn.py::_nn_kernel (launched by _nn_pallas_2d
// at pallas_knn.py:100).  For each batch element b and query i it computes
//
//   d2(i, j)  = ((x0 - y0)^2 + (x1 - y1)^2) + (x2 - y2)^2      (f32)
//   idx[b, i] = the FIRST j that minimises d2(i, j)
//   d2[b, i]  = that minimum
//
// with the sum in the order of the Pallas kernel (pallas_knn.py:65-68) and of
// the plain PyTorch version (ops/tiled_knn.py::nn_distances_plain).  The
// library is built with --fmad=false, so no multiply is contracted into an
// add: every d2 is bit-equal to the plain version's, and so is every index.
//
// What bounds it: f32 arithmetic on the CUDA cores, about 9 flops per
// (query, target) pair and n*m pairs per batch element.  Memory is not the
// limit: each target tile staged in shared memory is read by every query of
// the block, so a block reads each target once while it does QB*9 flops on it.
//
// Design (a simple kernel that is right, not a copy of the Pallas grid):
// the grid is (ceil(n / QB), B).  Each thread keeps QPT queries and their
// running (best d2, best index) in registers.  The block walks the targets in
// index order, TM at a time, staged in shared memory as SoA f32; a strict '<'
// keeps the earliest index among equal distances, so ties resolve to the
// lowest index by construction.  The ragged query and target edges are
// masked here: there are no padding rows.  The kernel allocates nothing and
// runs on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kQPT = 2;                    // queries per thread
constexpr int kQB = kThreads * kQPT;       // queries per block
constexpr int kTM = 1024;                  // targets per shared-memory tile

__global__ void __launch_bounds__(kThreads)
tiled_nn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                int n, int m, int32_t* __restrict__ idx_out,
                float* __restrict__ d2_out) {
  __shared__ float sy[3][kTM];

  const int64_t b = blockIdx.y;
  const float* xb = x + b * static_cast<int64_t>(n) * 3;
  const float* yb = y + b * static_cast<int64_t>(m) * 3;

  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
  int32_t arg[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = blockIdx.x * kQB + k * kThreads + threadIdx.x;
    const bool valid = q < n;
    qx[k] = valid ? xb[3 * static_cast<int64_t>(q) + 0] : 0.0f;
    qy[k] = valid ? xb[3 * static_cast<int64_t>(q) + 1] : 0.0f;
    qz[k] = valid ? xb[3 * static_cast<int64_t>(q) + 2] : 0.0f;
    best[k] = CUDART_INF_F;
    arg[k] = 0;
  }

  for (int t0 = 0; t0 < m; t0 += kTM) {
    const int tn = min(kTM, m - t0);
    __syncthreads();  // every thread is done with the previous tile
    // coalesced copy of the (tn, 3) AoS slab into three SoA rows
    const float* slab = yb + 3 * static_cast<int64_t>(t0);
    for (int e = threadIdx.x; e < 3 * tn; e += kThreads) {
      sy[e % 3][e / 3] = slab[e];
    }
    __syncthreads();

    for (int j = 0; j < tn; ++j) {
      const float tx = sy[0][j];
      const float ty = sy[1][j];
      const float tz = sy[2][j];
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        const float dx = qx[k] - tx;
        const float dy = qy[k] - ty;
        const float dz = qz[k] - tz;
        float d = dx * dx;
        d = d + dy * dy;
        d = d + dz * dz;
        if (d < best[k]) {
          best[k] = d;
          arg[k] = t0 + j;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = blockIdx.x * kQB + k * kThreads + threadIdx.x;
    if (q < n) {
      idx_out[b * n + q] = arg[k];
      d2_out[b * n + q] = best[k];
    }
  }
}

}  // namespace

// x (batch, n, 3) and y (batch, m, 3) contiguous f32; idx (batch, n) int32 and
// d2 (batch, n) f32 preallocated by the caller; m >= 1; batch <= 65535.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int tiled_nn_launch(const float* x, const float* y, int batch,
                               int n, int m, int32_t* idx, float* d2,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  const dim3 grid((n + kQB - 1) / kQB, batch);
  tiled_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
