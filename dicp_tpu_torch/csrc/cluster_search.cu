// Cluster-index block search on Hopper (sm_90a): K2 and K5.
//
// Replaces dicp_tpu/ops/pallas_cluster.py::_make_fused_kernel (K2, launched
// by fused_search_pallas at pallas_cluster.py:253) and ::_make_kernel (K5,
// launched by block_search_pallas at :109).  For batch element b, query block
// i and query q of the block, with bsel[b, i, :] the block's P selected
// groups of g sorted points each:
//
//   d2(c)  = ((x0 - y0)^2 + (x1 - y1)^2) + (x2 - y2)^2     (f32, candidate c)
//   best   = min over the P*g candidates, in (probe, offset) column order;
//            the FIRST column that attains it wins (strict '<')
//   row    = bsel[j] * g + offset of that column (sorted-cloud row)
//   bound  = min over the NON-selected real groups of
//            max(sqrt(dc2) * (1 - 8 eps) - r, 0)^2            (K2 only)
//
// with the sums in the order of the Pallas kernels (pallas_cluster.py:145-148,
// :164-169) and of the plain versions (ops/cluster_search.py).  The library is
// built with --fmad=false and uses IEEE sqrtf, so best, row and bound are bit
// for bit those of fused_search_plain / block_search_plain.  When every
// distance is inf the row stays at its initial value: column 0's row (K2) or
// 0 (K5), as in the Pallas kernels.  Unlike Pallas, whose sentinel-padded
// centers make the bound ~3e30 when every group is selected, the bound here
// is over the G real groups only and is inf then (the certificate is the
// same).
//
// What bounds it: f32 issue on the CUDA cores, about 9 flops per (query,
// candidate) pair and P*g pairs per query, plus about 12 flops and a sqrt per
// (query, group) for the bound.  At 100k queries, P=32 and g=128 that is
// 4.1e8 pairs and 7.8e7 bound terms.  Memory is not the limit: a group slab
// staged in shared memory is read by every query of the block, and the whole
// grouped cloud (1.2 MB at 100k points) stays in L2.
//
// Design (a simple kernel that is right, not a copy of the Pallas grid): the
// TPU version gathers a (nb, 3, P*g) candidate array in XLA first and streams
// it through VMEM; here each block gathers its own candidates and nothing is
// materialised.  Grid (nb, B), one thread per query of the block (Qs <=
// kMaxQs threads).  For j = 0..P-1 the block stages group bsel[j] in shared
// memory as SoA, in tiles of kTile points (any g), and every thread walks the
// offsets in order with a strict '<'.  For the bound the block builds a bitmap
// of its selected groups in shared memory and streams centers and radii
// through shared memory in tiles of kCTile.  Later work: cp.async double
// buffering of the slabs, several queries per thread.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxQs = 1024;    // threads per block = queries per block
constexpr int kTile = 512;      // candidate points per shared-memory tile
constexpr int kCTile = 512;     // group centers per shared-memory tile
constexpr int kMaxGroups = 1 << 20;
constexpr float kShrink = 1.0f - 8.0f * 1.1920928955078125e-07f;  // 1 - 8 eps
constexpr size_t kStaticBytes = (3 * kTile + 4 * kCTile) * sizeof(float);

template <bool kBound>
__global__ void __launch_bounds__(kMaxQs) cluster_search_kernel(
    const float* __restrict__ points, const float* __restrict__ centers,
    const float* __restrict__ radius, const float* __restrict__ xb,
    const int32_t* __restrict__ bsel, int G, int g, int nb, int Qs, int P,
    float* __restrict__ best_out, int32_t* __restrict__ row_out,
    float* __restrict__ bound_out) {
  extern __shared__ float smem[];
  float* slab = smem;                  // [3][kTile] candidate coordinates
  float* ctile = smem + 3 * kTile;     // [4][kCTile] centers and radii
  unsigned* selected = reinterpret_cast<unsigned*>(smem + 3 * kTile + 4 * kCTile);

  const int64_t blk = static_cast<int64_t>(blockIdx.y) * nb + blockIdx.x;
  const int t = threadIdx.x;
  const int64_t q = blk * Qs + t;
  const float qx = xb[3 * q + 0];
  const float qy = xb[3 * q + 1];
  const float qz = xb[3 * q + 2];
  const int32_t* sel = bsel + blk * P;
  const float* pts = points + static_cast<int64_t>(blockIdx.y) * G * g * 3;

  float best = CUDART_INF_F;
  int32_t row = kBound ? sel[0] * g : 0;

  for (int j = 0; j < P; ++j) {
    const int32_t grp = sel[j];
    const float* src = pts + static_cast<int64_t>(grp) * g * 3;
    for (int t0 = 0; t0 < g; t0 += kTile) {
      const int tn = min(kTile, g - t0);
      __syncthreads();  // every thread is done with the previous tile
      for (int e = t; e < 3 * tn; e += blockDim.x) {
        slab[(e % 3) * kTile + e / 3] = src[3 * t0 + e];
      }
      __syncthreads();
      for (int o = 0; o < tn; ++o) {
        const float dx = qx - slab[o];
        const float dy = qy - slab[kTile + o];
        const float dz = qz - slab[2 * kTile + o];
        float d = dx * dx;
        d = d + dy * dy;
        d = d + dz * dz;
        if (d < best) {
          best = d;
          row = grp * g + t0 + o;
        }
      }
    }
  }
  best_out[q] = best;
  row_out[q] = row;
  if (!kBound) return;

  // ---- certification bound over the non-selected groups
  const int words = (G + 31) / 32;
  for (int w = t; w < words; w += blockDim.x) selected[w] = 0u;
  __syncthreads();
  for (int j = t; j < P; j += blockDim.x) {
    atomicOr(&selected[sel[j] >> 5], 1u << (sel[j] & 31));
  }
  const float* cen = centers + static_cast<int64_t>(blockIdx.y) * G * 3;
  const float* rad = radius + static_cast<int64_t>(blockIdx.y) * G;
  float bound = CUDART_INF_F;
  for (int c0 = 0; c0 < G; c0 += kCTile) {
    const int cn = min(kCTile, G - c0);
    __syncthreads();  // bitmap complete; previous tile consumed
    for (int e = t; e < 3 * cn; e += blockDim.x) {
      ctile[(e % 3) * kCTile + e / 3] = cen[3 * static_cast<int64_t>(c0) + e];
    }
    for (int e = t; e < cn; e += blockDim.x) ctile[3 * kCTile + e] = rad[c0 + e];
    __syncthreads();
    for (int o = 0; o < cn; ++o) {
      const int gi = c0 + o;
      if (selected[gi >> 5] & (1u << (gi & 31))) continue;
      const float dx = qx - ctile[o];
      const float dy = qy - ctile[kCTile + o];
      const float dz = qz - ctile[2 * kCTile + o];
      float dc2 = dx * dx;
      dc2 = dc2 + dy * dy;
      dc2 = dc2 + dz * dz;
      float lb = fmaxf(sqrtf(dc2) * kShrink - ctile[3 * kCTile + o], 0.0f);
      lb = lb * lb;
      bound = fminf(bound, lb);
    }
  }
  bound_out[q] = bound;
}

}  // namespace

// points (batch, G, g, 3), centers (batch, G, 3), radius (batch, G), xb
// (batch, nb, Qs, 3) contiguous f32; bsel (batch, nb, P) int32 with values in
// [0, G); outputs best, row, bound (batch, nb, Qs) preallocated by the caller
// (centers, radius and bound unused when with_bound == 0).  1 <= Qs <= 1024,
// G <= 2^20, batch <= 65535.  Returns the CUDA error code of the launch.
extern "C" int cluster_search_launch(const float* points, const float* centers,
                                     const float* radius, const float* xb,
                                     const int32_t* bsel, int batch, int G, int g,
                                     int nb, int Qs, int P, int with_bound,
                                     float* best, int32_t* row, float* bound,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || nb == 0) return 0;
  if (Qs < 1 || Qs > kMaxQs || G < 1 || G > kMaxGroups || g < 1 || P < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(nb, batch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_bound) {
    const size_t bytes = kStaticBytes + ((G + 31) / 32) * sizeof(unsigned);
    err = cudaFuncSetAttribute(cluster_search_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster_search_kernel<true><<<grid, Qs, bytes, s>>>(
        points, centers, radius, xb, bsel, G, g, nb, Qs, P, best, row, bound);
  } else {
    cluster_search_kernel<false><<<grid, Qs, 3 * kTile * sizeof(float), s>>>(
        points, centers, radius, xb, bsel, G, g, nb, Qs, P, best, row, bound);
  }
  return static_cast<int>(cudaGetLastError());
}
