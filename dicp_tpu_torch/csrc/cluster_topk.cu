// Cluster-index exact k-NN on Hopper (sm_90a): K3.
//
// Replaces dicp_tpu/ops/pallas_cluster.py::_make_topk_kernel (launched by
// fused_topk_pallas at pallas_cluster.py:398).  Same inputs, gather and
// certification bound as K2 (csrc/cluster_search.cu); for each query it
// returns the k <= 32 smallest candidate d2, ascending, with their
// sorted-cloud rows.  The Pallas kernel fills the block's (Qs, P*g) d2 tile in
// VMEM and runs k masked-iota argmin passes over it (pallas_cluster.py:
// 308-317): each pass takes the lowest column among the tied minima and
// masks ONLY that column, so duplicate distances stay for later ranks.  The
// result is the first k entries of the candidates sorted by (d2, column).
// Once every finite distance is taken the passes return column 0 (the lowest
// column of an all-inf row) again and again.
//
// Here each thread keeps a sorted top-K list (K = k rounded up to a power of
// two, a template parameter) in registers, initialised to (inf, column 0's
// row), and inserts each candidate in column order after every entry of
// equal d2: a stable insertion, which yields exactly that (d2, column) order
// and the same column-0 fill; the first k entries are written out.  The d2
// sums are in the Pallas order, built with --fmad=false, so the output is bit
// for bit that of fused_topk_plain (ops/cluster_search.py).  Certified iff the
// k-th d2 <= bound (computed by the caller).
//
// What bounds it: the same f32 issue as K2 (about 9 flops per (query,
// candidate)), plus one compare per candidate against the K-th entry; an
// insertion (K compare-and-swaps, unrolled in registers) is rare once the
// list holds near neighbours, because candidates arrive group by group in
// block-selection order.  Registers, not shared memory, hold the list: at
// K = 32 that is 64 of them per thread.
//
// A group id outside [0, G) stops the kernel with __trap() before anything
// is read from that group: the launch's stream then reports a CUDA error at
// its next synchronisation, and the wrapper needs no host-side check.  (A
// redesign on K2's schedule, the columns split into slices across warps with
// a list per query and slice, was slower than this one from k = 5 up; its
// times are in PERF.md.)

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxQs = 256;      // threads per block: 64 list registers at K = 32
constexpr int kTile = 512;
constexpr int kCTile = 512;
constexpr int kMaxGroups = 1 << 20;
constexpr float kShrink = 1.0f - 8.0f * 1.1920928955078125e-07f;  // 1 - 8 eps
constexpr size_t kStaticBytes = (3 * kTile + 4 * kCTile) * sizeof(float);

template <int K>
__global__ void __launch_bounds__(kMaxQs) cluster_topk_kernel(
    const float* __restrict__ points, const float* __restrict__ centers,
    const float* __restrict__ radius, const float* __restrict__ xb,
    const int32_t* __restrict__ bsel, int G, int g, int nb, int Qs, int P, int k,
    float* __restrict__ d2_out, int32_t* __restrict__ row_out,
    float* __restrict__ bound_out) {
  extern __shared__ float smem[];
  float* slab = smem;
  float* ctile = smem + 3 * kTile;
  unsigned* selected = reinterpret_cast<unsigned*>(smem + 3 * kTile + 4 * kCTile);

  const int64_t blk = static_cast<int64_t>(blockIdx.y) * nb + blockIdx.x;
  const int t = threadIdx.x;
  const int64_t q = blk * Qs + t;
  const float qx = xb[3 * q + 0];
  const float qy = xb[3 * q + 1];
  const float qz = xb[3 * q + 2];
  const int32_t* sel = bsel + blk * P;
  const float* pts = points + static_cast<int64_t>(blockIdx.y) * G * g * 3;

  float vals[K];
  int32_t rows[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    vals[i] = CUDART_INF_F;
    rows[i] = sel[0] * g;  // column 0
  }

  for (int j = 0; j < P; ++j) {
    const int32_t grp = sel[j];
    if (grp < 0 || grp >= G) __trap();
    const float* src = pts + static_cast<int64_t>(grp) * g * 3;
    for (int t0 = 0; t0 < g; t0 += kTile) {
      const int tn = min(kTile, g - t0);
      __syncthreads();
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
        if (d < vals[K - 1]) {
          // stable insertion: the new entry moves ahead only of strictly
          // larger ones, so it lands after every entry of equal d2
          vals[K - 1] = d;
          rows[K - 1] = grp * g + t0 + o;
#pragma unroll
          for (int i = K - 1; i > 0; --i) {
            if (vals[i] < vals[i - 1]) {
              const float tv = vals[i];
              vals[i] = vals[i - 1];
              vals[i - 1] = tv;
              const int32_t tr = rows[i];
              rows[i] = rows[i - 1];
              rows[i - 1] = tr;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k) {
      d2_out[q * k + i] = vals[i];
      row_out[q * k + i] = rows[i];
    }
  }

  // ---- certification bound over the non-selected groups (as in K2)
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
    __syncthreads();
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

template <int K>
int launch(const float* points, const float* centers, const float* radius,
           const float* xb, const int32_t* bsel, int batch, int G, int g, int nb,
           int Qs, int P, int k, float* d2, int32_t* rows, float* bound,
           cudaStream_t stream) {
  const size_t bytes = kStaticBytes + ((G + 31) / 32) * sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_topk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cluster_topk_kernel<K><<<dim3(nb, batch), Qs, bytes, stream>>>(
      points, centers, radius, xb, bsel, G, g, nb, Qs, P, k, d2, rows, bound);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Inputs as cluster_search_launch; outputs d2 and rows (batch, nb, Qs, k) and
// bound (batch, nb, Qs) preallocated by the caller.  1 <= k <= min(32, P*g),
// 1 <= Qs <= 256; bsel values in [0, G) (others stop the kernel).
// Returns the CUDA error code of the launch.
extern "C" int cluster_topk_launch(const float* points, const float* centers,
                                   const float* radius, const float* xb,
                                   const int32_t* bsel, int batch, int G, int g,
                                   int nb, int Qs, int P, int k, float* d2,
                                   int32_t* rows, float* bound, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || nb == 0) return 0;
  if (Qs < 1 || Qs > kMaxQs || G < 1 || G > kMaxGroups || g < 1 || P < 1 ||
      k < 1 || k > 32 || k > P * g) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
  if (k <= 2) return launch<2>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
  if (k <= 4) return launch<4>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
  if (k <= 8) return launch<8>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
  if (k <= 16) return launch<16>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
  return launch<32>(points, centers, radius, xb, bsel, batch, G, g, nb, Qs, P, k, d2, rows, bound, s);
}
