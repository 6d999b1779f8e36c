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
// distance is inf the row is column 0's row (K2) or 0 (K5), as in the Pallas
// kernels.  Unlike Pallas, whose sentinel-padded centers make the bound ~3e30
// when every group is selected, the bound here is over the G real groups only
// and is inf then (the certificate is the same).  A group id outside [0, G)
// stops the kernel with __trap(): the launch's stream then reports a CUDA
// error at its next synchronisation, and nothing is read out of bounds.
//
// What bounds it: f32 issue on the CUDA cores.  About 9 operations per
// (query, candidate) pair, P*g pairs per query, and about 13 plus an IEEE sqrt
// per (query, non-selected group) for the bound: at 100k queries, P = 32 and
// g = 128, 4.1e8 pairs and 7.5e7 bound terms.  Built --fmad=false, each f32
// operation is one instruction, so the issue ceiling (132 SMs x 128 lanes x
// 1.98 GHz, 3.3e13 instructions/s) is half the 67 TFLOP/s f32 bound that
// counts an FMA as two.  Memory is not the limit: a staged group slab is read
// by every query of the block, and the grouped cloud stays in L2.
//
// Design.  Grid (nb, B), one block per query block of Qs <= 1024 queries,
// 32 * QG * S threads: QG = ceil(Qs / 128) query groups of 128 (4 queries per
// lane, so each staged candidate feeds 4 pairs from registers) times
// S = 8 / QG column slices (S = 8 at the cluster tier's Qs = 128).
//   1. The block's selected group slabs, each a contiguous (g, 3) f32 run,
//      are copied once into shared memory with cp.async: 16-byte requests
//      when g is a multiple of 4 and the points are 16-byte aligned, 4-byte
//      requests otherwise.  No per-element % 3 or / 3 and one barrier.  All
//      P slabs (48 KB at P = 32, g = 128) fit in one pass; more than
//      kMaxSlabBytes are staged in passes of whole groups.
//   2. While the copies fly, K2 computes the bound: the warp of (query group,
//      slice s) walks groups s, s + S, ... (one warp-uniform center and
//      radius per group, a bitmap of the selected groups in shared memory)
//      and keeps min_g max(a_g, 0), a_g = sqrt(dc2) (1 - 8 eps) - r.  Since
//      the square rounds monotonically on values >= 0, min_g max(a_g, 0)^2 =
//      (min_g max(a_g, 0))^2: the square is done once per query.  The
//      slices' partial minima are merged with fminf (exact and order-free).
//      The clamp stays per group: fmaxf maps a NaN a_g (a group whose center
//      or radius is NaN, from a NaN point) to 0, so that group gives the
//      bound 0 and nothing is certified past it, where a NaN skipped by a
//      bare fminf would drop the group from the bound.  (The plain version's
//      bound is NaN for every query once a center is NaN, selected or not.)
//   3. Each warp scans its slice of the staged columns, 4 candidates (three
//      16-byte broadcast loads) at a time, in column order.  The argmin costs
//      one instruction per pair: per chunk of kChunk columns each query keeps
//      fminf of its d2, and a strict '<' of the chunk minimum against the
//      running best records the first chunk that attains the slice's
//      minimum.  fminf skips a NaN as '<' does.
//   4. The S partial (best, chunk) pairs of a query are merged by the
//      lexicographic minimum of (d2, first column of the chunk): chunks are
//      disjoint column ranges, so the winner holds the lowest column of the
//      smallest d2, which is what the sequential strict '<' keeps.  A
//      partial best is never NaN and a slice whose candidates are all inf
//      keeps (inf, 0), so it never displaces column 0.  Then the merging
//      thread walks that one chunk again, from global memory with the same
//      expression (the same bits), for the first column whose d2 equals the
//      best, and forms the row from it: one re-scan of kChunk columns per
//      query.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kLaneQ = 4;                       // queries per lane
constexpr int kGroupQ = 32 * kLaneQ;            // queries per warp (128)
constexpr int kWarps = 8;                       // warps per block at most
constexpr int kMaxQs = kGroupQ * kWarps;        // 1024
constexpr int kMaxSlabBytes = 64 * 1024;        // staged slabs per pass
constexpr int kMaxGroups = 1 << 20;
constexpr int kChunk = 32;                      // columns per running-minimum chunk
constexpr float kShrink = 1.0f - 8.0f * 1.1920928955078125e-07f;  // 1 - 8 eps

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int32_t checked_group(const int32_t* sel, int j, int G) {
  const int32_t grp = __ldg(sel + j);
  if (grp < 0 || grp >= G) __trap();
  return grp;
}

// Copy the slabs of selected groups j0 .. j0 + gn - 1 into slab[(j - j0) g 3 ..].
__device__ void stage(float* slab, const float* __restrict__ pts,
                      const int32_t* __restrict__ sel, int j0, int gn, int g, int G,
                      bool vec16) {
  if (vec16) {
    const int per = 3 * g / 4;  // 16-byte requests per slab
    for (int e = threadIdx.x; e < gn * per; e += blockDim.x) {
      const int jj = e / per;
      const int32_t grp = checked_group(sel, j0 + jj, G);
      cp_async16(slab + 4 * e, pts + static_cast<int64_t>(grp) * g * 3 + 4 * (e - jj * per));
    }
  } else {
    const int per = 3 * g;
    for (int e = threadIdx.x; e < gn * per; e += blockDim.x) {
      const int jj = e / per;
      const int32_t grp = checked_group(sel, j0 + jj, G);
      cp_async4(slab + e, pts + static_cast<int64_t>(grp) * g * 3 + (e - jj * per));
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float tx, float ty,
                                      float tz) {
  const float dx = qx - tx;
  const float dy = qy - ty;
  const float dz = qz - tz;
  float d = dx * dx;
  d = d + dy * dy;
  d = d + dz * dz;
  return d;
}

struct Lane {
  float qx[kLaneQ], qy[kLaneQ], qz[kLaneQ], best[kLaneQ];
  int32_t from[kLaneQ];  // first column of the chunk that holds best

  __device__ __forceinline__ void visit(float (&cmin)[kLaneQ], float tx, float ty, float tz) {
#pragma unroll
    for (int k = 0; k < kLaneQ; ++k) cmin[k] = fminf(cmin[k], dist2(qx[k], qy[k], qz[k], tx, ty, tz));
  }

  // Columns [c, c + 4) of the staged (columns, 3) run: three 16-byte loads.
  __device__ __forceinline__ void visit4(float (&cmin)[kLaneQ], const float* slab, int c) {
    const float4 a = *reinterpret_cast<const float4*>(slab + 3 * c);
    const float4 b = *reinterpret_cast<const float4*>(slab + 3 * c + 4);
    const float4 e = *reinterpret_cast<const float4*>(slab + 3 * c + 8);
    visit(cmin, a.x, a.y, a.z);
    visit(cmin, a.w, b.x, b.y);
    visit(cmin, b.z, b.w, e.x);
    visit(cmin, e.y, e.z, e.w);
  }

  // Columns [lo, hi) of the staged (columns, 3) run, whose column 0 is
  // candidate column `base`; lo is a multiple of 4 (a 48-byte boundary).
  // Per chunk of kChunk columns, the minimum; a strict '<' against the
  // running best keeps the first chunk that attains it.
  __device__ __forceinline__ void scan(const float* slab, int lo, int hi, int32_t base) {
    for (int c0 = lo; c0 < hi; c0 += kChunk) {
      float cmin[kLaneQ];
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) cmin[k] = CUDART_INF_F;
      if (c0 + kChunk <= hi) {
#pragma unroll
        for (int c = c0; c < c0 + kChunk; c += 4) visit4(cmin, slab, c);
      } else {
        int c = c0;
        for (; c + 4 <= hi; c += 4) visit4(cmin, slab, c);
        for (; c < hi; ++c) visit(cmin, slab[3 * c], slab[3 * c + 1], slab[3 * c + 2]);
      }
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) {
        if (cmin[k] < best[k]) {
          best[k] = cmin[k];
          from[k] = base + c0;
        }
      }
    }
  }
};

template <bool kBound>
__global__ void __launch_bounds__(32 * kWarps) cluster_search_kernel(
    const float* __restrict__ points, const float* __restrict__ centers,
    const float* __restrict__ radius, const float* __restrict__ xb,
    const int32_t* __restrict__ bsel, int G, int g, int nb, int Qs, int P, int S,
    int gpass, int slab_floats, int vec16, float* __restrict__ best_out,
    int32_t* __restrict__ row_out, float* __restrict__ bound_out) {
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;  // staged slabs; later the partials (3 words per entry)
  unsigned* selected = reinterpret_cast<unsigned*>(smem + slab_floats);

  const int64_t blk = static_cast<int64_t>(blockIdx.y) * nb + blockIdx.x;
  const int32_t* sel = bsel + blk * P;
  const float* pts = points + static_cast<int64_t>(blockIdx.y) * G * g * 3;
  const float* xq = xb + blk * Qs * 3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qg = warp / S;
  const int s = warp - qg * S;

  Lane L;
#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    const int q = qg * kGroupQ + 32 * k + lane;
    const bool valid = q < Qs;
    L.qx[k] = valid ? xq[3 * q + 0] : 0.0f;
    L.qy[k] = valid ? xq[3 * q + 1] : 0.0f;
    L.qz[k] = valid ? xq[3 * q + 2] : 0.0f;
    L.best[k] = CUDART_INF_F;
    L.from[k] = 0;
  }

  stage(slab, pts, sel, 0, min(gpass, P), g, G, vec16 != 0);

  float amin[kLaneQ];
  if (kBound) {
    // ---- certification bound, while the first slabs are in flight
    const int words = (G + 31) / 32;
    for (int w = threadIdx.x; w < words; w += blockDim.x) selected[w] = 0u;
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      const int32_t grp = checked_group(sel, j, G);
      atomicOr(&selected[grp >> 5], 1u << (grp & 31));
    }
    __syncthreads();
    const float* cen = centers + static_cast<int64_t>(blockIdx.y) * G * 3;
    const float* rad = radius + static_cast<int64_t>(blockIdx.y) * G;
#pragma unroll
    for (int k = 0; k < kLaneQ; ++k) amin[k] = CUDART_INF_F;
    for (int gi = s; gi < G; gi += S) {  // warp-uniform
      if (selected[gi >> 5] & (1u << (gi & 31))) continue;
      const float cx = __ldg(cen + 3 * gi);
      const float cy = __ldg(cen + 3 * gi + 1);
      const float cz = __ldg(cen + 3 * gi + 2);
      const float r = __ldg(rad + gi);
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) {
        const float dx = L.qx[k] - cx;
        const float dy = L.qy[k] - cy;
        const float dz = L.qz[k] - cz;
        float dc2 = dx * dx;
        dc2 = dc2 + dy * dy;
        dc2 = dc2 + dz * dz;
        amin[k] = fminf(amin[k], fmaxf(sqrtf(dc2) * kShrink - r, 0.0f));
      }
    }
  }

  // ---- the search, pass by pass (one pass at the cluster tier's sizes)
  for (int j0 = 0; j0 < P; j0 += gpass) {
    const int gn = min(gpass, P - j0);
    if (j0 > 0) {
      __syncthreads();  // every warp is done with the previous pass
      stage(slab, pts, sel, j0, gn, g, G, vec16 != 0);
    }
    cp_async_wait_all();
    __syncthreads();  // every thread's copies are visible
    const int cols = gn * g;
    const int width = ((cols + S - 1) / S + 3) & ~3;
    const int lo = min(cols, s * width);
    L.scan(slab, lo, min(cols, lo + width), j0 * g);
  }

  // ---- merge the S slices of each query
  __syncthreads();  // the slabs are free
  float* part_d = slab;
  int32_t* part_c = reinterpret_cast<int32_t*>(slab + kGroupQ * kWarps);
  float* part_a = slab + 2 * kGroupQ * kWarps;
#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    const int e = warp * kGroupQ + 32 * k + lane;
    part_d[e] = L.best[k];
    part_c[e] = L.from[k];
    if (kBound) part_a[e] = amin[k];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Qs; q += blockDim.x) {
    const int g0 = q / kGroupQ;
    int e = g0 * S * kGroupQ + q - g0 * kGroupQ;
    float best = part_d[e];
    int32_t from = part_c[e];
    float a = kBound ? part_a[e] : 0.0f;
    for (int t = 1; t < S; ++t) {
      e += kGroupQ;
      const float d = part_d[e];
      const int32_t c = part_c[e];
      // chunks are disjoint column ranges: the lowest chunk of the lowest d2
      // holds the lowest column of it
      if (d < best || (d == best && c < from)) {
        best = d;
        from = c;
      }
      if (kBound) a = fminf(a, part_a[e]);
    }
    // the first column of that chunk whose d2 equals best, recomputed from
    // global memory with the same expression (the same bits)
    int32_t col = 0;
    if (best < CUDART_INF_F) {
      const float x0 = xq[3 * q + 0];
      const float x1 = xq[3 * q + 1];
      const float x2 = xq[3 * q + 2];
      col = -1;
      int j = from / g;
      int off = from - j * g;
      int32_t grp = __ldg(sel + j);
      for (int c = from; c < min(from + kChunk, P * g); ++c) {
        const float* p = pts + (static_cast<int64_t>(grp) * g + off) * 3;
        if (col < 0 && dist2(x0, x1, x2, __ldg(p), __ldg(p + 1), __ldg(p + 2)) == best) col = c;
        if (++off == g && c + 1 < P * g) {
          off = 0;
          grp = __ldg(sel + ++j);
        }
      }
    }
    const int64_t out = blk * Qs + q;
    const int32_t j = col / g;
    int32_t row = __ldg(sel + j) * g + (col - j * g);
    best_out[out] = best;
    if (kBound) {
      bound_out[out] = a * a;
    } else if (!(best < CUDART_INF_F)) {
      row = 0;  // the Pallas K5 starts from row 0 where K2 starts from column 0
    }
    row_out[out] = row;
  }
}

}  // namespace

// points (batch, G, g, 3), centers (batch, G, 3), radius (batch, G), xb
// (batch, nb, Qs, 3) contiguous f32; bsel (batch, nb, P) int32 with values in
// [0, G) (others stop the kernel); outputs best, row, bound (batch, nb, Qs)
// preallocated by the caller (centers, radius and bound unused when
// with_bound == 0).  1 <= Qs <= 1024, G <= 2^20, g*12 <= 64 KB,
// batch <= 65535.  Returns the CUDA error code of the launch.
extern "C" int cluster_search_launch(const float* points, const float* centers,
                                     const float* radius, const float* xb,
                                     const int32_t* bsel, int batch, int G, int g,
                                     int nb, int Qs, int P, int with_bound,
                                     float* best, int32_t* row, float* bound,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || nb == 0) return 0;
  if (Qs < 1 || Qs > kMaxQs || G < 1 || G > kMaxGroups || g < 1 || P < 1 ||
      static_cast<int64_t>(g) * 12 > kMaxSlabBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int QG = (Qs + kGroupQ - 1) / kGroupQ;
  const int S = kWarps / QG;
  const int gpass = min(P, kMaxSlabBytes / (12 * g));
  const bool vec16 = g % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  // the slab region also holds the partials: 3 words per (warp, 128 queries)
  const int slab_floats = max((gpass * g * 3 + 3) & ~3, 3 * kGroupQ * kWarps);
  // at most 64 KB of slabs and a 128 KB bitmap: within the 227 KB a block may use
  const size_t bytes = slab_floats * sizeof(float) +
                       (with_bound ? ((G + 31) / 32) * sizeof(unsigned) : 0);
  const dim3 grid(nb, batch);
  const int threads = 32 * QG * S;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (with_bound) {
    err = cudaFuncSetAttribute(cluster_search_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster_search_kernel<true><<<grid, threads, bytes, st>>>(
        points, centers, radius, xb, bsel, G, g, nb, Qs, P, S, gpass, slab_floats,
        vec16, best, row, bound);
  } else {
    err = cudaFuncSetAttribute(cluster_search_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cluster_search_kernel<false><<<grid, threads, bytes, st>>>(
        points, centers, radius, xb, bsel, G, g, nb, Qs, P, S, gpass, slab_floats,
        vec16, best, row, bound);
  }
  return static_cast<int>(cudaGetLastError());
}
