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
// What bounds it: f32 issue on the CUDA cores, 8 operations and a compare per
// (query, target) pair and n*m pairs per batch element.  Built --fmad=false,
// each is one instruction, so the issue ceiling (132 SMs x 128 lanes x
// 1.98 GHz, 3.3e13 instructions/s) is half the 67 TFLOP/s f32 bound that
// counts an FMA as two.  Memory is not the limit: a staged target is read by
// 128 queries.
//
// Design.  Grid (ceil(n / 128), B) of 4-warp blocks.  Each lane keeps 4
// queries (q = 32 k + lane of the block's 128) in registers, so each staged
// target feeds 4 pairs.  The block's target range is cut into 4 contiguous
// slices, one per warp, so a block has 4 warps in flight where one query
// tile would give one (768 blocks of 4 warps at (8, 12288, 16000), one wave
// of ~23 warps per SM).  Slices are a multiple of 4 targets wide, so every
// tile starts on a 48-byte boundary of the (m, 3) rows.  Each warp streams
// its slice through its own two-stage shared-memory ring of kTile-target
// tiles with cp.async (only __syncwarp between stages, no block barrier):
// 16-byte requests when the batch element's rows are 16-byte aligned, 4-byte
// ones for the rest of a ragged tile and for rows that are not.  The staged
// (kTile, 3) run is read as it lies, 4 targets per three broadcast 16-byte
// shared-memory loads: no per-element % 3 or / 3 and no repacked copy.
//
// The argmin costs one instruction per pair instead of a compare and two
// selects: per chunk of kChunk targets each query keeps fminf of its d2, and
// a strict '<' of the chunk minimum against the running best records the
// first chunk that attains the slice's minimum.  fminf skips a NaN as '<'
// does.  The 4 slices' (best, chunk) of a query are merged in slice order
// with a strict '<': slices are contiguous and ascending, so that gives the
// first chunk that attains the minimum, and a slice whose distances are all
// inf (or that is empty) keeps (inf, 0) and never displaces slice 0.  Then
// one thread per query walks that one chunk again (from global memory, the
// same expression, so the same bits) for the first target whose d2 equals
// the minimum: the first index, as the sequential strict '<' gives it; a
// query whose distances are all inf keeps index 0.  (A re-scan at every
// chunk that improves the best would run in about half of the (warp, query
// slot, chunk) triples, since some lane of 32 finds a new best in most
// chunks; chip_smoke.py phase 2 counts that share.  Deferred to the merge,
// it runs once per query.)  The ragged query and target edges are masked by
// counts: there are no padding rows.  The kernel allocates nothing and runs
// on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kLaneQ = 4;                  // queries per lane
constexpr int kSlices = 4;                 // warps per block = target slices
constexpr int kThreads = 32 * kSlices;
constexpr int kQB = 32 * kLaneQ;           // queries per block
constexpr int kTile = 128;                 // targets per warp tile (1.5 KB)
constexpr int kChunk = 32;                 // targets per running-minimum chunk

static_assert(kTile % kChunk == 0, "a chunk never straddles two stages");
static_assert(kChunk % 4 == 0, "a full chunk is read 4 targets at a time");

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane-strided copy of targets [t0, t0 + tn), 3 tn floats, into a warp's
// stage.  t0 is a multiple of 4, so with 16-byte-aligned rows the run starts
// on a 16-byte boundary: 16-byte requests for its whole 16-byte words, 4-byte
// requests for the rest (at most 3 floats of a ragged tile, or all of it when
// the rows are not aligned).
__device__ __forceinline__ void issue(float* stage, const float* __restrict__ yb, int t0,
                                      int tn, int lane, bool vec16) {
  const float* src = yb + 3 * static_cast<int64_t>(t0);
  const int floats = 3 * tn;
  const int whole = vec16 ? floats / 4 : 0;
  for (int e = lane; e < whole; e += 32) cp_async16(stage + 4 * e, src + 4 * e);
  for (int e = 4 * whole + lane; e < floats; e += 32) cp_async4(stage + e, src + e);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
tiled_nn_kernel(const float* __restrict__ x, const float* __restrict__ y, int n, int m,
                int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ __align__(16) float ring[kSlices][2][3 * kTile];
  __shared__ float part_d[kSlices][kQB];
  __shared__ int32_t part_i[kSlices][kQB];

  const int64_t b = blockIdx.y;
  const float* xb = x + b * static_cast<int64_t>(n) * 3;
  const float* yb = y + b * static_cast<int64_t>(m) * 3;
  const bool vec16 = (reinterpret_cast<uintptr_t>(yb) & 15) == 0;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // this warp's slice of the targets, a multiple of 4 wide
  const int width = ((m + kSlices - 1) / kSlices + 3) & ~3;
  const int lo = min(m, warp * width);
  const int hi = min(m, lo + width);
  const int tiles = (hi - lo + kTile - 1) / kTile;
  if (tiles > 0) issue(ring[warp][0], yb, lo, min(kTile, hi - lo), lane, vec16);

  float qx[kLaneQ], qy[kLaneQ], qz[kLaneQ], best[kLaneQ];
  int32_t from[kLaneQ];  // first target of the chunk that holds best
#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    const int q = blockIdx.x * kQB + 32 * k + lane;
    const bool valid = q < n;
    qx[k] = valid ? xb[3 * static_cast<int64_t>(q) + 0] : 0.0f;
    qy[k] = valid ? xb[3 * static_cast<int64_t>(q) + 1] : 0.0f;
    qz[k] = valid ? xb[3 * static_cast<int64_t>(q) + 2] : 0.0f;
    best[k] = CUDART_INF_F;
    from[k] = 0;
  }

  for (int t = 0; t < tiles; ++t) {
    const int t0 = lo + t * kTile;
    const int tn = min(kTile, hi - t0);
    if (t + 1 < tiles) {
      issue(ring[warp][(t + 1) & 1], yb, t0 + kTile, min(kTile, hi - t0 - kTile), lane,
            vec16);
      cp_async_wait<1>();  // tile t has landed; tile t + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's part of tile t is visible
    const float* tile = ring[warp][t & 1];
    for (int c0 = 0; c0 < tn; c0 += kChunk) {
      const int ce = min(c0 + kChunk, tn);
      float cmin[kLaneQ];
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) cmin[k] = CUDART_INF_F;
      auto visit = [&](float tx, float ty, float tz) {
#pragma unroll
        for (int k = 0; k < kLaneQ; ++k) {
          cmin[k] = fminf(cmin[k], dist2(qx[k], qy[k], qz[k], tx, ty, tz));
        }
      };
      // targets [j, j + 4): three 16-byte loads (j is a multiple of 4)
      auto visit4 = [&](int j) {
        const float4 a = *reinterpret_cast<const float4*>(tile + 3 * j);
        const float4 c = *reinterpret_cast<const float4*>(tile + 3 * j + 4);
        const float4 e = *reinterpret_cast<const float4*>(tile + 3 * j + 8);
        visit(a.x, a.y, a.z);
        visit(a.w, c.x, c.y);
        visit(c.z, c.w, e.x);
        visit(e.y, e.z, e.w);
      };
      if (ce - c0 == kChunk) {
#pragma unroll
        for (int j = c0; j < c0 + kChunk; j += 4) visit4(j);
      } else {
        int j = c0;
        for (; j + 4 <= ce; j += 4) visit4(j);
        for (; j < ce; ++j) visit(tile[3 * j], tile[3 * j + 1], tile[3 * j + 2]);
      }
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) {
        if (cmin[k] < best[k]) {  // strict: the first chunk that attains the minimum
          best[k] = cmin[k];
          from[k] = t0 + c0;
        }
      }
    }
    __syncwarp();  // tile t's stage is free for tile t + 2
  }

#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    part_d[warp][32 * k + lane] = best[k];
    part_i[warp][32 * k + lane] = from[k];
  }
  __syncthreads();
  const int q = blockIdx.x * kQB + threadIdx.x;
  if (q >= n) return;
  // the slices in order with a strict '<': the first chunk of the minimum
  float bd = part_d[0][threadIdx.x];
  int32_t start = part_i[0][threadIdx.x];
#pragma unroll
  for (int s = 1; s < kSlices; ++s) {
    const float d = part_d[s][threadIdx.x];
    if (d < bd) {
      bd = d;
      start = part_i[s][threadIdx.x];
    }
  }
  // the first index of that chunk whose d2 equals the minimum, recomputed
  // from global memory with the same expression (the same bits)
  int32_t arg = 0;
  if (bd < CUDART_INF_F) {
    const float x0 = xb[3 * static_cast<int64_t>(q) + 0];
    const float x1 = xb[3 * static_cast<int64_t>(q) + 1];
    const float x2 = xb[3 * static_cast<int64_t>(q) + 2];
    arg = -1;
    for (int j = start; j < min(start + kChunk, m); ++j) {
      const float* p = yb + 3 * static_cast<int64_t>(j);
      if (arg < 0 && dist2(x0, x1, x2, __ldg(p), __ldg(p + 1), __ldg(p + 2)) == bd) arg = j;
    }
  }
  idx_out[b * n + q] = arg;
  d2_out[b * n + q] = bd;
}

static_assert(kThreads == kQB, "one merging thread per query of the block");

}  // namespace

// x (batch, n, 3) and y (batch, m, 3) contiguous f32; idx (batch, n) int32
// and d2 (batch, n) f32 preallocated by the caller; m >= 1; batch <= 65535.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int tiled_nn_launch(const float* x, const float* y, int batch,
                               int n, int m, int32_t* idx, float* d2,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kQB - 1) / kQB, batch);
  tiled_nn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, n, m, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
