// Score-form exact 1-NN on Hopper (sm_90a): K6 (split over target tiles) and
// K7 (every target tile streamed by each query tile), on one scoring core.
//
// K6 replaces benchmarks/exp_knn.py::_kernel_v1 (launched by nn_v1 at
// exp_knn.py:108); K7 replaces benchmarks/exp_knn.py::_make_kernel_v2
// (launched by nn_v2 at exp_knn.py:193).  Both compute the function of that
// script, not K1's: for queries x (n, 3) f32 and the packed targets
//
//   y4 (4, m_pad) f32 = rows [-2 y0, -2 y1, -2 y2, |y|^2], pad columns
//                       (j >= m) holding 0, 0, 0, 1e30
//
// (packed by dicp_tpu_torch/benchmarks/exp_knn.py::_pack_y8 with
// |y|^2 = (y0 y0 + y1 y1) + y2 y2), the score of query i and column j is
//
//   s(i, j) = ((x0 a0 + x1 a1) + x2 a2) + |y|^2          (f32, |x|^2 dropped)
//
// and the result is the FIRST j minimising s(i, j) with that minimum
// (idx int32, s f32): the first column inside a target tile, and a strict
// '<' that keeps the earlier tile across tiles, from a carry that starts at
// (inf, 0).  The library is built with --fmad=false, so no product is
// contracted into an add and every score is bit-equal to the plain PyTorch
// version's (nn_v1_plain / nn_v2_plain).  No tensor core and no TF32: the
// score cancels |y|^2 against 2 x.y, and a 10-bit mantissa flips real
// argmins, the twin of the TPU's one-pass bf16 trap (exp_knn.py:39-42).
//
// A NaN score is skipped, as K1 and K2 skip a NaN distance: a NaN target
// point loses only its own column.  The TPU kernels and the plain versions
// drop the whole target tile that holds it (their tile minimum is NaN and
// fails the strict '<'); ROADMAP Queue 2 records the deviation.
//
// What bounds it: f32 issue on the CUDA cores, 7 operations per (query,
// column) pair (3 multiplies, 3 adds, 1 minimum).  Built --fmad=false each
// is one instruction, so the issue ceiling (132 SMs x 128 lanes x 1.98 GHz)
// is half the 67 TFLOP/s f32 rate.  Memory is not the limit: a staged
// column is read by the 128 queries of a warp.
//
// The scoring core is K1's warp schedule (csrc/tiled_nn.cu).  A warp owns a
// query group of 128 queries, 4 per lane in registers, and walks one
// contiguous column range through its own two-stage shared-memory ring of
// kTile columns x 4 rows with cp.async: 16-byte requests when the rows and
// the range start on 16-byte boundaries, 4-byte ones otherwise (K6's tm need
// not be a multiple of 4, and then neither are m_pad and the row starts).
// Only __syncwarp separates the stages.  The staged rows are read as float4,
// four columns of a row per broadcast load, shared by the lane's 4 queries:
// 0.25 shared loads per pair.  Per chunk of kChunk columns each query keeps
// fminf of its scores, and a strict '<' of the chunk minimum against the
// running best records the first chunk that attains the range's minimum.
// A block cuts its column range into S contiguous slices, one warp each per
// query group, merges the slices in order with a strict '<' (a slice whose
// scores are all inf or NaN, or that is empty, keeps (inf, 0) and never
// displaces an earlier one), and one thread per query walks the winning
// chunk again from global memory, with the same expression and so the same
// bits, for the first column whose score equals the minimum.  A query whose
// scores are all inf or NaN keeps (inf, 0).
//
// K6 (v1's grid axis j of target tiles, run in order on the TPU with a carry
// in scratch).  Blocks of a CUDA grid run in no order, so the grid is
// (ceil(n / tq), m_pad / tm): block (i, t) runs the core over target tile t
// and writes the tile's (min score, first column) per query into a
// (m_pad / tm, n) partial buffer; a second small kernel reduces the partials
// in tile order with a strict '<', which equals the sequential carry.  The
// re-scan runs once per (query, tile): kChunk more scores per tm.
//
// K7 (v2: one query tile streams every target tile through a double
// buffer, the counterpart of make_async_copy).  Grid (ceil(n / tq),): block
// i runs the core over all m_pad columns and writes (idx, s) itself, with no
// partials and no block barrier inside the walk.
//
// On this card a warp's stage need not be the TPU's DMA tile: tq sets the
// query groups per block, ceil(tq / 128), with S = min(kSlices, 32 / groups)
// slices each (tq <= 1024, at most 32 warps); tm sets K6's target tile, and
// for K7 only m_pad.  A block takes 32 kTile bytes of dynamic shared memory
// per warp (its ring; each warp's partials reuse its own ring after its
// walk).  The kernels allocate nothing and run on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kLaneQ = 4;                  // queries per lane
constexpr int kGroupQ = 32 * kLaneQ;       // queries per warp: a query group
constexpr int kSlices = 4;                 // column slices per group, at most
constexpr int kMaxWarps = 32;              // per block: tq <= 1024
constexpr int kTile = 128;                 // columns per warp stage (2 KB)
constexpr int kChunk = 32;                 // columns per running-minimum chunk

static_assert(kTile % kChunk == 0, "a chunk never straddles two stages");
static_assert(kChunk % 4 == 0, "a full chunk is read 4 columns at a time");
static_assert(8 * kTile >= 2 * kGroupQ, "a warp's partials fit in its ring");
static_assert(kSlices >= 4, "one merging thread per query: 32 S threads per 128 queries");

__device__ __forceinline__ float score(float x0, float x1, float x2, float a0, float a1,
                                       float a2, float yy) {
  float s = x0 * a0;
  s = s + x1 * a1;
  s = s + x2 * a2;
  s = s + yy;
  return s;
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

// Lane-strided copy of columns [c0, c0 + cn) of the 4 rows into a stage
// (row r at stage + r kTile): 16-byte requests for the whole 16-byte words
// when vec16 (rows and c0 16-byte aligned), 4-byte requests for the rest.
__device__ __forceinline__ void issue(float* stage, const float* __restrict__ y4,
                                      int64_t m_pad, int c0, int cn, int lane, bool vec16) {
  const int whole = vec16 ? cn / 4 : 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* src = y4 + r * m_pad + c0;
    float* dst = stage + r * kTile;
    for (int e = lane; e < whole; e += 32) cp_async16(dst + 4 * e, src + 4 * e);
    for (int e = 4 * whole + lane; e < cn; e += 32) cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The scoring core: one warp's 4 queries per lane over columns [lo, hi),
// through the warp's ring (2 stages of 4 kTile floats).  best and from hold
// the range's minimum and the first column of the first chunk attaining it.
__device__ __forceinline__ void walk(const float (&x0)[kLaneQ], const float (&x1)[kLaneQ],
                                     const float (&x2)[kLaneQ], const float* __restrict__ y4,
                                     int64_t m_pad, int lo, int hi, float* ring, int lane,
                                     bool vec16, float (&best)[kLaneQ],
                                     int32_t (&from)[kLaneQ]) {
  const int stages = (hi - lo + kTile - 1) / kTile;
  if (stages > 0) issue(ring, y4, m_pad, lo, min(kTile, hi - lo), lane, vec16);
  for (int t = 0; t < stages; ++t) {
    const int c0 = lo + t * kTile;
    const int cn = min(kTile, hi - c0);
    if (t + 1 < stages) {
      issue(ring + ((t + 1) & 1) * 4 * kTile, y4, m_pad, c0 + kTile,
            min(kTile, hi - c0 - kTile), lane, vec16);
      cp_async_wait<1>();  // stage t has landed; stage t + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's part of stage t is visible
    const float* st = ring + (t & 1) * 4 * kTile;
    for (int j0 = 0; j0 < cn; j0 += kChunk) {
      const int je = min(j0 + kChunk, cn);
      float cmin[kLaneQ];
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) cmin[k] = CUDART_INF_F;
      auto visit = [&](float a0, float a1, float a2, float yy) {
#pragma unroll
        for (int k = 0; k < kLaneQ; ++k) {
          cmin[k] = fminf(cmin[k], score(x0[k], x1[k], x2[k], a0, a1, a2, yy));
        }
      };
      // columns [j, j + 4): one 16-byte load per row (j is a multiple of 4)
      auto visit4 = [&](int j) {
        const float4 a0 = *reinterpret_cast<const float4*>(st + j);
        const float4 a1 = *reinterpret_cast<const float4*>(st + kTile + j);
        const float4 a2 = *reinterpret_cast<const float4*>(st + 2 * kTile + j);
        const float4 yy = *reinterpret_cast<const float4*>(st + 3 * kTile + j);
        visit(a0.x, a1.x, a2.x, yy.x);
        visit(a0.y, a1.y, a2.y, yy.y);
        visit(a0.z, a1.z, a2.z, yy.z);
        visit(a0.w, a1.w, a2.w, yy.w);
      };
      if (je - j0 == kChunk) {
#pragma unroll
        for (int j = j0; j < j0 + kChunk; j += 4) visit4(j);
      } else {
        int j = j0;
        for (; j + 4 <= je; j += 4) visit4(j);
        for (; j < je; ++j) visit(st[j], st[kTile + j], st[2 * kTile + j], st[3 * kTile + j]);
      }
#pragma unroll
      for (int k = 0; k < kLaneQ; ++k) {
        if (cmin[k] < best[k]) {  // strict: the first chunk that attains the minimum
          best[k] = cmin[k];
          from[k] = c0 + j0;
        }
      }
    }
    __syncwarp();  // stage t is free for stage t + 2
  }
}

// A query's (min score, first column); q < 0 for a thread without a query.
struct Result {
  int64_t q;
  float s;
  int32_t idx;
};

// One block: its tq queries (query tile blockIdx.x) over columns [lo, hi),
// the groups' slices merged and the winning chunk re-scanned.  Thread
// q_local < tq returns the result of query blockIdx.x tq + q_local.
__device__ __forceinline__ Result block_argmin(const float* __restrict__ x,
                                               const float* __restrict__ y4, int n,
                                               int64_t m_pad, int tq, int lo, int hi,
                                               int slices, bool vec16, float* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int group = warp / slices;
  const int slice = warp - group * slices;
  float* ring = smem + warp * 8 * kTile;

  // this warp's slice, a multiple of 4 columns wide
  const int span = hi - lo;
  const int width = ((span + slices - 1) / slices + 3) & ~3;
  const int s_lo = lo + min(span, slice * width);
  const int s_hi = lo + min(span, slice * width + width);

  float x0[kLaneQ], x1[kLaneQ], x2[kLaneQ], best[kLaneQ];
  int32_t from[kLaneQ];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * tq;
#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    const int local = group * kGroupQ + 32 * k + lane;
    const int64_t q = base + local;
    const bool valid = local < tq && q < n;
    x0[k] = valid ? x[3 * q + 0] : 0.0f;
    x1[k] = valid ? x[3 * q + 1] : 0.0f;
    x2[k] = valid ? x[3 * q + 2] : 0.0f;
    best[k] = CUDART_INF_F;
    from[k] = 0;
  }
  walk(x0, x1, x2, y4, m_pad, s_lo, s_hi, ring, lane, vec16, best, from);

  // the warp's partials in its own ring: its walk is over and its copies done
  int32_t* ring_i = reinterpret_cast<int32_t*>(ring + kGroupQ);
#pragma unroll
  for (int k = 0; k < kLaneQ; ++k) {
    ring[32 * k + lane] = best[k];
    ring_i[32 * k + lane] = from[k];
  }
  __syncthreads();

  Result out{-1, CUDART_INF_F, 0};
  const int local = threadIdx.x;
  if (local >= tq || base + local >= n) return out;
  // the group's slices in order with a strict '<': the first chunk of the minimum
  const int g = local / kGroupQ;
  const int slot = local - g * kGroupQ;
  float bs = CUDART_INF_F;
  int32_t start = 0;
  for (int s = 0; s < slices; ++s) {
    const float* part = smem + (g * slices + s) * 8 * kTile;
    const float v = part[slot];
    if (v < bs) {
      bs = v;
      start = reinterpret_cast<const int32_t*>(part + kGroupQ)[slot];
    }
  }
  // the first column of that chunk whose score equals the minimum,
  // recomputed from global memory with the same expression (the same bits)
  int32_t arg = 0;
  if (bs < CUDART_INF_F) {
    const int64_t q = base + local;
    const float q0 = x[3 * q + 0];
    const float q1 = x[3 * q + 1];
    const float q2 = x[3 * q + 2];
    arg = -1;
    for (int j = start; j < min(start + kChunk, hi); ++j) {
      if (arg < 0 && score(q0, q1, q2, __ldg(y4 + j), __ldg(y4 + m_pad + j),
                           __ldg(y4 + 2 * m_pad + j), __ldg(y4 + 3 * m_pad + j)) == bs) {
        arg = j;
      }
    }
  }
  out.q = base + local;
  out.s = bs;
  out.idx = arg;
  return out;
}

// K6, pass 1: block (i, t) scores query tile i against target tile t.
__global__ void __launch_bounds__(32 * kMaxWarps)
score_split_kernel(const float* __restrict__ x, const float* __restrict__ y4, int n,
                   int m_pad, int tq, int tm, int slices, bool vec16,
                   float* __restrict__ part_s, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.y;
  const Result r = block_argmin(x, y4, n, m_pad, tq, t * tm, t * tm + tm, slices, vec16, smem);
  if (r.q < 0) return;
  part_s[static_cast<int64_t>(t) * n + r.q] = r.s;
  part_i[static_cast<int64_t>(t) * n + r.q] = r.idx;
}

// K6, pass 2: the sequential carry over the tiles' partials, in tile order.
__global__ void score_reduce_kernel(const float* __restrict__ part_s,
                                    const int32_t* __restrict__ part_i, int n,
                                    int nt, int32_t* __restrict__ idx,
                                    float* __restrict__ s_out) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;
  float best = CUDART_INF_F;
  int32_t arg = 0;
  for (int t = 0; t < nt; ++t) {
    const float v = part_s[static_cast<int64_t>(t) * n + q];
    if (v < best) {
      best = v;
      arg = part_i[static_cast<int64_t>(t) * n + q];
    }
  }
  idx[q] = arg;
  s_out[q] = best;
}

// K7: block i scores query tile i against every column.
__global__ void __launch_bounds__(32 * kMaxWarps)
score_stream_kernel(const float* __restrict__ x, const float* __restrict__ y4, int n,
                    int m_pad, int tq, int slices, bool vec16, int32_t* __restrict__ idx,
                    float* __restrict__ s_out) {
  extern __shared__ __align__(16) float smem[];
  const Result r = block_argmin(x, y4, n, m_pad, tq, 0, m_pad, slices, vec16, smem);
  if (r.q < 0) return;
  idx[r.q] = r.idx;
  s_out[r.q] = r.s;
}

struct Plan {
  int slices, warps;
  size_t bytes;
};

// Query groups of 128 per block, each with S column slices.
Plan plan(int tq) {
  const int groups = (tq + kGroupQ - 1) / kGroupQ;
  const int slices = kSlices < kMaxWarps / groups ? kSlices : kMaxWarps / groups;
  return {slices, groups * slices, size_t(32) * kTile * groups * slices};
}

bool valid_sizes(int n, int m_pad, int tq, int tm) {
  return n >= 0 && tq >= 1 && tq <= kMaxWarps / 4 * kGroupQ && tm >= 1 && m_pad >= tm &&
         m_pad % tm == 0 && m_pad / tm <= 65535;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// K6.  x (n, 3) and y4 (4, m_pad) contiguous f32; part_s (m_pad / tm, n) f32
// and part_i (m_pad / tm, n) int32 scratch, idx (n,) int32 and s (n,) f32
// outputs, all preallocated by the caller.  1 <= tq <= 1024, m_pad a
// multiple of tm with at most 65535 tiles.  Returns the CUDA error code of
// the launches (0 on success).
extern "C" int score_nn_v1_launch(const float* x, const float* y4, int n, int m_pad,
                                  int tq, int tm, float* part_s, int32_t* part_i,
                                  int32_t* idx, float* s, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_sizes(n, m_pad, tq, tm)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const Plan p = plan(tq);
  err = allow_smem(score_split_kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = m_pad / tm;
  const bool vec16 = aligned16(y4) && tm % 4 == 0;
  score_split_kernel<<<dim3((n + tq - 1) / tq, nt), 32 * p.warps, p.bytes, st>>>(
      x, y4, n, m_pad, tq, tm, p.slices, vec16, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part_s, part_i, n, nt, idx, s);
  return static_cast<int>(cudaGetLastError());
}

// K7.  Inputs as K6 with tm a multiple of 4; idx (n,) int32 and s (n,) f32
// preallocated by the caller.  Returns the CUDA error code.
extern "C" int score_nn_v2_launch(const float* x, const float* y4, int n, int m_pad,
                                  int tq, int tm, int32_t* idx, float* s, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_sizes(n, m_pad, tq, tm) || tm % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const Plan p = plan(tq);
  err = allow_smem(score_stream_kernel, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  score_stream_kernel<<<(n + tq - 1) / tq, 32 * p.warps, p.bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      x, y4, n, m_pad, tq, p.slices, aligned16(y4), idx, s);
  return static_cast<int>(cudaGetLastError());
}
