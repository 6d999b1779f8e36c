// Score-form exact 1-NN on Hopper (sm_90a): K6 (split over target tiles) and
// K7 (targets streamed through a cp.async double buffer).
//
// K6 replaces benchmarks/exp_knn.py::_kernel_v1 (launched by nn_v1 at
// exp_knn.py:108); K7 replaces benchmarks/exp_knn.py::_make_kernel_v2
// (launched by nn_v2 at exp_knn.py:193).  Both compute the function of that
// script, not K1's: for queries x (n, 3) f32 and the packed targets
//
//   y4 (4, m_pad) f32 = rows [-2 y0, -2 y1, -2 y2, |y|^2], pad columns
//                       (j >= m) holding 0, 0, 0, 1e30
//
// (packed by dicp_tpu_torch/benchmarks/exp_knn.py::_pack_y4 with
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
// What bounds it: f32 issue on the CUDA cores, 7 operations per (query,
// column) pair (3 multiplies, 3 adds, 1 compare).  Memory is not the limit:
// a staged target tile is read by every query of the block.
//
// K6 design.  The TPU runs v1's grid axis j (target tiles) in order and
// carries the running min in scratch.  Blocks of a CUDA grid run in no order,
// so the grid is (ceil(n / tq), m_pad / tm): block (i, t) stages target tile
// t in shared memory as SoA, scores its tq queries against it and writes the
// tile's (min score, first column) per query into a (m_pad / tm, n) partial
// buffer.  A second small kernel reduces the partials in tile order with a
// strict '<', which equals the sequential carry.  No float atomics: they
// would break the first-index rule and determinism.
//
// K7 design.  Grid (ceil(n / tq),): each block walks every target tile.
// While it scores tile t from one shared-memory buffer, the copy engine
// fills the other with tile t + 1 (cp.async, 16 bytes per request): the
// counterpart of v2's make_async_copy double buffer and MXU/VPU overlap
// (exp_knn.py:137-184).  The running min per query stays in registers.
// Two stages of four f32 rows are 32 tm bytes (128 KB at tm = 4096), above
// the 48 KB default, so the launch raises the dynamic shared-memory limit.
//
// Both kernels: blocks of up to 128 threads, each thread keeping QPT queries
// (QPT = ceil(tq / threads), rounded up to a power of two, <= 8; tq <= 1024).
// The kernels allocate nothing and run on the caller's stream.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 128;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Query q_local = k * blockDim.x + threadIdx.x of the block's tile of tq.
template <int QPT>
struct Queries {
  float x0[QPT], x1[QPT], x2[QPT], best[QPT];
  int32_t arg[QPT];
  int64_t q[QPT];
  bool valid[QPT];

  __device__ __forceinline__ void load(const float* __restrict__ x, int n, int tq) {
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const int local = k * blockDim.x + threadIdx.x;
      q[k] = static_cast<int64_t>(blockIdx.x) * tq + local;
      valid[k] = local < tq && q[k] < n;
      x0[k] = valid[k] ? x[3 * q[k] + 0] : 0.0f;
      x1[k] = valid[k] ? x[3 * q[k] + 1] : 0.0f;
      x2[k] = valid[k] ? x[3 * q[k] + 2] : 0.0f;
      best[k] = CUDART_INF_F;
      arg[k] = 0;
    }
  }

  // Score `cols` columns of a SoA tile (rows a0, a1, a2, |y|^2, each `stride`
  // floats apart) whose first column is `col0`, in column order.
  __device__ __forceinline__ void score(const float* tile, int stride, int cols,
                                        int32_t col0) {
    for (int j = 0; j < cols; ++j) {
      const float a0 = tile[j];
      const float a1 = tile[stride + j];
      const float a2 = tile[2 * stride + j];
      const float yy = tile[3 * stride + j];
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        float s = x0[k] * a0;
        s = s + x1[k] * a1;
        s = s + x2[k] * a2;
        s = s + yy;
        if (s < best[k]) {
          best[k] = s;
          arg[k] = col0 + j;
        }
      }
    }
  }
};

// K6, pass 1: block (i, t) scores query tile i against target tile t.
template <int QPT>
__global__ void __launch_bounds__(kMaxThreads)
score_split_kernel(const float* __restrict__ x, const float* __restrict__ y4,
                   int n, int m_pad, int tq, int tm,
                   float* __restrict__ part_s, int32_t* __restrict__ part_i) {
  extern __shared__ __align__(16) float tile[];  // (4, tm) SoA
  const int t = blockIdx.y;
  const int64_t col0 = static_cast<int64_t>(t) * tm;
  for (int e = threadIdx.x; e < 4 * tm; e += blockDim.x) {
    const int r = e / tm;
    tile[e] = y4[static_cast<int64_t>(r) * m_pad + col0 + (e - r * tm)];
  }
  Queries<QPT> qs;
  qs.load(x, n, tq);
  __syncthreads();
  qs.score(tile, tm, tm, static_cast<int32_t>(col0));
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    if (qs.valid[k]) {
      part_s[static_cast<int64_t>(t) * n + qs.q[k]] = qs.best[k];
      part_i[static_cast<int64_t>(t) * n + qs.q[k]] = qs.arg[k];
    }
  }
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

// K7: one block per query tile walks every target tile, double-buffered.
__device__ __forceinline__ void issue_tile(float* stage, const float* __restrict__ y4,
                                           int m_pad, int tm, int t) {
  const int chunks = tm / 4;  // 16-byte requests per row
  for (int e = threadIdx.x; e < 4 * chunks; e += blockDim.x) {
    const int r = e / chunks;
    const int c = 4 * (e - r * chunks);
    cp_async16(stage + r * tm + c,
               y4 + static_cast<int64_t>(r) * m_pad + static_cast<int64_t>(t) * tm + c);
  }
  cp_async_commit();
}

template <int QPT>
__global__ void __launch_bounds__(kMaxThreads)
score_stream_kernel(const float* __restrict__ x, const float* __restrict__ y4,
                    int n, int m_pad, int tq, int tm, int32_t* __restrict__ idx,
                    float* __restrict__ s_out) {
  extern __shared__ __align__(16) float buf[];  // (2, 4, tm)
  const int nt = m_pad / tm;
  issue_tile(buf, y4, m_pad, tm, 0);
  Queries<QPT> qs;
  qs.load(x, n, tq);
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      issue_tile(buf + ((t + 1) & 1) * 4 * tm, y4, m_pad, tm, t + 1);
      cp_async_wait<1>();  // tile t has landed; tile t + 1 may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's part of tile t is visible
    qs.score(buf + (t & 1) * 4 * tm, tm, tm, t * tm);
    __syncthreads();  // tile t's buffer is free for tile t + 2
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    if (qs.valid[k]) {
      idx[qs.q[k]] = qs.arg[k];
      s_out[qs.q[k]] = qs.best[k];
    }
  }
}

struct Launch {
  const float* x;
  const float* y4;
  int n, m_pad, tq, tm;
  int threads;
  cudaStream_t stream;
};

template <int QPT>
int launch_split(const Launch& L, float* part_s, int32_t* part_i, int32_t* idx,
                 float* s_out) {
  const size_t bytes = size_t(16) * L.tm;
  cudaError_t err = cudaFuncSetAttribute(
      score_split_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nt = L.m_pad / L.tm;
  const dim3 grid((L.n + L.tq - 1) / L.tq, nt);
  score_split_kernel<QPT><<<grid, L.threads, bytes, L.stream>>>(
      L.x, L.y4, L.n, L.m_pad, L.tq, L.tm, part_s, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  score_reduce_kernel<<<(L.n + 255) / 256, 256, 0, L.stream>>>(part_s, part_i, L.n,
                                                               nt, idx, s_out);
  return static_cast<int>(cudaGetLastError());
}

template <int QPT>
int launch_stream(const Launch& L, int32_t* idx, float* s_out) {
  const size_t bytes = size_t(32) * L.tm;
  cudaError_t err = cudaFuncSetAttribute(
      score_stream_kernel<QPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  score_stream_kernel<QPT><<<(L.n + L.tq - 1) / L.tq, L.threads, bytes, L.stream>>>(
      L.x, L.y4, L.n, L.m_pad, L.tq, L.tm, idx, s_out);
  return static_cast<int>(cudaGetLastError());
}

// Threads per block and queries per thread for a query tile of tq.
int plan(Launch& L) {
  L.threads = L.tq >= kMaxThreads ? kMaxThreads : ((L.tq + 31) / 32) * 32;
  const int need = (L.tq + L.threads - 1) / L.threads;
  int qpt = 1;
  while (qpt < need) qpt *= 2;
  return qpt;
}

bool valid_sizes(int n, int m_pad, int tq, int tm) {
  return n >= 0 && tq >= 1 && tq <= 8 * kMaxThreads && tm >= 1 && m_pad >= tm &&
         m_pad % tm == 0 && m_pad / tm <= 65535;
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
  Launch L{x, y4, n, m_pad, tq, tm, 0, static_cast<cudaStream_t>(stream)};
  switch (plan(L)) {
    case 1: return launch_split<1>(L, part_s, part_i, idx, s);
    case 2: return launch_split<2>(L, part_s, part_i, idx, s);
    case 4: return launch_split<4>(L, part_s, part_i, idx, s);
    default: return launch_split<8>(L, part_s, part_i, idx, s);
  }
}

// K7.  Inputs as K6 with tm a multiple of 4 (16-byte copies); idx (n,) int32
// and s (n,) f32 preallocated by the caller.  Returns the CUDA error code.
extern "C" int score_nn_v2_launch(const float* x, const float* y4, int n, int m_pad,
                                  int tq, int tm, int32_t* idx, float* s, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!valid_sizes(n, m_pad, tq, tm) || tm % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Launch L{x, y4, n, m_pad, tq, tm, 0, static_cast<cudaStream_t>(stream)};
  switch (plan(L)) {
    case 1: return launch_stream<1>(L, idx, s);
    case 2: return launch_stream<2>(L, idx, s);
    case 4: return launch_stream<4>(L, idx, s);
    default: return launch_stream<8>(L, idx, s);
  }
}
