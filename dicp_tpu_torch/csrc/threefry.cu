// D1: JAX's threefry2x32 uniform draws for the Gumbel soft NN, and D2:
// jax.random.randint's draws for SGD-ICP's mini-batches, on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package draws its Gumbel noise with
// jax.random.uniform (dicp_tpu/knn.py:98, :124), which XLA lowers to its own
// threefry2x32 code.  The port computed the same bits as ~110 int32
// elementwise passes per block (knn.threefry_uniform_plain, kept as this
// kernel's plain version for CPU tensors); this kernel is one pass.
//
// For each row r of `rows` and each j < size it writes
//
//   key     = fold_in(fold_in((k1[r], k2[r]), *iteration), chunk)
//             (each fold only where given; fold_in(k, d) = threefry(k, (0, d)))
//   (b1, b2) = threefry2x32(key, (j >> 32, j mod 2^32))
//   u[r, j] = f32: bits((b1 ^ b2) >> 9 | 0x3F800000) - 1
//             f64: bits((b1 << 20) | (b2 >> 12) | 0x3FF0000000000000) - 1
//
// the partitionable counter layout of jax.random (jax_threefry_partitionable)
// and jax.random.uniform's float from bits (jax/_src/prng.py, random.py).
// The iteration is a device int32 (a solve's loop counter), read here and
// never on the host, so a captured solve draws at its own counter.
//
// What bounds it: integer issue.  Per element 2 adds, 20 rounds of (add,
// funnel-shift rotate, xor), 5 key injections of 2 adds, and the float's
// 3-4 bit operations and a subtract: ~76 instructions for 4 (f32) or 8
// (f64) bytes written, far above the card's bytes-per-instruction balance.
//
// Design.  Grid (ceil(size / 2048), rows) of 256-thread blocks; thread 0
// folds the row's key in (at most two more threefry blocks per block of
// 2048 elements) into shared memory, then each thread draws 8 elements
// 256 apart, so a warp's stores are 128 contiguous bytes (f32).  The
// rotations are immediate __funnelshift_l operands (the loops unroll fully).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__host__ __device__ constexpr int rotation(int round, int j) {
  return round % 2 == 0 ? (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6)
                        : (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24);
}

// threefry2x32 (20 rounds) of the key (k0, k1) over the count words
// (x0, x1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0,
                                         uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(i, j));
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

template <bool kF64>
__global__ void __launch_bounds__(kThreads) threefry_uniform_kernel(
    const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
    const int32_t* __restrict__ iteration, int has_chunk, uint32_t chunk, long long size,
    void* __restrict__ out) {
  __shared__ uint32_t key[2];
  const int row = blockIdx.y;
  if (threadIdx.x == 0) {
    uint32_t a = static_cast<uint32_t>(k1[row]), b = static_cast<uint32_t>(k2[row]);
    if (iteration != nullptr) {
      uint32_t x0 = 0, x1 = static_cast<uint32_t>(*iteration);
      threefry(a, b, x0, x1);
      a = x0;
      b = x1;
    }
    if (has_chunk) {
      uint32_t x0 = 0, x1 = chunk;
      threefry(a, b, x0, x1);
      a = x0;
      b = x1;
    }
    key[0] = a;
    key[1] = b;
  }
  __syncthreads();
  const uint32_t a = key[0], b = key[1];
  const long long first = static_cast<long long>(blockIdx.x) * (kThreads * kPerThread) +
                          threadIdx.x;
  const long long row_base = static_cast<long long>(row) * size;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const long long j = first + static_cast<long long>(e) * kThreads;
    if (j < size) {
      uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(j) >> 32);
      uint32_t x1 = static_cast<uint32_t>(j);
      threefry(a, b, x0, x1);
      if (kF64) {
        const unsigned long long bits = (static_cast<unsigned long long>(x0) << 20) |
                                        (x1 >> 12) | 0x3FF0000000000000ull;
        static_cast<double*>(out)[row_base + j] = __longlong_as_double(bits) - 1.0;
      } else {
        const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
        static_cast<float*>(out)[row_base + j] = __uint_as_float(bits) - 1.0f;
      }
    }
  }
}

// D2.  Replaces no Pallas kernel: the JAX package draws SGD-ICP's mini-batch
// with jax.random.randint(fold_in(key, it), (k,), 0, n) (dicp_tpu/sgd_icp.py:
// 179-180), XLA's threefry2x32 again.  With x64 on it draws int64: for each
// row r and j < k
//
//   key      = fold_in((k1[r], k2[r]), *iteration)   (where given)
//   hi, lo   = the 64-bit words b1 << 32 | b2 of threefry2x32(fold_in(key, h),
//              (j >> 32, j mod 2^32)) for h = 0 and 1   (_split, partitionable)
//   out[r, j] = ((hi mod n) * ((2^32 mod n)^2 mod n) + lo mod n) mod n
//
// (jax/_src/random.py::_randint, the span n >= 1).  Every product stays
// below 2^64 for n <= 2^32.  Grid (ceil(k / 256), rows); threads 0 and 1
// fold the row's key with the iteration and then with 0 and 1 into shared
// memory; each thread draws one sample (two blocks and three u64 remainders).
__global__ void __launch_bounds__(kThreads) threefry_randint_kernel(
    const int32_t* __restrict__ k1, const int32_t* __restrict__ k2,
    const int32_t* __restrict__ iteration, long long k, unsigned long long span,
    long long* __restrict__ out) {
  __shared__ uint32_t halves[2][2];
  const int row = blockIdx.y;
  if (threadIdx.x < 2) {
    uint32_t a = static_cast<uint32_t>(k1[row]), b = static_cast<uint32_t>(k2[row]);
    if (iteration != nullptr) {
      uint32_t x0 = 0, x1 = static_cast<uint32_t>(*iteration);
      threefry(a, b, x0, x1);
      a = x0;
      b = x1;
    }
    uint32_t x0 = 0, x1 = threadIdx.x;
    threefry(a, b, x0, x1);
    halves[threadIdx.x][0] = x0;
    halves[threadIdx.x][1] = x1;
  }
  __syncthreads();
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= k) return;
  unsigned long long mod[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(j) >> 32);
    uint32_t x1 = static_cast<uint32_t>(j);
    threefry(halves[h][0], halves[h][1], x0, x1);
    mod[h] = ((static_cast<unsigned long long>(x0) << 32) | x1) % span;
  }
  const unsigned long long r32 = (1ull << 32) % span;
  out[static_cast<long long>(row) * k + j] =
      static_cast<long long>((mod[0] * (r32 * r32 % span) + mod[1]) % span);
}

}  // namespace

// out (rows, size) of f32 (f64 != 0: f64); k1, k2 (rows,) int32 key words;
// iteration a device int32 or null; chunk folded in where has_chunk.
extern "C" int threefry_uniform_launch(const int32_t* k1, const int32_t* k2, int rows,
                                       const int32_t* iteration, int has_chunk,
                                       unsigned int chunk, long long size, int f64,
                                       void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || size == 0) return 0;
  const long long blocks = (size + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  if (rows < 0 || rows > 65535 || size < 0 || blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks), rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64)
    threefry_uniform_kernel<true><<<grid, kThreads, 0, s>>>(k1, k2, iteration, has_chunk,
                                                            chunk, size, out);
  else
    threefry_uniform_kernel<false><<<grid, kThreads, 0, s>>>(k1, k2, iteration, has_chunk,
                                                             chunk, size, out);
  return static_cast<int>(cudaGetLastError());
}

// out (rows, k) int64 in [0, n) (n <= 0 draws 0); k1, k2 (rows,) int32 key
// words; iteration a device int32 or null.
extern "C" int threefry_randint_launch(const int32_t* k1, const int32_t* k2, int rows,
                                       const int32_t* iteration, long long k, long long n,
                                       long long* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0 || k == 0) return 0;
  const long long blocks = (k + kThreads - 1) / kThreads;
  if (rows < 0 || rows > 65535 || k < 0 || blocks > 2147483647LL || n > (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(blocks), rows);
  const unsigned long long span = n > 0 ? static_cast<unsigned long long>(n) : 1ull;
  threefry_randint_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k1, k2, iteration, k, span, out);
  return static_cast<int>(cudaGetLastError());
}
