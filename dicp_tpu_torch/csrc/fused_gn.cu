// Whole-solve Gauss-Newton ICP for small pairs on Hopper (sm_90a): K4.
//
// Replaces dicp_tpu/ops/fused_gn.py::_make_kernel (launched by fused_gn_solve
// at fused_gn.py:413).  For each batch element it runs the entire
// non-differentiable early-exit solve with histories off: dense 1-NN, robust
// and trim weights, the pt2pt/pt2pl normal equations, the Jacobi-equilibrated
// Schur/Cramer solve (6x6, or 3x3 for dim 2), the Rodrigues retraction,
// convergence freezing and the first-crossing stats.  The arithmetic repeats
// the Pallas kernel's and the plain PyTorch version's
// (ops/fused_gn.py::fused_gn_solve_plain) expression for expression; built
// with --fmad=false, nothing is contracted into an FMA.  Only the sums over
// points round differently: here a fixed-order warp-shuffle tree, there
// torch.sum.
//
// What bounds it: not the card's rates.  The work is tiny (B=256 pairs of 65
// points take ~1e8 flops and under 1 MB) and it is a serial chain: per
// iteration a block does m distance evaluations per thread, one reduction
// with two barriers, and a solve on one thread while the others wait.  The
// time is the latency of that chain times the iterations, for ceil(B/132)
// waves of blocks.  The design keeps everything of an element on one SM for
// the whole solve: the inputs are read from device memory once and only the
// results are written back; there is no launch per iteration and no host sync.
//
// Design: one block per batch element, one thread per source point
// (blockDim = 32 * ceil(n / 32) <= 256; threads past n carry weight 0).  The
// target's columns (3 for pt2pt, 6 for pt2pl, m <= 512) are staged once in
// shared memory as SoA (<= 12 KB).  Each iteration every thread transforms
// its point, walks the m targets in index order with a strict '<' (the first
// index of the minimum), and forms its residual, weights and Jacobian
// products.  The normal-equation sums (21 of A and 6 of b for k = 6, 6 and 3
// for k = 3), the cost, the weight sum and the two match counts go through a
// warp-shuffle tree and a sum over the warps in warp order: no atomics, so a
// launch repeats bit for bit.  Thread 0 then solves, retracts, and updates C,
// r and the stats in shared memory; a barrier, and the next iteration.
//
// icp_type and dim pick one of four template instances at launch, so the
// per-thread arrays have compile-time sizes and stay in registers; the loss,
// differentiable, trim, tikhonov and the tolerances are runtime arguments
// whose branches are uniform across the block.
//
// The one deliberate deviation from Pallas: each element leaves its loop
// when it converges, where the Pallas kernel leaves per tile of 8 elements
// (its converged elements run no-op iterations that drift by O(1e-12)).  The
// plain version holds converged elements' state, so it exits the same way.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;

struct Params {
  int n, m, loss, diff, has_trim, has_tik, max_iters;
  float trim, metric, steep, tol, thresh, tik;
};

__device__ __forceinline__ float safe_sqrt(float sq) {
  return sq == 0.0f ? 0.0f : sqrtf(sq);
}

__device__ __forceinline__ float trim_w(float en2, float metric, int diff, float steep) {
  const float en = safe_sqrt(en2);
  if (diff) return 0.5f * tanhf(steep * (metric - en) - 3.0f) + 0.5f;
  return en < metric ? 1.0f : 0.0f;
}

// losses.robust_weight on |loss_err|^2; codes as ops/fused_gn.py::_LOSS_CODES
__device__ __forceinline__ float loss_w(int code, float le2, float metric, int diff,
                                        float steep) {
  const float m2 = metric * metric;
  switch (code) {
    case 1:
      if (diff) return m2 / (m2 + le2);
      {
        const float en = safe_sqrt(le2);
        return en > metric ? metric / (en == 0.0f ? 1.0f : en) : 1.0f;
      }
    case 2: return 1.0f / (1.0f + le2 / m2);
    case 3: return expf(-le2 / m2);
    case 4: { const float q = m2 / (m2 + le2); return q * q; }
    case 5: return trim_w(le2, metric, diff, steep);
    default: return 1.0f;
  }
}

// ---- the scalar solve of the Pallas kernel (fused_gn.py:55-108) ----------

__device__ __forceinline__ void inv3(float a[3][3], float out[3][3]) {
  const float c00 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
  const float c01 = a[1][2] * a[2][0] - a[1][0] * a[2][2];
  const float c02 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
  const float det = a[0][0] * c00 + a[0][1] * c01 + a[0][2] * c02;
  const float c10 = a[0][2] * a[2][1] - a[0][1] * a[2][2];
  const float c11 = a[0][0] * a[2][2] - a[0][2] * a[2][0];
  const float c12 = a[0][1] * a[2][0] - a[0][0] * a[2][1];
  const float c20 = a[0][1] * a[1][2] - a[0][2] * a[1][1];
  const float c21 = a[0][2] * a[1][0] - a[0][0] * a[1][2];
  const float c22 = a[0][0] * a[1][1] - a[0][1] * a[1][0];
  const float adj[3][3] = {{c00, c10, c20}, {c01, c11, c21}, {c02, c12, c22}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = adj[i][j] / det;
}

__device__ __forceinline__ void mv3(float m[3][3], const float v[3], float out[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = m[i][0] * v[0] + m[i][1] * v[1] + m[i][2] * v[2];
}

__device__ __forceinline__ void mm3(float a[3][3], float b[3][3],
                                    float out[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
}

__device__ __forceinline__ void solve6(float a[6][6], const float b[6], float x[6]) {
  float p[3][3], q[3][3], qt[3][3], s[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      p[i][j] = a[i][j];
      q[i][j] = a[i][3 + j];
      qt[i][j] = a[3 + i][j];
      s[i][j] = a[3 + i][3 + j];
    }
  float p_inv[3][3], p_inv_q[3][3], m_qq[3][3], m[3][3], m_inv[3][3];
  inv3(p, p_inv);
  mm3(p_inv, q, p_inv_q);
  mm3(qt, p_inv_q, m_qq);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) m[i][j] = s[i][j] - m_qq[i][j];
  const float b1[3] = {b[0], b[1], b[2]};
  float p_inv_b1[3], qtb[3], rhs[3], x2[3], px2[3];
  mv3(p_inv, b1, p_inv_b1);
  mv3(qt, p_inv_b1, qtb);
#pragma unroll
  for (int i = 0; i < 3; ++i) rhs[i] = b[3 + i] - qtb[i];
  inv3(m, m_inv);
  mv3(m_inv, rhs, x2);
  mv3(p_inv_q, x2, px2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    x[i] = p_inv_b1[i] - px2[i];
    x[3 + i] = x2[i];
  }
}

// ops/smallsolve.solve_spd with its Jacobi equilibration, on scalars
template <int K>
__device__ __forceinline__ void solve_spd(float a[K][K], const float b[K],
                                          float x[K]) {
  float dinv[K], a_eq[K][K], b_eq[K], y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) dinv[i] = 1.0f / sqrtf(fmaxf(a[i][i], 1e-30f));
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) a_eq[i][j] = a[i][j] * dinv[i] * dinv[j];
    b_eq[i] = b[i] * dinv[i];
  }
  if constexpr (K == 3) {
    float inv[3][3];
    inv3(a_eq, inv);
    mv3(inv, b_eq, y);
  } else {
    solve6(a_eq, b_eq, y);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) x[i] = y[i] * dinv[i];
}

// Rodrigues with the f32 series switch at theta^2 < 0.01 (fused_gn.py:111-127)
__device__ __forceinline__ void exp_so3(const float w[3], float R[3][3]) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta2 < 0.01f;
  const float theta = sqrtf(small ? 1.0f : theta2);
  const float a = small ? 1.0f - theta2 / 6.0f + theta2 * theta2 / 120.0f
                        : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f + theta2 * theta2 / 720.0f
                        : (1.0f - cosf(theta)) / theta2;
  float k[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  float kk[3][3];
  mm3(k, k, kk);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[i][j] = (i == j ? 1.0f : 0.0f) + a * k[i][j] + b * kk[i][j];
}

// Sum of each v[q] over the block in a fixed order: a shuffle tree inside
// each warp, then thread 0 adds the warps in warp order into tot.  Every
// thread calls it; tot is meaningful on thread 0 only.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red, float (&tot)[NV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float x = v[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * NV + q] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      float s = red[q];
      for (int wi = 1; wi < nwarps; ++wi) s += red[wi * NV + q];
      tot[q] = s;
    }
  }
}

template <int K, bool PT2PL>
__global__ void __launch_bounds__(kMaxThreads)
fused_gn_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                const float* __restrict__ w0, const float* __restrict__ C0,
                const float* __restrict__ r0, float* __restrict__ C_out,
                float* __restrict__ r_out, float* __restrict__ conv_out,
                float* __restrict__ iters_out, float* __restrict__ ratio_out,
                float* __restrict__ wsave_out, float* __restrict__ cost_out, Params p) {
  constexpr int TC = PT2PL ? 6 : 3;
  constexpr int NA = K * (K + 1) / 2;
  constexpr int NV = NA + K + 4;  // A, b, cost, sum w, matches now, matches at start
  extern __shared__ float smem[];
  float* st = smem;               // (TC, m) target columns
  float* red = smem + TC * p.m;   // (warps, NV) partial sums
  __shared__ float sC[9], sr[3];
  __shared__ float s_conv, s_iters, s_ratio, s_cost, s_below, s_keep_w;
  __shared__ int s_it_final;

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int n = p.n, m = p.m;
  const bool valid = t < n;

  const float* tb = tgt + b * m * TC;
  for (int e = t; e < TC * m; e += blockDim.x) st[(e % TC) * m + e / TC] = tb[e];
  if (t < 9) sC[t] = C0[b * 9 + t];
  if (t < 3) sr[t] = r0[b * 3 + t];
  if (t == 0) {
    s_conv = 0.0f;
    s_iters = 0.0f;
    s_ratio = 0.0f;
    s_cost = 0.0f;
    s_it_final = 0;
  }
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, winit = 0.0f;
  if (valid) {
    sx = src[(b * n + t) * 3 + 0];
    sy = src[(b * n + t) * 3 + 1];
    sz = src[(b * n + t) * 3 + 2];
    winit = w0[b * n + t];
  }
  float wsave = 0.0f, wraw = 0.0f;
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
    if (s_conv != 0.0f) break;  // uniform: written before the last barrier
    float C[9], r[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) C[i] = sC[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = sr[i];
    const float cp[3] = {sx * C[0] + sy * C[1] + sz * C[2],
                         sx * C[3] + sy * C[4] + sz * C[5],
                         sx * C[6] + sy * C[7] + sz * C[8]};
    const float ps[3] = {cp[0] + r[0], cp[1] + r[1], cp[2] + r[2]};

    // hard 1-NN: index order, strict '<' -> the first index of the minimum
    float best = CUDART_INF_F;
    int arg = 0;
    for (int j = 0; j < m; ++j) {
      const float dx = ps[0] - st[j];
      float d = dx * dx;
      const float dy = ps[1] - st[m + j];
      d = d + dy * dy;
      const float dz = ps[2] - st[2 * m + j];
      d = d + dz * dz;
      if (d < best) {
        best = d;
        arg = j;
      }
    }
    float nn[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) nn[c] = st[c * m + arg];
    const float e[3] = {ps[0] - nn[0], ps[1] - nn[1], ps[2] - nn[2]};
    const float en2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2];
    const float trim = p.has_trim ? trim_w(en2, p.trim, p.diff, p.steep) : 1.0f;
    float res = 0.0f, le2 = en2;
    if constexpr (PT2PL) {
      res = e[0] * nn[3] + e[1] * nn[4] + e[2] * nn[5];
      le2 = res * res;
    }
    const float lw = loss_w(p.loss, le2, p.metric, p.diff, p.steep);
    const float w = valid ? winit * trim * lw : 0.0f;
    const float w_sqrt = sqrtf(w + 1.0e-10f) - 1.0e-5f;
    const float ws2 = w_sqrt * w_sqrt;

    float v[NV];
    if constexpr (PT2PL) {
      const float J6[6] = {nn[4] * cp[2] - nn[5] * cp[1], nn[5] * cp[0] - nn[3] * cp[2],
                           nn[3] * cp[1] - nn[4] * cp[0], -nn[3], -nn[4], -nn[5]};
      constexpr int o = K == 3 ? 2 : 0;
      int q = 0;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = i; j < K; ++j) v[q++] = ws2 * (J6[o + i] * J6[o + j]);
#pragma unroll
      for (int i = 0; i < K; ++i) v[NA + i] = ws2 * (J6[o + i] * res);
      v[NA + K] = ws2 * le2;
    } else {
      const float R6[3][6] = {{0.0f, -cp[2], cp[1], -1.0f, 0.0f, 0.0f},
                              {cp[2], 0.0f, -cp[0], 0.0f, -1.0f, 0.0f},
                              {-cp[1], cp[0], 0.0f, 0.0f, 0.0f, -1.0f}};
      constexpr int o = K == 3 ? 2 : 0;
      int q = 0;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = i; j < K; ++j)
          v[q++] = ws2 * (R6[0][o + i] * R6[0][o + j] + R6[1][o + i] * R6[1][o + j]
                          + R6[2][o + i] * R6[2][o + j]);
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[NA + i] = ws2 * (R6[0][o + i] * e[0] + R6[1][o + i] * e[1] + R6[2][o + i] * e[2]);
      v[NA + K] = ws2 * en2;
    }
    v[NA + K + 1] = w;
    v[NA + K + 2] = (valid && w > p.thresh) ? 1.0f : 0.0f;
    v[NA + K + 3] = (valid && winit > p.thresh) ? 1.0f : 0.0f;
    if (!valid) {
#pragma unroll
      for (int q = 0; q <= NA + K; ++q) v[q] = 0.0f;
    }

    float tot[NV];
    block_sum<NV>(v, red, tot);
    if (t == 0) {
      float A[K][K], bb[K];
      int q = 0;
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = i; j < K; ++j) {
          A[i][j] = tot[q];
          A[j][i] = tot[q];
          ++q;
        }
#pragma unroll
      for (int i = 0; i < K; ++i) bb[i] = tot[NA + i];
      const float cost = tot[NA + K], sum_w = tot[NA + K + 1];
      const float num_curr = tot[NA + K + 2];
      float num_start = tot[NA + K + 3];

      float lam;
      if (p.has_tik) {
        lam = p.tik;
      } else {
        float dmax = A[0][0];
#pragma unroll
        for (int i = 1; i < K; ++i) dmax = fmaxf(dmax, A[i][i]);
        lam = 1e-6f * fmaxf(dmax, 1.0f);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) A[i][i] = A[i][i] + lam;
      float delta[K];
      solve_spd<K>(A, bb, delta);
#pragma unroll
      for (int i = 0; i < K; ++i) delta[i] = -delta[i];
      float d6[6];
      if constexpr (K == 3) {
        d6[0] = 0.0f; d6[1] = 0.0f; d6[2] = delta[0];
        d6[3] = delta[1]; d6[4] = delta[2]; d6[5] = 0.0f;
      } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) d6[i] = delta[i];
      }
      float dn2 = delta[0] * delta[0];
#pragma unroll
      for (int i = 1; i < K; ++i) dn2 = dn2 + delta[i] * delta[i];
      const bool below = sqrtf(dn2) < p.tol;

      // retraction C <- exp(w^)^T C, r <- r - rho
      float dC[3][3];
      exp_so3(d6, dC);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          sC[3 * i + j] = dC[0][i] * C[j] + dC[1][i] * C[3 + j] + dC[2][i] * C[6 + j];
#pragma unroll
      for (int c = 0; c < 3; ++c) sr[c] = r[c] - d6[3 + c];

      // bookkeeping (registration._apply_step, histories off)
      s_keep_w = sum_w == 0.0f ? 0.0f : 1.0f;
      if (cost != 0.0f) s_cost = cost;
      const float itf = static_cast<float>(it + 1);
      if (below) s_iters = s_iters + itf * (s_iters == 0.0f ? 1.0f : 0.0f);
      if (num_start == 0.0f) num_start = 1.0f;
      const float ratio = num_curr / num_start;
      if (below) s_ratio = s_ratio + ratio * (s_ratio == 0.0f ? 1.0f : 0.0f);
      s_conv = fmaxf(s_conv, below ? 1.0f : 0.0f);
      s_below = below ? 1.0f : 0.0f;
      s_it_final = it + 1;
    }
    __syncthreads();
    wraw = w;
    if (s_keep_w != 0.0f) wsave = w;
    winit = winit * (s_below != 0.0f ? 0.0f : 1.0f);
  }

  // post-loop stats fill (registration._finalize)
  float cnt[2] = {(valid && wraw > p.thresh) ? 1.0f : 0.0f,
                  (valid && winit > p.thresh) ? 1.0f : 0.0f};
  float ctot[2];
  block_sum<2>(cnt, red, ctot);
  if (t == 0) {
    const float itf = static_cast<float>(s_it_final);
    const float ns = ctot[1] == 0.0f ? 1.0f : ctot[1];
#pragma unroll
    for (int i = 0; i < 9; ++i) C_out[b * 9 + i] = sC[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) r_out[b * 3 + i] = sr[i];
    conv_out[b] = s_conv;
    iters_out[b] = s_iters == 0.0f ? itf : s_iters;
    ratio_out[b] = s_ratio == 0.0f ? ctot[0] / ns : s_ratio;
    cost_out[b] = s_cost;
  }
  if (valid) wsave_out[b * n + t] = wsave;
}

template <int K, bool PT2PL>
cudaError_t launch(const float* src, const float* tgt, const float* w0, const float* C0,
                   const float* r0, float* C, float* r, float* conv, float* iters,
                   float* ratio, float* wsave, float* cost, int batch, int threads,
                   const Params& p, cudaStream_t stream) {
  constexpr int TC = PT2PL ? 6 : 3;
  constexpr int NV = K * (K + 1) / 2 + K + 4;
  const size_t smem = sizeof(float) * (static_cast<size_t>(TC) * p.m + (threads / 32) * NV);
  fused_gn_kernel<K, PT2PL><<<batch, threads, smem, stream>>>(
      src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave, cost, p);
  return cudaGetLastError();
}

}  // namespace

// src (batch, n, 3), tgt (batch, m, 6 if pt2pl else 3), w0 (batch, n),
// C0 (batch, 3, 3), r0 (batch, 3): contiguous f32.  Outputs, preallocated by
// the caller: C (batch, 3, 3), r (batch, 3), conv/iters/ratio/cost (batch,)
// and wsave (batch, n), f32.  1 <= n <= 256, 1 <= m <= 512.  loss: 0 none,
// 1 huber, 2 cauchy, 3 welsch, 4 gm, 5 trim.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int fused_gn_launch(const float* src, const float* tgt, const float* w0,
                               const float* C0, const float* r0, float* C, float* r,
                               float* conv, float* iters, float* ratio, float* wsave,
                               float* cost, int batch, int n, int m, int pt2pl, int dim,
                               int loss, int diff, int has_trim, int has_tik, float trim,
                               float metric, float steep, float tol, float thresh,
                               float tik, int max_iters, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || n == 0) return 0;
  const int threads = 32 * ((n + 31) / 32);
  if (threads > kMaxThreads || m < 1 || m > 512)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{n, m, loss, diff, has_trim, has_tik, max_iters,
                 trim, metric, steep, tol, thresh, tik};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 2) {
    err = pt2pl ? launch<3, true>(src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave,
                                  cost, batch, threads, p, s)
                : launch<3, false>(src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave,
                                   cost, batch, threads, p, s);
  } else {
    err = pt2pl ? launch<6, true>(src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave,
                                  cost, batch, threads, p, s)
                : launch<6, false>(src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave,
                                   cost, batch, threads, p, s);
  }
  return static_cast<int>(err);
}
