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
// points take ~1e8 flops and under 1 MB) and it is a serial chain: the time
// is the iterations (~7 for the reference pair) times the per-iteration
// critical path, for ceil(B/132) waves of blocks, plus the launch.  The
// design keeps everything of an element on one SM for the whole solve: the
// inputs are read from device memory once and only the results are written
// back; there is no launch per iteration and no host sync.
//
// Design: one block per batch element; each source point gets L lanes (L a
// power of two, at most kMaxLanes, chosen at launch so that the block stays
// within kMaxThreads and no lane is left without targets: L = 2 at the
// reference pair's 65 points, 160 threads; L = 1 at 256 points).  The
// target's columns (3 for pt2pt, 6 for pt2pl, m <= 512) are staged once in
// shared memory as SoA, each padded to a multiple of 4 with +inf
// coordinates.  Per iteration:
//   1. every lane transforms its point and walks its share of the targets,
//      4 at a time (chunks part, part + L, ...: three 16-byte loads per 4
//      targets), keeps the first chunk whose minimum is below its running
//      best (fminf within the chunk, a strict '<' across chunks: 1.5
//      instructions per target for the argmin instead of 3) and walks that
//      chunk again for the first index of the minimum; the L partial
//      (d2, index) pairs are merged by the lexicographic minimum, so the
//      first index of the minimum wins as in one walk (a padded target's d2
//      is inf or NaN and is never taken);
//   2. the point's residual, weights and normal-equation terms (21 of A and
//      6 of b for k = 6, 6 and 3 for k = 3, the cost, the weight sum and the
//      two match counts) are summed over the warp's points by a fixed
//      shuffle tree and written per warp into shared memory;
//   3. a barrier; warp 0 then adds term q over the warps in warp order on
//      lane q (in parallel over q; the parent's thread 0 added them alone),
//      broadcasts the totals with shuffles, and runs the solve, the
//      Rodrigues retraction and the bookkeeping, with the solve's divisions
//      and square roots spread over its lanes: lane j computes output j with
//      that output's own expression (the same bits) and the warp exchanges
//      them with shuffles, so the warp issues one division where a lone
//      thread issues nine;
//   4. thread 0 writes C, r and the flags to shared memory, a second
//      barrier, and every thread reads them.
// Running the solve in every warp instead (the same bits in every warp, and
// one barrier per iteration) was slower at every lane count: its issue
// slots cost more than the barrier it saves (PERF.md, PR 6).
// No atomics: a launch repeats bit for bit.  Thread 0 writes the results.
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

constexpr int kMaxThreads = 256;  // threads per block
constexpr int kMaxLanes = 4;      // lanes per source point
constexpr int kMaxN = 256;
constexpr int kMaxM = 512;

struct Params {
  int n, m, mp, lanes, loss, diff, has_trim, has_tik, max_iters;
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
//
// Warp 0 runs it.  Its divisions and square roots, the longest instructions
// of the chain, are spread over the lanes: lane j computes output j with the
// output's own expression (the same bits) and the warp exchanges the results
// with shuffles.

// v[j] of lane j (j < N; other lanes keep v[0]), by selects: no dynamic
// register indexing
template <int N>
__device__ __forceinline__ float lane_pick(const float (&v)[N]) {
  const int lane = threadIdx.x & 31;
  float x = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) x = lane == j ? v[j] : x;
  return x;
}

template <int N>
__device__ __forceinline__ void lane_gather(float x, float (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = __shfl_sync(0xffffffffu, x, j);
}

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
  const float adj[9] = {c00, c10, c20, c01, c11, c21, c02, c12, c22};
  float q[9];
  lane_gather<9>(lane_pick<9>(adj) / det, q);  // out[i][j] = adj[i][j] / det
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[i][j] = q[3 * i + j];
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
  float diag[K], dinv[K], a_eq[K][K], b_eq[K], y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) diag[i] = a[i][i];
  lane_gather<K>(1.0f / sqrtf(fmaxf(lane_pick<K>(diag), 1e-30f)), dinv);
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

// Sum each v[q] over the lanes 0, L, 2L, ... of the warp (the points'
// first lanes; the others hold zeros) by a fixed shuffle tree; lane 0 gets
// the warp's sums and stores them at out[q].
template <int NV>
__device__ __forceinline__ void warp_sums(float (&v)[NV], int lanes, float* out) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    float x = v[q];
    for (int off = 16; off >= lanes; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0) out[q] = x;
  }
}

// After the barrier: lane q (< NV) adds term q over the warps in warp order,
// and every lane receives all NV totals, the same bits in every warp.
template <int NV>
__device__ __forceinline__ void block_totals(const float* red, int nwarps, float (&tot)[NV]) {
  const int lane = threadIdx.x & 31;
  float x = 0.0f;
  if (lane < NV) {
    x = red[lane];
    for (int wi = 1; wi < nwarps; ++wi) x += red[wi * NV + lane];
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) tot[q] = __shfl_sync(0xffffffffu, x, q);
}

// d2 of the point ps to the targets 4 ch .. 4 ch + 3 of the (3, 4 chunks)
// SoA, in the difference form ((dx^2 + dy^2) + dz^2)
__device__ __forceinline__ void dist4(const float4* st4, int chunks, int ch, const float (&ps)[3],
                                      float (&d)[4]) {
  const float4 X = st4[ch];
  const float4 Y = st4[chunks + ch];
  const float4 Z = st4[2 * chunks + ch];
  const float tx[4] = {X.x, X.y, X.z, X.w};
  const float ty[4] = {Y.x, Y.y, Y.z, Y.w};
  const float tz[4] = {Z.x, Z.y, Z.z, Z.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float dx = ps[0] - tx[u];
    float e = dx * dx;
    const float dy = ps[1] - ty[u];
    e = e + dy * dy;
    const float dz = ps[2] - tz[u];
    d[u] = e + dz * dz;
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
  extern __shared__ __align__(16) float smem[];
  const int n = p.n, m = p.m, mp = p.mp, L = p.lanes;
  const int nwarps = blockDim.x >> 5;
  float* st = smem;                          // (TC, mp) target columns
  float* red = smem + TC * mp;               // (warps, NV) partial sums
  float* red_post = red + nwarps * NV;       // (warps, 2) for the post-loop counts
  float* state = red_post + 2 * nwarps;      // C, r, conv, below, sum_w from warp 0

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int part = t & (L - 1);
  const int pt = t / L;
  const bool valid = pt < n;
  const bool owner = valid && part == 0;  // the lane that adds the point's terms

  const float* tb = tgt + b * m * TC;
  for (int e = t; e < TC * m; e += blockDim.x) st[(e % TC) * mp + e / TC] = tb[e];
  for (int e = t; e < TC * (mp - m); e += blockDim.x) {
    const int c = e / (mp - m);
    st[c * mp + m + e % (mp - m)] = c < 3 ? CUDART_INF_F : 0.0f;
  }
  float C[9], r[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) C[i] = C0[b * 9 + i];
#pragma unroll
  for (int i = 0; i < 3; ++i) r[i] = r0[b * 3 + i];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, winit = 0.0f;
  if (valid) {
    sx = src[(b * n + pt) * 3 + 0];
    sy = src[(b * n + pt) * 3 + 1];
    sz = src[(b * n + pt) * 3 + 2];
    winit = w0[b * n + pt];
  }
  float wsave = 0.0f, wraw = 0.0f;
  float s_conv = 0.0f, s_iters = 0.0f, s_ratio = 0.0f, s_cost = 0.0f;
  int it_final = 0;
  const float4* st4 = reinterpret_cast<const float4*>(st);
  const int chunks = mp >> 2;
  __syncthreads();

  for (int it = 0; it < p.max_iters; ++it) {
    const float cp[3] = {sx * C[0] + sy * C[1] + sz * C[2],
                         sx * C[3] + sy * C[4] + sz * C[5],
                         sx * C[6] + sy * C[7] + sz * C[8]};
    const float ps[3] = {cp[0] + r[0], cp[1] + r[1], cp[2] + r[2]};

    // hard 1-NN: this lane's chunks of 4 targets in index order, the minimum
    // of each chunk (fminf skips a NaN as '<' does) against the running best
    // with a strict '<', so the first chunk that attains the lane's minimum
    // is kept; that chunk again for the first index whose d2 equals it (the
    // same expression, the same bits); then the lexicographic minimum of
    // (d2, index) over the point's L lanes
    float best = CUDART_INF_F;
    int from = -1;
    for (int ch = part; ch < chunks; ch += L) {
      float d[4];
      dist4(st4, chunks, ch, ps, d);
      const float cmin = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
      if (cmin < best) {
        best = cmin;
        from = ch;
      }
    }
    int arg = 0;
    if (from >= 0) {
      float d[4];
      dist4(st4, chunks, from, ps, d);
      arg = d[2] == best ? 4 * from + 2 : 4 * from + 3;
      arg = d[1] == best ? 4 * from + 1 : arg;
      arg = d[0] == best ? 4 * from : arg;
    }
    for (int off = 1; off < L; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
      if (ob < best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    float nn[TC];
#pragma unroll
    for (int c = 0; c < TC; ++c) nn[c] = st[c * mp + arg];
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
    v[NA + K + 2] = w > p.thresh ? 1.0f : 0.0f;
    v[NA + K + 3] = winit > p.thresh ? 1.0f : 0.0f;
    if (!owner) {
#pragma unroll
      for (int q = 0; q < NV; ++q) v[q] = 0.0f;
    }

    warp_sums<NV>(v, L, red + warp * NV);
    __syncthreads();
    // ---- warp 0 solves on the block's totals; its lanes hold the same values
    if (warp == 0) {
      float tot[NV];
      block_totals<NV>(red, nwarps, tot);
      float A[K][K], bb[K];
      {
        int q = 0;
#pragma unroll
        for (int i = 0; i < K; ++i)
#pragma unroll
          for (int j = i; j < K; ++j) {
            A[i][j] = tot[q];
            A[j][i] = tot[q];
            ++q;
          }
      }
#pragma unroll
      for (int i = 0; i < K; ++i) bb[i] = tot[NA + i];
      const float cost = tot[NA + K];
      const float sum_w = tot[NA + K + 1];
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
      float dC[3][3], Cn[9];
      exp_so3(d6, dC);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          Cn[3 * i + j] = dC[0][i] * C[j] + dC[1][i] * C[3 + j] + dC[2][i] * C[6 + j];
#pragma unroll
      for (int i = 0; i < 9; ++i) C[i] = Cn[i];
#pragma unroll
      for (int c = 0; c < 3; ++c) r[c] = r[c] - d6[3 + c];

      // bookkeeping (registration._apply_step, histories off)
      if (cost != 0.0f) s_cost = cost;
      const float itf = static_cast<float>(it + 1);
      if (below) s_iters = s_iters + itf * (s_iters == 0.0f ? 1.0f : 0.0f);
      if (num_start == 0.0f) num_start = 1.0f;
      const float ratio = num_curr / num_start;
      if (below) s_ratio = s_ratio + ratio * (s_ratio == 0.0f ? 1.0f : 0.0f);
      s_conv = fmaxf(s_conv, below ? 1.0f : 0.0f);
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 9; ++i) state[i] = C[i];
#pragma unroll
        for (int i = 0; i < 3; ++i) state[9 + i] = r[i];
        state[12] = s_conv;
        state[13] = below ? 1.0f : 0.0f;
        state[14] = sum_w;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 9; ++i) C[i] = state[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = state[9 + i];
    s_conv = state[12];
    const bool below = state[13] != 0.0f;
    const float sum_w = state[14];
    it_final = it + 1;
    wraw = w;
    if (sum_w != 0.0f) wsave = w;
    winit = winit * (below ? 0.0f : 1.0f);
    if (s_conv != 0.0f) break;  // read by every thread from the same word
  }

  // post-loop stats fill (registration._finalize)
  float cnt[2] = {(owner && wraw > p.thresh) ? 1.0f : 0.0f,
                  (owner && winit > p.thresh) ? 1.0f : 0.0f};
  warp_sums<2>(cnt, L, red_post + warp * 2);
  __syncthreads();
  float ctot[2];
  block_totals<2>(red_post, nwarps, ctot);
  if (t == 0) {
    const float itf = static_cast<float>(it_final);
    const float ns = ctot[1] == 0.0f ? 1.0f : ctot[1];
#pragma unroll
    for (int i = 0; i < 9; ++i) C_out[b * 9 + i] = C[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) r_out[b * 3 + i] = r[i];
    conv_out[b] = s_conv;
    iters_out[b] = s_iters == 0.0f ? itf : s_iters;
    ratio_out[b] = s_ratio == 0.0f ? ctot[0] / ns : s_ratio;
    cost_out[b] = s_cost;
  }
  if (owner) wsave_out[b * n + pt] = wsave;
}

template <int K, bool PT2PL>
cudaError_t launch(const float* src, const float* tgt, const float* w0, const float* C0,
                   const float* r0, float* C, float* r, float* conv, float* iters,
                   float* ratio, float* wsave, float* cost, int batch, int threads,
                   const Params& p, cudaStream_t stream) {
  constexpr int TC = PT2PL ? 6 : 3;
  constexpr int NV = K * (K + 1) / 2 + K + 4;
  const int nwarps = threads / 32;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(TC) * p.mp + nwarps * NV + 2 * nwarps + 16);
  fused_gn_kernel<K, PT2PL><<<batch, threads, smem, stream>>>(
      src, tgt, w0, C0, r0, C, r, conv, iters, ratio, wsave, cost, p);
  return cudaGetLastError();
}

// Lanes per point: the most, up to kMaxLanes, with the block within
// kMaxThreads and every lane given at least one chunk of 4 targets.
int lanes_for(int n, int m) {
  const int chunks = (m + 3) / 4;
  int lanes = kMaxLanes;
  while (lanes > 1 && (32 * ((n * lanes + 31) / 32) > kMaxThreads || lanes > chunks)) {
    lanes >>= 1;
  }
  return lanes;
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
  if (n < 0 || n > kMaxN || m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = lanes_for(n, m);
  const int threads = 32 * ((n * lanes + 31) / 32);
  const Params p{n, m, 4 * ((m + 3) / 4), lanes, loss, diff, has_trim, has_tik, max_iters,
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
