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
// result is the first k entries of the candidates sorted by (d2, column),
// column = j * g + offset in the block's probe-major candidate list.  Once
// every finite distance is taken the passes return column 0 (the lowest
// column of an all-inf row) again and again.
//
// Here that order is one 64-bit key per candidate, (bits of d2) << 32 |
// column: d2 >= 0, so its bits order like the floats, and a NaN or inf d2
// sorts after (inf, 0).  The output is the k smallest keys, whatever order
// they are visited in; a list of keys initialised to (inf, column 0) yields
// the column-0 fill, and no inf or NaN candidate can enter it.  The d2 sums
// are in the Pallas order, built with --fmad=false, so d2, rows and bound are
// bit for bit those of fused_topk_plain (ops/cluster_search.py).
//
// Schedule.  Grid (nb, B), one block of kWarps = 16 warps per query block.
//   1. The block's P selected group slabs are copied once into shared memory
//      with cp.async, as K2 stages them (16-byte requests when g % 4 == 0 and
//      the points are 16-byte aligned, 4-byte ones otherwise).  When the P
//      slabs exceed kMaxSlabBytes the warps read the groups from global
//      memory instead (through L1): every query's list lives in one warp's
//      registers for the whole scan, so the slabs are not staged in passes.
//   2. While the copies fly, the certification bound, as K2 computes it:
//      kLaneQ queries per lane, warp-uniform groups split over S slices,
//      fmaxf per group, fminf over groups and slices, squared once.
//   3. Each warp computes the bounding box (fminf/fmaxf, so a NaN coordinate
//      is left out) of some of the first kMaxBoxes selected groups.
//   4. Each warp takes the block's queries in turn, one at a time: warp w
//      queries w, w + kWarps, ...  For each chunk of 32 selected groups a
//      lane computes its group's lower bound lb, the f32 distance from the
//      query to the group's box in the d2 order: for every point of the box
//      the kernel's d2 is >= lb, because rounding is monotone.  The chunk is
//      sorted by lb (a bitonic network of 32-bit keys (lb bits with the low
//      5 cleared) | lane) and its groups are visited nearest first.  A group
//      with lb > the k-th d2 is skipped, and once the truncated lb of the
//      next group exceeds it, so is the rest of the chunk: none of their
//      candidates could enter the list.  In a visited group lane l takes
//      offsets l, l + 32, ... (a step of 32 columns per warp), computes d2
//      from the staged slab and tests (d2, column) < the list's k-th key:
//      lexicographically, since the lanes and the nearest-first order reach
//      the columns out of order.  A passing key goes to the lane's queue of
//      one key.
//   5. The warp's list is K = next power of two >= k keys, sorted ascending,
//      held once in every segment of K lanes (one key per lane).  When a
//      lane's queue is full (__any_sync after each step), and after the last
//      group, the queues are flushed.  At most kInsertMax queued keys go in
//      one by one (a ballot and popc give the key's rank, the entries above
//      it move up a lane); more are sorted in segments of K lanes by a
//      bitonic network of __shfl_xor_sync compare-exchanges, halved to the K
//      smallest by merging segments with their mirror image (lane ^ (h |
//      (K - 1)), both partners keep the minimum), merged with the list the
//      same way (lane ^ (K - 1)) and sorted by a bitonic merge.  The new k-th key is then broadcast from
//      lane k - 1.  Lanes 0 .. k - 1 write the list out.
//   6. The first group visited would pass every key while the list is empty,
//      so its first kFirst steps are taken at once: the list starts as the K
//      smallest of the lanes' minima (clamped to (inf, 0)), whose k-th is an
//      upper bound of the group's, and only the lanes' other keys below it
//      go through the queues.
//
// The geometry was chosen on the H100 at the cluster tier's blocks (Qs =
// 128, P = 32, g = 128, k = 1 to 32) by timing edited copies of this file
// against it: 16 warps beat 8 at every k (more warps in flight hide the
// networks' shuffle latency), a queue of one key beat two and four (a
// fresher k-th key), inserting up to 8 keys one by one beat merging every
// flush by the network at k >= 16 (which won by less at k <= 2) and beat
// up to 16, and was level with up to 4; step 6 was faster at every k.  __launch_bounds__ asks for two blocks per SM:
// without it ptxas held every instance at 40 registers and some spilled.
//
// What bounds it: K2's f32 issue (13 operations and an IEEE sqrt per
// (query, non-selected group) for the bound, 9 per (query, candidate)), but
// only for the candidates of the groups whose box lies within the query's
// k-th d2: any exact selection must search those, and no others.  At the
// cluster tier's sizes that is a few of the P groups per query, so the bound
// and the merges (about 20 network stages of 2 shuffles, a 64-bit compare,
// a predicate and 2 selects each, or about 15 instructions per inserted key)
// take most of the issue slots.  Registers hold one list key, the threshold
// and the queue per lane: no spills at any K.
//
// A group id outside [0, G) stops the kernel with __trap() before anything
// is read from that group: the launch's stream then reports a CUDA error at
// its next synchronisation, and the wrapper needs no host-side check.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using Key = unsigned long long;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;                      // warps per block
constexpr int kFirst = 4;                       // steps of the first group at once
constexpr int kInsertMax = 8;                   // a flush of at most this many keys
                                                // inserts them key by key
constexpr int kLaneQ = 4;                       // bound: queries per lane
constexpr int kGroupQ = 32 * kLaneQ;            // bound: queries per warp (128)
constexpr int kMaxQs = 256;                     // queries per block
constexpr int kMaxSlabBytes = 64 * 1024;        // staged slabs at most
constexpr int kMaxBoxes = 1024;                 // groups with a bounding box
constexpr int kMaxGroups = 1 << 20;
constexpr float kShrink = 1.0f - 8.0f * 1.1920928955078125e-07f;  // 1 - 8 eps
constexpr Key kFill = static_cast<Key>(0x7f800000u) << 32;       // (inf, column 0)
constexpr Key kEmpty = ~static_cast<Key>(0);                      // an empty queue

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

// Copy the slabs of the P selected groups into slab[j g 3 ..].
__device__ void stage(float* slab, const float* __restrict__ pts,
                      const int32_t* __restrict__ sel, int P, int g, int G, bool vec16) {
  if (vec16) {
    const int per = 3 * g / 4;  // 16-byte requests per slab
    for (int e = threadIdx.x; e < P * per; e += blockDim.x) {
      const int j = e / per;
      const int32_t grp = checked_group(sel, j, G);
      cp_async16(slab + 4 * e, pts + static_cast<int64_t>(grp) * g * 3 + 4 * (e - j * per));
    }
  } else {
    const int per = 3 * g;
    for (int e = threadIdx.x; e < P * per; e += blockDim.x) {
      const int j = e / per;
      const int32_t grp = checked_group(sel, j, G);
      cp_async4(slab + e, pts + static_cast<int64_t>(grp) * g * 3 + (e - j * per));
    }
  }
  cp_async_commit();
}

// The (g, 3) points of selected group j: staged, or in global memory.
template <bool kStaged>
__device__ __forceinline__ const float* group_points(const float* slab, const float* pts,
                                                     const int32_t* sel, int j, int g, int G) {
  if (kStaged) return slab + static_cast<int64_t>(j) * g * 3;
  return pts + static_cast<int64_t>(checked_group(sel, j, G)) * g * 3;
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

// The f32 distance from q to the box [lo, hi] in dist2's order: <= dist2(q, p)
// for every p in the box.
__device__ __forceinline__ float box_lb(float qx, float qy, float qz, const float* b) {
  const float ex = qx < b[0] ? qx - b[0] : (qx > b[3] ? qx - b[3] : 0.0f);
  const float ey = qy < b[1] ? qy - b[1] : (qy > b[4] ? qy - b[4] : 0.0f);
  const float ez = qz < b[2] ? qz - b[2] : (qz > b[5] ? qz - b[5] : 0.0f);
  float d = ex * ex;
  d = d + ey * ey;
  d = d + ez * ez;
  return d;
}

// Compare-exchange with lane ^ m: keep the smaller key if `lower`, else the larger.
template <typename T>
__device__ __forceinline__ T exchange(T v, int m, bool lower) {
  const T o = __shfl_xor_sync(kFull, v, m);
  return lower == (o < v) ? o : v;
}

// A bitonic sequence in each segment of S lanes, sorted ascending.
template <int S, typename T>
__device__ __forceinline__ T merge_up(T v, int lane) {
#pragma unroll
  for (int m = S / 2; m > 0; m /= 2) v = exchange(v, m, (lane & m) == 0);
  return v;
}

// Each segment of S lanes sorted ascending.
template <int S, typename T>
__device__ __forceinline__ T sort_segments(T v, int lane) {
#pragma unroll
  for (int size = 2; size <= S; size *= 2) {
    const bool up = size == S || (lane & size) == 0;
#pragma unroll
    for (int m = size / 2; m > 0; m /= 2) v = exchange(v, m, ((lane & m) == 0) == up);
  }
  return v;
}

// The K smallest of the warp's 32 keys, sorted ascending, in every segment of
// K lanes: sort the segments, then merge each with its mirror image in the
// segment h lanes away (both keep the minima: the K smallest of the two, a
// bitonic sequence) and sort it again.
template <int K>
__device__ __forceinline__ Key lowest(Key v, int lane) {
  v = sort_segments<K>(v, lane);
#pragma unroll
  for (int h = K; h < 32; h *= 2) {
    const Key o = __shfl_xor_sync(kFull, v, h | (K - 1));
    v = o < v ? o : v;
    v = merge_up<K>(v, lane);
  }
  return v;
}

// The list (sorted, in every segment of K lanes) := the K smallest of the
// list and the warp's 32 keys v.
template <int K>
__device__ __forceinline__ Key merge_into(Key list, Key v, int lane) {
  v = lowest<K>(v, lane);
  if (K > 1) v = __shfl_xor_sync(kFull, v, K - 1);  // mirrored
  list = v < list ? v : list;
  return merge_up<K>(list, lane);
}

// The key of candidate offset o of a group whose column 0 is col0.
__device__ __forceinline__ Key candidate(float qx, float qy, float qz, const float* src, int o,
                                         int col0) {
  const float d = dist2(qx, qy, qz, src[3 * o], src[3 * o + 1], src[3 * o + 2]);
  return (static_cast<Key>(__float_as_uint(d)) << 32) | static_cast<unsigned>(col0 + o);
}

// A key below the list's k-th into the lane's queue of one.
__device__ __forceinline__ void push(Key key, Key thr, Key& queue, bool& queued) {
  if (key < thr) {
    queue = key;
    queued = true;
  }
}

// One key into the list (sorted, in every segment of K lanes): the entries
// above it move up a lane.
template <int K>
__device__ __forceinline__ Key insert(Key list, Key key, int lane) {
  const unsigned below = __ballot_sync(kFull, list < key) & (kFull >> (32 - K));
  const int pos = __popc(below);
  const Key up = __shfl_up_sync(kFull, list, 1, K);
  const int i = lane & (K - 1);
  return i < pos ? list : (i == pos ? key : up);
}

// Merge the lanes' queues into the list (a few keys one by one, more by a
// network), and broadcast the new k-th key.
template <int K>
__device__ __forceinline__ void flush(Key& list, Key& thr, Key queue, bool& queued, int lane,
                                      int k) {
  unsigned has = __ballot_sync(kFull, queued);
  if (__popc(has) > kInsertMax) {
    list = merge_into<K>(list, queued ? queue : kEmpty, lane);
  } else {
    while (has) {
      const int src = __ffs(has) - 1;
      has &= has - 1;
      list = insert<K>(list, __shfl_sync(kFull, queue, src), lane);
    }
  }
  queued = false;
  thr = __shfl_sync(kFull, list, k - 1);
}

template <int K, bool kStaged>
__global__ void __launch_bounds__(32 * kWarps, 2) cluster_topk_kernel(
    const float* __restrict__ points, const float* __restrict__ centers,
    const float* __restrict__ radius, const float* __restrict__ xb,
    const int32_t* __restrict__ bsel, int G, int g, int nb, int Qs, int P, int k, int S,
    int slab_floats, int nbox, int vec16, float* __restrict__ d2_out,
    int32_t* __restrict__ row_out, float* __restrict__ bound_out) {
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;
  float* box = smem + slab_floats;           // 6 per group: lo xyz, hi xyz
  float* part = box + 6 * nbox;              // the bound's partial minima
  unsigned* selected = reinterpret_cast<unsigned*>(part + kWarps * kGroupQ);

  const int64_t blk = static_cast<int64_t>(blockIdx.y) * nb + blockIdx.x;
  const int32_t* sel = bsel + blk * P;
  const float* pts = points + static_cast<int64_t>(blockIdx.y) * G * g * 3;
  const float* xq = xb + blk * Qs * 3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (kStaged) stage(slab, pts, sel, P, g, G, vec16 != 0);

  // ---- certification bound (K2's), while the slabs are in flight
  {
    const int words = (G + 31) / 32;
    for (int w = threadIdx.x; w < words; w += blockDim.x) selected[w] = 0u;
    __syncthreads();
    for (int j = threadIdx.x; j < P; j += blockDim.x) {
      const int32_t grp = checked_group(sel, j, G);
      atomicOr(&selected[grp >> 5], 1u << (grp & 31));
    }
    __syncthreads();
    const int qg = warp / S;
    const int s = warp - qg * S;
    float qx[kLaneQ], qy[kLaneQ], qz[kLaneQ], amin[kLaneQ];
#pragma unroll
    for (int i = 0; i < kLaneQ; ++i) {
      const int q = qg * kGroupQ + 32 * i + lane;
      const bool valid = q < Qs;
      qx[i] = valid ? xq[3 * q + 0] : 0.0f;
      qy[i] = valid ? xq[3 * q + 1] : 0.0f;
      qz[i] = valid ? xq[3 * q + 2] : 0.0f;
      amin[i] = CUDART_INF_F;
    }
    const float* cen = centers + static_cast<int64_t>(blockIdx.y) * G * 3;
    const float* rad = radius + static_cast<int64_t>(blockIdx.y) * G;
    for (int gi = s; gi < G; gi += S) {  // warp-uniform
      if (selected[gi >> 5] & (1u << (gi & 31))) continue;
      const float cx = __ldg(cen + 3 * gi);
      const float cy = __ldg(cen + 3 * gi + 1);
      const float cz = __ldg(cen + 3 * gi + 2);
      const float r = __ldg(rad + gi);
#pragma unroll
      for (int i = 0; i < kLaneQ; ++i) {
        const float dc2 = dist2(qx[i], qy[i], qz[i], cx, cy, cz);
        // the clamp per group: a NaN center or radius gives 0
        amin[i] = fminf(amin[i], fmaxf(sqrtf(dc2) * kShrink - r, 0.0f));
      }
    }
#pragma unroll
    for (int i = 0; i < kLaneQ; ++i) part[warp * kGroupQ + 32 * i + lane] = amin[i];
  }
  if (kStaged) cp_async_wait_all();
  __syncthreads();  // the slabs and the partial minima are visible

  // ---- bounding boxes of the first nbox selected groups
  for (int j = warp; j < nbox; j += kWarps) {
    const float* src = group_points<kStaged>(slab, pts, sel, j, g, G);
    float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
    float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
    for (int o = lane; o < g; o += 32) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], src[3 * o + c]);
        hi[c] = fmaxf(hi[c], src[3 * o + c]);
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m /= 2) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(kFull, lo[c], m));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(kFull, hi[c], m));
      }
    }
    if (lane < 3) {
      box[6 * j + lane] = lane == 0 ? lo[0] : (lane == 1 ? lo[1] : lo[2]);
      box[6 * j + 3 + lane] = lane == 0 ? hi[0] : (lane == 1 ? hi[1] : hi[2]);
    }
  }
  // the bound, merged over the slices
  for (int q = threadIdx.x; q < Qs; q += blockDim.x) {
    const int g0 = q / kGroupQ;
    int e = g0 * S * kGroupQ + q - g0 * kGroupQ;
    float a = part[e];
    for (int t = 1; t < S; ++t) a = fminf(a, part[e += kGroupQ]);
    bound_out[blk * Qs + q] = a * a;
  }
  __syncthreads();  // the boxes are visible

  // ---- the search: one query per warp at a time
  for (int q = warp; q < Qs; q += kWarps) {
    const float qx = xq[3 * q + 0];
    const float qy = xq[3 * q + 1];
    const float qz = xq[3 * q + 2];
    Key list = kFill;  // sorted, in every segment of K lanes
    Key thr = kFill;   // the list's k-th key
    Key queue = kEmpty;
    bool queued = false;
    bool fresh = true;  // no key listed yet

    for (int c0 = 0; c0 < P; c0 += 32) {
      const int j = c0 + lane;
      float lb = CUDART_INF_F;
      if (j < P) lb = j < nbox ? box_lb(qx, qy, qz, box + 6 * j) : 0.0f;
      unsigned order = j < P ? (__float_as_uint(lb) & ~31u) | lane : ~0u;
      order = sort_segments<32>(order, lane);  // nearest box first
      const int n = min(32, P - c0);
      for (int i = 0; i < n; ++i) {
        const unsigned gk = __shfl_sync(kFull, order, i);
        const float dk = __uint_as_float(static_cast<unsigned>(thr >> 32));
        if (__uint_as_float(gk & ~31u) > dk) break;  // the rest of the chunk too
        const int jl = gk & 31;
        if (__shfl_sync(kFull, lb, jl) > dk) continue;
        const int jj = c0 + jl;
        const float* src = group_points<kStaged>(slab, pts, sel, jj, g, G);
        int o0 = 0;
        if (fresh) {
          // the first group's first kFirst steps at once: the list starts as
          // the K smallest of the lanes' minima (a key >= (inf, 0) kept out),
          // then the lanes' other keys go through the filter
          fresh = false;
          Key key[kFirst];
          Key least = kEmpty;
#pragma unroll
          for (int u = 0; u < kFirst; ++u) {
            const int o = 32 * u + lane;
            key[u] = o < g ? candidate(qx, qy, qz, src, o, jj * g) : kEmpty;
            least = key[u] < least ? key[u] : least;
          }
          list = lowest<K>(least, lane);
          list = list < kFill ? list : kFill;
          thr = __shfl_sync(kFull, list, k - 1);
#pragma unroll
          for (int u = 0; u < kFirst; ++u) {
            if (key[u] != least) push(key[u], thr, queue, queued);
            if (__any_sync(kFull, queued)) flush<K>(list, thr, queue, queued, lane, k);
          }
          o0 = 32 * kFirst;
        }
        for (; o0 < g; o0 += 32) {
          const int o = o0 + lane;
          if (o < g) push(candidate(qx, qy, qz, src, o, jj * g), thr, queue, queued);
          if (__any_sync(kFull, queued)) flush<K>(list, thr, queue, queued, lane, k);
        }
      }
    }
    if (__any_sync(kFull, queued)) flush<K>(list, thr, queue, queued, lane, k);

    if (lane < k) {
      const int64_t out = (blk * Qs + q) * k + lane;
      const int col = static_cast<int>(list & 0xffffffffu);
      const int j = col / g;
      d2_out[out] = __uint_as_float(static_cast<unsigned>(list >> 32));
      row_out[out] = __ldg(sel + j) * g + (col - j * g);
    }
  }
}

template <int K>
int launch(const float* points, const float* centers, const float* radius,
           const float* xb, const int32_t* bsel, int batch, int G, int g, int nb,
           int Qs, int P, int k, float* d2, int32_t* rows, float* bound,
           cudaStream_t stream) {
  const int QG = (Qs + kGroupQ - 1) / kGroupQ;
  const int S = kWarps / QG;  // the bound's slices
  const bool staged = static_cast<int64_t>(P) * g * 12 <= kMaxSlabBytes;
  const bool vec16 = g % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const int slab_floats = staged ? (P * g * 3 + 3) & ~3 : 0;
  const int nbox = min(P, kMaxBoxes);
  // at most 64 KB of slabs, 24 KB of boxes, 4 KB of partials and a 128 KB
  // bitmap: within the 227 KB a block may use
  const size_t bytes = (slab_floats + 6 * nbox + kWarps * kGroupQ) * sizeof(float) +
                       ((G + 31) / 32) * sizeof(unsigned);
  const dim3 grid(nb, batch);
  auto kernel = staged ? cluster_topk_kernel<K, true> : cluster_topk_kernel<K, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * kWarps, bytes, stream>>>(points, centers, radius, xb, bsel, G, g, nb,
                                               Qs, P, k, S, slab_floats, nbox, vec16, d2,
                                               rows, bound);
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
