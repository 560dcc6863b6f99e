// The upmap balancer's candidate scorer for Hopper (sm_90a).
//
// Replaces the XLA program ceph_tpu/mgr/placement.py::_score_kernel
// (:107, jitted; no Pallas source). The wrapper is
// ceph_tpu_torch/mgr/placement.py::score_candidates; its plain torch
// version, score_candidates_plain, computes the same function on any
// device and is what the CPU tests hold against the twin.
//
// The function. A candidate row r moves one shard of a PG off the
// overfull device src[r]; members[r] holds the PG's raw and effective
// sets (2S slots, CRUSH_ITEM_NONE padding). For every target dsts[u],
// u < U:
//   illegal  = some slot j has members[r][j] == dsts[u]          (member)
//           or some valid slot j has dom[members[r][j]] == dom[dsts[u]]
//              (valid: not NONE and not src[r]; an invalid slot's
//               domain is the sentinel -(2^31)+1, which no real domain
//               id holds; members are clipped to [0, n_osds) first)
//   gain     = (dev[src[r]] - dev[dsts[u]]) - 1.0f, in float32
//   score    = -inf if illegal or gain <= 0, else gain
// and the row's output is the top `topk` <= 8 (u, score) pairs in
// lax.top_k's order: score descending, ties to the lower u, -inf slots
// filled in ascending u.
//
// Bound. The function reads N*2S + N member and source words and the
// small dsts/dev/dom tables, and writes N*topk (index, score) pairs:
// 6.3 + 1.0 MB in and 16.8 MB out at the balancer's 10k-OSD shape (N =
// 262,144, 2S = 6, U = 512, topk = 8), 0.007 ms at 3.35 TB/s. The
// compares are N*U*2*2S = 1.6e9 int32 operations, 0.096 ms at the H100's
// int32 rate (64 int32 lanes a SM: 132 * 64 * 1.98 GHz = 16.7e12 a
// second, half the float32 lanes behind the data sheet's 67 TFLOP/s):
// the work is bound by operations, not bytes. Measured there (an H100
// SXM at 700 W): 0.219 ms a launch on the device, 44 % of that bound.
//
// Design (simple first). One thread a row, 128 rows a block. The row's
// 2S members and their masked domains sit in registers (the slot count
// is a template parameter, so the loops unroll; ptxas gives the nine
// instances 48 to 124 registers and at most 12 bytes of spill; 2S up to
// 32 covers an EC pool of size 16). The block
// stages the targets in chunks of 512: dsts, dom[dsts] and dev[dsts] in
// shared memory, so that every lane of a warp reads the same entry, a
// broadcast with no bank conflict. Each lane then walks u in ascending
// order, computes the score, and keeps its top 8 in registers by an
// insertion that takes a new entry only when it is strictly greater
// than the 8th (or a slot is still empty): ties keep the earlier u,
// exactly lax.top_k's order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0x7fffffff;          // CRUSH_ITEM_NONE
constexpr int kMasked = -2147483647;       // -(2**31) + 1
constexpr int kChunk = 512;                // targets staged at once
constexpr int kTopK = 8;
constexpr int kThreads = 128;

template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
score_kernel(const int* __restrict__ members, const int* __restrict__ src,
             const int* __restrict__ dsts, const float* __restrict__ dev,
             const int* __restrict__ dom, int n_rows, int n_slots,
             int n_dsts, int n_osds, int topk, int* __restrict__ best,
             float* __restrict__ score) {
  __shared__ int s_dst[kChunk];
  __shared__ int s_dom[kChunk];
  __shared__ float s_dev[kChunk];

  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n_rows;

  int mem[SLOTS];
  int mdom[SLOTS];
  float dsrc = 0.0f;
  if (live) {
    const int s = src[row];
    dsrc = dev[s];
    const int* mrow = members + (long long)row * n_slots;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int v = j < n_slots ? mrow[j] : kNone;
      mem[j] = v;
      const bool valid = v != kNone && v != s;
      const int c = min(max(v, 0), n_osds - 1);
      mdom[j] = valid ? dom[c] : kMasked;
    }
  }

  float vals[kTopK];
  int idx[kTopK];
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    vals[p] = -INFINITY;
    idx[p] = -1;                            // empty slot
  }

  for (int base = 0; base < n_dsts; base += kChunk) {
    const int n = min(kChunk, n_dsts - base);
    __syncthreads();                        // the last chunk is read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int d = dsts[base + i];
      s_dst[i] = d;
      s_dom[i] = dom[d];
      s_dev[i] = dev[d];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const int d = s_dst[i];
      const int dd = s_dom[i];
      bool bad = false;
#pragma unroll
      for (int j = 0; j < SLOTS; ++j)
        bad |= (mem[j] == d) | (mdom[j] == dd);
      const float gain = __fsub_rn(__fsub_rn(dsrc, s_dev[i]), 1.0f);
      const float v = (bad || gain <= 0.0f) ? -INFINITY : gain;
      if (v > vals[kTopK - 1] || idx[kTopK - 1] < 0) {
        // insert (v, u) before the first slot it beats strictly (or the
        // first empty one); every later entry moves down one slot
        float cv = v;
        int ci = base + i;
        bool placed = false;
#pragma unroll
        for (int p = 0; p < kTopK; ++p) {
          if (placed || cv > vals[p] || idx[p] < 0) {
            const float tv = vals[p];
            const int ti = idx[p];
            vals[p] = cv;
            idx[p] = ci;
            cv = tv;
            ci = ti;
            placed = true;
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    if (p < topk) {
      best[(long long)row * topk + p] = idx[p];
      score[(long long)row * topk + p] = vals[p];
    }
  }
}

template <int SLOTS>
void launch(const int* members, const int* src, const int* dsts,
            const float* dev, const int* dom, int n_rows, int n_slots,
            int n_dsts, int n_osds, int topk, int* best, float* score,
            cudaStream_t stream) {
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  score_kernel<SLOTS><<<blocks, kThreads, 0, stream>>>(
      members, src, dsts, dev, dom, n_rows, n_slots, n_dsts, n_osds, topk,
      best, score);
}

}  // namespace

extern "C" {

// members (N, n_slots) int32, src (N,) int32, dsts (U,) int32, dev
// (n_osds,) float32, dom (n_osds,) int32, all on the device and
// contiguous; best (N, topk) int32 and score (N, topk) float32 out.
// Returns the launch's cudaError_t (0: launched); the caller checks the
// arguments, this rechecks the ranges the kernel relies on.
int score_candidates(const void* members, const void* src, const void* dsts,
                     const void* dev, const void* dom, int n_rows,
                     int n_slots, int n_dsts, int n_osds, int topk,
                     void* best, void* score, void* stream) {
  if (n_rows <= 0) return 0;
  if (n_slots < 1 || n_slots > 32 || topk < 1 || topk > kTopK ||
      n_dsts < topk || n_osds < 1)
    return (int)cudaErrorInvalidValue;
  const int* m = static_cast<const int*>(members);
  const int* s = static_cast<const int*>(src);
  const int* d = static_cast<const int*>(dsts);
  const float* v = static_cast<const float*>(dev);
  const int* o = static_cast<const int*>(dom);
  int* b = static_cast<int*>(best);
  float* c = static_cast<float*>(score);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SCORE_CASE(K)                                                    \
  if (n_slots <= K) {                                                    \
    launch<K>(m, s, d, v, o, n_rows, n_slots, n_dsts, n_osds, topk, b, c, \
              st);                                                       \
    return (int)cudaGetLastError();                                      \
  }
  SCORE_CASE(2)
  SCORE_CASE(4)
  SCORE_CASE(6)
  SCORE_CASE(8)
  SCORE_CASE(12)
  SCORE_CASE(16)
  SCORE_CASE(22)
  SCORE_CASE(24)
  SCORE_CASE(32)
#undef SCORE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
