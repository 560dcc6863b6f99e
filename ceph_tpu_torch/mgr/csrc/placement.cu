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
// and the row's output is the top `topk` <= 8 (u, score) pairs in the
// order of a stable descending sort: score descending in IEEE 754's
// total order, as lax.top_k ranks them (a NaN with its sign bit set
// below -inf, one without above +inf), ties to the lower u, -inf slots
// filled in ascending u.
//
// Why a row need not look at every target. For a fixed row the gain
// never increases as dev[dsts[u]] grows: both subtractions round
// monotonically, overflow to +-inf included. So in the order of
// (dev[dsts[u]] ascending, u ascending) a row's gains never increase,
// and the row's top k are settled once k legal entries are held and the
// next gain is strictly below the k-th (an equal gain may still enter
// with a lower u); the walk also ends at the first gain <= 0. The
// balancer passes its targets as np.argsort(dev)[:U], already in that
// order, and at 10k OSDs in hosts of 8 a row's 3 members clash with
// few of the first targets: a row settles after about 8-12 targets, not
// U = 512.
//
// Bound. What the function must move: N*2S + N member and source words
// and the small dsts/dev/dom tables in, N*topk (index, score) pairs
// out: 6.3 + 1.0 MB in and 16.8 MB out at the balancer's 10k-OSD shape
// (N = 262,144, 2S = 6, U = 512, topk = 8), 0.0072 ms at 3.35 TB/s.
// What it must compute: 2S + 1 compares for each target a row visits
// before its top k are settled, plus the -inf fill's checks (these
// inputs' count, chip_smoke.py::score_bound from
// placement.py::score_visits_plain; a member equal to the target is the
// source or shares the target's domain, so one compare with the source
// and one per member's domain decide legality), about N * 8 * 7 = 1.5e7
// int32 operations at the balancer's order, 0.001 ms at the H100's
// int32 rate (132 SMs * 64 lanes * 1.98 GHz = 16.7e12 a second): the
// bytes bind. An exhaustive loop over every target does N*U*2*2S =
// 1.6e9 compares, 100x what these inputs need.
//
// Design. Two instances, chosen by U on the host:
//  * score_kernel_walk (U <= kMaxWalk = 4096): a persistent grid of
//    256-thread blocks, as many as fit on the SMs. Each block stages
//    the targets once as 16-byte records (dst, dom[dst], dev[dst], u)
//    in dynamic shared memory and checks with __syncthreads_and that
//    their deviations are finite and non-decreasing (the balancer's
//    case). If they are finite but unsorted, it sorts 64-bit keys
//    (order-preserving bits of dev, u) by a bitonic sort in shared
//    memory and re-stages the records in walk order; the record keeps
//    u. Then each thread walks rows: the row's masked member domains in
//    registers (2S is a template parameter), the targets read in walk
//    order (every lane of a warp at the same record: a broadcast), the
//    stop tests on the gain first, then legality (2S + 1 compares), and
//    the ranked slots keyed on (score descending, u ascending). A legal
//    entry goes after the ones held, as gains never increase along the
//    walk, unless it ties the last with a lower u: then it is inserted,
//    because within a run of equal gains the walk order is not index
//    order (distinct deviations can round to one gain: with dev[src] =
//    3.0e7f, targets at 0.25, 0.5 and 1.0 all give 30000000.0f). A row
//    with c < topk legal entries fills the rest with the lowest u not
//    among them. A row whose dev[src] is not finite, or a block whose
//    staged deviations are not all finite (inf - inf is NaN, which
//    breaks the order), takes every target with a NaN-aware insertion
//    instead.
//  * score_kernel_scan (U > kMaxWalk): the exhaustive loop, one thread
//    a row, targets staged in chunks of 512, with the same NaN-aware
//    insertion.
// score_candidates_visits also writes, for every row, the targets its
// legality was tested against plus the fill's checks (U for a row
// scored exhaustively): the count that score_visits_plain models.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kNone = 0x7fffffff;          // CRUSH_ITEM_NONE
constexpr int kMasked = -2147483647;       // -(2**31) + 1
constexpr int kTopK = 8;
constexpr int kChunk = 512;                // scan: targets staged at once
constexpr int kScanThreads = 128;
constexpr int kWalkThreads = 256;
constexpr int kMaxWalk = 4096;             // walk: targets staged at most

// Order-preserving bits of a float: IEEE 754's total order (-NaN <
// -inf < ... < -0 < +0 < ... < +inf < +NaN) as unsigned compares.
__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (v, u) ranks before the slot (w, t): a greater score, or an equal one
// with a lower u; an empty slot (t < 0) ranks last. NAN_AWARE compares
// in the total order, so a NaN ranks by its sign and bits (the walk
// meets no NaN, and no score is +-0: a gain <= 0 scores -inf).
template <bool NAN_AWARE>
__device__ __forceinline__ bool ranks_before(float v, int u, float w,
                                             int t) {
  if (t < 0) return true;
  if (NAN_AWARE) {
    const unsigned kv = order_key(v), kw = order_key(w);
    return kv > kw || (kv == kw && u < t);
  }
  return v > w || (v == w && u < t);
}

// Insert (v, u) into the ranked slots: before the first slot it ranks
// before; every later entry moves down one slot, the 8th drops out.
template <bool NAN_AWARE>
__device__ __forceinline__ void insert(float (&vals)[kTopK],
                                       int (&idx)[kTopK], float v, int u) {
  if (!ranks_before<NAN_AWARE>(v, u, vals[kTopK - 1], idx[kTopK - 1]))
    return;
  float cv = v;
  int ci = u;
  bool placed = false;
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    if (placed || ranks_before<NAN_AWARE>(cv, ci, vals[p], idx[p])) {
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

// The row's source and its members' domains (kMasked where the slot is
// NONE or the source) into registers; returns dev[src].
template <int SLOTS>
__device__ __forceinline__ float load_row(
    const int* __restrict__ members, const int* __restrict__ src,
    const float* __restrict__ dev, const int* __restrict__ dom, int row,
    int n_slots, int n_osds, int& s, int (&mdom)[SLOTS]) {
  s = src[row];
  const int* mrow = members + (long long)row * n_slots;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int v = j < n_slots ? mrow[j] : kNone;
    const bool valid = v != kNone && v != s;
    const int c = min(max(v, 0), n_osds - 1);
    mdom[j] = valid ? __ldg(dom + c) : kMasked;
  }
  return __ldg(dev + s);
}

// Is target d (domain dd) illegal for the row? The function's 2 * 2S
// compares (d a member, or dd a valid member's domain) in 2S + 1: d is
// in [0, n_osds), so a member equal to d in a valid slot has d's domain,
// NONE never equals d, and a masked slot that is not NONE holds the
// source.
template <int SLOTS>
__device__ __forceinline__ bool clashes(const int (&mdom)[SLOTS], int s,
                                        int d, int dd) {
  bool bad = d == s;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) bad |= mdom[j] == dd;
  return bad;
}

// vals/idx[p] = (v, u) for the p that equals the runtime `at` (a
// register array takes no runtime index).
__device__ __forceinline__ void put(float (&vals)[kTopK], int (&idx)[kTopK],
                                    int at, float v, int u) {
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    if (p == at) {
      vals[p] = v;
      idx[p] = u;
    }
  }
}

__device__ __forceinline__ void get(const float (&vals)[kTopK],
                                    const int (&idx)[kTopK], int at,
                                    float& v, int& u) {
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    if (p == at) {
      v = vals[p];
      u = idx[p];
    }
  }
}

__device__ __forceinline__ void store_row(const float (&vals)[kTopK],
                                          const int (&idx)[kTopK], int row,
                                          int topk, int* __restrict__ best,
                                          float* __restrict__ score) {
  int* b = best + (long long)row * topk;
  float* s = score + (long long)row * topk;
  if (topk == kTopK) {                     // 32-byte rows: 16-byte stores
    reinterpret_cast<int4*>(b)[0] = make_int4(idx[0], idx[1], idx[2], idx[3]);
    reinterpret_cast<int4*>(b)[1] = make_int4(idx[4], idx[5], idx[6], idx[7]);
    reinterpret_cast<float4*>(s)[0] =
        make_float4(vals[0], vals[1], vals[2], vals[3]);
    reinterpret_cast<float4*>(s)[1] =
        make_float4(vals[4], vals[5], vals[6], vals[7]);
    return;
  }
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    if (p < topk) {
      b[p] = idx[p];
      s[p] = vals[p];
    }
  }
}

struct __align__(16) Target {
  int dst;
  int dom;
  float dev;
  int u;                                   // index into dsts
};

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ constexpr size_t walk_smem(int n_dsts) {
  return (size_t)n_dsts * sizeof(Target) +
         (size_t)pow2_at_least(n_dsts) * sizeof(unsigned long long);
}

template <int SLOTS>
__global__ void __launch_bounds__(kWalkThreads)
score_kernel_walk(const int* __restrict__ members, const int* __restrict__ src,
                  const int* __restrict__ dsts, const float* __restrict__ dev,
                  const int* __restrict__ dom, int n_rows, int n_slots,
                  int n_dsts, int n_osds, int topk, int* __restrict__ best,
                  float* __restrict__ score, int* __restrict__ visits) {
  extern __shared__ int4 smem[];
  Target* s_t = reinterpret_cast<Target*>(smem);
  unsigned long long* s_key =
      reinterpret_cast<unsigned long long*>(smem + n_dsts);
  const int U = n_dsts;

  // stage the targets in index order; finite and sorted?
  bool fin = true;
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    const int d = dsts[i];
    const float v = __ldg(dev + d);
    s_t[i] = Target{d, __ldg(dom + d), v, i};
    fin &= isfinite(v);
  }
  __syncthreads();
  bool up = true;
  for (int i = threadIdx.x; i + 1 < U; i += blockDim.x)
    up &= !(s_t[i].dev > s_t[i + 1].dev);
  const bool finite = __syncthreads_and(fin);
  const bool sorted = __syncthreads_and(up);
  if (finite && !sorted) {
    // bitonic sort of (order_key(dev), u), padded to a power of two
    const int P = pow2_at_least(U);
    for (int i = threadIdx.x; i < P; i += blockDim.x)
      s_key[i] = i < U ? ((unsigned long long)order_key(s_t[i].dev) << 32) |
                             (unsigned)i
                       : ~0ull;
    __syncthreads();
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = threadIdx.x; i < P; i += blockDim.x) {
          const int l = i ^ j;
          if (l > i) {
            const unsigned long long a = s_key[i], b = s_key[l];
            if ((a > b) == ((i & k) == 0)) {
              s_key[i] = b;
              s_key[l] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // re-stage in walk order (from global memory: s_t is overwritten)
    for (int i = threadIdx.x; i < U; i += blockDim.x) {
      const int u = (int)(unsigned)s_key[i];
      const int d = dsts[u];
      s_t[i] = Target{d, __ldg(dom + d), __ldg(dev + d), u};
    }
    __syncthreads();
  }

  const int4* s_rec = smem;
  for (int row = blockIdx.x * blockDim.x + threadIdx.x; row < n_rows;
       row += gridDim.x * blockDim.x) {
    int s;
    int mdom[SLOTS];
    const float dsrc = load_row<SLOTS>(members, src, dev, dom, row, n_slots,
                                       n_osds, s, mdom);
    float vals[kTopK];
    int idx[kTopK];
#pragma unroll
    for (int p = 0; p < kTopK; ++p) {
      vals[p] = -INFINITY;
      idx[p] = -1;                          // empty slot
    }
    int n = 0;                              // targets tested, fill checks
    if (finite && isfinite(dsrc)) {
      // held legal entries, ranked, in slots 0..held-1 (held <= topk);
      // (lastv, lastu) the lowest of them, which is the topk-th (kth)
      // once held == topk
      int held = 0;
      float lastv = 0.0f;
      int lastu = 0;
      int i = 0;
      for (; i < U; ++i) {
        const int4 e = s_rec[i];
        const float g = __fsub_rn(__fsub_rn(dsrc, __int_as_float(e.z)), 1.0f);
        if (!(g > 0.0f) || (held == topk && g < lastv)) break;
        if (clashes<SLOTS>(mdom, s, e.x, e.y)) continue;
        if (held < topk) {
          // gains arrive in non-increasing order: the entry goes last
          // unless it ties the last with a lower u
          if (held == 0 || !ranks_before<false>(g, e.w, lastv, lastu)) {
            put(vals, idx, held, g, e.w);
            lastv = g;
            lastu = e.w;
          } else {
            insert<false>(vals, idx, g, e.w);
            get(vals, idx, held, lastv, lastu);
          }
          ++held;
        } else if (ranks_before<false>(g, e.w, lastv, lastu)) {
          insert<false>(vals, idx, g, e.w);   // ties the kth, lower u
          get(vals, idx, topk - 1, lastv, lastu);
        }
      }
      n = i;
      // -inf slots: the lowest u that hold no legal entry, ascending
      const int have = held;
      int u = 0;
#pragma unroll
      for (int p = 0; p < kTopK; ++p) {
        if (p >= have && p < topk) {
          for (;; ++u) {
            ++n;
            bool taken = false;
#pragma unroll
            for (int q = 0; q < kTopK; ++q) taken |= q < have && idx[q] == u;
            if (!taken) break;
          }
          idx[p] = u++;
        }
      }
    } else {
      for (int i = 0; i < U; ++i) {
        const int4 e = s_rec[i];
        const float g = __fsub_rn(__fsub_rn(dsrc, __int_as_float(e.z)), 1.0f);
        const bool bad = clashes<SLOTS>(mdom, s, e.x, e.y);
        insert<true>(vals, idx, (bad || g <= 0.0f) ? -INFINITY : g, e.w);
      }
      n = U;
    }
    store_row(vals, idx, row, topk, best, score);
    if (visits) visits[row] = n;
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kScanThreads)
score_kernel_scan(const int* __restrict__ members, const int* __restrict__ src,
                  const int* __restrict__ dsts, const float* __restrict__ dev,
                  const int* __restrict__ dom, int n_rows, int n_slots,
                  int n_dsts, int n_osds, int topk, int* __restrict__ best,
                  float* __restrict__ score, int* __restrict__ visits) {
  __shared__ int s_dst[kChunk];
  __shared__ int s_dom[kChunk];
  __shared__ float s_dev[kChunk];

  const int row = blockIdx.x * kScanThreads + threadIdx.x;
  const bool live = row < n_rows;
  int s = 0;
  int mdom[SLOTS];
  float dsrc = 0.0f;
  if (live)
    dsrc = load_row<SLOTS>(members, src, dev, dom, row, n_slots, n_osds, s,
                           mdom);
  float vals[kTopK];
  int idx[kTopK];
#pragma unroll
  for (int p = 0; p < kTopK; ++p) {
    vals[p] = -INFINITY;
    idx[p] = -1;
  }
  for (int base = 0; base < n_dsts; base += kChunk) {
    const int n = min(kChunk, n_dsts - base);
    __syncthreads();                        // the last chunk is read
    for (int i = threadIdx.x; i < n; i += kScanThreads) {
      const int d = dsts[base + i];
      s_dst[i] = d;
      s_dom[i] = __ldg(dom + d);
      s_dev[i] = __ldg(dev + d);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < n; ++i) {
      const float g = __fsub_rn(__fsub_rn(dsrc, s_dev[i]), 1.0f);
      const bool bad = clashes<SLOTS>(mdom, s, s_dst[i], s_dom[i]);
      insert<true>(vals, idx, (bad || g <= 0.0f) ? -INFINITY : g, base + i);
    }
  }
  if (!live) return;
  store_row(vals, idx, row, topk, best, score);
  if (visits) visits[row] = n_dsts;
}

template <int SLOTS>
int launch(const int* members, const int* src, const int* dsts,
           const float* dev, const int* dom, int n_rows, int n_slots,
           int n_dsts, int n_osds, int topk, int* best, float* score,
           int* visits, cudaStream_t stream) {
  if (n_dsts > kMaxWalk) {
    const int blocks = (n_rows + kScanThreads - 1) / kScanThreads;
    score_kernel_scan<SLOTS><<<blocks, kScanThreads, 0, stream>>>(
        members, src, dsts, dev, dom, n_rows, n_slots, n_dsts, n_osds, topk,
        best, score, visits);
    return (int)cudaGetLastError();
  }
  const size_t smem = walk_smem(n_dsts);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(score_kernel_walk<SLOTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, score_kernel_walk<SLOTS>, kWalkThreads, smem)) !=
          cudaSuccess)
    return (int)err;
  const long long want = (n_rows + kWalkThreads - 1) / kWalkThreads;
  const int blocks = (int)(want < (long long)max(per_sm, 1) * sms
                               ? want
                               : (long long)max(per_sm, 1) * sms);
  score_kernel_walk<SLOTS><<<blocks, kWalkThreads, smem, stream>>>(
      members, src, dsts, dev, dom, n_rows, n_slots, n_dsts, n_osds, topk,
      best, score, visits);
  return (int)cudaGetLastError();
}

int dispatch(const void* members, const void* src, const void* dsts,
             const void* dev, const void* dom, int n_rows, int n_slots,
             int n_dsts, int n_osds, int topk, void* best, void* score,
             void* visits, void* stream) {
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
  int* n = static_cast<int*>(visits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SCORE_CASE(K)                                                      \
  if (n_slots <= K)                                                        \
    return launch<K>(m, s, d, v, o, n_rows, n_slots, n_dsts, n_osds, topk, \
                     b, c, n, st);
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
  return dispatch(members, src, dsts, dev, dom, n_rows, n_slots, n_dsts,
                  n_osds, topk, best, score, nullptr, stream);
}

// The same launch that also writes visits (N,) int32: the targets each
// row's legality was tested against plus the -inf fill's checks (U for
// a row scored exhaustively).
int score_candidates_visits(const void* members, const void* src,
                            const void* dsts, const void* dev,
                            const void* dom, int n_rows, int n_slots,
                            int n_dsts, int n_osds, int topk, void* best,
                            void* score, void* visits, void* stream) {
  return dispatch(members, src, dsts, dev, dom, n_rows, n_slots, n_dsts,
                  n_osds, topk, best, score, visits, stream);
}

// The most targets the walk instance stages (above: the scan instance).
int score_walk_max_targets(void) { return kMaxWalk; }

}  // extern "C"
