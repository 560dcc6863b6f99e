// Batched block checksums for Hopper (sm_90a): CRC-32C, XXH32, XXH64 of
// every row of a (B, L) uint8 array, any L >= 0, rows `pitch` bytes apart.
//
// Replaces the XLA programs of ceph_tpu/csum/kernels.py, which have no
// Pallas source: crc32c_blocks (:113) / crc32c_extend (:148) through
// _crc32c_zero_seed (:83), and the stripe loops _xxh32_jit (:195) and
// _xxh64_jit (:339). The wrapper is ceph_tpu_torch/csum/kernels.py; its
// plain torch versions compute the same functions on any device.
//
// CRC-32C (crc32c_kernel). CRC is GF(2)-linear in the message, and a
// zero register stays zero through zero bytes. A row's head of
// units = L / 32 units of 32 bytes is viewed as pad zero units followed
// by the data, cut into S = 2^levels segments of seg units (S * seg =
// pad + units). One lane computes the zero-register CRC of one segment.
// A work item is a warp: 32 consecutive segments of a row (S >= 32), or
// all S segments of 32 / S rows. Each lane shifts its segment's CRC past
// the later segments of its row in the item (a 32x32 GF(2) matrix of its
// own, applied as 32 masked XORs of column words) and the row's lanes
// XOR theirs together with shuffles. A row of S > 32 segments spans
// S / 32 items: the warp shifts an item's value past the items after it
// (the binary digits of their count pick level matrices, seg * 32 << l
// bytes) with every lane holding one column (a butterfly of shuffles
// XORs the columns of the value's set bits), and XORs it into the row's
// output with one 64-bit atomicXor; the entry point zeroes the output
// first (cudaMemsetAsync on the same stream). The last L % 32 bytes (the
// tail, <= 7 word steps and <= 3 byte steps) are stepped by the row's
// last lane while the others start their segments, and the last item
// adds them and the seed term: shift^L(init) ^ xorout, a host constant,
// for crc32c_blocks; shift^L(regs[row]) for crc32c_extend. The matrices
// are a plan's constants in device memory (`plan_mats` in
// csum/kernels.py, cached per plan); `crc32c_split_ref` and
// `crc32c_sets_ref` there model this algebra in torch, and the CPU tests
// hold them against the oracle.
//
// Why this design. The function reads B*L bytes once: 0.040 ms for 256
// rows of 512 KiB at 3.35 TB/s. A table-driven CRC spends one shared-
// memory lookup a byte, and the lookup's index is the data. The
// microbenchmark (tools/crc_microbench.cu, `chip_smoke.py --crc-times`;
// an H100 SXM at 700 W) timed the parts of the earlier kernel at those
// rows: each thread's 16-byte loads of its own segment alone 0.067 ms
// (a warp load touches 32 lines; coalesced loads of the same bytes
// 0.048 ms), and its slicing-by-8 lookups from 8 KiB of tables the warp
// shares, on random register data, 0.049 ms (32 lookups on random
// banks). The two share the SM's load pipe: the kernel took 0.0963 ms,
// about their sum. So both go:
// - Lookups: every lane has its own slicing-by-4 tables (128 KiB in
//   all), so a warp's lookups are one bank each; a table's entries are
//   256 bytes apart, two tables interleaved, so that one byte permute
//   (PRMT) forms a lookup's address from the data byte and the lane.
//   Alone: 0.024 ms, 3.9 instructions a byte.
// - Loads: the warp stages its lanes' next 4 units in shared memory with
//   coalesced 16-byte cp.async (a copy instruction moves four lanes' 128
//   contiguous bytes; 16-byte chunks swizzled so that neither the copies
//   nor the lanes' reads meet a bank conflict), double-buffered, the
//   copies running one round ahead across the warp's items. Alone: 0.047
//   ms, 2.86 TB/s, as fast as plain coalesced loads.
// 128 KiB of tables and 8 KiB of stages a warp leave one block of 12
// warps a SM. The grid is persistent: one block a SM (fewer when items
// are fewer), which builds its tables once (T_0..T_3 by bit steps, then
// every lane's copy) and whose warps walk the items i = block + grid *
// (warp + 12 k), so every SM gets the same count to within one. `csum/kernels.py::plan_for` picks S: the fewest segments whose
// items number 16 a SM (best of 8, 16, 32, 64 on the card), while a
// segment keeps 4 units (128 bytes) or more: few long rows get many
// items, short rows a warp or less a row (the RMW delta's 4093-byte
// rows: 32 segments of 4 units, one item a row).
//
// One launch takes up to four row sets, each with its own rows, pitch,
// B, L, plan and seed (`add`, or `regs`), and writes one (sum of B)
// output: the fused write's data and parity rows, the RMW delta's, and
// the recovery program's rebuilt rows and helper fold are one launch.
//
// Rows whose start or pitch is not a multiple of 16 (the RMW delta's
// windows, 4093 bytes apart; a view at an odd offset) are not staged:
// each lane reads the two or three aligned 16-byte words that hold a
// unit's bytes and realigns them by word selects and a funnel shift,
// never touching a word that holds no byte of the row, its next unit's
// loads in flight while it steps through one. Rows are < 2^31 bytes.
//
// XXH32 / XXH64 (xxh32_kernel, xxh64_kernel). Four threads a row, one
// for each accumulator v1..v4: thread a reads its 4-byte (8-byte) lane
// a of every 16-byte (32-byte) stripe, so the four threads of a row read
// one stripe together. __shfl_sync gathers the accumulators to the
// row's first thread, which does the merge, the <= 15 (<= 31) tail bytes
// and the avalanche. uint64_t is native: no limb pairs. Rows shorter
// than a stripe take the seed + PRIME5 start as in the reference. The
// bound is the bytes (0.32 ms for 262,144 rows of 4 KiB at 3.35 TB/s);
// the arithmetic is 3 integer operations per lane word. Where it may
// lose: rows of 4 KiB are 4 KiB apart, so a warp's load touches 8 rows'
// 16 (32) bytes, half a sector for XXH32, and the next stripe's load
// must find the rest in L1.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // the XXH kernels' blocks
constexpr int kCrcWarps = 12;          // the CRC kernel's blocks
constexpr int kStageUnits = 4;         // units a lane stages a round
constexpr int kStageChunks = 2 * kStageUnits;        // 16-byte chunks
constexpr int kStageBytes = 2 * 32 * kStageUnits * 32;  // a warp's 2 x 4 KiB
constexpr int kTabBytes = 4 * 256 * 32 * 4;          // lane-private: 128 KiB
constexpr int kMaxLevels = 20;
constexpr int kMaxSets = 4;
constexpr uint32_t kPoly = 0x82F63B78u;  // CRC-32C, reflected

struct CrcSet {
  const uint8_t* rows;
  long long pitch;        // bytes from a row to the next
  const long long* regs;  // (B,) seeds (crc32c_extend) or null
  const uint32_t* mats;   // the plan's shift matrices (plan_mats)
  long long first_item;   // warp items of the sets before this one
  long long out_row;      // the set's first row in the output
  int B;
  int units;              // 32-byte units of a row's head
  int tail;               // L % 32
  int seg;                // units a segment (one lane)
  int pad;                // zero units in front: S * seg - units
  int log_lanes;          // log2 of a row's lanes in one item (<= 5)
  int levels;             // log2 S
  int aligned;            // start and pitch multiples of 16
  uint32_t add;           // seed term of crc32c_blocks
};

// A plan's shift matrices on the device, as column words (column b of
// a 32x32 GF(2) matrix: the image of bit b): lane j's (the shift past
// the later segments of its row in its item) column b at [32 b + j];
// then level l's (seg * 32 << l bytes) column b at [1024 + 32 l + b],
// the tail's (L % 32 bytes) at [1024 + 32 levels + b] and the row's (L
// bytes) at [1024 + 32 (levels + 1) + b].
constexpr int kLaneMats = 32 * 32;

struct CrcParams {
  CrcSet set[kMaxSets];
  long long* out;         // (sum of B,) int64 holding uint32
  long long items;        // warp items of all sets
  int nsets;
};

// the matrix with column b at cols[b], applied to x by one lane
__device__ __forceinline__ uint32_t apply_cols(const uint32_t* cols,
                                               uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= (0u - ((x >> b) & 1u)) & __ldg(cols + b);
  return r;
}

// the matrix applied to x (the same in every lane) by the whole warp:
// lane b holds column b, and the XOR of the columns of x's set bits is
// a butterfly across the lanes; every lane gets the result
__device__ __forceinline__ uint32_t apply_warp(uint32_t col, uint32_t x,
                                               int lane) {
  uint32_t r = (0u - ((x >> lane) & 1u)) & col;
#pragma unroll
  for (int d = 16; d; d >>= 1) r ^= __shfl_xor_sync(0xFFFFFFFFu, r, d);
  return r;
}

// Lane-private slicing-by-4 tables in shared memory: T_j (the step of
// a register byte through j + 1 zero bytes) holds entry v for lane l at
// byte (j >> 1) * 64 KiB + v * 256 + (j & 1) * 128 + 4 l, so a lane
// always reads its own bank, and one byte permute forms the offset
// (v << 8 | 4 l) of byte q of x: __byte_perm(x, 4 l, 0x55q4).
constexpr uint32_t kT0 = 0, kT1 = 128, kT2 = 65536, kT3 = 65536 + 128;

__device__ __forceinline__ uint32_t look(const uint8_t* tab, uint32_t at) {
  return *reinterpret_cast<const uint32_t*>(tab + at);
}

// register after one little-endian word, x = register ^ word
__device__ __forceinline__ uint32_t step4(const uint8_t* tab, uint32_t l4,
                                          uint32_t x) {
  return look(tab + kT3, __byte_perm(x, l4, 0x5504))
       ^ look(tab + kT2, __byte_perm(x, l4, 0x5514))
       ^ look(tab + kT1, __byte_perm(x, l4, 0x5524))
       ^ look(tab + kT0, __byte_perm(x, l4, 0x5534));
}

__device__ __forceinline__ uint32_t step_unit(const uint8_t* tab,
                                              uint32_t l4, uint32_t v,
                                              const uint32_t w[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) v = step4(tab, l4, v ^ w[i]);
  return v;
}

// 32 bytes at p, any alignment, as eight little-endian words: the
// aligned 16-byte words that hold [p, p + 32) (a third only when p is
// off the grid: it then holds p[31]), shifted by o / 4 words through
// selects and by o % 4 bytes through a funnel shift
__device__ __forceinline__ void load_realigned(const uint8_t* p,
                                               uint32_t w[8]) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const uint4* q = reinterpret_cast<const uint4*>(at & ~uintptr_t(15));
  const int o = (int)(at & 15);
  uint32_t x[12];
  const uint4 a = __ldg(q), b = __ldg(q + 1);
  const uint4 c = o ? __ldg(q + 2) : make_uint4(0u, 0u, 0u, 0u);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  x[8] = c.x; x[9] = c.y; x[10] = c.z; x[11] = c.w;
  if (o & 8) {
#pragma unroll
    for (int i = 0; i < 10; ++i) x[i] = x[i + 2];
  }
  if (o & 4) {
#pragma unroll
    for (int i = 0; i < 9; ++i) x[i] = x[i + 1];
  }
  const unsigned s = 8u * (o & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __funnelshift_r(x[i], x[i + 1], s);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// zero-register CRC of the tail's n < 32 bytes at p: the aligned words
// that hold them, loaded together and realigned, n / 4 word steps and
// n % 4 byte steps
__device__ __forceinline__ uint32_t tail_crc(const uint8_t* tab,
                                             uint32_t l4, const uint8_t* p,
                                             int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(at & ~uintptr_t(3));
  const int words = (int)((at + n + 3 - (at & ~uintptr_t(3))) >> 2);
  uint32_t x[9], w[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) x[k] = k < words ? __ldg(q + k) : 0u;
  const unsigned s = 8u * (unsigned)(at & 3);
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = __funnelshift_r(x[k], x[k + 1], s);
  uint32_t t = 0, last = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k < (n >> 2)) t = step4(tab, l4, t ^ w[k]);
    else if (k == (n >> 2)) last = w[k];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < (n & 3))
      t = (t >> 8) ^ look(tab + kT0, __byte_perm(t ^ (last >> (8 * i)), l4,
                                                  0x5504));
  return t;
}

// where a work item's lanes sit: its set, row group and item of the row
struct Item {
  int s, lg, per_row, bi;
  long long grp;
};

__device__ __forceinline__ Item locate(const CrcParams& p, long long it) {
  Item q;
  q.s = 0;
  while (q.s + 1 < p.nsets && it >= p.set[q.s + 1].first_item) ++q.s;
  const CrcSet& c = p.set[q.s];
  const long long li = it - c.first_item;
  q.lg = c.log_lanes;
  q.per_row = c.levels - q.lg;             // log2 items a row
  q.grp = li >> q.per_row;
  q.bi = (int)(li & ((1LL << q.per_row) - 1));
  return q;
}

__global__ void __launch_bounds__(kCrcWarps * 32, 1)
crc32c_kernel(const __grid_constant__ CrcParams p) {
  extern __shared__ uint4 smem[];           // tables, then 2 x 4 KiB a warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wpb = blockDim.x >> 5;          // warps a block
  uint4* const stages = smem + kTabBytes / 16;
  {  // T_0..T_3 into the stages' space (T_j[v]: 8 (j + 1) bit steps of
     // v, one chain a v), then every lane's copy, 16 bytes (4 lanes) a
     // store
    uint32_t* const compact = reinterpret_cast<uint32_t*>(stages);
    if (tid < 256) {
      uint32_t x = tid;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) x = (x >> 1) ^ ((0u - (x & 1u)) & kPoly);
        compact[256 * j + tid] = x;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < kTabBytes / 16; e += blockDim.x) {
      const uint32_t x =
          compact[256 * (2 * (e >> 12) + ((e >> 3) & 1)) + ((e >> 4) & 255)];
      smem[e] = make_uint4(x, x, x, x);
    }
    __syncthreads();
  }
  const uint8_t* const tab = reinterpret_cast<const uint8_t*>(smem);
  const uint32_t l4 = 4u * lane;
  const uint4* const stage = stages + warp * (2 * 32 * kStageChunks);
  const uint32_t stage_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  // copying, this lane moves chunk cc of the owners 4 i + cq (i = 0..7),
  // a copy instruction four owners' 128 contiguous bytes; chunk k of
  // owner o sits in slot 8 o + (k ^ (o & 7)), so that neither the
  // copies nor the owners' 16-byte reads meet a bank conflict; for
  // o = 4 i + cq the slot is 32 i + cslot[i & 1]
  const int cc = lane & 7, cq = lane >> 3;
  const uint32_t cslot[2] = {16u * (8 * cq + (cc ^ cq)),
                             16u * (8 * cq + (cc ^ (cq + 4)))};
  const long long stride = (long long)gridDim.x * wpb;
  const long long it0 = blockIdx.x + (long long)gridDim.x * warp;
  // The warp's aligned items are one sequence of steps (rounds of 4
  // units a lane): the copier runs one step ahead of the lanes' lookups
  // across items, into the other of two buffers. Its state: the item
  // and round it copies next, and each owner's source and first real
  // unit (an owner past the set's rows gets none).
  long long cit = 0;
  int cr = 0, crounds = 0, cseg = 0;
  const uint8_t* src[8];
  int first[8];
  auto enter = [&](long long it) {  // the first aligned item from `it` on
    for (; it < p.items; it += stride) {
      const Item q = locate(p, it);
      const CrcSet& c = p.set[q.s];
      if (!c.aligned || c.seg == 0) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int o = 4 * i + cq;
        const long long orow = (q.grp << (5 - q.lg)) + (o >> q.lg);
        const long long ou0 =
            (((long long)q.bi << q.lg) + (o & ((1 << q.lg) - 1))) * c.seg
            - c.pad;
        src[i] = c.rows + orow * c.pitch + ou0 * 32 + 16 * cc;
        first[i] = orow < c.B ? (ou0 < 0 ? (int)-ou0 : 0) : c.seg;
      }
      cit = it;
      cr = 0;
      cseg = c.seg;
      crounds = (c.seg + kStageUnits - 1) / kStageUnits;
      return;
    }
    cit = p.items;
  };
  auto issue = [&](uint32_t buf) {  // the copier's step into buffer buf
    if (cit < p.items) {
      const int m = kStageUnits * cr + cc / 2;   // unit of the segment
      const uint32_t dst = stage_s + buf * (32 * kStageChunks * 16);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (m >= first[i] && m < cseg)
          cp_async16(dst + 512u * i + cslot[i & 1],
                     src[i] + 32LL * kStageUnits * cr);
      if (++cr == crounds) enter(cit + stride);
    }
    cp_async_commit();
  };
  enter(it0);
  issue(0);
  unsigned n = 0;                           // aligned steps looked up
  for (long long it = it0; it < p.items; it += stride) {
    const Item q = locate(p, it);
    const CrcSet& c = p.set[q.s];
    const int lg = q.lg, bi = q.bi;
    const int j = lane & ((1 << lg) - 1);
    const long long row = (q.grp << (5 - lg)) + (lane >> lg);
    // this lane's segment: units [u0, u0 + seg) of its row, those < 0
    // virtual zeros (they leave the zero register as it is)
    const long long u0 = (((long long)bi << lg) + j) * c.seg - c.pad;
    const unsigned nb = 1u << q.per_row, later = nb - 1 - bi;
    const uint32_t* lv = c.mats + kLaneMats;  // level, tail, length columns
    uint32_t v = 0, t = 0, lane_col[32], level_col[kMaxLevels - 5];
    uint32_t tail_col = 0, len_col = 0, reg = 0;
    // this lane's matrix, and with a row an item this lane's column of
    // each matrix the finish applies (loaded now, used after the segment)
    if (lg) {
#pragma unroll
      for (int b = 0; b < 32; ++b) lane_col[b] = __ldg(c.mats + 32 * b + j);
    }
#pragma unroll
    for (int k = 0; k < kMaxLevels - 5; ++k)
      level_col[k] = lg == 5 && ((later >> k) & 1u)
                   ? __ldg(lv + 32 * (5 + k) + lane) : 0u;
    if (lg == 5 && row < c.B) {
      if (c.tail) tail_col = __ldg(lv + 32 * c.levels + lane);
      if (c.regs && bi == (int)nb - 1) {
        len_col = __ldg(lv + 32 * (c.levels + 1) + lane);
        reg = (uint32_t)c.regs[row];
      }
    }
    // the tail's CRC (the row's last segment lane, in the row's last item)
    if (c.tail && j == (1 << lg) - 1 && row < c.B
        && bi == (1 << q.per_row) - 1)
      t = tail_crc(tab, l4, c.rows + row * c.pitch + (long long)c.units * 32,
                   c.tail);
    if (c.aligned && c.seg) {
      const int mine = row < c.B ? (u0 < 0 ? (int)-u0 : 0) : c.seg;
      const int rounds = (c.seg + kStageUnits - 1) / kStageUnits;
      for (int r = 0; r < rounds; ++r, ++n) {
        issue((n + 1) & 1);
        cp_async_wait<1>();
        __syncwarp();
        const uint4* buf = stage + (n & 1) * (32 * kStageChunks);
#pragma unroll
        for (int k = 0; k < kStageUnits; ++k) {
          const int m = kStageUnits * r + k;
          if (m >= mine && m < c.seg) {
            const uint4 a = buf[lane * 8 + ((2 * k) ^ (lane & 7))];
            const uint4 b = buf[lane * 8 + ((2 * k + 1) ^ (lane & 7))];
            const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
            v = step_unit(tab, l4, v, w);
          }
        }
        __syncwarp();
      }
    } else if (!c.aligned && row < c.B) {
      // rows off the 16-byte grid: each lane loads its own units,
      // realigned, the next one in flight while it steps through one
      long long u = u0 < 0 ? 0 : u0;
      const long long u1 = u0 + c.seg;
      if (u < u1) {
        const uint8_t* qr = c.rows + row * c.pitch;
        uint32_t w[8];
        load_realigned(qr + u * 32, w);
        for (++u; u < u1; ++u) {
          uint32_t x[8];
          load_realigned(qr + u * 32, x);
          v = step_unit(tab, l4, v, w);
#pragma unroll
          for (int k = 0; k < 8; ++k) w[k] = x[k];
        }
        v = step_unit(tab, l4, v, w);
      }
    }
    // each lane's value shifted past the later segments of its row in
    // this item (its own matrix), XORed across the row's lanes: every
    // lane of the row then holds the item's value
    if (lg) {
      uint32_t r = 0;
#pragma unroll
      for (int b = 0; b < 32; ++b) r ^= (0u - ((v >> b) & 1u)) & lane_col[b];
      v = r;
      for (int l = 0; l < lg; ++l)
        v ^= __shfl_xor_sync(0xFFFFFFFFu, v, 1 << l);
    }
    const int last = (1 << lg) - 1;           // the row's lane with its tail
    t = __shfl_sync(0xFFFFFFFFu, t, (lane & ~last) + last);
    if (lg == 5) {
      // one row an item: the warp shifts the value past the items after
      // this one and the tail, and the last item adds the tail's CRC
      // and the seed term
      if (row < c.B) {
#pragma unroll
        for (int k = 0; k < kMaxLevels - 5; ++k)
          if ((later >> k) & 1u) v = apply_warp(level_col[k], v, lane);
        if (c.tail) v = apply_warp(tail_col, v, lane);
        if (bi == (int)nb - 1)
          v ^= t ^ (c.regs ? apply_warp(len_col, reg, lane) : c.add);
        if (lane == 0) {
          long long* o = p.out + c.out_row + row;
          if (nb == 1)
            *o = (long long)v;
          else
            atomicXor(reinterpret_cast<unsigned long long*>(o),
                      (unsigned long long)v);
        }
      }
    } else if (j == 0 && row < c.B) {
      // rows of one item each: the row's first lane adds the tail
      if (c.tail) v = apply_cols(lv + 32 * c.levels, v);
      v ^= t ^ (c.regs ? apply_cols(lv + 32 * (c.levels + 1),
                                       (uint32_t)c.regs[row])
                       : c.add);
      p.out[c.out_row + row] = (long long)v;
    }
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------------------ xxhash

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
       | ((uint32_t)p[3] << 24);
}

constexpr uint32_t P32_1 = 2654435761u, P32_2 = 2246822519u,
                   P32_3 = 3266489917u, P32_4 = 668265263u,
                   P32_5 = 374761393u;
constexpr uint64_t P64_1 = 11400714785074694791ull,
                   P64_2 = 14029467366897019727ull,
                   P64_3 = 1609587929392839161ull,
                   P64_4 = 9650029242287828579ull,
                   P64_5 = 2870177450012600261ull;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

template <bool ALIGNED>
__device__ __forceinline__ uint32_t load32(const uint8_t* p) {
  if constexpr (ALIGNED) return __ldg(reinterpret_cast<const uint32_t*>(p));
  else return le32(p);
}

template <bool ALIGNED>
__device__ __forceinline__ uint64_t load64(const uint8_t* p) {
  if constexpr (ALIGNED) {
    return __ldg(reinterpret_cast<const unsigned long long*>(p));
  } else {
    return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32);
  }
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
xxh32_kernel(const uint8_t* rows, long long pitch, int B, int L,
             uint32_t seed, long long* out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t >> 2;
  const int a = threadIdx.x & 3;
  const bool live = row < B;
  const uint8_t* base = rows + (live ? row : 0) * pitch;
  const int stripes = L >> 4;
  uint32_t v = a == 0 ? seed + P32_1 + P32_2
             : a == 1 ? seed + P32_2 : a == 2 ? seed : seed - P32_1;
  if (live) {
    const uint8_t* q = base + 4 * a;
#pragma unroll 4
    for (int s = 0; s < stripes; ++s)
      v = rotl32(v + load32<ALIGNED>(q + 16 * s) * P32_2, 13) * P32_1;
  }
  const uint32_t v2 = __shfl_sync(0xFFFFFFFFu, v, 1, 4);
  const uint32_t v3 = __shfl_sync(0xFFFFFFFFu, v, 2, 4);
  const uint32_t v4 = __shfl_sync(0xFFFFFFFFu, v, 3, 4);
  if (a != 0 || !live) return;
  uint32_t h = stripes ? rotl32(v, 1) + rotl32(v2, 7) + rotl32(v3, 12)
                             + rotl32(v4, 18)
                       : seed + P32_5;
  h += (uint32_t)L;
  int q = stripes * 16;
  for (; q + 4 <= L; q += 4)
    h = rotl32(h + load32<ALIGNED>(base + q) * P32_3, 17) * P32_4;
  for (; q < L; ++q) h = rotl32(h + base[q] * P32_5, 11) * P32_1;
  h ^= h >> 15;
  h *= P32_2;
  h ^= h >> 13;
  h *= P32_3;
  h ^= h >> 16;
  out[row] = (long long)h;
}

__device__ __forceinline__ uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P64_2, 31) * P64_1;
}

template <bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
xxh64_kernel(const uint8_t* rows, long long pitch, int B, int L,
             uint64_t seed, long long* out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long row = t >> 2;
  const int a = threadIdx.x & 3;
  const bool live = row < B;
  const uint8_t* base = rows + (live ? row : 0) * pitch;
  const int stripes = L >> 5;
  uint64_t v = a == 0 ? seed + P64_1 + P64_2
             : a == 1 ? seed + P64_2 : a == 2 ? seed : seed - P64_1;
  if (live) {
    const uint8_t* q = base + 8 * a;
#pragma unroll 4
    for (int s = 0; s < stripes; ++s)
      v = round64(v, load64<ALIGNED>(q + 32 * s));
  }
  const uint64_t v2 = __shfl_sync(0xFFFFFFFFu, v, 1, 4);
  const uint64_t v3 = __shfl_sync(0xFFFFFFFFu, v, 2, 4);
  const uint64_t v4 = __shfl_sync(0xFFFFFFFFu, v, 3, 4);
  if (a != 0 || !live) return;
  uint64_t h;
  if (stripes) {
    h = rotl64(v, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    const uint64_t vs[4] = {v, v2, v3, v4};
#pragma unroll
    for (int i = 0; i < 4; ++i) h = (h ^ round64(0, vs[i])) * P64_1 + P64_4;
  } else {
    h = seed + P64_5;
  }
  h += (uint64_t)L;
  int q = stripes * 32;
  for (; q + 8 <= L; q += 8)
    h = rotl64(h ^ round64(0, load64<ALIGNED>(base + q)), 27) * P64_1 + P64_4;
  if (q + 4 <= L) {
    h ^= (uint64_t)load32<ALIGNED>(base + q) * P64_1;
    h = rotl64(h, 23) * P64_2 + P64_3;
    q += 4;
  }
  for (; q < L; ++q) h = rotl64(h ^ base[q] * P64_5, 11) * P64_1;
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  h ^= h >> 32;
  out[2 * row] = (long long)(h >> 32);
  out[2 * row + 1] = (long long)(h & 0xFFFFFFFFull);
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// CRC-32C of nsets (1 to 4) row sets in one launch, into out: set s's
// rows follow the rows of the sets before it. meta: nsets x 13 int64 a
// set: rows, pitch, regs (null, or B int64 seeds), mats (the plan's
// shift matrices on the device, see CrcSet), B, units, tail, seg, pad,
// log_lanes, levels, add, aligned. sms: blocks at most (one a SM).
extern "C" int crc32c_rows(int nsets, const long long* meta, void* out,
                           int sms, void* stream) {
  if (nsets < 1 || nsets > kMaxSets || sms < 1)
    return (int)cudaErrorInvalidValue;
  CrcParams p;
  p.out = static_cast<long long*>(out);
  p.nsets = nsets;
  long long items = 0, rows = 0;
  bool joined = false;
  for (int s = 0; s < nsets; ++s) {
    const long long* m = meta + 13 * s;
    CrcSet& c = p.set[s];
    c.rows = reinterpret_cast<const uint8_t*>(m[0]);
    c.pitch = m[1];
    c.regs = reinterpret_cast<const long long*>(m[2]);
    c.mats = reinterpret_cast<const uint32_t*>(m[3]);
    c.B = (int)m[4];
    c.units = (int)m[5];
    c.tail = (int)m[6];
    c.seg = (int)m[7];
    c.pad = (int)m[8];
    c.log_lanes = (int)m[9];
    c.levels = (int)m[10];
    c.add = (uint32_t)m[11];
    c.aligned = (int)m[12];
    if (c.B < 1 || c.levels > kMaxLevels || c.log_lanes > 5
        || c.log_lanes != (c.levels < 5 ? c.levels : 5))
      return (int)cudaErrorInvalidValue;
    const int per_item = 32 >> c.log_lanes;  // rows an item
    c.first_item = items;
    c.out_row = rows;
    items += (((long long)c.B + per_item - 1) / per_item)
             << (c.levels - c.log_lanes);
    rows += c.B;
    joined |= c.levels > c.log_lanes;
  }
  p.items = items;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool sized[64];  // tables and stages: 224 KiB, once a device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    rc = cudaFuncSetAttribute(crc32c_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kTabBytes + kCrcWarps * kStageBytes);
    if (rc != cudaSuccess) return (int)rc;
    sized[dev] = true;
  }
  if (joined) {  // rows over several items meet by atomicXor
    rc = cudaMemsetAsync(out, 0, sizeof(long long) * rows, st);
    if (rc != cudaSuccess) return (int)rc;
  }
  // one block a SM (fewer when items are fewer)
  const long long grid = items < sms ? items : sms;
  crc32c_kernel<<<(unsigned)grid, 32 * kCrcWarps,
                  kTabBytes + kCrcWarps * kStageBytes, st>>>(p);
  return (int)cudaGetLastError();
}

// XXH32 of B rows of L bytes into out (B,) int64 holding uint32.
// aligned: row starts and pitch are multiples of 4.
extern "C" int xxh32_rows(const void* rows, long long pitch, int B, int L,
                          unsigned seed, void* out, int aligned,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(4LL * B);
  const uint8_t* r = static_cast<const uint8_t*>(rows);
  long long* o = static_cast<long long*>(out);
  if (aligned) xxh32_kernel<true><<<grid, kThreads, 0, s>>>(r, pitch, B, L, seed, o);
  else xxh32_kernel<false><<<grid, kThreads, 0, s>>>(r, pitch, B, L, seed, o);
  return (int)cudaGetLastError();
}

// XXH64 of B rows of L bytes into out (B, 2) int64 [hi, lo].
// aligned: row starts and pitch are multiples of 8.
extern "C" int xxh64_rows(const void* rows, long long pitch, int B, int L,
                          unsigned long long seed, void* out, int aligned,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = blocks_for(4LL * B);
  const uint8_t* r = static_cast<const uint8_t*>(rows);
  long long* o = static_cast<long long*>(out);
  if (aligned) xxh64_kernel<true><<<grid, kThreads, 0, s>>>(r, pitch, B, L, seed, o);
  else xxh64_kernel<false><<<grid, kThreads, 0, s>>>(r, pitch, B, L, seed, o);
  return (int)cudaGetLastError();
}
