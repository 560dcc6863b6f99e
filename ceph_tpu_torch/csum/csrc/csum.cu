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
// pad + units). One thread computes the zero-register CRC of one
// segment with slicing-by-8 (a running register, 8 table lookups per 8
// bytes) from the eight 1 KiB tables, which every block computes into
// shared memory at its start (no table in global memory, no upload).
// The segment CRCs combine by a tree: a node is shift(left) ^ right,
// where shift advances a register through the right half's bytes, a
// 32x32 GF(2) matrix applied as 32 masked XORs of column words. Level
// l's matrix (seg * 32 * 2^l bytes) is one of the launch's parameters
// (a __grid_constant__ struct the wrapper fills from reference.py's
// shift_matrix, cached per plan), so the combine reads no memory. A row
// is spread over nb = S / min(S, 256) blocks where rows are few and
// long: lanes combine by __shfl_down_sync, warps through shared memory,
// and each block shifts its value by the segments of the blocks after
// it (the binary digits of that count pick level matrices), then
// atomically XORs it into the row's output, which the entry point
// zeroes first (cudaMemsetAsync on the same stream). Where rows are
// many, a block holds 256 / S rows and stores each row's value. The
// last L % 32 bytes step serially on one thread (<= 31 byte steps), and
// the seed term is added there: shift^L(init) ^ xorout, a host
// constant, for crc32c_blocks; shift^L(regs[row]) for crc32c_extend.
// The wrapper picks S (`csum/kernels.py::plan_for`) to give the card
// about 1,024 threads per SM with at least 8 units (256 bytes) a
// thread; `crc32c_split_ref` there models this kernel's algebra in
// torch, and the tests hold it against the oracle.
//
// Loads: rows whose start and pitch are multiples of 16 read a unit as
// two 16-byte loads (uint4), multiples of 8 as four 8-byte loads;
// anything else (the RMW delta's 4093-byte windows, a view at an odd
// offset) assembles each word from byte loads. Rows are < 2^31 bytes.
//
// Bound on the H100 (SXM, 700 W): the function reads B*L bytes once and
// writes 8 bytes a row, 0.040 ms for 256 rows of 512 KiB at 3.35 TB/s.
// The design spends one shared-memory lookup per byte; a warp's 32
// lookups go to random banks (the index is the data), so a request
// takes about 3.5 bank cycles. At 32 banks a clock on 132 SMs at 1.98
// GHz that is about 2.4e12 lookups/s, 0.06 ms for the same rows, above
// the bytes bound: the lookups, not HBM, are expected to bound it.
// Where it may lose: few long rows (the blocks a row is cut into leave
// SMs idle below ~130 blocks), short segments (the combine's matrix
// applies, about 100 integer operations each, stop being small beside
// 8 units of lookups), and byte loads on misaligned rows.
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

constexpr int kThreads = 256;
constexpr int kMaxLevels = 20;
constexpr uint32_t kPoly = 0x82F63B78u;  // CRC-32C, reflected

struct CrcParams {
  const uint8_t* rows;
  long long pitch;        // bytes from a row to the next
  long long* out;         // (B,) int64 holding uint32
  const long long* regs;  // (B,) seeds (crc32c_extend) or null
  int B;
  int units;              // 32-byte units of a row's head
  int tail;               // L % 32
  int seg;                // units a segment (one thread)
  int pad;                // zero units in front: S * seg - units
  int log_sblk;           // log2 of a row's threads in one block
  int nb;                 // blocks a row
  uint32_t add;           // seed term of crc32c_blocks
  uint32_t shift[kMaxLevels][32];  // level l: shift by seg * 32 << l bytes
  uint32_t shift_tail[32];         // shift by tail bytes
  uint32_t shift_len[32];          // shift by L bytes (regs)
};

__device__ __forceinline__ uint32_t apply_cols(const uint32_t* cols,
                                               uint32_t x) {
  uint32_t r = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) r ^= (0u - ((x >> b) & 1u)) & cols[b];
  return r;
}

// register after 8 bytes (lo: bytes 0-3 XOR the register, hi: 4-7)
__device__ __forceinline__ uint32_t step8(const uint32_t (*t)[256],
                                          uint32_t lo, uint32_t hi) {
  return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
       ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
       ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16)
       | ((uint32_t)p[3] << 24);
}

// 32 bytes as eight little-endian words
template <int VEC>
__device__ __forceinline__ void load_unit(const uint8_t* p, uint32_t w[8]) {
  if constexpr (VEC == 16) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else if constexpr (VEC == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint2 a = __ldg(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = a.x; w[2 * i + 1] = a.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = le32(p + 4 * i);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
crc32c_kernel(const __grid_constant__ CrcParams p) {
  __shared__ uint32_t tab[8][256];
  __shared__ uint32_t warp_v[kThreads / 32];
  const int tid = threadIdx.x;
  {  // slicing-by-8 tables: T0 byte-wise, T[j][v] = T0 step of T[j-1][v]
    uint32_t c = tid;
#pragma unroll
    for (int i = 0; i < 8; ++i) c = (c >> 1) ^ ((0u - (c & 1u)) & kPoly);
    tab[0][tid] = c;
    __syncthreads();
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      c = (c >> 8) ^ tab[0][c & 0xFF];
      tab[j][tid] = c;
    }
    __syncthreads();
  }
  const int sblk = 1 << p.log_sblk;
  const int rpb = kThreads >> p.log_sblk;  // rows a block
  const int j = tid & (sblk - 1);
  const long long rgroup = blockIdx.x / p.nb;
  const int bi = blockIdx.x % p.nb;
  const long long row = rgroup * rpb + (tid >> p.log_sblk);
  uint32_t v = 0;
  if (row < p.B) {
    const long long g = (long long)bi * sblk + j;
    long long u = g * p.seg - p.pad;
    const long long u1 = u + p.seg;
    if (u < 0) u = 0;
    const uint8_t* base = p.rows + row * p.pitch;
#pragma unroll 2
    for (; u < u1; ++u) {
      uint32_t w[8];
      load_unit<VEC>(base + u * 32, w);
#pragma unroll
      for (int s = 0; s < 4; ++s) v = step8(tab, v ^ w[2 * s], w[2 * s + 1]);
    }
  }
  // tree over the row's segments in this block: node = shift(left) ^ right
  const int in_warp = p.log_sblk < 5 ? p.log_sblk : 5;
  for (int l = 0; l < in_warp; ++l) {
    const uint32_t x = __shfl_down_sync(0xFFFFFFFFu, v, 1 << l);
    if ((j & ((2 << l) - 1)) == 0) v = apply_cols(p.shift[l], v) ^ x;
  }
  bool fin = j == 0;
  long long frow = row;
  if (p.log_sblk > 5) {  // across the warps of a row
    const int lane = tid & 31;
    if (lane == 0) warp_v[tid >> 5] = v;
    __syncthreads();
    const int wpr = sblk >> 5;  // warps a row
    const int jw = lane & (wpr - 1);
    fin = false;
    if (tid < 32) {
      v = lane < kThreads / 32 ? warp_v[lane] : 0u;
      for (int l = 5; l < p.log_sblk; ++l) {
        const uint32_t x = __shfl_down_sync(0xFFFFFFFFu, v, 1 << (l - 5));
        if ((jw & ((2 << (l - 5)) - 1)) == 0)
          v = apply_cols(p.shift[l], v) ^ x;
      }
      fin = lane < kThreads / 32 && jw == 0;
      frow = rgroup * rpb + lane / wpr;
    }
  }
  if (!fin || frow >= p.B) return;
  // shift past the blocks after this one, then past the tail
  for (unsigned m = p.nb - 1 - bi, l = p.log_sblk; m; m >>= 1, ++l)
    if (m & 1u) v = apply_cols(p.shift[l], v);
  if (p.tail) v = apply_cols(p.shift_tail, v);
  if (bi == p.nb - 1) {
    const uint8_t* tb = p.rows + frow * p.pitch + (long long)p.units * 32;
    uint32_t t = 0;
    for (int i = 0; i < p.tail; ++i) t = (t >> 8) ^ tab[0][(t ^ tb[i]) & 0xFF];
    v ^= t ^ (p.regs ? apply_cols(p.shift_len, (uint32_t)p.regs[frow])
                     : p.add);
  }
  if (p.nb == 1)
    p.out[frow] = (long long)v;
  else
    atomicXor(reinterpret_cast<unsigned long long*>(p.out + frow),
              (unsigned long long)v);
}

// ------------------------------------------------------------------ xxhash

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

// CRC-32C of B rows. plan: units, tail, seg, pad, log_sblk, nb, levels,
// add; cols: (levels + 2) x 32 column words (level matrices, the tail's
// shift, the length's shift). vec: 16, 8 or 1 (the load width the row
// starts and pitch allow). regs: null, or B int64 seeds.
extern "C" int crc32c_rows(const void* rows, long long pitch, void* out,
                           const void* regs, int B, const int* plan,
                           const uint32_t* cols, int vec, void* stream) {
  const int levels = plan[6];
  if (levels > kMaxLevels || (vec != 16 && vec != 8 && vec != 1))
    return (int)cudaErrorInvalidValue;
  CrcParams p;
  p.rows = static_cast<const uint8_t*>(rows);
  p.pitch = pitch;
  p.out = static_cast<long long*>(out);
  p.regs = static_cast<const long long*>(regs);
  p.B = B;
  p.units = plan[0];
  p.tail = plan[1];
  p.seg = plan[2];
  p.pad = plan[3];
  p.log_sblk = plan[4];
  p.nb = plan[5];
  p.add = (uint32_t)plan[7];
  for (int l = 0; l < kMaxLevels; ++l)
    for (int b = 0; b < 32; ++b) p.shift[l][b] = l < levels ? cols[32 * l + b] : 0u;
  for (int b = 0; b < 32; ++b) {
    p.shift_tail[b] = cols[32 * levels + b];
    p.shift_len[b] = cols[32 * (levels + 1) + b];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.nb > 1) {
    const cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(long long) * B, s);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long groups = (B + (kThreads >> p.log_sblk) - 1)
                           / (kThreads >> p.log_sblk);
  const dim3 grid((unsigned)(groups * p.nb));
  if (vec == 16) crc32c_kernel<16><<<grid, kThreads, 0, s>>>(p);
  else if (vec == 8) crc32c_kernel<8><<<grid, kThreads, 0, s>>>(p);
  else crc32c_kernel<1><<<grid, kThreads, 0, s>>>(p);
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
