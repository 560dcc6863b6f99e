// Batched static-matrix GF(2^8) apply for Hopper (sm_90a):
//   out[b, i, :] = XOR_j matrix[i, j] (x) in[b, j, :]   over GF(2^8)/0x11D
// in (B, k, L) uint8, out (B, m, L) uint8, any L >= 0.
//
// Replaces ceph_tpu/ops/pallas_gf.py::_kernel_body (launched by
// _build(...).apply through apply_matrix_pallas). It computes the same
// SWAR bit-linear form on 32-bit words of 4 field bytes:
//   c (x) x == XOR_{b: bit b of x set} (c * 2^b)
//   mask_b = per-byte 0xFF where bit b of the byte is set
//   acc[i] ^= mask_b & coef[i][j][b],  coef = (matrix[i,j] * 2^b) * 0x01010101
//
// The schedule. The TPU kernel skipped zero columns and zero
// coefficients while it traced (pallas_gf.py:72-85). The wrapper
// (ops/gf_kernel.py::compile_schedule) does the same once per matrix,
// with numpy, and keeps the result on the device: the output rows are
// cut into row groups of MT (1, 2, 4 or 8) rows; for each group, the
// ascending input rows j with any non-zero coefficient in the group
// ("entries", packed as j << 8 | an MT-bit mask of the group's non-zero
// rows), and for each entry, for each row of its mask in ascending
// order, the 8 words coef[i][j][0..7] (two 16-byte loads). A group's
// entries are cut into chunks of at most 96 KiB of words. Clay k=8 m=4
// d=11's matrices are 4.8-9.2 % non-zero: its encode walks 4,480
// entries and 6,272 row words where a dense loop walks 16,384 of each.
//
// The grid. Blocks of 128 threads over (row group, tile of 128 places,
// object), row group fastest, so the groups that read one tile of an
// object's input run side by side and all but the first find it in the
// 50 MB L2. The grid is cut to about 4 waves of 8 blocks per SM; a block
// keeps its row group and walks further tiles, and stages a group of one
// chunk only once. Each thread owns one place of a row (a 16-byte word,
// uint4, where rows allow) and keeps MT accumulators per word in
// registers. For each entry it makes the eight byte masks of its input
// word once, 2 operations each (a shift that brings bit b of every byte
// to bit 7, which the compiler issues as IMAD.SHL on the FMA pipe, then
// PRMT's sign-replicate mode, which spreads bit 7 over the byte on the
// integer pipe; 1 at b = 7), and does 8 AND+XORs (one LOP3 each) for
// each row whose mask bit is set. That branch is uniform across the
// block: every thread walks the same entry. The input words of the next
// two entries are in flight during an entry's math; a block's group
// record (three 16-byte loads) holds its first three entries and its
// first chunk, so the first input loads wait on one load only.
// Coefficient words come from shared memory (SMEM = true: a chunk staged
// in cw * 4 bytes of dynamic shared memory, past 48 KiB by opt-in, a
// barrier on each side) where the largest chunk passes 512 bytes (the
// wrapper's stages(); Clay's, RS k=8 m=3's encode), else from global
// memory through L1. The wrapper compiles the schedule, its device
// arrays and the launch record the entry point reads (addresses, sizes,
// the SM count) once per matrix, so a launch's host work is one ctypes
// call of seven arguments.
// Rows whose length is not a multiple of 16 bytes (or misaligned
// pointers) take the 4-byte-word instance; rows whose length is not a
// multiple of 4 (the RMW delta windows, any length) assemble each
// thread's 4-byte word from byte loads and store its bytes one by one,
// the last word holding L % 4 bytes. No padded copy is made.
//
// Bound and model on the H100 (SXM, 700 W): the function moves
// B*(k+m)*L bytes through HBM at 3.35 TB/s (55 us for RS k=8 m=3 over
// 32 objects of 4 MiB). Per 4 input bytes and row group the design
// issues 8 PRMT and 7 IMAD.SHL per entry and 8 LOP3 per non-zero
// coefficient. The integer pipe does 64 results per clock per SM (132
// SMs, 1.98 GHz: 16.7 Tops/s): 32 per word at RS k=8 m=3, 64 us for the
// same batch, above the bytes bound; per 16-byte place of Clay's encode
// 4,480*32 + 6,272*32 = 344k, 0.34 ms for 32 objects of 64 sub-chunks of
// 8 KiB. Measured on the card (PERF.md, chip_smoke.py phase 4), the RS
// shapes run at about 0.098 ms of device time (1.9 TB/s), the dense
// design's time, with neither the integer pipe (about 65 %) nor HBM
// filled; Clay's shapes run 20-28x faster than the dense design.
//
// Decided from arithmetic: tensor cores. A dense int8 bit-plane product
// of Clay's encode is 2*2048*4096*262144 = 4.4e12 operations, 2.2 ms at
// 1,979 Tops/s, over six times the sparse model; at RS k=8 m=3 the
// product is cheap but packing its 8*m int32 accumulators of each byte
// column back into bytes takes shuffles across the fragment's threads
// that cost more per byte than the 32 SWAR operations. Tried while the
// design was made and dropped, none faster at the RS shapes: cp.async
// staging of the input rows (a ring of 4 places a thread in shared
// memory; slower at Clay's), two places a thread, 256-thread blocks,
// the whole schedule in the kernel's parameters (the constant bank;
// several times slower), group 0's record in the parameters (Clay 9 %
// slower) and an entry's global coefficient loads all issued before its
// math (RS decode 10 %, SHEC 25 % slower).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Threads of a block; blocks the grid aims at per SM, and waves of them.
constexpr int kThreads = 128, kBlocksPerSM = 8, kWaves = 4;

// How one thread reads and writes its place in a row: NW 32-bit words
// of field bytes. Rows are byte pointers; `p` counts places in a row.
template <int VEC> struct Words;
template <> struct Words<4> {              // 16 bytes, 16-byte aligned rows
  static constexpr int NW = 4;
  __device__ static long long places(long long L) { return L / 16; }
  __device__ static void load(const uint8_t* row, long long p, long long,
                              uint32_t* w) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ static void store(uint8_t* row, long long p, long long,
                               const uint32_t* w) {
    reinterpret_cast<uint4*>(row)[p] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Words<1> {              // 4 bytes, 4-byte aligned rows
  static constexpr int NW = 1;
  __device__ static long long places(long long L) { return L / 4; }
  __device__ static void load(const uint8_t* row, long long p, long long,
                              uint32_t* w) {
    w[0] = __ldg(reinterpret_cast<const uint32_t*>(row) + p);
  }
  __device__ static void store(uint8_t* row, long long p, long long,
                               const uint32_t* w) {
    reinterpret_cast<uint32_t*>(row)[p] = w[0];
  }
};
template <> struct Words<0> {              // 4 bytes, rows of any length
  static constexpr int NW = 1;
  __device__ static long long places(long long L) { return (L + 3) / 4; }
  __device__ static void load(const uint8_t* row, long long p, long long L,
                              uint32_t* w) {
    const long long q = 4 * p;
    uint32_t x = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (q + e < L) x |= (uint32_t)__ldg(row + q + e) << (8 * e);
    w[0] = x;
  }
  __device__ static void store(uint8_t* row, long long p, long long L,
                               const uint32_t* w) {
    const long long q = 4 * p;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (q + e < L) row[q + e] = (uint8_t)(w[0] >> (8 * e));
  }
};

// Bit 7 of each byte of x spread over the byte (PRMT sign-replicate).
__device__ __forceinline__ uint32_t spread7(uint32_t x) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %1, 0xBA98;" : "=r"(r) : "r"(x));
  return r;
}

// The compiled schedule (ops/gf_kernel.py::compile_schedule).
struct Schedule {
  const uint32_t* words;  // row words of entries, chunk by chunk
  const int* ent;         // entry -> j << 8 | row mask
  const int* cent;        // chunk -> first entry (chunks + 1)
  const int* cwo;         // chunk -> first word (chunks + 1)
  const int4* grp;        // group -> 3 int4: (first chunk, end chunk,
                          // first entry, end entry), the first three
                          // entries' ent, (first chunk's first word,
                          // end word, end entry)
  int groups;
};

// Masks of bits 0..7 of the NW words x, then acc[i] ^= mask_b & coef for
// the rows i of `msk`, their 8 words (two uint4) each at c in turn.
template <int MT, int NW, bool SMEM>
__device__ __forceinline__ void entry(const uint32_t* x, int msk,
                                      const uint4* c,
                                      uint32_t (&acc)[MT][NW]) {
  uint32_t mk[8][NW];
#pragma unroll
  for (int bit = 0; bit < 8; ++bit)
#pragma unroll
    for (int w = 0; w < NW; ++w)
      mk[bit][w] = spread7(x[w] << (7 - bit));
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (!((msk >> i) & 1)) continue;
    const uint4 lo = SMEM ? c[0] : __ldg(c), hi = SMEM ? c[1] : __ldg(c + 1);
    c += 2;
    const uint32_t cb[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int bit = 0; bit < 8; ++bit)
#pragma unroll
      for (int w = 0; w < NW; ++w) acc[i][w] ^= mk[bit][w] & cb[bit];
  }
}

// Stage n4 uint4 of coefficient words in shared memory. Every thread of
// the block calls it (it holds two barriers).
__device__ __forceinline__ void stage(uint4* chunk4, const uint4* src,
                                      int n4) {
  __syncthreads();  // the block is done with the previous chunk
  for (int t = threadIdx.x; t < n4; t += kThreads)
    chunk4[t] = __ldg(src + t);
  __syncthreads();
}

// One block: row group g = blockIdx.x % groups, tiles of kThreads places
// blockIdx.x / groups + i * gridDim.x / groups, objects
// blockIdx.y + i * gridDim.y. All loop bounds and every
// branch around a barrier are uniform across the block; threads past
// the end of a row skip only the loads, the math and the stores.
template <int MT, int VEC, bool SMEM>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                const Schedule sc, int B, int k, int m, long long L) {
  typedef Words<VEC> W;
  constexpr int NW = W::NW;
  extern __shared__ uint4 chunk4[];  // one chunk of coefficient words
  const long long places = W::places(L);
  const long long tiles = (places + kThreads - 1) / kThreads;
  const uint4* words4 = reinterpret_cast<const uint4*>(sc.words);
  // gridDim.x is a multiple of groups: a block keeps its row group over
  // all its tiles, and stages a group of one chunk only once, after the
  // first tile's input loads are on their way
  const int g = (int)(blockIdx.x % (unsigned)sc.groups);
  const int4 gr = __ldg(sc.grp + 3 * g);      // chunks, entries
  const int4 gm = __ldg(sc.grp + 3 * g + 1);  // the first three entries
  const int4 gw = __ldg(sc.grp + 3 * g + 2);  // first chunk: words, end
  const int e1 = gr.w;
  const bool once = SMEM && gr.y - gr.x == 1;
  bool staged = false;
  const int tile0 = (int)(blockIdx.x / (unsigned)sc.groups);
  const int tile_step = (int)(gridDim.x / (unsigned)sc.groups);
  for (long long t = tile0; t < tiles; t += tile_step) {
    const long long p = t * kThreads + threadIdx.x;
    const bool on = p < places;
    for (long long b = blockIdx.y; b < B; b += gridDim.y) {
      const uint8_t* obj = in + b * k * L;
      uint32_t acc[MT][NW];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int w = 0; w < NW; ++w) acc[i][w] = 0u;
      // the input words of the next two entries are in flight during an
      // entry's math (xa, xb), and the metadata of the one after them
      // (entries e .. e + 2: m0, m1, m2)
      int e = gr.z, m0 = gm.x, m1 = gm.y, m2 = gm.z;
      uint32_t xa[NW], xb[NW];
      if (on && e < e1) W::load(obj + (long long)(m0 >> 8) * L, p, L, xa);
      if (on && e + 1 < e1)
        W::load(obj + (long long)(m1 >> 8) * L, p, L, xb);
      if (once && !staged) {
        stage(chunk4, words4 + gw.x / 4, (gw.y - gw.x) / 4);
        staged = true;
      }
      for (int c = gr.x; c < gr.y; ++c) {
        const bool first = c == gr.x;
        const int eb = first ? gw.z : __ldg(sc.cent + c + 1);
        const int w0 = first ? gw.x : __ldg(sc.cwo + c);
        const uint4* cws = SMEM ? chunk4 : words4 + w0 / 4;
        if (SMEM && !once)
          stage(chunk4, words4 + w0 / 4,
                ((first ? gw.y : __ldg(sc.cwo + c + 1)) - w0) / 4);
        for (; e < eb; ++e) {
          const int msk = m0 & 0xff;
          m0 = m1;
          m1 = m2;
          if (e + 3 < e1) m2 = __ldg(sc.ent + e + 3);
          uint32_t x[NW];
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            x[w] = xa[w];
            xa[w] = xb[w];
          }
          if (on && e + 2 < e1)
            W::load(obj + (long long)(m1 >> 8) * L, p, L, xb);
          if (on) entry<MT, NW, SMEM>(x, msk, cws, acc);
          cws += 2 * __popc(msk);
        }
      }
      if (!on) continue;
      uint8_t* yb = out + (b * m + (long long)g * MT) * L;
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (g * MT + i < m) W::store(yb + i * L, p, L, acc[i]);
    }
  }
}

template <int MT, int VEC, bool SMEM>
cudaError_t launch(const void* in, void* out, const Schedule& sc, int B,
                   int k, int m, long long L, int cw, int sms,
                   cudaStream_t stream) {
  const long long places = VEC == 4 ? L / 16 : VEC == 1 ? L / 4
                                                        : (L + 3) / 4;
  const size_t smem = SMEM ? (size_t)cw * sizeof(uint32_t) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        gf_apply_kernel<MT, VEC, SMEM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  // about kWaves waves of kBlocksPerSM blocks on every SM; a block walks
  // the rest of its group's tiles
  const unsigned gy = B < 65535 ? (unsigned)B : 65535u;
  const long long tiles = (places + kThreads - 1) / kThreads;
  const long long column = (long long)sc.groups * gy;  // blocks a tile
  long long per = ((long long)sms * kBlocksPerSM * kWaves + column - 1) /
                  column;
  if (per > tiles) per = tiles;
  if (per < 1) per = 1;
  if (per > 0x7fffffffLL / sc.groups) per = 0x7fffffffLL / sc.groups;
  const long long gx = sc.groups * per;
  gf_apply_kernel<MT, VEC, SMEM><<<dim3((unsigned)gx, gy), kThreads, smem,
                                   stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), sc, B, k,
      m, L);
  return cudaGetLastError();
}

template <int VEC, bool SMEM>
cudaError_t by_mt(int mt, const void* in, void* out, const Schedule& sc,
                  int B, int k, int m, long long L, int cw, int sms,
                  cudaStream_t s) {
  switch (mt) {
    case 1: return launch<1, VEC, SMEM>(in, out, sc, B, k, m, L, cw, sms, s);
    case 2: return launch<2, VEC, SMEM>(in, out, sc, B, k, m, L, cw, sms, s);
    case 4: return launch<4, VEC, SMEM>(in, out, sc, B, k, m, L, cw, sms, s);
    case 8: return launch<8, VEC, SMEM>(in, out, sc, B, k, m, L, cw, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool SMEM>
cudaError_t by_vec(int vec, int mt, const void* in, void* out,
                   const Schedule& sc, int B, int k, int m, long long L,
                   int cw, int sms, cudaStream_t s) {
  switch (vec) {
    case 4: return by_mt<4, SMEM>(mt, in, out, sc, B, k, m, L, cw, sms, s);
    case 1: return by_mt<1, SMEM>(mt, in, out, sc, B, k, m, L, cw, sms, s);
    case 0: return by_mt<0, SMEM>(mt, in, out, sc, B, k, m, L, cw, sms, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// vec = 4: L % 16 == 0 and 16-byte aligned pointers; vec = 1: L % 4 == 0
// and 4-byte aligned pointers; vec = 0: any L (byte loads and stores).
// rec is the schedule's launch record, 12 int64 the wrapper keeps with
// the compiled schedule on the device: the addresses of words, ent, cent
// and cwo (chunks + 1 each) and grp (groups x 12), words 16-byte aligned;
// then k and m of the matrix; mt, the rows per group (1, 2, 4 or 8);
// groups = ceil(m / mt); cw, the largest chunk's words (a multiple of
// 8); smem, nonzero to stage each chunk's words in cw words of shared
// memory, else read from global memory; and the device's SM count.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gf_apply(const void* in, void* out, const long long* rec,
                        int B, long long L, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k = (int)rec[5], m = (int)rec[6], mt = (int)rec[7],
            groups = (int)rec[8], cw = (int)rec[9], smem = (int)rec[10],
            sms = (int)rec[11];
  if (B <= 0 || m <= 0 || L <= 0 || k < 0 || groups <= 0 ||
      (long long)groups * mt < m || cw < 0 || cw % 8 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Schedule sc = {reinterpret_cast<const uint32_t*>(rec[0]),
                       reinterpret_cast<const int*>(rec[1]),
                       reinterpret_cast<const int*>(rec[2]),
                       reinterpret_cast<const int*>(rec[3]),
                       reinterpret_cast<const int4*>(rec[4]), groups};
  if (smem)
    return (int)by_vec<true>(vec, mt, in, out, sc, B, k, m, L, cw, sms, s);
  return (int)by_vec<false>(vec, mt, in, out, sc, B, k, m, L, cw, sms, s);
}
