// Batched static-matrix GF(2^8) apply for Hopper (sm_90a):
//   out[b, i, :] = XOR_j matrix[i, j] (x) in[b, j, :]   over GF(2^8)/0x11D
// in (B, k, L) uint8, out (B, m, L) uint8, any L >= 0.
//
// Replaces ceph_tpu/ops/pallas_gf.py::_kernel_body (launched by
// _build(...).apply through apply_matrix_pallas). It computes the same
// SWAR bit-linear form on 32-bit words of 4 field bytes:
//   c (x) x == XOR_{b: bit b of x set} (c * 2^b)
//   v = (w >> b) & 0x01010101,  mask = (v << 8) - v   (per-byte 0x00/0xFF)
//   acc[i] ^= mask & coef[i][j][b],  coef = (matrix[i,j] * 2^b) * 0x01010101
// The TPU kernel baked the coefficients into the program and tiled the
// rows into (64, 512) u32 slabs for the VPU. Here the coefficients are
// data: the wrapper uploads them once per (matrix, device) as an
// (m, k, 8) uint32 table, and each block stages the table of its row
// group in shared memory as [j][b][i], so that one (j, b) step reads MT
// broadcast words. The table is staged kc input rows at a time, kc
// chosen by the wrapper to fit a fixed shared-memory budget (48 KiB),
// so any k launches: Clay's matrices reach k = 2560 (640 KiB of words
// for a row group at k=10 m=4 d=13). When kc >= k the table stays
// resident for the whole row group; otherwise every tile of row places
// walks the stages, with __syncthreads() around each restage, and the
// accumulators stay in registers across stages. Each thread owns one
// 16-byte word (uint4) of one object row position, loops over the k
// input rows and 8 bits, and keeps MT accumulators per lane in
// registers. Rows whose length is not a multiple
// of 16 bytes (or misaligned pointers) take the 4-byte-word instance.
// Rows whose length is not a multiple of 4 bytes (the RMW delta windows,
// any length) do not start on a word boundary past row 0, so the same
// instance then assembles each thread's 4-byte word from byte loads and
// stores its bytes one by one; the last word of a row holds L % 4 bytes,
// the rest of it is zero in and dropped out. The GF math is the same
// SWAR word form in every instance, and no padded copy is made.
// m > 8 runs in row groups of 8 inside the one launch (the input is read
// once per group); the last group's missing rows have zero coefficients
// and are not stored.
//
// Bound on the H100 (SXM, 700 W): the function moves B*(k+m)*L bytes
// through HBM at 3.35 TB/s, which for RS k=8 m=3 over a batch of 32
// 4 MiB objects is 55 us; that is the least time the card could take
// (a bit-plane product on the int8 tensor cores would need only 26 us
// of operations). This design does about 8*(3+m) 32-bit integer
// operations per 4 input bytes: shift, and, and the mask (shift + sub,
// or one multiply) per (j, b), then one AND+XOR per output row, which
// one LOP3 can do. At 64 int32 results per clock per SM (132 SMs,
// 1.98 GHz; 16.7 Tops/s) that is 96 us for the same batch, so the
// design runs into the integer ALUs before the memory. It keeps all
// temporaries in registers and touches HBM exactly once per byte;
// fewer operations per byte (byte-permute nibble tables, or the
// tensor-core bit-plane product) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Stage the coefficient words of input rows [j0, j0 + jn) of row group
// g into sc as [j - j0][b][i]; rows past m get zero words. Every thread
// of the block calls it (it holds two barriers).
template <int MT>
__device__ void stage(uint32_t* sc, const uint32_t* __restrict__ coefs,
                      int g, int m, int k, int j0, int jn) {
  __syncthreads();  // the block is done with the previous stage
  const int n = jn * 8 * MT;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    const int row = g + t % MT;
    const int jb = t / MT;  // (j - j0) * 8 + b
    sc[t] = row < m ? coefs[((long long)row * k + j0) * 8 + jb] : 0u;
  }
  __syncthreads();
}

// One block walks row groups, objects (grid y) and tiles of row places
// (grid x, grid-stride). Loop bounds are uniform across the block, so
// every thread reaches the barriers of each stage; threads past the end
// of a row only skip the loads, the math and the stores.
template <int MT, int VEC>
__global__ void __launch_bounds__(256)
gf_apply_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                const uint32_t* __restrict__ coefs,  // (m, k, 8)
                int B, int k, int m, long long L, int kc) {
  typedef Words<VEC> W;
  constexpr int NW = W::NW;
  extern __shared__ uint32_t sc[];  // [j - j0][b][i], kc * 8 * MT words
  const long long places = W::places(L);
  const bool resident = kc >= k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int g = 0; g < m; g += MT) {
    if (resident) stage<MT>(sc, coefs, g, m, k, 0, k);
    for (long long b = blockIdx.y; b < B; b += gridDim.y) {
      const uint8_t* xb = in + b * k * L;
      uint8_t* yb = out + (b * m + g) * L;
      for (long long p0 = (long long)blockIdx.x * blockDim.x; p0 < places;
           p0 += stride) {
        const long long p = p0 + threadIdx.x;
        const bool active = p < places;
        uint32_t acc[MT][NW];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < NW; ++e) acc[i][e] = 0u;
        for (int j0 = 0; j0 < k; j0 += kc) {
          const int jn = k - j0 < kc ? k - j0 : kc;
          if (!resident) stage<MT>(sc, coefs, g, m, k, j0, jn);
          if (!active) continue;
#pragma unroll 2
          for (int j = 0; j < jn; ++j) {
            uint32_t x[NW];
            W::load(xb + (long long)(j0 + j) * L, p, L, x);
            const uint32_t* cj = sc + j * 8 * MT;
#pragma unroll
            for (int bit = 0; bit < 8; ++bit) {
              uint32_t c[MT];
#pragma unroll
              for (int i = 0; i < MT; ++i) c[i] = cj[bit * MT + i];
#pragma unroll
              for (int e = 0; e < NW; ++e) {
                const uint32_t v = (x[e] >> bit) & 0x01010101u;
                const uint32_t mask = (v << 8) - v;
#pragma unroll
                for (int i = 0; i < MT; ++i) acc[i][e] ^= mask & c[i];
              }
            }
          }
        }
        if (!active) continue;
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (g + i < m) W::store(yb + i * L, p, L, acc[i]);
      }
    }
  }
}

template <int MT, int VEC>
cudaError_t launch(const void* in, void* out, const void* coefs, int B,
                   int k, int m, long long L, int kc, cudaStream_t stream) {
  const long long places = VEC == 4 ? L / 16 : VEC == 1 ? L / 4
                                                        : (L + 3) / 4;
  const int threads = 256;
  // kc * 8 * MT words fit the default 48 KiB a block may take (the
  // wrapper's budget), so no launch needs the opt-in attribute
  const int rows = kc < k ? kc : (k > 0 ? k : 1);
  const size_t smem = (size_t)rows * 8 * MT * sizeof(uint32_t);
  long long gx = (places + threads - 1) / threads;
  if (gx > 0x7fffffffLL) gx = 0x7fffffffLL;
  const unsigned gy = B < 65535 ? (unsigned)B : 65535u;
  gf_apply_kernel<MT, VEC><<<dim3((unsigned)gx, gy), threads, smem,
                             stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out),
      static_cast<const uint32_t*>(coefs), B, k, m, L, kc);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const void* in, void* out, const void* coefs, int B,
                     int k, int m, long long L, int kc, cudaStream_t s) {
  switch (m) {
    case 1: return launch<1, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 2: return launch<2, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 3: return launch<3, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 4: return launch<4, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 5: return launch<5, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 6: return launch<6, VEC>(in, out, coefs, B, k, m, L, kc, s);
    case 7: return launch<7, VEC>(in, out, coefs, B, k, m, L, kc, s);
    default: return launch<8, VEC>(in, out, coefs, B, k, m, L, kc, s);
  }
}

}  // namespace

// vec = 4: L % 16 == 0 and 16-byte aligned pointers; vec = 1: L % 4 == 0
// and 4-byte aligned pointers; vec = 0: any L (byte loads and stores).
// kc: input rows whose coefficient words a block stages at once
// (kc * 8 * min(m, 8) words of shared memory; kc >= k keeps the whole
// table resident). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int gf_apply(const void* in, void* out, const void* coefs, int B,
                        int k, int m, long long L, int vec, int kc,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || L <= 0 || k < 0 || kc <= 0)
    return (int)cudaErrorInvalidValue;
  if (vec == 4) return (int)dispatch<4>(in, out, coefs, B, k, m, L, kc, s);
  if (vec == 1) return (int)dispatch<1>(in, out, coefs, B, k, m, L, kc, s);
  if (vec == 0) return (int)dispatch<0>(in, out, coefs, B, k, m, L, kc, s);
  return (int)cudaErrorInvalidValue;
}
