// Batched static-matrix GF(2^8) apply for Hopper (sm_90a):
//   out[b, i, :] = XOR_j matrix[i, j] (x) in[b, j, :]   over GF(2^8)/0x11D
// in (B, k, L) uint8, out (B, m, L) uint8, L % 4 == 0.
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
// broadcast words. Each thread owns one 16-byte word (uint4) of one object
// row position, loops over the k input rows and 8 bits, and keeps MT
// accumulators per lane in registers. Rows whose length is not a multiple
// of 16 bytes (or misaligned pointers) take the 4-byte-word instance.
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

template <int VEC> struct Words;
template <> struct Words<4> {
  typedef uint4 T;
  __device__ static void unpack(const uint4 v, uint32_t* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  __device__ static uint4 pack(const uint32_t* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Words<1> {
  typedef uint32_t T;
  __device__ static void unpack(const uint32_t v, uint32_t* w) { w[0] = v; }
  __device__ static uint32_t pack(const uint32_t* w) { return w[0]; }
};

// One block stages the (k, 8, MT) coefficient words of one row group
// and walks objects (grid y) and row positions (grid x, grid-stride).
template <int MT, int VEC>
__global__ void __launch_bounds__(256)
gf_apply_kernel(const typename Words<VEC>::T* __restrict__ in,
                typename Words<VEC>::T* __restrict__ out,
                const uint32_t* __restrict__ coefs,  // (m, k, 8)
                int B, int k, int m, long long row_vecs) {
  typedef Words<VEC> W;
  extern __shared__ uint32_t sc[];  // [j][b][i], k * 8 * MT words
  const long long in_obj = (long long)k * row_vecs;
  const long long out_obj = (long long)m * row_vecs;
  const int n_coef = k * 8 * MT;
  for (int g = 0; g < m; g += MT) {
    __syncthreads();
    for (int t = threadIdx.x; t < n_coef; t += blockDim.x) {
      const int row = g + t % MT;
      const int jb = t / MT;
      sc[t] = row < m ? coefs[(long long)row * k * 8 + jb] : 0u;
    }
    __syncthreads();
    for (long long b = blockIdx.y; b < B; b += gridDim.y) {
      const typename W::T* xb = in + b * in_obj;
      typename W::T* yb = out + b * out_obj + (long long)g * row_vecs;
      for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
           p < row_vecs; p += (long long)gridDim.x * blockDim.x) {
        uint32_t acc[MT][VEC];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = 0u;
#pragma unroll 2
        for (int j = 0; j < k; ++j) {
          uint32_t x[VEC];
          W::unpack(__ldg(xb + (long long)j * row_vecs + p), x);
          const uint32_t* cj = sc + j * 8 * MT;
#pragma unroll
          for (int bit = 0; bit < 8; ++bit) {
            uint32_t c[MT];
#pragma unroll
            for (int i = 0; i < MT; ++i) c[i] = cj[bit * MT + i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const uint32_t v = (x[e] >> bit) & 0x01010101u;
              const uint32_t mask = (v << 8) - v;
#pragma unroll
              for (int i = 0; i < MT; ++i) acc[i][e] ^= mask & c[i];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (g + i < m) yb[(long long)i * row_vecs + p] = W::pack(acc[i]);
      }
    }
  }
}

template <int MT, int VEC>
cudaError_t launch(const void* in, void* out, const void* coefs, int B,
                   int k, int m, long long L, cudaStream_t stream) {
  typedef typename Words<VEC>::T T;
  const long long row_vecs = L / (4 * VEC);
  const int threads = 256;
  const size_t smem = (size_t)k * 8 * MT * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_apply_kernel<MT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  long long gx = (row_vecs + threads - 1) / threads;
  if (gx > 0x7fffffffLL) gx = 0x7fffffffLL;
  const unsigned gy = B < 65535 ? (unsigned)B : 65535u;
  gf_apply_kernel<MT, VEC><<<dim3((unsigned)gx, gy), threads, smem,
                             stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out),
      static_cast<const uint32_t*>(coefs), B, k, m, row_vecs);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch(const void* in, void* out, const void* coefs, int B,
                     int k, int m, long long L, cudaStream_t s) {
  switch (m) {
    case 1: return launch<1, VEC>(in, out, coefs, B, k, m, L, s);
    case 2: return launch<2, VEC>(in, out, coefs, B, k, m, L, s);
    case 3: return launch<3, VEC>(in, out, coefs, B, k, m, L, s);
    case 4: return launch<4, VEC>(in, out, coefs, B, k, m, L, s);
    case 5: return launch<5, VEC>(in, out, coefs, B, k, m, L, s);
    case 6: return launch<6, VEC>(in, out, coefs, B, k, m, L, s);
    case 7: return launch<7, VEC>(in, out, coefs, B, k, m, L, s);
    default: return launch<8, VEC>(in, out, coefs, B, k, m, L, s);
  }
}

}  // namespace

// vec = 4: L % 16 == 0 and 16-byte aligned pointers; vec = 1: 4-byte
// words. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gf_apply(const void* in, void* out, const void* coefs, int B,
                        int k, int m, long long L, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || m <= 0 || L <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (vec == 4) return (int)dispatch<4>(in, out, coefs, B, k, m, L, s);
  if (vec == 1) return (int)dispatch<1>(in, out, coefs, B, k, m, L, s);
  return (int)cudaErrorInvalidValue;
}
