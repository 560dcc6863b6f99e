// Batched XOR fold for Hopper (sm_90a):
//   out[o, :] = in[o, 0, :] ^ in[o, 1, :] ^ ... ^ in[o, H - 1, :]
// in (outer, H, inner) uint8 with strides (bs, rs, 1), out a fresh
// contiguous (outer, inner) uint8. Any outer, H >= 1, inner >= 1.
//
// Replaces the torch loop in ops/rs_kernels.py::xor_reduce on CUDA
// tensors (the clone of the first row, then `acc ^= p` once for each
// further row). The JAX package folds in one fused XLA pass,
// `jnp.bitwise_xor.reduce(stack, axis=1)` in ceph_tpu/osd/ecbackend.py
// (_build_recover_program, line 2045); the port's recovery program
// (osd/ecbackend.py::_build_recover_program's `fold`) folds the helper
// stack before its CRC verifies it against the helpers' hinfo CRCs.
// The torch loop made 2 + 3 (H - 1) row passes where H + 1 do: every
// `acc ^= p` reads a (B, rl) view with stride H * rl, which ATen walks
// with its non-vectorised elementwise kernel, a byte an element a
// thread.
//
// Bound on the H100 (SXM, 700 W): the fold reads each of the
// outer * H * inner input bytes once and writes the outer * inner
// output bytes once, (H + 1) row-bytes through HBM at 3.35 TB/s: 0.180
// ms for the recovery program at RS k=8 m=3 (128 objects, 8 helper rows
// of 512 KiB), 0.060 ms at Clay k=8 m=4 d=11's repair (128 objects, 11
// helpers' 16 shipped planes of 8 KiB). One XOR per 16 input bytes is
// nothing beside that: the kernel is a streaming reduction and its only
// task is to keep enough loads in flight.
//
// The design. One thread owns one place of the output: 16 bytes
// (uint4) where both addresses, both strides and `inner` are multiples
// of 16, else 1 byte (ragged rows, such as 4,093-byte windows or odd
// sub-chunks, or a view that starts off the 16-byte grid;
// ops/fold_kernel.py::place_bytes picks the width from the input). A
// scalar head and tail around a 16-byte body would not serve ragged
// rows: packed rows of 4,093 bytes each start at their own offset from
// the grid, so no 16-byte column lines up in all H rows. In the byte
// instance a warp's load of one row is 32 contiguous bytes, one sector,
// so it reads no byte twice from HBM: 0.0390 ms at (2048, 8, 4093) -> 1,
// 57.7 % of the bound, against 0.2027 ms for the torch loop (the card
// named below). For its place a thread issues all H loads
// through the read-only path (ld.global.nc, __ldg) before the first
// XOR, so it has H * 16 bytes in flight; it XORs them in registers and
// makes one store. H up to 16 is a template parameter, unrolled; a
// larger H runs groups of 16 loads, then the rest one by one. Threads
// walk the flat (outer * inner / place) places in address order,
// neighbouring threads on neighbouring places of one row, so a warp's
// load of one helper row is 512 contiguous bytes. The grid is one wave
// of as many blocks as the SMs hold at once (the occupancy query), each
// thread striding by the grid's width: the card reads the stack front
// to back once, and what a preceding kernel (gf_apply's decode of the
// same stack) left in L2 is the stack's end, evicted before the fold
// gets there, so no L2 hit is counted as HBM bytes. Launch geometry
// depends only on the shape, the place width, the SM count and the
// kernel's occupancy: 32-40 registers a thread at H <= 16 (56 for the
// loop), 256-thread blocks.
//
// Measured on the card (PERF.md, chip_smoke.py --fold-times, "NVIDIA
// H100 80GB HBM3, 700.00 W"): 0.2010 ms of device time at
// (128, 8, 524288) -> 1, 89.7 % of the bound, and 0.0689 ms at
// (128, 11, 131072) -> 1, 87.2 %, against 1.462 and 0.533 ms for the
// torch loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// How one thread reads, XORs and writes its place of PB bytes.
template <int PB> struct Place;
template <> struct Place<16> {
  typedef uint4 T;
  __device__ static T load(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void fold(T& a, const T& b) {
    a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
  }
  __device__ static void store(uint8_t* p, const T& v) {
    *reinterpret_cast<uint4*>(p) = v;
  }
};
template <> struct Place<1> {
  typedef uint8_t T;
  __device__ static T load(const uint8_t* p) { return __ldg(p); }
  __device__ static void fold(T& a, const T& b) { a ^= b; }
  __device__ static void store(uint8_t* p, const T& v) { *p = v; }
};

// The XOR of HT rows of one place, rs bytes apart: all HT loads are
// issued before the first XOR.
template <int PB, int HT>
__device__ __forceinline__ typename Place<PB>::T fold_rows(
    const uint8_t* src, long long rs) {
  typedef Place<PB> P;
  typename P::T r[HT];
#pragma unroll
  for (int h = 0; h < HT; ++h) r[h] = P::load(src + h * rs);
#pragma unroll
  for (int h = 1; h < HT; ++h) P::fold(r[0], r[h]);
  return r[0];
}

// HT = H for H <= 16; HT = 0 reads H (> 16) at run time.
template <int PB, int HT>
__global__ void __launch_bounds__(kThreads)
xor_fold_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                long long outer, int H, long long inner, long long bs,
                long long rs) {
  typedef Place<PB> P;
  const long long row = inner / PB;                 // places a row
  const long long n = outer * row;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= n) return;
  const long long step = (long long)gridDim.x * kThreads;
  const long long step_o = step / row, step_c = step % row;
  long long o = v / row, c = v % row;
  for (; v < n; v += step) {
    const uint8_t* src = in + o * bs + c * PB;
    typename P::T acc;
    if (HT > 0) {
      acc = fold_rows<PB, (HT > 0 ? HT : 1)>(src, rs);
    } else {
      acc = fold_rows<PB, 16>(src, rs);
      int h = 16;
      for (; h + 16 <= H; h += 16)
        P::fold(acc, fold_rows<PB, 16>(src + h * rs, rs));
      for (; h < H; ++h) P::fold(acc, P::load(src + h * rs));
    }
    P::store(out + o * inner + c * PB, acc);
    c += step_c;
    o += step_o;
    if (c >= row) {
      c -= row;
      ++o;
    }
  }
}

template <int PB, int HT>
cudaError_t launch(const void* in, void* out, long long outer, int H,
                   long long inner, long long bs, long long rs, int sms,
                   cudaStream_t stream) {
  // one wave: the blocks the SMs hold at once (asked once per instance)
  static const int resident = [] {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &b, xor_fold_kernel<PB, HT>, kThreads, 0) != cudaSuccess ||
        b < 1)
      b = 1;
    return b;
  }();
  const long long n = outer * (inner / PB);
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long wave = (long long)sms * resident;
  if (blocks > wave) blocks = wave;
  xor_fold_kernel<PB, HT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), outer, H,
      inner, bs, rs);
  return cudaGetLastError();
}

template <int PB>
cudaError_t by_h(const void* in, void* out, long long outer, int H,
                 long long inner, long long bs, long long rs, int sms,
                 cudaStream_t s) {
#define XOR_FOLD_H(h) \
  case h: return launch<PB, h>(in, out, outer, H, inner, bs, rs, sms, s);
  switch (H) {
    XOR_FOLD_H(1) XOR_FOLD_H(2) XOR_FOLD_H(3) XOR_FOLD_H(4)
    XOR_FOLD_H(5) XOR_FOLD_H(6) XOR_FOLD_H(7) XOR_FOLD_H(8)
    XOR_FOLD_H(9) XOR_FOLD_H(10) XOR_FOLD_H(11) XOR_FOLD_H(12)
    XOR_FOLD_H(13) XOR_FOLD_H(14) XOR_FOLD_H(15) XOR_FOLD_H(16)
    default: return launch<PB, 0>(in, out, outer, H, inner, bs, rs, sms, s);
  }
#undef XOR_FOLD_H
}

}  // namespace

// in: (outer, H, inner) uint8, element (o, h, i) at in + o*bs + h*rs + i;
// out: (outer, inner) uint8, contiguous; both on CUDA device `device`,
// which is made current for the launch (and the caller's restored after
// it), as a device guard would. pb, the bytes a thread's place holds, is
// 16 or 1, and in, out, bs, rs and inner are multiples of it. sms is
// the device's SM count. Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int xor_fold(const void* in, void* out, long long outer, int H,
                        long long inner, long long bs, long long rs, int pb,
                        int device, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (outer <= 0 || H <= 0 || inner <= 0 || sms <= 0 || bs < 0 || rs < 0 ||
      (pb != 16 && pb != 1) ||
      (reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
       (uintptr_t)bs | (uintptr_t)rs | (uintptr_t)inner) % pb)
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return (int)rc;
  switch (pb) {
    case 16: rc = by_h<16>(in, out, outer, H, inner, bs, rs, sms, s); break;
    default: rc = by_h<1>(in, out, outer, H, inner, bs, rs, sms, s);
  }
  if (current != device) cudaSetDevice(current);
  return (int)rc;
}
