// Microbenchmark of the CRC-32C kernel's parts on Hopper (sm_90a), run by
// `python3 chip_smoke.py --crc-times`: the same bytes and the same work
// items as ceph_tpu_torch/csum/csrc/csum.cu's crc32c_kernel (persistent
// blocks, warp items of 32 segments of `seg` 32-byte units, one lane a
// segment), one part at a time, and the parts of the designs it was
// chosen over:
//   0 loads only: each lane's 16-byte loads of its own segment (the
//     earlier kernel's pattern, 32 lines a warp load), XORed together;
//   1 loads only, coalesced: the same bytes, a warp reading 512
//     contiguous bytes a load;
//   2 the earlier kernel's lookups on register data, no loads:
//     slicing-by-8 from 8 KiB of byte tables the warp shares (the data
//     is random, so the lookups fall on random banks);
//   3 the kernel's lookups on register data, no loads: slicing-by-4 from
//     lane-private tables (128 KiB, each lane its own bank), one byte
//     permute a lookup's address;
//   4 the kernel's lookups on each lane's own 16-byte loads (mode 0's);
//   5 loads only, staged as the kernel stages them: the warp copies its
//     lanes' next 4 units into shared memory with coalesced 16-byte
//     cp.async (four lanes' 128 bytes a copy instruction), double-
//     buffered, and each lane reads its own back.
// Every thread writes what it computed, so that nothing is elided. The
// register data of 2 and 3 is a hash of the lane and the position.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTabBytes = 4 * 256 * 32 * 4;
constexpr int kStageBytes = 2 * 32 * 128;   // a warp's, as the kernel's
constexpr uint32_t kPoly = 0x82F63B78u;
constexpr uint32_t kT0 = 0, kT1 = 128, kT2 = 65536, kT3 = 65536 + 128;

__device__ __forceinline__ uint32_t look(const uint8_t* tab, uint32_t at) {
  return *reinterpret_cast<const uint32_t*>(tab + at);
}

__device__ __forceinline__ uint32_t step4(const uint8_t* tab, uint32_t l4,
                                          uint32_t x) {
  return look(tab + kT3, __byte_perm(x, l4, 0x5504))
       ^ look(tab + kT2, __byte_perm(x, l4, 0x5514))
       ^ look(tab + kT1, __byte_perm(x, l4, 0x5524))
       ^ look(tab + kT0, __byte_perm(x, l4, 0x5534));
}

__device__ __forceinline__ uint32_t step8(const uint32_t (*t)[256],
                                          uint32_t lo, uint32_t hi) {
  return t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
       ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
       ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
}

__device__ __forceinline__ uint32_t hash(uint32_t a, uint32_t b) {
  return a * 0x9E3779B1u + b * 0x85EBCA77u;
}

// 32 warps a block, as the earlier kernel kept a SM busy; 12 where the
// stages take the shared memory (mode 5, as the kernel)
template <int MODE>
__host__ __device__ constexpr int warps() { return MODE == 5 ? 12 : 32; }

template <int MODE>
__global__ void __launch_bounds__(32 * warps<MODE>(), 1)
probe(const uint8_t* data, long long items, int seg, uint32_t* out) {
  constexpr int kWarps = warps<MODE>(), kThreads = 32 * kWarps;
  extern __shared__ uint4 smem[];
  __shared__ uint32_t ctab[8][256];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (MODE >= 2 && MODE <= 4) {  // T_j: the step through j + 1 bytes
    for (int e = tid; e < 2048; e += kThreads) {
      uint32_t c = e & 255;
      for (int i = 8 * ((e >> 8) + 1); i; --i)
        c = (c >> 1) ^ ((0u - (c & 1u)) & kPoly);
      ctab[e >> 8][e & 255] = c;
    }
    __syncthreads();
    if (MODE >= 3) {  // the kernel's lane-private layout
      for (int e = tid; e < kTabBytes / 16; e += kThreads) {
        const uint32_t x =
            ctab[2 * (e >> 12) + ((e >> 3) & 1)][(e >> 4) & 255];
        smem[e] = make_uint4(x, x, x, x);
      }
      __syncthreads();
    }
  }
  const uint8_t* tab = reinterpret_cast<const uint8_t*>(smem);
  const uint32_t l4 = 4u * lane;
  uint32_t acc = 0;
  const long long seg_bytes = 32LL * seg;
  for (long long it = blockIdx.x + (long long)gridDim.x * warp; it < items;
       it += (long long)gridDim.x * kWarps) {
    const uint8_t* mine = data + (it * 32 + lane) * seg_bytes;
    uint32_t v = acc + lane;
    if (MODE == 0 || MODE == 4) {  // each lane's loads, next unit ahead
      const uint4* q = reinterpret_cast<const uint4*>(mine);
      uint4 a = __ldg(q), b = __ldg(q + 1);
#pragma unroll 1
      for (int u = 1; u <= seg; ++u) {
        uint4 na = a, nb = b;
        if (u < seg) {
          na = __ldg(q + 2 * u);
          nb = __ldg(q + 2 * u + 1);
        }
        if (MODE == 0) {
          v ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
        } else {
          const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) v = step4(tab, l4, v ^ w[i]);
        }
        a = na;
        b = nb;
      }
    } else if (MODE == 5) {  // staged: 4 units a lane a round, 2 buffers
      const uint4* stage = smem + warp * (kStageBytes / 16);
      const uint32_t stage_s =
          static_cast<uint32_t>(__cvta_generic_to_shared(stage));
      const int cc = lane & 7, cq = lane >> 3;
      const uint32_t cslot[2] = {16u * (8 * cq + (cc ^ cq)),
                                 16u * (8 * cq + (cc ^ (cq + 4)))};
      const int rounds = (seg + 3) / 4;
      auto copy = [&](int r) {
        if (4 * r + cc / 2 < seg) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                         :: "r"(stage_s + (r & 1) * 4096u + 512u * i
                                + cslot[i & 1]),
                            "l"(data + (it * 32 + 4 * i + cq) * seg_bytes
                                + 128LL * r + 16 * cc) : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      };
      copy(0);
#pragma unroll 1
      for (int r = 0; r < rounds; ++r) {
        if (r + 1 < rounds) copy(r + 1);
        else asm volatile("cp.async.commit_group;\n" ::: "memory");
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        __syncwarp();
        const uint4* buf = stage + (r & 1) * 256;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (4 * r + k < seg) {
            const uint4 a = buf[lane * 8 + ((2 * k) ^ (lane & 7))];
            const uint4 b = buf[lane * 8 + ((2 * k + 1) ^ (lane & 7))];
            v ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
          }
        }
        __syncwarp();
      }
    } else {
#pragma unroll 1
      for (int u = 0; u < seg; ++u) {
        if (MODE == 1) {
          const uint8_t* q =
              data + it * 32 * seg_bytes + 1024LL * u + 16 * lane;
          const uint4 a = __ldg(reinterpret_cast<const uint4*>(q));
          const uint4 b = __ldg(reinterpret_cast<const uint4*>(q + 512));
          v ^= a.x ^ a.y ^ a.z ^ a.w ^ b.x ^ b.y ^ b.z ^ b.w;
        } else if (MODE == 2) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v = step8(ctab, v ^ hash(lane, u * 8 + 2 * i),
                      hash(lane, u * 8 + 2 * i + 1));
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v = step4(tab, l4, v ^ hash(lane, u * 8 + i));
        }
      }
    }
    acc ^= v;
  }
  out[(long long)blockIdx.x * kThreads + tid] = acc;
}

template <int MODE>
int launch(const void* data, long long items, int seg, void* out, int grid,
           cudaStream_t s) {
  const int smem = MODE == 3 || MODE == 4 ? kTabBytes
                 : MODE == 5 ? warps<MODE>() * kStageBytes : 0;
  if (smem) {
    const cudaError_t rc = cudaFuncSetAttribute(
        probe<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  probe<MODE><<<grid, 32 * warps<MODE>(), smem, s>>>(
      static_cast<const uint8_t*>(data), items, seg,
      static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// One run of part `mode` over items * 32 segments of seg units at data
// (16-byte aligned, items * 32 * seg * 32 bytes); out holds grid * 1024
// words.
extern "C" int crc_probe(int mode, const void* data, long long items,
                         int seg, void* out, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(data, items, seg, out, grid, s);
    case 1: return launch<1>(data, items, seg, out, grid, s);
    case 2: return launch<2>(data, items, seg, out, grid, s);
    case 3: return launch<3>(data, items, seg, out, grid, s);
    case 4: return launch<4>(data, items, seg, out, grid, s);
    case 5: return launch<5>(data, items, seg, out, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
