// The fused ed25519 challenge on the card, for sm_90a:
//   k = SHA-512(R || A || M) mod L, canonical (0 <= k < L).
//
//   tm_challenge     <- tendermint_tpu/ops/sha512.py:394 challenge_batch
//                       (sha512_batch :265, reduce_mod_l :362), the first
//                       half of ed25519_batch.py:136 verify_msgs_bigcache
//   tm_reduce_mod_l  the reduction alone over given 64-byte digests, so a
//                       test can feed digests SHA-512 cannot be made to give
//
// The TPU has no 64-bit lanes, so the JAX package carries each word as a
// (hi, lo) uint32 pair; Hopper has native 64-bit adds and logic (each two
// 32-bit instructions) and 32-bit funnel shifts, so words are uint64_t
// here and nvcc makes each rotation two funnel shifts of the halves.
//
// What bounds it on an H100: integer logic. One 128-byte block is 80
// rounds of ~25 64-bit operations plus the 64-word schedule, ~5.7k 32-bit
// instructions, against 128 bytes read: far above the card's ~5
// operations per byte. At the blocksync window's 16,384 rows there are
// ~4 warps an SM, so the latency of each load shows unless it is hidden:
// one thread a row read each 64-bit word as 8 byte loads, rows nblk x 128
// bytes apart, so each warp load touched 32 lines. Design (challenge_warp
// in sha512_device.cuh): one lane a row, the state and a 16-word rolling
// schedule in registers (rounds unrolled so every index is static); a warp
// stages each block of its 32 rows in shared memory with coalesced 16-byte
// loads, issued a block ahead, and each lane builds its words from its own
// row with byte permutes. The reduction is ref10's sc_reduce.
//
// Plain C interface, as ed25519_kernels.cu: launchers run on the caller's
// stream, allocate nothing, and return cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha512_device.cuh"

using namespace shadev;

namespace {

// two warps a block: 16,384 rows are 256 blocks, 2,048 rows 32
constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// the warp's barrier and maximum for challenge_warp: blocks are whole, so
// every lane of a warp arrives, the lanes past the batch included
struct WarpSync {
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ int max(int v) const {
    return __reduce_max_sync(0xFFFFFFFFu, v);
  }
};

__global__ void __launch_bounds__(kThreads)
challenge_kernel(const uint8_t* __restrict__ msg, int nblk,
                 const int32_t* __restrict__ n_blocks,
                 uint8_t* __restrict__ out, int b) {
  __shared__ w128 stage[kWarps][kStagePieces];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kThreads + warp * 32;
  if (row0 >= b) return;  // the whole warp
  const int nrows = b - row0 < 32 ? b - row0 : 32;
  WarpSync wp;
  challenge_warp(lane, wp, stage[warp], msg, nblk, n_blocks, out, row0,
                 nrows);
}

__global__ void __launch_bounds__(kThreads)
reduce_mod_l_kernel(const uint8_t* __restrict__ digest,
                    uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  uint64_t k[4];
  sc_reduce(k, digest + (size_t)i * 64);
  store_k(out + (size_t)i * 32, k);
}

}  // namespace

extern "C" {

int tm_challenge(const void* msg, int nblk, const void* n_blocks, void* out,
                 int b, void* stream) {
  if (b > 0)
    challenge_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, nblk, (const int32_t*)n_blocks, (uint8_t*)out,
        b);
  return (int)cudaGetLastError();
}

int tm_reduce_mod_l(const void* digest, void* out, int b, void* stream) {
  if (b > 0)
    reduce_mod_l_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)digest, (uint8_t*)out, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
