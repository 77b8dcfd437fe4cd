// Batched SHA-256 on the card, for sm_90a: the RFC 6962 merkle leaf and
// inner hashes of the block's transactions.
//
//   tm_sha256  <- tendermint_tpu/ops/sha256.py:159 sha256_batch, and through
//                 it merkle_leaf_hash :205, merkle_inner_hash :224 and
//                 merkle_root_pow2 :241
//
// Operands: [B, NBLK * 64] uint8 rows padded on the host (pad_messages),
// [B] int32 block counts; output [B, 32] uint8 big-endian digests. A row
// runs its own first n_blocks blocks (clamped to [0, NBLK]) and ignores
// the padding blocks behind them, which is the JAX package's masked state
// update.
//
// What bounds it on an H100: integer logic and, for the card's batches,
// one row's serial chain. A 64-byte block is 64 rounds of ~20 32-bit
// operations plus 48 schedule steps of ~12, against 64 bytes read: far
// above the card's ~5 operations per byte. The rounds of a row cannot be
// split across lanes, so a batch of B rows is B / 32 warps, and the
// slowest warp runs its longest row's blocks: the L2 block's leaf batch,
// 4,096 rows of 1-17 blocks, is 128 warps. One thread a row read each word
// as 4 byte loads, rows nblk x 64 bytes apart, so each warp load touched
// 32 lines and nothing hid their latency. Design (sha256_warp in
// sha256_device.cuh): one lane a row, the state and a 16-word rolling
// schedule in registers (rounds unrolled so every index is static); a warp
// stages each block of its 32 rows in shared memory with coalesced 16-byte
// loads, issued a block ahead, each lane builds its words from its own row
// with byte permutes, and writes its digest as two 16-byte stores. One
// warp a block, so the leaf batch's 128 warps spread over 128 SMs.
//
// Plain C interface, as the other kernels: the launcher runs on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_device.cuh"

using namespace sha256dev;

namespace {

// threads a block: one warp, so a batch's warps go to as many SMs
constexpr int kThreads = 32;
constexpr int kWarps = kThreads / 32;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// the warp's barrier and maximum for sha256_warp: blocks are whole warps,
// so every lane arrives, the lanes past the batch included
struct WarpSync {
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ int max(int v) const {
    return __reduce_max_sync(0xFFFFFFFFu, v);
  }
};

__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ msg, int nblk,
              const int32_t* __restrict__ n_blocks, uint8_t* __restrict__ out,
              int b) {
  __shared__ w128 stage[kWarps][kStagePieces];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kThreads + warp * 32;
  if (row0 >= b) return;  // the whole warp
  const int nrows = b - row0 < 32 ? b - row0 : 32;
  WarpSync wp;
  sha256_warp(lane, wp, stage[warp], msg, nblk, n_blocks, out, row0, nrows);
}

}  // namespace

extern "C" {

int tm_sha256(const void* msg, int nblk, const void* n_blocks, void* out,
              int b, void* stream) {
  if (b > 0)
    sha256_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)msg, nblk, (const int32_t*)n_blocks, (uint8_t*)out,
        b);
  return (int)cudaGetLastError();
}

}  // extern "C"
