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
// What bounds it on an H100: integer logic. A 64-byte block is 64 rounds
// of ~20 32-bit operations plus 48 schedule steps of ~12, ~1.9k
// instructions against 64 bytes read, far above the card's ~5 operations
// per byte. Design, simple first: one thread per row, the state and a
// 16-word rolling schedule in registers (rounds unrolled so every index is
// static), the round constants in constant memory (every thread of a warp
// reads the same one), the row's bytes read one word at a time.
//
// Plain C interface, as the other kernels: the launcher runs on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__constant__ uint32_t kK256[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

__device__ __forceinline__ uint32_t load_be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

// one SHA-256 compression of the 64-byte block at blk into st
__device__ __forceinline__ void sha256_compress(uint32_t st[8],
                                                const uint8_t* blk) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = load_be32(blk + 4 * i);
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5],
           g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 64; i++) {
    if (i >= 16) {
      // w[i & 15] still holds w[i - 16]
      const uint32_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr32(x15, 7) ^ rotr32(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr32(x2, 17) ^ rotr32(x2, 19) ^ (x2 >> 10);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint32_t S1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kK256[i] + w[i & 15];
    const uint32_t S0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

__global__ void __launch_bounds__(kThreads)
sha256_kernel(const uint8_t* __restrict__ msg, int nblk,
              const int32_t* __restrict__ n_blocks, uint8_t* __restrict__ out,
              int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  uint32_t st[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};
  // the plain version runs blocks 0 .. nblk - 1 and keeps those below the
  // row's count: the same as clamping the count to [0, nblk]
  int nb = n_blocks[i];
  nb = nb < 0 ? 0 : (nb > nblk ? nblk : nb);
  const uint8_t* row = msg + (size_t)i * nblk * 64;
  for (int blk = 0; blk < nb; blk++) sha256_compress(st, row + blk * 64);
  uint8_t* o = out + (size_t)i * 32;
#pragma unroll
  for (int j = 0; j < 32; j++) o[j] = (uint8_t)(st[j >> 2] >> (24 - 8 * (j & 3)));
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
