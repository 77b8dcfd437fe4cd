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
// (hi, lo) uint32 pair; Hopper has native 64-bit adds, shifts and logic
// (each two 32-bit instructions), so words are uint64_t here.
//
// What bounds it on an H100: integer logic. One 128-byte block is 80
// rounds of ~25 64-bit operations plus the 64-word schedule, ~5.7k 32-bit
// instructions, against 128 bytes read: far above the card's ~5 operations
// per byte, so no part of it waits on memory. Design: one thread per row,
// the state and a 16-word rolling schedule in registers (rounds unrolled so
// every index is static), a row's blocks in order, rows past their block
// count untouched. The reduction is ref10's sc_reduce (radix-2^21 signed
// limbs, folding with 2^252 = -(L - 2^252) mod L), which returns the
// canonical k < L: a k' = k mod L but >= L would verify differently on
// keys with a small-order component.
//
// Plain C interface, as ed25519_kernels.cu: launchers run on the caller's
// stream, allocate nothing, and return cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__constant__ uint64_t kK512[80] = {
    0x428A2F98D728AE22ULL, 0x7137449123EF65CDULL, 0xB5C0FBCFEC4D3B2FULL,
    0xE9B5DBA58189DBBCULL, 0x3956C25BF348B538ULL, 0x59F111F1B605D019ULL,
    0x923F82A4AF194F9BULL, 0xAB1C5ED5DA6D8118ULL, 0xD807AA98A3030242ULL,
    0x12835B0145706FBEULL, 0x243185BE4EE4B28CULL, 0x550C7DC3D5FFB4E2ULL,
    0x72BE5D74F27B896FULL, 0x80DEB1FE3B1696B1ULL, 0x9BDC06A725C71235ULL,
    0xC19BF174CF692694ULL, 0xE49B69C19EF14AD2ULL, 0xEFBE4786384F25E3ULL,
    0x0FC19DC68B8CD5B5ULL, 0x240CA1CC77AC9C65ULL, 0x2DE92C6F592B0275ULL,
    0x4A7484AA6EA6E483ULL, 0x5CB0A9DCBD41FBD4ULL, 0x76F988DA831153B5ULL,
    0x983E5152EE66DFABULL, 0xA831C66D2DB43210ULL, 0xB00327C898FB213FULL,
    0xBF597FC7BEEF0EE4ULL, 0xC6E00BF33DA88FC2ULL, 0xD5A79147930AA725ULL,
    0x06CA6351E003826FULL, 0x142929670A0E6E70ULL, 0x27B70A8546D22FFCULL,
    0x2E1B21385C26C926ULL, 0x4D2C6DFC5AC42AEDULL, 0x53380D139D95B3DFULL,
    0x650A73548BAF63DEULL, 0x766A0ABB3C77B2A8ULL, 0x81C2C92E47EDAEE6ULL,
    0x92722C851482353BULL, 0xA2BFE8A14CF10364ULL, 0xA81A664BBC423001ULL,
    0xC24B8B70D0F89791ULL, 0xC76C51A30654BE30ULL, 0xD192E819D6EF5218ULL,
    0xD69906245565A910ULL, 0xF40E35855771202AULL, 0x106AA07032BBD1B8ULL,
    0x19A4C116B8D2D0C8ULL, 0x1E376C085141AB53ULL, 0x2748774CDF8EEB99ULL,
    0x34B0BCB5E19B48A8ULL, 0x391C0CB3C5C95A63ULL, 0x4ED8AA4AE3418ACBULL,
    0x5B9CCA4F7763E373ULL, 0x682E6FF3D6B2B8A3ULL, 0x748F82EE5DEFB2FCULL,
    0x78A5636F43172F60ULL, 0x84C87814A1F0AB72ULL, 0x8CC702081A6439ECULL,
    0x90BEFFFA23631E28ULL, 0xA4506CEBDE82BDE9ULL, 0xBEF9A3F7B2C67915ULL,
    0xC67178F2E372532BULL, 0xCA273ECEEA26619CULL, 0xD186B8C721C0C207ULL,
    0xEADA7DD6CDE0EB1EULL, 0xF57D4F7FEE6ED178ULL, 0x06F067AA72176FBAULL,
    0x0A637DC5A2C898A6ULL, 0x113F9804BEF90DAEULL, 0x1B710B35131C471BULL,
    0x28DB77F523047D84ULL, 0x32CAAB7B40C72493ULL, 0x3C9EBE0A15C9BEBCULL,
    0x431D67C49C100D4CULL, 0x4CC5D4BECB3E42B6ULL, 0x597F299CFC657E2AULL,
    0x5FCB6FAB3AD6FAECULL, 0x6C44198C4A475817ULL,
};

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ uint64_t load_be64(const uint8_t* p) {
  uint64_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) w = (w << 8) | p[j];
  return w;
}

// one SHA-512 compression of the 128-byte block at blk into st
__device__ __forceinline__ void sha512_compress(uint64_t st[8],
                                                const uint8_t* blk) {
  uint64_t w[16];
#pragma unroll
  for (int i = 0; i < 16; i++) w[i] = load_be64(blk + 8 * i);
  uint64_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4], f = st[5],
           g = st[6], h = st[7];
#pragma unroll
  for (int i = 0; i < 80; i++) {
    if (i >= 16) {
      // w[i & 15] still holds w[i - 16]
      const uint64_t x15 = w[(i - 15) & 15], x2 = w[(i - 2) & 15];
      const uint64_t s0 = rotr64(x15, 1) ^ rotr64(x15, 8) ^ (x15 >> 7);
      const uint64_t s1 = rotr64(x2, 19) ^ rotr64(x2, 61) ^ (x2 >> 6);
      w[i & 15] += s0 + w[(i - 7) & 15] + s1;
    }
    const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
    const uint64_t ch = (e & f) ^ (~e & g);
    const uint64_t t1 = h + S1 + ch + kK512[i] + w[i & 15];
    const uint64_t S0 = rotr64(a, 28) ^ rotr64(a, 34) ^ rotr64(a, 39);
    const uint64_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint64_t t2 = S0 + maj;
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

// n bits (n <= 29) of the little-endian 64-byte integer at bit offset pos
__device__ __forceinline__ int64_t load_bits(const uint8_t* s, int pos, int n) {
  uint64_t v = 0;
  const int byte0 = pos >> 3;
#pragma unroll
  for (int j = 0; j < 5; j++)
    if (byte0 + j < 64) v |= (uint64_t)s[byte0 + j] << (8 * j);
  return (int64_t)((v >> (pos & 7)) & ((1ULL << n) - 1));
}

// s[i] * 2^(21 i) with i >= 12 folded down by 2^252 = -(L - 2^252) mod L,
// whose radix-2^21 signed limbs are these six constants
__device__ __forceinline__ void sc_fold(int64_t* s, int i) {
  const int64_t v = s[i];
  s[i - 12] += v * 666643;
  s[i - 11] += v * 470296;
  s[i - 10] += v * 654183;
  s[i - 9] -= v * 997805;
  s[i - 8] += v * 136657;
  s[i - 7] -= v * 683901;
  s[i] = 0;
}

// carry limb i into limb i + 1, rounding (limb i ends in [-2^20, 2^20))
__device__ __forceinline__ void sc_carry_round(int64_t* s, int i) {
  const int64_t c = (s[i] + (1LL << 20)) >> 21;
  s[i + 1] += c;
  s[i] -= c * (1LL << 21);
}

// carry limb i into limb i + 1, floor (limb i ends in [0, 2^21))
__device__ __forceinline__ void sc_carry_floor(int64_t* s, int i) {
  const int64_t c = s[i] >> 21;
  s[i + 1] += c;
  s[i] -= c * (1LL << 21);
}

// ref10 sc_reduce: 64-byte little-endian integer -> canonical 32 bytes mod L
__device__ __forceinline__ void sc_reduce(uint8_t* out, const uint8_t* in) {
  int64_t s[24];
#pragma unroll
  for (int i = 0; i < 23; i++) s[i] = load_bits(in, 21 * i, 21);
  s[23] = load_bits(in, 483, 29);
#pragma unroll
  for (int i = 23; i >= 18; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 6; i <= 16; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 7; i <= 15; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 17; i >= 12; i--) sc_fold(s, i);
#pragma unroll
  for (int i = 0; i <= 10; i += 2) sc_carry_round(s, i);
#pragma unroll
  for (int i = 1; i <= 11; i += 2) sc_carry_round(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 11; i++) sc_carry_floor(s, i);
  sc_fold(s, 12);
#pragma unroll
  for (int i = 0; i <= 10; i++) sc_carry_floor(s, i);
  // s[0..11] are 21-bit limbs of k < L < 2^253
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint64_t v = (uint64_t)s[i];
    const int bit = 21 * i, word = bit >> 6, off = bit & 63;
    w[word] |= v << off;
    if (off > 64 - 21) w[word + 1] |= v >> (64 - off);
  }
#pragma unroll
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)(w[j >> 3] >> (8 * (j & 7)));
}

__global__ void __launch_bounds__(kThreads)
challenge_kernel(const uint8_t* __restrict__ msg, int nblk,
                 const int32_t* __restrict__ n_blocks,
                 uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  uint64_t st[8] = {
      0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
      0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
      0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL,
  };
  // the plain version runs blocks 0 .. nblk - 1 and keeps those below the
  // row's count: the same as clamping the count to [0, nblk]
  int nb = n_blocks[i];
  nb = nb < 0 ? 0 : (nb > nblk ? nblk : nb);
  const uint8_t* row = msg + (size_t)i * nblk * 128;
  for (int blk = 0; blk < nb; blk++) sha512_compress(st, row + blk * 128);
  // big-endian words -> the standard digest bytes, read by sc_reduce as a
  // little-endian integer (the ed25519 convention)
  uint8_t dig[64];
#pragma unroll
  for (int j = 0; j < 64; j++) dig[j] = (uint8_t)(st[j >> 3] >> (56 - 8 * (j & 7)));
  sc_reduce(out + (size_t)i * 32, dig);
}

__global__ void __launch_bounds__(kThreads)
reduce_mod_l_kernel(const uint8_t* __restrict__ digest,
                    uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  sc_reduce(out + (size_t)i * 32, digest + (size_t)i * 64);
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
