// SHA-512 and the reduction mod L of the fused ed25519 challenge
// (sha512_kernels.cu): k = SHA-512(R || A || M) mod L, canonical.
//
// One lane hashes one row: the 80 rounds of a block are one dependent
// chain, and rows are independent. A warp walks its 32 rows' blocks
// together and stages each block in shared memory before any lane
// compresses it (challenge_warp):
// - global -> registers (stage_load): the warp's 32 rows x 128 bytes are
//   256 16-byte pieces; lane l loads pieces l + 32 q (q = 0..7), so the 8
//   lanes of a quarter-warp read one row's 128 contiguous bytes and a
//   warp load touches 4 whole lines, where one thread a row read each
//   64-bit word as 8 byte loads, rows nblk x 128 bytes apart (32 lines a
//   warp load). The next block's loads are issued before the current one
//   is compressed, so their latency hides behind the rounds.
// - registers -> shared (stage_store), then each lane reads its own
//   row's 8 pieces (stage_read) and builds its 16 big-endian words with
//   __byte_perm. A row takes 144 bytes of shared memory (9 pieces, one
//   of padding): the quarter-warp that stores one row's 128 bytes and
//   the quarter-warp whose 8 lanes read piece c of 8 rows (36 words
//   apart, so 4 x lane + 4 c mod 32) both fall on distinct banks.
// - the compression on registers, each 64-bit rotation two 32-bit
//   funnel shifts.
// The warp loops to the largest clamped block count of its rows; a lane
// past its own count (or past the batch) still stages and syncs but does
// not compress. The reduction is ref10's sc_reduce (radix-2^21 signed
// limbs, folding with 2^252 = -(L - 2^252) mod L), which returns the
// canonical k < L: a k' = k mod L but >= L would verify differently on
// keys with a small-order component.
//
// The header is plain C++ over stdint types, so g++ also builds it: the
// CPU tests run challenge_warp through a host harness that plays a warp
// with 32 threads (tests/sha512_lanes_host.cpp). Outside nvcc the device
// qualifiers become plain inline functions, __constant__ static, and
// __byte_perm has a host definition.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __device__ inline
#define __forceinline__
#define __constant__ static

inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; i++)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

#endif

namespace shadev {

#ifdef __CUDACC__
typedef uint4 w128;
#else
struct alignas(16) w128 {
  uint32_t x, y, z, w;
};
#endif

// 16-byte pieces of shared memory a staged row takes (8 and one of
// padding), and a warp's staging buffer
constexpr int kRowPieces = 9;
constexpr int kStagePieces = 32 * kRowPieces;

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

// x rotated right by n, a constant once the rounds are unrolled: nvcc
// emits it as two 32-bit funnel shifts (SHF) of the halves, 21.5 SHF a
// round for the 9.2 rotations and 1.6 shifts of a round and its schedule
// step (cuobjdump -sass; chip_kernels.py --kernel 8, "kernel8 sass:"), so
// writing the halves out by hand changes no instruction
__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

// the big-endian 64-bit word of 8 bytes read as two little-endian halves
__device__ __forceinline__ uint64_t be64(uint32_t u0, uint32_t u1) {
  return ((uint64_t)__byte_perm(u0, 0, 0x0123) << 32) |
         __byte_perm(u1, 0, 0x0123);
}

// one SHA-512 compression of the block whose big-endian words are w into
// st; w becomes the rolling schedule
__device__ __forceinline__ void sha512_compress(uint64_t st[8],
                                                uint64_t w[16]) {
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

// global -> registers: the lane's pieces of block blk of the warp's rows
// row0 .. row0 + nrows - 1 (piece l + 32 q is row (l >> 3) + 4 q, bytes
// 16 (l & 7) ..); pieces of rows past nrows are zero and read nothing
__device__ __forceinline__ void stage_load(w128 r[8], const uint8_t* msg,
                                           int nblk, int row0, int nrows,
                                           int blk, int lane) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const int row = (lane >> 3) + 4 * q;
    if (row < nrows) {
      r[q] = reinterpret_cast<const w128*>(
          msg + ((size_t)(row0 + row) * nblk + blk) * 128)[lane & 7];
    } else {
      r[q].x = r[q].y = r[q].z = r[q].w = 0;
    }
  }
}

// registers -> the warp's staging buffer sm (row r's piece p at
// sm[r * kRowPieces + p])
__device__ __forceinline__ void stage_store(w128* sm, const w128 r[8],
                                            int nrows, int lane) {
#pragma unroll
  for (int q = 0; q < 8; q++) {
    const int row = (lane >> 3) + 4 * q;
    if (row < nrows) sm[row * kRowPieces + (lane & 7)] = r[q];
  }
}

// the lane's own row of the staging buffer -> its 16 big-endian words
__device__ __forceinline__ void stage_read(uint64_t w[16], const w128* sm,
                                           int lane) {
#pragma unroll
  for (int p = 0; p < 8; p++) {
    const w128 v = sm[lane * kRowPieces + p];
    w[2 * p] = be64(v.x, v.y);
    w[2 * p + 1] = be64(v.z, v.w);
  }
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

// ref10 sc_reduce: 64-byte little-endian integer -> canonical k mod L as
// four little-endian 64-bit words
__device__ __forceinline__ void sc_reduce(uint64_t w[4], const uint8_t* in) {
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
  w[0] = w[1] = w[2] = w[3] = 0;
#pragma unroll
  for (int i = 0; i < 12; i++) {
    const uint64_t v = (uint64_t)s[i];
    const int bit = 21 * i, word = bit >> 6, off = bit & 63;
    w[word] |= v << off;
    if (off > 64 - 21) w[word + 1] |= v >> (64 - off);
  }
}

// k's 32 bytes at out, 16-byte aligned: two 16-byte stores on the card
__device__ __forceinline__ void store_k(uint8_t* out, const uint64_t w[4]) {
#ifdef __CUDACC__
  ulonglong2* d = reinterpret_cast<ulonglong2*>(out);
  d[0] = make_ulonglong2(w[0], w[1]);
  d[1] = make_ulonglong2(w[2], w[3]);
#else
  for (int j = 0; j < 32; j++) out[j] = (uint8_t)(w[j >> 3] >> (8 * (j & 7)));
#endif
}

// The challenges of the warp's rows row0 .. row0 + nrows - 1 (1 <= nrows
// <= 32) by lane `lane`: SHA-512 of the row's first n_blocks (clamped to
// [0, nblk], as the plain version keeps the blocks below the count), then
// sc_reduce, written at out + row * 32. wp.sync() is the warp's barrier
// and wp.max(v) the largest v of its lanes; every lane of the warp takes
// part in every staging and sync, up to the warp's largest count. sm is
// the warp's staging buffer (kStagePieces pieces); msg and out 16-byte
// aligned.
template <class Warp>
__device__ __forceinline__ void challenge_warp(
    int lane, Warp& wp, w128* sm, const uint8_t* msg, int nblk,
    const int32_t* n_blocks, uint8_t* out, int row0, int nrows) {
  const bool live = lane < nrows;
  int nb = live ? n_blocks[row0 + lane] : 0;
  nb = nb < 0 ? 0 : (nb > nblk ? nblk : nb);
  const int nmax = wp.max(nb);
  uint64_t st[8] = {
      0x6A09E667F3BCC908ULL, 0xBB67AE8584CAA73BULL, 0x3C6EF372FE94F82BULL,
      0xA54FF53A5F1D36F1ULL, 0x510E527FADE682D1ULL, 0x9B05688C2B3E6C1FULL,
      0x1F83D9ABFB41BD6BULL, 0x5BE0CD19137E2179ULL,
  };
  w128 r[8];
  if (nmax > 0) stage_load(r, msg, nblk, row0, nrows, 0, lane);
  for (int blk = 0; blk < nmax; blk++) {
    stage_store(sm, r, nrows, lane);
    wp.sync();
    uint64_t w[16];
    if (blk < nb) stage_read(w, sm, lane);
    wp.sync();
    if (blk + 1 < nmax) stage_load(r, msg, nblk, row0, nrows, blk + 1, lane);
    if (blk < nb) sha512_compress(st, w);
  }
  if (!live) return;
  // big-endian words -> the standard digest bytes, read by sc_reduce as a
  // little-endian integer (the ed25519 convention)
  uint8_t dig[64];
#pragma unroll
  for (int j = 0; j < 64; j++) dig[j] = (uint8_t)(st[j >> 3] >> (56 - 8 * (j & 7)));
  uint64_t k[4];
  sc_reduce(k, dig);
  store_k(out + (size_t)(row0 + lane) * 32, k);
}

}  // namespace shadev
