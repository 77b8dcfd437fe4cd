// SHA-256 of the RFC 6962 merkle hashes (sha256_kernels.cu), a lane a row.
//
// The 64 rounds of a block are one dependent chain, and rows are
// independent, so one lane hashes one row. A warp walks its 32 rows'
// blocks together and stages each block in shared memory before any lane
// compresses it (sha256_warp):
// - global -> registers (stage_load): the warp's 32 rows x 64 bytes are
//   128 16-byte pieces; in load q (q = 0..3) lane l reads piece l & 3 of
//   row (l >> 3) + 4 ((l >> 2) & 1) + 8 q, so each load of the warp reads
//   8 rows' 64 contiguous bytes, 16 whole sectors, where one thread a row
//   read each word as 4 byte loads, rows nblk x 64 bytes apart (32 lines a
//   warp load). The next block's loads are issued before the current one
//   is compressed, so their latency hides behind the rounds.
// - registers -> shared (stage_store), then each lane reads its own
//   row's 4 pieces (stage_read) and builds its 16 big-endian words with
//   __byte_perm. A row takes 80 bytes of shared memory (5 pieces, one of
//   padding, 20 words): the 8 lanes of a quarter-warp that read piece c of
//   8 consecutive rows fall on banks 20 r + 4 c mod 32, all distinct, and
//   the quarter-warp that stores two rows' 64 bytes stores rows 4 apart,
//   80 words, so 16 banks apart: both are free of bank conflicts.
// - the compression on registers with a rolling 16-word schedule, the
//   round constants in constant memory (every lane reads the same one).
// - the digest as two 16-byte stores a row.
// The warp loops to the largest clamped block count of its rows; a lane
// past its own count (or past the batch) still stages and syncs but does
// not compress.
//
// The header is plain C++ over stdint types, so g++ also builds it: the
// CPU tests run sha256_warp through a host harness that plays a warp with
// 32 threads (tests/sha256_lanes_host.cpp). Outside nvcc the device
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

namespace sha256dev {

#ifdef __CUDACC__
typedef uint4 w128;
#else
struct alignas(16) w128 {
  uint32_t x, y, z, w;
};
#endif

// 16-byte pieces of shared memory a staged row takes (4 and one of
// padding), and a warp's staging buffer
constexpr int kRowPieces = 5;
constexpr int kStagePieces = 32 * kRowPieces;

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

// the byte swap between a little-endian load and a big-endian word
__device__ __forceinline__ uint32_t bswap32(uint32_t u) {
  return __byte_perm(u, 0, 0x0123);
}

// one SHA-256 compression of the block whose big-endian words are w into
// st; w becomes the rolling schedule
__device__ __forceinline__ void sha256_compress(uint32_t st[8],
                                                uint32_t w[16]) {
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

// the warp's row whose piece lane & 3 the lane loads in load q: a
// quarter-warp's two rows are 4 apart, so their stores fall 16 banks apart
__device__ __forceinline__ int stage_row(int lane, int q) {
  return (lane >> 3) + 4 * ((lane >> 2) & 1) + 8 * q;
}

// global -> registers: the lane's pieces of block blk of the warp's rows
// row0 .. row0 + nrows - 1; pieces of rows past nrows are zero and read
// nothing
__device__ __forceinline__ void stage_load(w128 r[4], const uint8_t* msg,
                                           int nblk, int row0, int nrows,
                                           int blk, int lane) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int row = stage_row(lane, q);
    if (row < nrows) {
      r[q] = reinterpret_cast<const w128*>(
          msg + ((size_t)(row0 + row) * nblk + blk) * 64)[lane & 3];
    } else {
      r[q].x = r[q].y = r[q].z = r[q].w = 0;
    }
  }
}

// registers -> the warp's staging buffer sm (row r's piece p at
// sm[r * kRowPieces + p])
__device__ __forceinline__ void stage_store(w128* sm, const w128 r[4],
                                            int nrows, int lane) {
#pragma unroll
  for (int q = 0; q < 4; q++) {
    const int row = stage_row(lane, q);
    if (row < nrows) sm[row * kRowPieces + (lane & 3)] = r[q];
  }
}

// the lane's own row of the staging buffer -> its 16 big-endian words
__device__ __forceinline__ void stage_read(uint32_t w[16], const w128* sm,
                                           int lane) {
#pragma unroll
  for (int p = 0; p < 4; p++) {
    const w128 v = sm[lane * kRowPieces + p];
    w[4 * p] = bswap32(v.x);
    w[4 * p + 1] = bswap32(v.y);
    w[4 * p + 2] = bswap32(v.z);
    w[4 * p + 3] = bswap32(v.w);
  }
}

// the digest's 32 bytes (big-endian words) at out, 16-byte aligned: two
// 16-byte stores on the card
__device__ __forceinline__ void store_digest(uint8_t* out,
                                             const uint32_t st[8]) {
#ifdef __CUDACC__
  uint4* d = reinterpret_cast<uint4*>(out);
  d[0] = make_uint4(bswap32(st[0]), bswap32(st[1]), bswap32(st[2]),
                    bswap32(st[3]));
  d[1] = make_uint4(bswap32(st[4]), bswap32(st[5]), bswap32(st[6]),
                    bswap32(st[7]));
#else
  for (int j = 0; j < 32; j++)
    out[j] = (uint8_t)(st[j >> 2] >> (24 - 8 * (j & 3)));
#endif
}

// The digests of the warp's rows row0 .. row0 + nrows - 1 (1 <= nrows <=
// 32) by lane `lane`: SHA-256 of the row's first n_blocks blocks (clamped
// to [0, nblk], as the plain version keeps the blocks below the count),
// written at out + row * 32. wp.sync() is the warp's barrier and wp.max(v)
// the largest v of its lanes; every lane of the warp takes part in every
// staging and sync, up to the warp's largest count. sm is the warp's
// staging buffer (kStagePieces pieces); msg and out 16-byte aligned.
template <class Warp>
__device__ __forceinline__ void sha256_warp(int lane, Warp& wp, w128* sm,
                                            const uint8_t* msg, int nblk,
                                            const int32_t* n_blocks,
                                            uint8_t* out, int row0,
                                            int nrows) {
  const bool live = lane < nrows;
  int nb = live ? n_blocks[row0 + lane] : 0;
  nb = nb < 0 ? 0 : (nb > nblk ? nblk : nb);
  const int nmax = wp.max(nb);
  uint32_t st[8] = {0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19};
  w128 r[4];
  if (nmax > 0) stage_load(r, msg, nblk, row0, nrows, 0, lane);
  for (int blk = 0; blk < nmax; blk++) {
    stage_store(sm, r, nrows, lane);
    wp.sync();
    uint32_t w[16];
    if (blk < nb) stage_read(w, sm, lane);
    wp.sync();
    if (blk + 1 < nmax) stage_load(r, msg, nblk, row0, nrows, blk + 1, lane);
    if (blk < nb) sha256_compress(st, w);
  }
  if (live) store_digest(out + (size_t)(row0 + lane) * 32, st);
}

}  // namespace sha256dev
