// GF(2^255-19) and edwards25519 device code for the ed25519 kernels.
//
// A field element is 5 limbs of 51 bits in uint64 (radix 2^51); products
// are 64x64->128-bit through unsigned __int128. The JAX package kept 32
// radix-2^8 int32 limbs only because a TPU has no 64-bit integers; here
// only the canonical 32 bytes at the boundary have to agree with it.
//
// Invariant: every fe op takes limbs < 2^52 and returns limbs < 2^52.
//   mul: f_i * 19 g_j < 2^108.3, five terms < 2^110.6, so the top carry
//        times 19 stays < 2^64; output < 2^51 + 2^13.
//   add/sub: one weak carry after the limb sums (sub adds 4p, whose limbs
//        are ~2^53 > any input limb, so nothing goes negative).
// Canonical encoding (fe_tobytes) freezes to [0, p) with three wrapped
// carries and the "+19 reaches 2^255" test.
//
// Constants d, 2d and sqrt(-1) are not typed in here: the wrappers pass
// them in as bytes built from the host oracle (crypto/ed25519.py).
//
// The header is plain C++ over stdint types, so g++ also builds it: the
// CPU tests run the four-lane row code (verify_table_x4,
// verify_generic_x4, verify_bigcache_x4, neg_pubkey_bigtable_x4,
// neg_pubkey_table_x4, dbl_chain_x4) through a host harness,
// tests/ed25519_lanes_host.cpp. Outside nvcc the device
// qualifiers below become plain inline functions.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __device__ inline
#define __forceinline__
#define __noinline__
#endif

namespace edev {

typedef unsigned __int128 u128;

static constexpr uint64_t M51 = (1ULL << 51) - 1;

struct fe {
  uint64_t v[5];
};

struct ge {  // extended (X : Y : Z : T)
  fe X, Y, Z, T;
};

struct ge_cached {  // (Y - X, Y + X, 2d T, 2 Z)
  fe YmX, YpX, T2d, Z2;
};

struct consts {
  fe d, d2, sqrtm1;
};

__device__ __forceinline__ void fe_0(fe& h) {
  h.v[0] = h.v[1] = h.v[2] = h.v[3] = h.v[4] = 0;
}

__device__ __forceinline__ void fe_1(fe& h) {
  fe_0(h);
  h.v[0] = 1;
}

__device__ __forceinline__ void fe_carry(fe& h) {
  uint64_t c;
  c = h.v[0] >> 51; h.v[0] &= M51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= M51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= M51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= M51; h.v[4] += c;
  c = h.v[4] >> 51; h.v[4] &= M51; h.v[0] += 19 * c;
}

__device__ __forceinline__ void fe_add(fe& h, const fe& f, const fe& g) {
#pragma unroll
  for (int i = 0; i < 5; i++) h.v[i] = f.v[i] + g.v[i];
  fe_carry(h);
}

// 4p limb-wise: 4 * (2^51 - 19), then 4 * (2^51 - 1)
static constexpr uint64_t FOURP0 = 0x1FFFFFFFFFFFB4ULL;
static constexpr uint64_t FOURP = 0x1FFFFFFFFFFFFCULL;

__device__ __forceinline__ void fe_sub(fe& h, const fe& f, const fe& g) {
  h.v[0] = f.v[0] + FOURP0 - g.v[0];
#pragma unroll
  for (int i = 1; i < 5; i++) h.v[i] = f.v[i] + FOURP - g.v[i];
  fe_carry(h);
}

__device__ __forceinline__ void fe_neg(fe& h, const fe& f) {
  fe z;
  fe_0(z);
  fe_sub(h, z, f);
}

__device__ __forceinline__ void fe_mul(fe& h, const fe& f, const fe& g) {
  const uint64_t f0 = f.v[0], f1 = f.v[1], f2 = f.v[2], f3 = f.v[3],
                 f4 = f.v[4];
  const uint64_t g0 = g.v[0], g1 = g.v[1], g2 = g.v[2], g3 = g.v[3],
                 g4 = g.v[4];
  const uint64_t g1_19 = 19 * g1, g2_19 = 19 * g2, g3_19 = 19 * g3,
                 g4_19 = 19 * g4;
  u128 r0 = (u128)f0 * g0 + (u128)f1 * g4_19 + (u128)f2 * g3_19 +
            (u128)f3 * g2_19 + (u128)f4 * g1_19;
  u128 r1 = (u128)f0 * g1 + (u128)f1 * g0 + (u128)f2 * g4_19 +
            (u128)f3 * g3_19 + (u128)f4 * g2_19;
  u128 r2 = (u128)f0 * g2 + (u128)f1 * g1 + (u128)f2 * g0 +
            (u128)f3 * g4_19 + (u128)f4 * g3_19;
  u128 r3 = (u128)f0 * g3 + (u128)f1 * g2 + (u128)f2 * g1 +
            (u128)f3 * g0 + (u128)f4 * g4_19;
  u128 r4 = (u128)f0 * g4 + (u128)f1 * g3 + (u128)f2 * g2 +
            (u128)f3 * g1 + (u128)f4 * g0;
  r1 += (uint64_t)(r0 >> 51);
  uint64_t h0 = (uint64_t)r0 & M51;
  r2 += (uint64_t)(r1 >> 51);
  uint64_t h1 = (uint64_t)r1 & M51;
  r3 += (uint64_t)(r2 >> 51);
  uint64_t h2 = (uint64_t)r2 & M51;
  r4 += (uint64_t)(r3 >> 51);
  uint64_t h3 = (uint64_t)r3 & M51;
  uint64_t c = (uint64_t)(r4 >> 51);
  uint64_t h4 = (uint64_t)r4 & M51;
  h0 += c * 19;
  h1 += h0 >> 51;
  h0 &= M51;
  h.v[0] = h0; h.v[1] = h1; h.v[2] = h2; h.v[3] = h3; h.v[4] = h4;
}

__device__ __forceinline__ void fe_sq(fe& h, const fe& f) { fe_mul(h, f, f); }

__device__ __forceinline__ void fe_sqn(fe& h, const fe& f, int n) {
  fe_sq(h, f);
  for (int i = 1; i < n; i++) fe_sq(h, h);
}

// z^(2^250 - 1) and z^11, the prefix shared by invert and pow22523
__device__ __noinline__ void fe_pow_2_250_1(fe& z2_250_0, fe& z11,
                                            const fe& z) {
  fe z2, z9, t, z2_5_0, z2_10_0, z2_20_0, z2_50_0, z2_100_0;
  fe_sq(z2, z);
  fe_sqn(t, z2, 2);
  fe_mul(z9, t, z);
  fe_mul(z11, z9, z2);
  fe_sq(t, z11);
  fe_mul(z2_5_0, t, z9);
  fe_sqn(t, z2_5_0, 5);
  fe_mul(z2_10_0, t, z2_5_0);
  fe_sqn(t, z2_10_0, 10);
  fe_mul(z2_20_0, t, z2_10_0);
  fe_sqn(t, z2_20_0, 20);
  fe_mul(t, t, z2_20_0);
  fe_sqn(t, t, 10);
  fe_mul(z2_50_0, t, z2_10_0);
  fe_sqn(t, z2_50_0, 50);
  fe_mul(z2_100_0, t, z2_50_0);
  fe_sqn(t, z2_100_0, 100);
  fe_mul(t, t, z2_100_0);
  fe_sqn(t, t, 50);
  fe_mul(z2_250_0, t, z2_50_0);
}

__device__ __forceinline__ void fe_invert(fe& h, const fe& z) {
  fe a, z11;
  fe_pow_2_250_1(a, z11, z);
  fe_sqn(a, a, 5);
  fe_mul(h, a, z11);
}

__device__ __forceinline__ void fe_pow22523(fe& h, const fe& z) {
  fe a, z11;
  fe_pow_2_250_1(a, z11, z);
  fe_sqn(a, a, 2);
  fe_mul(h, a, z);
}

// freeze to the canonical representative in [0, p), strict 51-bit limbs
__device__ __forceinline__ void fe_canon(fe& h) {
  fe_carry(h);
  fe_carry(h);
  fe_carry(h);
  uint64_t q = (h.v[0] + 19) >> 51;
  q = (h.v[1] + q) >> 51;
  q = (h.v[2] + q) >> 51;
  q = (h.v[3] + q) >> 51;
  q = (h.v[4] + q) >> 51;
  h.v[0] += 19 * q;
  uint64_t c;
  c = h.v[0] >> 51; h.v[0] &= M51; h.v[1] += c;
  c = h.v[1] >> 51; h.v[1] &= M51; h.v[2] += c;
  c = h.v[2] >> 51; h.v[2] &= M51; h.v[3] += c;
  c = h.v[3] >> 51; h.v[3] &= M51; h.v[4] += c;
  h.v[4] &= M51;
}

__device__ __forceinline__ uint64_t load_le64(const uint8_t* s) {
  uint64_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; j++) w |= (uint64_t)s[j] << (8 * j);
  return w;
}

__device__ __forceinline__ void store_le64(uint8_t* s, uint64_t w) {
#pragma unroll
  for (int j = 0; j < 8; j++) s[j] = (uint8_t)(w >> (8 * j));
}

// 32 little-endian bytes -> limbs; bit 255 is dropped (callers that need
// the sign bit read it first)
__device__ __forceinline__ void fe_frombytes(fe& h, const uint8_t* s) {
  const uint64_t w0 = load_le64(s), w1 = load_le64(s + 8),
                 w2 = load_le64(s + 16), w3 = load_le64(s + 24);
  h.v[0] = w0 & M51;
  h.v[1] = ((w0 >> 51) | (w1 << 13)) & M51;
  h.v[2] = ((w1 >> 38) | (w2 << 26)) & M51;
  h.v[3] = ((w2 >> 25) | (w3 << 39)) & M51;
  h.v[4] = (w3 >> 12) & M51;
}

// the canonical encoding as four little-endian 64-bit words (h is frozen
// in place)
__device__ __forceinline__ void fe_towords(uint64_t w[4], fe& h) {
  fe_canon(h);
  w[0] = h.v[0] | (h.v[1] << 51);
  w[1] = (h.v[1] >> 13) | (h.v[2] << 38);
  w[2] = (h.v[2] >> 26) | (h.v[3] << 25);
  w[3] = (h.v[3] >> 39) | (h.v[4] << 12);
}

// canonical little-endian encoding (h is frozen in place)
__device__ __forceinline__ void fe_tobytes(uint8_t* s, fe& h) {
  uint64_t w[4];
  fe_towords(w, h);
#pragma unroll
  for (int i = 0; i < 4; i++) store_le64(s + 8 * i, w[i]);
}

__device__ __forceinline__ bool fe_iszero(fe f) {
  fe_canon(f);
  return (f.v[0] | f.v[1] | f.v[2] | f.v[3] | f.v[4]) == 0;
}

__device__ __forceinline__ bool fe_eq(const fe& f, const fe& g) {
  fe d;
  fe_sub(d, f, g);
  return fe_iszero(d);
}

__device__ __forceinline__ int fe_parity(fe f) {
  fe_canon(f);
  return (int)(f.v[0] & 1);
}

__device__ __forceinline__ void load_consts(consts& k, const uint8_t* b) {
  fe_frombytes(k.d, b);
  fe_frombytes(k.d2, b + 32);
  fe_frombytes(k.sqrtm1, b + 64);
}

// --- group law ---------------------------------------------------------

__device__ __forceinline__ void ge_identity(ge& p) {
  fe_0(p.X);
  fe_1(p.Y);
  fe_1(p.Z);
  fe_0(p.T);
}

__device__ __forceinline__ void ge_to_cached(ge_cached& c, const ge& p,
                                             const consts& k) {
  fe_sub(c.YmX, p.Y, p.X);
  fe_add(c.YpX, p.Y, p.X);
  fe_mul(c.T2d, p.T, k.d2);
  fe_add(c.Z2, p.Z, p.Z);
}

// add-2008-hwcd-3 with the 2d / 2 factors folded into the cached operand
__device__ __forceinline__ void ge_add_cached(ge& r, const ge& p,
                                              const ge_cached& c) {
  fe a, b, cc, d, e, f, g, h, t;
  fe_sub(t, p.Y, p.X);
  fe_mul(a, t, c.YmX);
  fe_add(t, p.Y, p.X);
  fe_mul(b, t, c.YpX);
  fe_mul(cc, p.T, c.T2d);
  fe_mul(d, p.Z, c.Z2);
  fe_sub(e, b, a);
  fe_sub(f, d, cc);
  fe_add(g, d, cc);
  fe_add(h, b, a);
  fe_mul(r.X, e, f);
  fe_mul(r.Y, g, h);
  fe_mul(r.Z, f, g);
  fe_mul(r.T, e, h);
}

// ref10 ge_p2_dbl shape, the same formula as curve25519.double
__device__ __forceinline__ void ge_dbl(ge& r, const ge& p) {
  fe xx, yy, zz, aa, t, x3, y3, z3, t3;
  fe_sq(xx, p.X);
  fe_sq(yy, p.Y);
  fe_sq(zz, p.Z);
  fe_add(t, p.X, p.Y);
  fe_sq(aa, t);
  fe_add(y3, yy, xx);
  fe_sub(z3, yy, xx);
  fe_sub(x3, aa, y3);
  fe_add(t, zz, zz);
  fe_sub(t3, t, z3);
  fe_mul(r.X, x3, t3);
  fe_mul(r.Y, y3, z3);
  fe_mul(r.Z, z3, t3);
  fe_mul(r.T, x3, y3);
}

__device__ __forceinline__ void ge_neg(ge& p) {
  fe_neg(p.X, p.X);
  fe_neg(p.T, p.T);
}

__device__ __forceinline__ void ge_cached_frombytes(ge_cached& c,
                                                    const uint8_t* s) {
  fe_frombytes(c.YmX, s);
  fe_frombytes(c.YpX, s + 32);
  fe_frombytes(c.T2d, s + 64);
  fe_frombytes(c.Z2, s + 96);
}

__device__ __forceinline__ void ge_cached_tobytes(uint8_t* s, ge_cached& c) {
  fe_tobytes(s, c.YmX);
  fe_tobytes(s + 32, c.YpX);
  fe_tobytes(s + 64, c.T2d);
  fe_tobytes(s + 96, c.Z2);
}

// canonical encoding of the affine point: y, with sign(x) on bit 255
__device__ __forceinline__ void ge_compress(uint8_t* s, const ge& p) {
  fe zi, x, y;
  fe_invert(zi, p.Z);
  fe_mul(x, p.X, zi);
  fe_mul(y, p.Y, zi);
  const int sign = fe_parity(x);
  fe_tobytes(s, y);
  s[31] |= (uint8_t)(sign << 7);
}

// y < p for the 255-bit little-endian value in s (bit 255 ignored)
__device__ __forceinline__ bool bytes_lt_p(const uint8_t* s) {
  // p = 2^255 - 19: bytes ed ff .. ff 7f
  int top = s[31] & 0x7f;
  if (top != 0x7f) return true;
  for (int i = 30; i >= 1; i--)
    if (s[i] != 0xff) return true;
  return s[0] < 0xed;
}

// point decompression; valid == the host oracle's _recover_x succeeding.
// Invalid inputs still produce the point the formulas give (as the plain
// version does), so tables built from them agree byte for byte.
__device__ __forceinline__ bool ge_decompress(ge& p, const uint8_t* s,
                                              const consts& k) {
  const int sign = s[31] >> 7;
  const bool y_ok = bytes_lt_p(s);
  fe one, yy, u, v, v3, v7, t, x, vx2, nu;
  fe_1(one);
  fe_frombytes(p.Y, s);
  fe_sq(yy, p.Y);
  fe_sub(u, yy, one);
  fe_mul(v, yy, k.d);
  fe_add(v, v, one);
  fe_sq(t, v);
  fe_mul(v3, t, v);
  fe_sq(t, v3);
  fe_mul(v7, t, v);
  fe_mul(t, u, v7);
  fe_pow22523(t, t);
  fe_mul(x, u, v3);
  fe_mul(x, x, t);
  fe_sq(t, x);
  fe_mul(vx2, v, t);
  const bool ok_direct = fe_eq(vx2, u);
  fe_neg(nu, u);
  const bool ok_flipped = fe_eq(vx2, nu);
  if (ok_flipped) {
    fe_mul(t, x, k.sqrtm1);
    x = t;
  }
  const bool x_zero = fe_iszero(x);
  if (fe_parity(x) != sign && !x_zero) fe_neg(x, x);
  p.X = x;
  fe_1(p.Z);
  fe_mul(p.T, x, p.Y);
  return y_ok && (ok_direct || ok_flipped) && !(x_zero && sign == 1);
}

__device__ __forceinline__ int nibble(const uint8_t* k, int i) {
  const int b = k[i >> 1];
  return (i & 1) ? (b >> 4) : (b & 15);
}

// --- four lanes per signature ------------------------------------------
//
// A group of 4 lanes holds one signature, and every lane holds the whole
// point. Each point operation is two stages of 4 independent field
// multiplications: lane l computes the l-th product of a stage, then an
// exchange hands every lane all four, and each lane does the cheap adds
// itself. A point operation thus costs 2 dependent multiplications
// instead of 8, and every value is the one-thread function's (ge_dbl,
// ge_add_cached, ge_to_cached) limb for limb. Each lane picks its operands
// by lane index before it multiplies, so the 4 lanes run one instruction
// stream.
//
// Ex is the exchange: ex.all(o0, o1, o2, o3, mine) leaves lane j's `mine`
// in o_j on every lane of the group. On the card it is a width-4 shuffle
// (Shfl4 in ed25519_kernels.cu); in the host harness, a slot array the 4
// lanes fill in lock-step.

// h = (a, b, c, d)[lane], by selects rather than a branch
__device__ __forceinline__ void fe_pick(fe& h, int lane, const fe& a,
                                        const fe& b, const fe& c,
                                        const fe& d) {
#pragma unroll
  for (int i = 0; i < 5; i++)
    h.v[i] = lane == 0 ? a.v[i] : lane == 1 ? b.v[i]
             : lane == 2 ? c.v[i] : d.v[i];
}

// ge_dbl: lane l squares one of (X, Y, Z, X + Y), then computes one of
// (X3, Y3, Z3, T3); r may alias p
template <class Ex>
__device__ __forceinline__ void ge_dbl_x4(ge& r, const ge& p, int lane,
                                          Ex& ex) {
  fe t, a, b, mine, xx, yy, zz, aa, x3, y3, z3, t3;
  fe_add(t, p.X, p.Y);
  fe_pick(a, lane, p.X, p.Y, p.Z, t);
  fe_sq(mine, a);
  ex.all(xx, yy, zz, aa, mine);
  fe_add(y3, yy, xx);
  fe_sub(z3, yy, xx);
  fe_sub(x3, aa, y3);
  fe_add(t, zz, zz);
  fe_sub(t3, t, z3);
  fe_pick(a, lane, x3, y3, z3, x3);
  fe_pick(b, lane, t3, z3, t3, y3);
  fe_mul(mine, a, b);
  ex.all(r.X, r.Y, r.Z, r.T, mine);
}

// ge_add_cached with c = the lane's own component of the cached operand
// (YmX, YpX, T2d, Z2)[lane]: lane l computes one of (a, b, cc, d), then one
// of (X, Y, Z, T); r may alias p
template <class Ex>
__device__ __forceinline__ void ge_add_cached_x4(ge& r, const ge& p,
                                                 const fe& c, int lane,
                                                 Ex& ex) {
  fe t, u, a, b, cc, d, e, f, g, h, mine;
  fe_sub(t, p.Y, p.X);
  fe_add(u, p.Y, p.X);
  fe_pick(a, lane, t, u, p.T, p.Z);
  fe_mul(mine, a, c);
  ex.all(a, b, cc, d, mine);
  fe_sub(e, b, a);
  fe_sub(f, d, cc);
  fe_add(g, d, cc);
  fe_add(h, b, a);
  fe_pick(t, lane, e, g, f, e);
  fe_pick(u, lane, f, h, g, h);
  fe_mul(mine, t, u);
  ex.all(r.X, r.Y, r.Z, r.T, mine);
}

// the lane's component of ge_to_cached(p)
__device__ __forceinline__ void ge_to_cached_lane(fe& c, const ge& p,
                                                  const consts& k, int lane) {
  fe ymx, ypx, t2d, z2;
  fe_sub(ymx, p.Y, p.X);
  fe_add(ypx, p.Y, p.X);
  fe_mul(t2d, p.T, k.d2);
  fe_add(z2, p.Z, p.Z);
  fe_pick(c, lane, ymx, ypx, t2d, z2);
}

// How a lane reads its component of entry j (0..15) of the 16-entry
// cached window table of -A, tab(e, j), and how neg_table_x4 stores it,
// tab.store(j, c):
// - TableBytes (kernel 3): the lane's 32 canonical bytes of a stored
//   table, at tab + j * 128 (tab = the key's table + lane * 32);
// - TableLimbs<S> (kernel 4): the 5 loose limbs the lane wrote itself
//   (neg_table_x4), limb l of entry j at p[(j * 5 + l) * S]. On the card p
//   is the thread's column of a shared-memory array laid out [entry][limb]
//   [thread], S the block's threads; in the host harness a lane's column
//   of a host array.
// - TableOut (kernel 2): the store alone, the lane's component as its 32
//   canonical bytes at p + j * 128 (p = the key's table + lane * 32), in
//   whole words: two 16-byte stores on the card, so the 4 lanes of a
//   group write each entry's 128 contiguous bytes. Kernel 1 writes its
//   points through it too (dbl_chain_x4).
struct TableBytes {
  const uint8_t* tab;
  __device__ __forceinline__ void operator()(fe& e, int j) const {
    fe_frombytes(e, tab + j * 128);
  }
};

struct TableOut {
  uint8_t* p;
  __device__ __forceinline__ void store(int j, const fe& c) const {
    fe h = c;
    uint64_t w[4];
    fe_towords(w, h);
#ifdef __CUDACC__
    ulonglong2* d = reinterpret_cast<ulonglong2*>(p + j * 128);
    d[0] = make_ulonglong2(w[0], w[1]);
    d[1] = make_ulonglong2(w[2], w[3]);
#else
    for (int i = 0; i < 4; i++) store_le64(p + j * 128 + 8 * i, w[i]);
#endif
  }
};

template <int S>
struct TableLimbs {
  uint64_t* p;
  __device__ __forceinline__ void operator()(fe& e, int j) const {
#pragma unroll
    for (int l = 0; l < 5; l++) e.v[l] = p[(j * 5 + l) * S];
  }
  __device__ __forceinline__ void store(int j, const fe& c) const {
#pragma unroll
    for (int l = 0; l < 5; l++) p[(j * 5 + l) * S] = c.v[l];
  }
};

// The points of one small-tier or generic row by one lane of its group:
// acc = [k](-A) (64 windows of 4 doublings and a cached add of entry
// nibble w of k, MSB first), sb = [s]B (32 cached adds over the byte-digit
// base table), q = sb + acc. The one-thread kernel's operations in its
// order, so with the one-thread table every lane ends with its limbs.
template <class Ex, class Tab>
__device__ __forceinline__ void table_points_x4(
    ge& acc, ge& sb, ge& q, const Tab& tab, const uint8_t* ki,
    const uint8_t* si, const uint8_t* base, const consts& kc, int lane,
    Ex& ex) {
  fe e;
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    ge_dbl_x4(acc, acc, lane, ex);
    ge_dbl_x4(acc, acc, lane, ex);
    ge_dbl_x4(acc, acc, lane, ex);
    ge_dbl_x4(acc, acc, lane, ex);
    tab(e, nibble(ki, w));
    ge_add_cached_x4(acc, acc, e, lane, ex);
  }
  ge_identity(sb);
  for (int j = 0; j < 32; j++) {
    fe_frombytes(e, base + ((size_t)j * 256 + si[j]) * 128 + lane * 32);
    ge_add_cached_x4(sb, sb, e, lane, ex);
  }
  ge_to_cached_lane(e, acc, kc, lane);
  ge_add_cached_x4(q, sb, e, lane, ex);
}

// encode([s]B + [k](-A)) == R for row i: table_points_x4, then the
// compression, whose inversion runs on every lane alike
template <class Ex, class Tab>
__device__ __forceinline__ bool verify_chain_x4(
    int i, int lane, Ex& ex, const Tab& tab, const uint8_t* r,
    const uint8_t* s, const uint8_t* k, const uint8_t* base,
    const consts& kc) {
  ge acc, sb, q;
  table_points_x4(acc, sb, q, tab, k + (size_t)i * 32, s + (size_t)i * 32,
                  base, kc, lane, ex);
  uint8_t enc[32];
  ge_compress(enc, q);
  const uint8_t* ri = r + (size_t)i * 32;
  bool eq = true;
  for (int j = 0; j < 32; j++) eq &= (enc[j] == ri[j]);
  return eq;
}

// The small-tier verify of row i by one lane of its group, with the row
// gather of the JAX package's _verify_cached_small:
// encode([s]B + [k](-A)) == R, -A from the key's 16-entry cached window
// table. A row whose verdict is already decided (idx < 0 or past the
// store, invalid key, s >= L) returns at once; all 4 lanes share i, so
// the group exits together. Each lane reads only its quarter of a cached
// entry.
template <class Ex>
__device__ __forceinline__ bool verify_table_x4(
    int i, int lane, Ex& ex, const uint8_t* tables, const uint8_t* tvalid,
    int rows, const int32_t* idx, const uint8_t* r, const uint8_t* s,
    const uint8_t* k, const uint8_t* s_ok, const uint8_t* base,
    const uint8_t* kbytes) {
  const int row = idx[i];
  if (row < 0 || row >= rows || !tvalid[row] || !s_ok[i]) return false;
  consts kc;
  load_consts(kc, kbytes);
  const TableBytes tab{tables + (size_t)row * 16 * 128 + lane * 32};
  return verify_chain_x4(i, lane, ex, tab, r, s, k, base, kc);
}

// The 16-entry cached window table of a = -A by one lane of its group, in
// the one-thread order (ge_to_cached, ge_add_cached): the identity, a,
// then 14 cached adds of cached(a). Lane l stores only component l (YmX,
// YpX, T2d, Z2) of each entry into tbl (TableLimbs: the loose limbs of
// ge_to_cached_lane, the one-thread table's limbs; TableOut: their
// canonical bytes). The sequence is fixed: the entries are projective, so
// any other order of the adds gives other bytes.
template <class Ex, class Sink>
__device__ __forceinline__ void neg_table_x4(const Sink& tbl, const ge& a,
                                             const consts& kc, int lane,
                                             Ex& ex) {
  fe ac, c;
  ge_to_cached_lane(ac, a, kc, lane);
  ge cur;
  ge_identity(cur);
  for (int j = 0; j < 16; j++) {
    if (j == 1) cur = a;
    else if (j > 1) ge_add_cached_x4(cur, cur, ac, lane, ex);
    ge_to_cached_lane(c, cur, kc, lane);
    tbl.store(j, c);
  }
}

// Kernel 2's table of key `key` by one lane of its group (the JAX
// package's neg_pubkey_table): every lane decompresses A alike, lane 0
// writes valid[key], and the group builds the 16-entry cached table of -A
// (neg_table_x4) into tables + key * 2048, lane l writing component l of
// each entry as canonical bytes. An invalid key gets the table the
// formulas give (ge_decompress's contract), so there is no early exit.
template <class Ex>
__device__ __forceinline__ void neg_pubkey_table_x4(
    int key, int lane, Ex& ex, const uint8_t* pub, uint8_t* tables,
    uint8_t* valid, const uint8_t* kbytes) {
  consts kc;
  load_consts(kc, kbytes);
  ge a;
  const bool ok = ge_decompress(a, pub + (size_t)key * 32, kc);
  if (lane == 0) valid[key] = ok ? 1 : 0;
  ge_neg(a);
  const TableOut out{tables + (size_t)key * 16 * 128 + lane * 32};
  neg_table_x4(out, a, kc, lane, ex);
}

// The generic verify of row i by one lane of its group (the JAX package's
// verify_prehashed): a_valid & s_ok & encode([s]B + [k](-A)) == R, with
// the table of -A built by the group into tbl. A row with s >= L (or a
// padding row) returns before the decompression, one with an invalid key
// after it; all 4 lanes share i, so the group exits together. A lane
// reads only the table slots it wrote.
template <class Ex, int S>
__device__ __forceinline__ bool verify_generic_x4(
    int i, int lane, Ex& ex, const TableLimbs<S>& tbl, const uint8_t* pub,
    const uint8_t* r, const uint8_t* s, const uint8_t* k,
    const uint8_t* s_ok, const uint8_t* base, const uint8_t* kbytes) {
  if (!s_ok[i]) return false;
  consts kc;
  load_consts(kc, kbytes);
  ge a;
  if (!ge_decompress(a, pub + (size_t)i * 32, kc)) return false;
  ge_neg(a);
  neg_table_x4(tbl, a, kc, lane, ex);
  return verify_chain_x4(i, lane, ex, tbl, r, s, k, base, kc);
}

// Two independent ge_add_cached_x4 in one pass: p += c and q += d, each
// stage's two multiplications issued together before its exchanges, so a
// lane holds two independent products in flight. Each result is the
// one-thread ge_add_cached's limb for limb.
template <class Ex>
__device__ __forceinline__ void ge_add_cached_x4_2(ge& p, const fe& c, ge& q,
                                                   const fe& d, int lane,
                                                   Ex& ex) {
  fe t, u, a1, a2, m1, m2, a, b, cc, dd, e1, f1, g1, h1, e2, f2, g2, h2;
  fe_sub(t, p.Y, p.X);
  fe_add(u, p.Y, p.X);
  fe_pick(a1, lane, t, u, p.T, p.Z);
  fe_sub(t, q.Y, q.X);
  fe_add(u, q.Y, q.X);
  fe_pick(a2, lane, t, u, q.T, q.Z);
  fe_mul(m1, a1, c);
  fe_mul(m2, a2, d);
  ex.all(a, b, cc, dd, m1);
  fe_sub(e1, b, a);
  fe_sub(f1, dd, cc);
  fe_add(g1, dd, cc);
  fe_add(h1, b, a);
  ex.all(a, b, cc, dd, m2);
  fe_sub(e2, b, a);
  fe_sub(f2, dd, cc);
  fe_add(g2, dd, cc);
  fe_add(h2, b, a);
  fe_pick(t, lane, e1, g1, f1, e1);
  fe_pick(u, lane, f1, h1, g1, h1);
  fe_mul(m1, t, u);
  fe_pick(t, lane, e2, g2, f2, e2);
  fe_pick(u, lane, f2, h2, g2, h2);
  fe_mul(m2, t, u);
  ex.all(p.X, p.Y, p.Z, p.T, m1);
  ex.all(q.X, q.Y, q.Z, q.T, m2);
}

// The points of one big-tier row by one lane of its group:
// acc = sum_w T[row, w, k_w] (64 cached adds, window w = nibble w of k,
// LSB first, no doublings), sb = [s]B (32 cached adds over the byte-digit
// base table), and q = sb + acc. tab is the row's table plus lane * 32, so
// a lane reads its quarter of each 128-byte entry and a group one whole
// entry. The two sums are independent chains: the first 32 windows of acc
// go in one pass with the 32 adds of sb (ge_add_cached_x4_2), the last 32
// alone, so the path is 64 adds of acc, not 96. Each sum takes the same
// adds in the same order as the one-thread kernel, so acc, sb and q are
// its values limb for limb.
template <class Ex>
__device__ __forceinline__ void bigcache_points_x4(
    ge& acc, ge& sb, ge& q, const uint8_t* tab, const uint8_t* ki,
    const uint8_t* si, const uint8_t* base, const consts& kc, int lane,
    Ex& ex) {
  fe e, eb;
  ge_identity(acc);
  ge_identity(sb);
  for (int w = 0; w < 32; w++) {
    fe_frombytes(e, tab + ((size_t)w * 16 + nibble(ki, w)) * 128);
    fe_frombytes(eb, base + ((size_t)w * 256 + si[w]) * 128 + lane * 32);
    ge_add_cached_x4_2(acc, e, sb, eb, lane, ex);
  }
  for (int w = 32; w < 64; w++) {
    fe_frombytes(e, tab + ((size_t)w * 16 + nibble(ki, w)) * 128);
    ge_add_cached_x4(acc, acc, e, lane, ex);
  }
  ge_to_cached_lane(e, acc, kc, lane);
  ge_add_cached_x4(q, sb, e, lane, ex);
}

// The big-tier verify of row i by one lane of its group, with the masking
// of the JAX package's _verify_cached_big: encode([s]B + sum_w T[idx, w,
// k_w]) == R against the store of 64 x 16 fixed-window tables. A row
// whose verdict is already decided (idx < 0 or past the store, invalid
// key, s >= L) returns at once; all 4 lanes share i, so the group exits
// together. The inversion in ge_compress runs on every lane alike.
template <class Ex>
__device__ __forceinline__ bool verify_bigcache_x4(
    int i, int lane, Ex& ex, const uint8_t* tables, const uint8_t* tvalid,
    int rows, const int32_t* idx, const uint8_t* r, const uint8_t* s,
    const uint8_t* k, const uint8_t* s_ok, const uint8_t* base,
    const uint8_t* kbytes) {
  const int row = idx[i];
  if (row < 0 || row >= rows || !tvalid[row] || !s_ok[i]) return false;
  consts kc;
  load_consts(kc, kbytes);
  ge acc, sb, q;
  bigcache_points_x4(acc, sb, q, tables + (size_t)row * 64 * 16 * 128 + lane * 32,
                     k + (size_t)i * 32, s + (size_t)i * 32, base, kc, lane,
                     ex);
  uint8_t enc[32];
  ge_compress(enc, q);
  const uint8_t* ri = r + (size_t)i * 32;
  bool eq = true;
  for (int j = 0; j < 32; j++) eq &= (enc[j] == ri[j]);
  return eq;
}

// The big-tier table of one key, column j, by one lane of its group:
// T[i, j] = cached([j * 16^i](-A)) for the 64 rows i, as 128 canonical
// bytes at tables + ((key * 64 + i) * 16 + j) * 128. Every lane
// decompresses A alike; row 0's entry is the JAX package's (0, -A, then
// j - 1 adds of cached(-A)); each row is emitted before its four
// doublings, the last after the 63rd step. Lane l writes only component
// l of each entry (YmX, YpX, T2d, Z2). An invalid key gets the table the
// formulas give (ge_decompress's contract), with no early exit; lane 0 of
// column 0 writes valid[key].
template <class Ex>
__device__ __forceinline__ void neg_pubkey_bigtable_x4(
    int key, int j, int lane, Ex& ex, const uint8_t* pub, uint8_t* tables,
    uint8_t* valid, const uint8_t* kbytes) {
  consts kc;
  load_consts(kc, kbytes);
  ge cur;
  const bool ok = ge_decompress(cur, pub + (size_t)key * 32, kc);
  if (j == 0 && lane == 0) valid[key] = ok ? 1 : 0;
  ge_neg(cur);
  fe c;
  if (j == 0) {
    ge_identity(cur);
  } else if (j > 1) {
    fe ac;
    ge_to_cached_lane(ac, cur, kc, lane);
    for (int m = 1; m < j; m++) ge_add_cached_x4(cur, cur, ac, lane, ex);
  }
  uint8_t* out = tables + ((size_t)key * 64 * 16 + j) * 128 + lane * 32;
  for (int i = 0; i < 64; i++) {
    ge_to_cached_lane(c, cur, kc, lane);
    fe_tobytes(out + (size_t)i * 16 * 128, c);
    if (i < 63) {
      ge_dbl_x4(cur, cur, lane, ex);
      ge_dbl_x4(cur, cur, lane, ex);
      ge_dbl_x4(cur, cur, lane, ex);
      ge_dbl_x4(cur, cur, lane, ex);
    }
  }
}

// Kernel 1's chain of point i by one lane of its group (the repo's Pallas
// microbenchmark, dbl_chain): every lane reads the whole point (X, Y, Z,
// T as 32 canonical bytes each at in + i * 128) and runs n_dbl ge_dbl_x4,
// so it holds the one-thread chain's limbs; lane l writes coordinate l's
// canonical bytes at out + i * 128 + l * 32 (TableOut's store), so the
// group writes the point's 128 contiguous bytes. The loop stays rolled:
// each doubling is one serial chain, and a rolled loop keeps one doubling
// in the code.
template <class Ex>
__device__ __forceinline__ void dbl_chain_x4(int i, int lane, Ex& ex,
                                             const uint8_t* in, uint8_t* out,
                                             int n_dbl) {
  const uint8_t* src = in + (size_t)i * 128;
  ge p;
  fe_frombytes(p.X, src);
  fe_frombytes(p.Y, src + 32);
  fe_frombytes(p.Z, src + 64);
  fe_frombytes(p.T, src + 96);
#pragma unroll 1
  for (int j = 0; j < n_dbl; j++) ge_dbl_x4(p, p, lane, ex);
  fe c;
  fe_pick(c, lane, p.X, p.Y, p.Z, p.T);
  const TableOut dst{out + (size_t)i * 128 + lane * 32};
  dst.store(0, c);
}

}  // namespace edev
