// secp256k1 ECDSA verification on the card, for sm_90a:
//   verdict = ok_in & ~inf(R) & (x(R) mod n == r),  R = u1 G + u2 Q.
//
//   tm_secp_verify  <- tendermint_tpu/ops/secp256k1_kernel.py:161
//                      verify_prehashed (its field: ops/vecfield.py:29
//                      make_field)
//
// What bounds it on an H100: integer multiplies. A row is 263 doublings
// (the ladder's 256, 3 in the table of Q and 4 inside the table's and the
// ladder's equal-point cases at most) of 7 field multiplications and
// about 135 additions of 16, ~3.9k 256-bit multiplications of 16
// 64x64->128-bit products each, against 193 bytes read and one written:
// far above the card's ~5 operations per byte, so memory is never the
// limit. Design, simple first:
// - one thread per row, the field in 4 x 64-bit words (secp256k1_device.cuh)
//   with products through unsigned __int128 and the high half folded
//   through 2^256 = 0x1000003D1 (mod p), every value canonical;
// - the radix-16 Straus ladder of the JAX package, most significant digit
//   first: 64 steps of 4 doublings, one addition from the row's table of
//   16 multiples of Q (built as the JAX package builds it, in local
//   memory) and one from the 16 multiples of G, which the block loads into
//   shared memory (neighbouring threads read different entries; constant
//   memory would serialise them);
// - no inversion: with Z != 0, x(R) == r iff r < p and X == r Z^2, and the
//   wrapped branch x(R) - n == r iff r + n < p and X == (r + n) Z^2 (mod
//   p), the same verdict as the JAX package's invert-then-compare with its
//   borrow guard;
// - a row whose host checks failed (ok_in false, every padding row) exits
//   at once: its verdict is false whatever R is.
// 32 threads a block spread a few thousand rows over the card's 132 SMs;
// each thread is one serial chain, so the card is latency-bound.
//
// Plain C interface, as the other kernels: the launcher runs on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1_device.cuh"

using namespace sdev;

namespace {

constexpr int kThreads = 32;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// n, the group order, as little-endian words
__constant__ uint64_t kN[4] = {0xBFD25E8CD0364141ull, 0xBAAEDCE6AF48A03Bull,
                               0xFFFFFFFFFFFFFFFEull, 0xFFFFFFFFFFFFFFFFull};

// the big-endian 32-byte integer at b as 4 little-endian words
__device__ __forceinline__ void load_be256(uint64_t* w, const uint8_t* b) {
  for (int i = 0; i < 4; i++) {
    uint64_t x = 0;
    for (int j = 0; j < 8; j++) x = (x << 8) | b[8 * (3 - i) + j];
    w[i] = x;
  }
}

// the radix-16 digit k (most significant first) of a big-endian scalar
__device__ __forceinline__ int nibble(const uint8_t* s, int k) {
  const int byte = s[k >> 1];
  return (k & 1) ? (byte & 15) : (byte >> 4);
}

// c < p for a 4-word integer (the value itself, not mod p)
__device__ __forceinline__ bool lt_p(const uint64_t* c) {
  fe x, t;
  for (int i = 0; i < 4; i++) x.v[i] = c[i];
  return sub_p(t, x) != 0;
}

// X == c Z^2 (mod p) for a canonical c
__device__ __forceinline__ bool x_matches(const point& R, const fe& z2,
                                          const uint64_t* c) {
  fe cf, t;
  for (int i = 0; i < 4; i++) cf.v[i] = c[i];
  fe_mul(t, cf, z2);
  return fe_eq(t, R.x);
}

__global__ void __launch_bounds__(kThreads)
secp_verify_kernel(const int32_t* __restrict__ qx,
                   const int32_t* __restrict__ qy,
                   const uint8_t* __restrict__ u1,
                   const uint8_t* __restrict__ u2,
                   const uint8_t* __restrict__ r_bytes,
                   const bool* __restrict__ ok_in,
                   const uint64_t* __restrict__ gtab, bool* __restrict__ out,
                   int b) {
  __shared__ point g[16];
  for (int k = threadIdx.x; k < 16 * 12; k += blockDim.x)
    (&g[0].x.v[0])[k] = gtab[k];
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= b) return;
  if (!ok_in[row]) {
    out[row] = false;
    return;
  }
  point q;
  fe_from_limbs(q.x, qx + (size_t)row * 32);
  fe_from_limbs(q.y, qy + (size_t)row * 32);
  fe_set_u64(q.z, 1);
  // per-row table of Q: even entries by doubling, odd by one addition
  point tab[16];
  pt_identity(tab[0]);
  tab[1] = q;
#pragma unroll 1
  for (int d = 2; d < 16; d++) {
    if (d % 2 == 0)
      pt_double(tab[d], tab[d / 2]);
    else
      pt_add(tab[d], tab[d - 1], q);
  }
  const uint8_t* s1 = u1 + (size_t)row * 32;
  const uint8_t* s2 = u2 + (size_t)row * 32;
  point acc;
  pt_identity(acc);
#pragma unroll 1
  for (int k = 0; k < 64; k++) {
    for (int j = 0; j < 4; j++) pt_double(acc, acc);
    pt_add(acc, acc, tab[nibble(s2, k)]);
    pt_add(acc, acc, g[nibble(s1, k)]);
  }
  if (fe_is_zero(acc.z)) {  // R at infinity
    out[row] = false;
    return;
  }
  fe z2;
  fe_sqr(z2, acc.z);
  uint64_t r[4], rn[4];
  load_be256(r, r_bytes + (size_t)row * 32);
  // r + n, and whether it carried past 2^256
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)r[i] + kN[i];
    rn[i] = (uint64_t)c;
    c >>= 64;
  }
  const bool direct = lt_p(r) && x_matches(acc, z2, r);
  const bool wrapped = c == 0 && lt_p(rn) && x_matches(acc, z2, rn);
  out[row] = direct || wrapped;
}

}  // namespace

extern "C" {

int tm_secp_verify(const void* qx, const void* qy, const void* u1,
                   const void* u2, const void* r, const void* ok_in,
                   const void* gtab, void* out, int b, void* stream) {
  if (b > 0)
    secp_verify_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)qx, (const int32_t*)qy, (const uint8_t*)u1,
        (const uint8_t*)u2, (const uint8_t*)r, (const bool*)ok_in,
        (const uint64_t*)gtab, (bool*)out, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
