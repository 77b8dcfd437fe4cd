// The ed25519 kernels of the commit-verification paths, for sm_90a.
//
// Each replaces a device program of the JAX package:
//   tm_neg_pubkey_table     <- tendermint_tpu/ops/ed25519_batch.py:51
//                              neg_pubkey_table (table build, once per key)
//   tm_verify_table         <- tendermint_tpu/ops/ed25519_batch.py:65
//                              verify_prehashed_table, with the row gather
//                              of crypto/batch_verifier.py:125
//                              _verify_cached_small
//   tm_verify_generic       <- tendermint_tpu/ops/ed25519_batch.py:36
//                              verify_prehashed (cache-overflow path)
//   tm_dbl_chain            <- tools/microbench_pallas.py:106 dbl_chain (the
//                              repo's one pl.pallas_call)
//   tm_neg_pubkey_bigtable  <- tendermint_tpu/ops/ed25519_batch.py:80
//                              neg_pubkey_bigtable (curve25519.py:311
//                              big_window_table): the big tier's 64 x 16
//                              fixed-window table, once per key
//   tm_verify_bigcache      <- tendermint_tpu/ops/ed25519_batch.py:96
//                              verify_prehashed_bigcache with the masking of
//                              crypto/batch_verifier.py:143 _verify_cached_big;
//                              also the launch of :115
//                              verify_prehashed_bigcache_mxu, whose one-hot
//                              MXU product is the TPU's way to gather
//
// What bounds them on an H100: integer multiplies. A small-tier verify is
// ~3.1k field multiplications of 25 64x64->128-bit products each and reads
// ~12 KiB of table bytes, almost all from L2; a big-tier verify ~1.0k
// multiplications and 8 KiB of gathered table; no kernel is near the memory
// roofline. Design: one thread per signature (per point for dbl_chain, per
// key and column for the big table), limbs in registers, no shared memory.
// The generic kernel's 16-entry cached table (2.5 KiB per thread) lives in
// local memory. Rows whose verdict is already decided (invalid key,
// s >= L, padding, idx < 0 or past the store) skip the arithmetic, and no
// row reads outside its inputs. Faster designs (cooperative rows,
// shared-memory tables) are later work.
//
// Plain C interface: no PyTorch headers here, so nvcc builds this file in
// seconds. Launchers run on the caller's stream, allocate nothing, and
// return cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ed25519_device.cuh"

using namespace edev;

namespace {

constexpr int kThreads = 128;

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

__device__ __forceinline__ int nibble(const uint8_t* k, int i) {
  const int b = k[i >> 1];
  return (i & 1) ? (b >> 4) : (b & 15);
}

// [s]B from the 32 x 256 byte-digit table of cached basepoint multiples
__device__ __forceinline__ void scalar_mult_base(ge& acc, const uint8_t* s,
                                                 const uint8_t* base) {
  ge_identity(acc);
  ge_cached e;
  for (int i = 0; i < 32; i++) {
    ge_cached_frombytes(e, base + ((size_t)i * 256 + s[i]) * 128);
    ge_add_cached(acc, acc, e);
  }
}

// [s]B + [k](-A) encoded and compared with R
__device__ __forceinline__ bool finish(const ge& sb, const ge& ka,
                                       const uint8_t* r, const consts& kc) {
  ge_cached c;
  ge q;
  ge_to_cached(c, ka, kc);
  ge_add_cached(q, sb, c);
  uint8_t enc[32];
  ge_compress(enc, q);
  bool eq = true;
  for (int j = 0; j < 32; j++) eq &= (enc[j] == r[j]);
  return eq;
}

__global__ void __launch_bounds__(kThreads)
neg_pubkey_table_kernel(const uint8_t* __restrict__ pub,
                        uint8_t* __restrict__ tables,
                        uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ kbytes, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  consts kc;
  load_consts(kc, kbytes);
  ge a;
  valid[i] = ge_decompress(a, pub + (size_t)i * 32, kc) ? 1 : 0;
  ge_neg(a);
  ge_cached ac, c;
  ge_to_cached(ac, a, kc);
  ge cur;
  ge_identity(cur);
  uint8_t* out = tables + (size_t)i * 16 * 128;
  for (int j = 0; j < 16; j++) {
    if (j == 1) cur = a;
    else if (j > 1) ge_add_cached(cur, cur, ac);
    ge_to_cached(c, cur, kc);
    ge_cached_tobytes(out + j * 128, c);
  }
}

__global__ void __launch_bounds__(kThreads)
verify_table_kernel(const uint8_t* __restrict__ tables,
                    const uint8_t* __restrict__ tvalid, int rows,
                    const int32_t* __restrict__ idx,
                    const uint8_t* __restrict__ r,
                    const uint8_t* __restrict__ s,
                    const uint8_t* __restrict__ k,
                    const uint8_t* __restrict__ s_ok,
                    const uint8_t* __restrict__ base,
                    const uint8_t* __restrict__ kbytes,
                    uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int row = idx[i];
  if (row < 0 || row >= rows || !tvalid[row] || !s_ok[i]) {
    out[i] = 0;
    return;
  }
  consts kc;
  load_consts(kc, kbytes);
  const uint8_t* tab = tables + (size_t)row * 16 * 128;
  const uint8_t* ki = k + (size_t)i * 32;
  ge acc;
  ge_cached e;
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_cached_frombytes(e, tab + nibble(ki, w) * 128);
    ge_add_cached(acc, acc, e);
  }
  ge sb;
  scalar_mult_base(sb, s + (size_t)i * 32, base);
  out[i] = finish(sb, acc, r + (size_t)i * 32, kc) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
verify_generic_kernel(const uint8_t* __restrict__ pub,
                      const uint8_t* __restrict__ r,
                      const uint8_t* __restrict__ s,
                      const uint8_t* __restrict__ k,
                      const uint8_t* __restrict__ s_ok,
                      const uint8_t* __restrict__ base,
                      const uint8_t* __restrict__ kbytes,
                      uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  consts kc;
  load_consts(kc, kbytes);
  ge a;
  const bool a_ok = ge_decompress(a, pub + (size_t)i * 32, kc);
  if (!a_ok || !s_ok[i]) {
    out[i] = 0;
    return;
  }
  ge_neg(a);
  // cached(0, -A, ..., -15A) in local memory
  ge_cached tbl[16];
  ge_cached ac;
  ge_to_cached(ac, a, kc);
  ge cur;
  ge_identity(cur);
  for (int j = 0; j < 16; j++) {
    if (j == 1) cur = a;
    else if (j > 1) ge_add_cached(cur, cur, ac);
    ge_to_cached(tbl[j], cur, kc);
  }
  const uint8_t* ki = k + (size_t)i * 32;
  ge acc;
  ge_identity(acc);
  for (int w = 63; w >= 0; w--) {
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_dbl(acc, acc);
    ge_add_cached(acc, acc, tbl[nibble(ki, w)]);
  }
  ge sb;
  scalar_mult_base(sb, s + (size_t)i * 32, base);
  out[i] = finish(sb, acc, r + (size_t)i * 32, kc) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
dbl_chain_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int b, int n_dbl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const uint8_t* src = in + (size_t)i * 128;
  ge p;
  fe_frombytes(p.X, src);
  fe_frombytes(p.Y, src + 32);
  fe_frombytes(p.Z, src + 64);
  fe_frombytes(p.T, src + 96);
  for (int j = 0; j < n_dbl; j++) ge_dbl(p, p);
  uint8_t* dst = out + (size_t)i * 128;
  fe_tobytes(dst, p.X);
  fe_tobytes(dst + 32, p.Y);
  fe_tobytes(dst + 64, p.Z);
  fe_tobytes(dst + 96, p.T);
}

// Big-tier table: T[i, j] = cached([j * 16^i](-A)), 64 rows x 16 columns
// of 128 canonical bytes (128 KiB per key). One thread per (key, column
// j): the 16 columns are independent chains of 63 x 4 doublings. Thread j
// forms row 0's entry j as the JAX package does (0, -A, then j - 1 adds
// of cached(-A)), repeating the adds of the columns before it, which is
// deterministic and gives the same projective values; each row is emitted
// as to_cached before its four doublings, the last after the 63rd step.
__global__ void __launch_bounds__(kThreads)
neg_pubkey_bigtable_kernel(const uint8_t* __restrict__ pub,
                           uint8_t* __restrict__ tables,
                           uint8_t* __restrict__ valid,
                           const uint8_t* __restrict__ kbytes, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 16) return;
  const int key = t >> 4, j = t & 15;
  consts kc;
  load_consts(kc, kbytes);
  ge a;
  const bool ok = ge_decompress(a, pub + (size_t)key * 32, kc);
  if (j == 0) valid[key] = ok ? 1 : 0;
  ge_neg(a);
  ge cur;
  if (j == 0) {
    ge_identity(cur);
  } else {
    cur = a;
    if (j > 1) {
      ge_cached ac;
      ge_to_cached(ac, a, kc);
      for (int m = 1; m < j; m++) ge_add_cached(cur, cur, ac);
    }
  }
  uint8_t* out = tables + (size_t)key * 64 * 16 * 128 + (size_t)j * 128;
  ge_cached c;
  for (int i = 0; i < 64; i++) {
    ge_to_cached(c, cur, kc);
    ge_cached_tobytes(out + (size_t)i * 16 * 128, c);
    if (i < 63) {
      ge_dbl(cur, cur);
      ge_dbl(cur, cur);
      ge_dbl(cur, cur);
      ge_dbl(cur, cur);
    }
  }
}

// Big-tier verify: [s]B + sum_i T[idx, i, k_i] with k's radix-16 digits
// LSB first (window i is nibble i), 64 cached adds and no doublings.
__global__ void __launch_bounds__(kThreads)
verify_bigcache_kernel(const uint8_t* __restrict__ tables,
                       const uint8_t* __restrict__ tvalid, int rows,
                       const int32_t* __restrict__ idx,
                       const uint8_t* __restrict__ r,
                       const uint8_t* __restrict__ s,
                       const uint8_t* __restrict__ k,
                       const uint8_t* __restrict__ s_ok,
                       const uint8_t* __restrict__ base,
                       const uint8_t* __restrict__ kbytes,
                       uint8_t* __restrict__ out, int b) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const int row = idx[i];
  if (row < 0 || row >= rows || !tvalid[row] || !s_ok[i]) {
    out[i] = 0;
    return;
  }
  consts kc;
  load_consts(kc, kbytes);
  const uint8_t* tab = tables + (size_t)row * 64 * 16 * 128;
  const uint8_t* ki = k + (size_t)i * 32;
  ge acc;
  ge_cached e;
  ge_identity(acc);
  for (int w = 0; w < 64; w++) {
    ge_cached_frombytes(e, tab + ((size_t)w * 16 + nibble(ki, w)) * 128);
    ge_add_cached(acc, acc, e);
  }
  ge sb;
  scalar_mult_base(sb, s + (size_t)i * 32, base);
  out[i] = finish(sb, acc, r + (size_t)i * 32, kc) ? 1 : 0;
}

}  // namespace

extern "C" {

int tm_neg_pubkey_table(const void* pub, void* tables, void* valid,
                        const void* kbytes, int n, void* stream) {
  if (n > 0)
    neg_pubkey_table_kernel<<<blocks_for(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const uint8_t*)pub, (uint8_t*)tables, (uint8_t*)valid,
        (const uint8_t*)kbytes, n);
  return (int)cudaGetLastError();
}

int tm_verify_table(const void* tables, const void* tvalid, int rows,
                    const void* idx, const void* r, const void* s,
                    const void* k, const void* s_ok, const void* base,
                    const void* kbytes, void* out, int b, void* stream) {
  if (b > 0)
    verify_table_kernel<<<blocks_for(b), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint8_t*)tables, (const uint8_t*)tvalid, rows,
        (const int32_t*)idx, (const uint8_t*)r, (const uint8_t*)s,
        (const uint8_t*)k, (const uint8_t*)s_ok, (const uint8_t*)base,
        (const uint8_t*)kbytes, (uint8_t*)out, b);
  return (int)cudaGetLastError();
}

int tm_verify_generic(const void* pub, const void* r, const void* s,
                      const void* k, const void* s_ok, const void* base,
                      const void* kbytes, void* out, int b, void* stream) {
  if (b > 0)
    verify_generic_kernel<<<blocks_for(b), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)s,
        (const uint8_t*)k, (const uint8_t*)s_ok, (const uint8_t*)base,
        (const uint8_t*)kbytes, (uint8_t*)out, b);
  return (int)cudaGetLastError();
}

int tm_dbl_chain(const void* in, void* out, int b, int n_dbl, void* stream) {
  if (b > 0)
    dbl_chain_kernel<<<blocks_for(b), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)out, b, n_dbl);
  return (int)cudaGetLastError();
}

int tm_neg_pubkey_bigtable(const void* pub, void* tables, void* valid,
                           const void* kbytes, int n, void* stream) {
  if (n > 0)
    neg_pubkey_bigtable_kernel<<<blocks_for(n * 16), kThreads, 0,
                                 (cudaStream_t)stream>>>(
        (const uint8_t*)pub, (uint8_t*)tables, (uint8_t*)valid,
        (const uint8_t*)kbytes, n);
  return (int)cudaGetLastError();
}

int tm_verify_bigcache(const void* tables, const void* tvalid, int rows,
                       const void* idx, const void* r, const void* s,
                       const void* k, const void* s_ok, const void* base,
                       const void* kbytes, void* out, int b, void* stream) {
  if (b > 0)
    verify_bigcache_kernel<<<blocks_for(b), kThreads, 0,
                             (cudaStream_t)stream>>>(
        (const uint8_t*)tables, (const uint8_t*)tvalid, rows,
        (const int32_t*)idx, (const uint8_t*)r, (const uint8_t*)s,
        (const uint8_t*)k, (const uint8_t*)s_ok, (const uint8_t*)base,
        (const uint8_t*)kbytes, (uint8_t*)out, b);
  return (int)cudaGetLastError();
}

const char* tm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
