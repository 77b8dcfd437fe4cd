// The BLS12-381 kernels of the quorum-certificate path, for sm_90a.
//
// Each replaces a device program of the JAX package:
//   tm_g1_aggregate  <- tendermint_tpu/ops/bls_g1.py:309 g1_aggregate (levels
//                       of g1_add :267 / g1_double :248): signature sums
//   tm_g2_aggregate  <- tendermint_tpu/ops/bls_g2.py:214 g2_aggregate
//                       (g2_add :157 / g2_double :138): public-key sums
//   tm_g1_add,       <- tendermint_tpu/ops/shard_reduce.py:48
//   tm_g2_add           aggregate_sharded (via bls_g1.py:335 and
//                       bls_g2.py:202): one round of the XOR butterfly
//                       over the mesh, x + ppermute(x), as a batch of
//                       complete additions of two point arrays
//   tm_miller        <- tendermint_tpu/ops/bls_pairing.py:405 _miller
//                       (miller_jit :476) and the chunk product :549-550
//   tm_final_exp     <- tendermint_tpu/ops/bls_pairing.py:443-502, the final
//                       exponentiation (easy_part_jit, exp_x_signed_jit,
//                       cube_jit), driven by pairing_value :541 and
//                       check_pairs :554
//
// What bounds them on an H100: integer multiplies. An Fp multiplication is
// 72 64x64->128-bit products; a 2-pair Miller loop is ~14k Fp
// multiplications, a final exponentiation ~9k, a G2 addition 43. Inputs are a few KiB, so no
// kernel is near the memory roofline. Design, simple first:
// - aggregation: one block per tree, the leaves in a global-memory scratch
//   in Montgomery form, one thread per addition of a level and
//   __syncthreads between levels (level s adds element 2is + s into 2is,
//   the JAX package's pairing of neighbours);
// - Miller: one thread per 2-pair chunk, state in local memory; a second
//   kernel (one block) multiplies the chunk values as a tree;
// - final exponentiation: one thread per element;
// - the butterfly add: one thread per pair, the tree's device add; a round
//   adds one partial per shard, so each launch has one active thread.
// A pairing check is therefore two serial chains on two threads, and the
// card is nearly idle; spreading an Fp12 product over a warp is later work.
// Heavy helpers are __noinline__ to keep nvcc's time and the code small.
//
// Plain C interface: no PyTorch headers here. Launchers run on the caller's
// stream, allocate nothing (the wrappers pass the scratch), and return
// cudaGetLastError() of their launches.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bls12_381_device.cuh"

using namespace bdev;

namespace {

constexpr int kTreeThreads = 128;
constexpr int kChunkThreads = 32;

template <class F>
__device__ void aggregate_tree(const uint8_t* in, jac<F>* scratch,
                               uint8_t* out, int b, int nb) {
  constexpr int kCoord = (int)(sizeof(F) / sizeof(fp)) * 48;  // bytes
  constexpr int kBytes = 3 * kCoord;
  const int tree = blockIdx.x;
  jac<F>* s = scratch + (size_t)tree * nb;
  const uint8_t* src = in + (size_t)tree * b * kBytes;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    if (i < b) {
      fe_load(s[i].x, src + (size_t)i * kBytes);
      fe_load(s[i].y, src + (size_t)i * kBytes + kCoord);
      fe_load(s[i].z, src + (size_t)i * kBytes + 2 * kCoord);
    } else {
      jac_identity(s[i]);
    }
  }
  __syncthreads();
  for (int step = 1; step < nb; step <<= 1) {
    for (int i = threadIdx.x; 2 * i * step < nb; i += blockDim.x) {
      const int k = 2 * i * step;
      jac<F> r;
      jac_add(r, s[k], s[k + step]);
      s[k] = r;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    uint8_t* dst = out + (size_t)tree * kBytes;
    fe_store(dst, s[0].x);
    fe_store(dst + kCoord, s[0].y);
    fe_store(dst + 2 * kCoord, s[0].z);
  }
}

__global__ void g1_aggregate_kernel(const uint8_t* in, jac<fp>* scratch,
                                    uint8_t* out, int b, int nb) {
  aggregate_tree<fp>(in, scratch, out, b, nb);
}

__global__ void g2_aggregate_kernel(const uint8_t* in, jac<fp2>* scratch,
                                    uint8_t* out, int b, int nb) {
  aggregate_tree<fp2>(in, scratch, out, b, nb);
}

// o[i] = p[i] + q[i], one thread per pair (the butterfly's combiner)
template <class F>
__device__ void add_pairs(const uint8_t* p, const uint8_t* q, uint8_t* o,
                          int n) {
  constexpr int kCoord = (int)(sizeof(F) / sizeof(fp)) * 48;  // bytes
  constexpr int kBytes = 3 * kCoord;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  jac<F> a, b, r;
  const uint8_t* pa = p + (size_t)i * kBytes;
  const uint8_t* qb = q + (size_t)i * kBytes;
  fe_load(a.x, pa);
  fe_load(a.y, pa + kCoord);
  fe_load(a.z, pa + 2 * kCoord);
  fe_load(b.x, qb);
  fe_load(b.y, qb + kCoord);
  fe_load(b.z, qb + 2 * kCoord);
  jac_add(r, a, b);
  uint8_t* dst = o + (size_t)i * kBytes;
  fe_store(dst, r.x);
  fe_store(dst + kCoord, r.y);
  fe_store(dst + 2 * kCoord, r.z);
}

__global__ void g1_add_kernel(const uint8_t* p, const uint8_t* q, uint8_t* o,
                              int n) {
  add_pairs<fp>(p, q, o, n);
}

__global__ void g2_add_kernel(const uint8_t* p, const uint8_t* q, uint8_t* o,
                              int n) {
  add_pairs<fp2>(p, q, o, n);
}

// one thread per chunk of two (P, Q) pairs; invalid pairs fold the
// identity line (skipped)
__global__ void miller_kernel(const uint8_t* xp, const uint8_t* yp,
                              const uint8_t* xq, const uint8_t* yq,
                              const bool* valid, fp12* scratch, int c) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= c) return;
  fp px[2], py[2];
  fp2 qx[2], qy[2], tx[2], ty[2], tz[2];
  bool v[2];
  for (int i = 0; i < 2; i++) {
    const int r = 2 * k + i;
    fp_load(px[i], xp + 48 * r);
    fp_load(py[i], yp + 48 * r);
    f2_load(qx[i], xq + 96 * r);
    f2_load(qy[i], yq + 96 * r);
    v[i] = valid[r];
    tx[i] = qx[i];
    ty[i] = qy[i];
    fp_one(tz[i].c0);
    fp_zero(tz[i].c1);
  }
  fp12 f;
  f12_one(f);
  for (int bit = 62; bit >= 0; bit--) {
    f12_sqr(f, f);
    for (int i = 0; i < 2; i++) {
      fp2 l0, l2, l3;
      miller_dbl_step(l0, l2, l3, tx[i], ty[i], tz[i], px[i], py[i]);
      if (v[i]) f12_mul_line(f, f, l0, l2, l3);
    }
    if ((X_ABS >> bit) & 1) {
      for (int i = 0; i < 2; i++) {
        fp2 l0, l2, l3;
        miller_add_step(l0, l2, l3, tx[i], ty[i], tz[i], qx[i], qy[i], px[i],
                        py[i]);
        if (v[i]) f12_mul_line(f, f, l0, l2, l3);
      }
    }
  }
  f12_conj(scratch[k], f);
}

// product of the c (a power of two) chunk values, as a tree, in one block
__global__ void chunk_product_kernel(fp12* s, int c, uint8_t* out) {
  for (int step = 1; step < c; step <<= 1) {
    for (int i = threadIdx.x; 2 * i * step < c; i += blockDim.x) {
      const int k = 2 * i * step;
      fp12 r;
      f12_mul(r, s[k], s[k + step]);
      s[k] = r;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) f12_store(out, s[0]);
}

__global__ void final_exp_kernel(const uint8_t* in, uint8_t* out, int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  fp2 gamma[6];
  fp12_gamma(gamma);
  fp12 f, r;
  f12_load(f, in + 576 * k);
  final_exponentiation(r, f, gamma);
  f12_store(out + 576 * k, r);
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

inline int tree_threads(int nb) {
  return nb / 2 < kTreeThreads ? (nb / 2 > 0 ? nb / 2 : 1) : kTreeThreads;
}

}  // namespace

extern "C" {

int tm_g1_aggregate(const void* in, void* scratch, void* out, int ntrees,
                    int b, int nb, void* stream) {
  if (ntrees > 0)
    g1_aggregate_kernel<<<ntrees, tree_threads(nb), 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (jac<fp>*)scratch, (uint8_t*)out, b, nb);
  return (int)cudaGetLastError();
}

int tm_g2_aggregate(const void* in, void* scratch, void* out, int ntrees,
                    int b, int nb, void* stream) {
  if (ntrees > 0)
    g2_aggregate_kernel<<<ntrees, tree_threads(nb), 0, (cudaStream_t)stream>>>(
        (const uint8_t*)in, (jac<fp2>*)scratch, (uint8_t*)out, b, nb);
  return (int)cudaGetLastError();
}

int tm_g1_add(const void* p, const void* q, void* out, int n, void* stream) {
  if (n > 0)
    g1_add_kernel<<<blocks_for(n, kChunkThreads), kChunkThreads, 0,
                    (cudaStream_t)stream>>>((const uint8_t*)p,
                                            (const uint8_t*)q, (uint8_t*)out,
                                            n);
  return (int)cudaGetLastError();
}

int tm_g2_add(const void* p, const void* q, void* out, int n, void* stream) {
  if (n > 0)
    g2_add_kernel<<<blocks_for(n, kChunkThreads), kChunkThreads, 0,
                    (cudaStream_t)stream>>>((const uint8_t*)p,
                                            (const uint8_t*)q, (uint8_t*)out,
                                            n);
  return (int)cudaGetLastError();
}

int tm_miller(const void* xp, const void* yp, const void* xq, const void* yq,
              const void* valid, void* scratch, void* out, int c,
              void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  miller_kernel<<<blocks_for(c, kChunkThreads), kChunkThreads, 0,
                  (cudaStream_t)stream>>>(
      (const uint8_t*)xp, (const uint8_t*)yp, (const uint8_t*)xq,
      (const uint8_t*)yq, (const bool*)valid, (fp12*)scratch, c);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  chunk_product_kernel<<<1, tree_threads(c > 1 ? c : 2), 0,
                       (cudaStream_t)stream>>>((fp12*)scratch, c,
                                               (uint8_t*)out);
  return (int)cudaGetLastError();
}

int tm_final_exp(const void* in, void* out, int n, void* stream) {
  if (n > 0)
    final_exp_kernel<<<blocks_for(n, kChunkThreads), kChunkThreads, 0,
                       (cudaStream_t)stream>>>((const uint8_t*)in,
                                               (uint8_t*)out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
