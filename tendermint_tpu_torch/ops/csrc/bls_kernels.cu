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
// What bounds them on an H100: integer multiplies, and the length of one
// dependent chain. An Fp multiplication is 72 64x64->128-bit products (144
// 32x32->64-bit ones and as many for the reduction); a 2-pair Miller loop is
// ~14k Fp multiplications, a final exponentiation ~9k, a G2 addition 43.
// Inputs are a few KiB, so no kernel is near the memory roofline. Design:
// - the G1 sums (tm_g1_aggregate, tm_g1_add): one thread per addition.
//   The tree keeps the leaves in a global-memory scratch in Montgomery form,
//   one thread per addition of a level and __syncthreads between levels
//   (level s adds element 2is + s into 2is, the JAX package's pairing of
//   neighbours); the butterfly add gives one thread to each pair;
// - the G2 sums (tm_g2_aggregate, tm_g2_add): one warp per addition.
//   jac_add<fp2> runs as the stage programs G2_HR (z1z1 .. h, r) and
//   G2_ADD_FIN (from (2h)^2 to z3), or G2_DBL where h = r = 0, over 32-bit
//   fq slots in shared memory, its branches taken by the whole warp
//   (g2_add_w in bls12_381_device.cuh). g2_aggregate_kernel is one block of
//   kG2TreeWarps warps per tree (fewer for a small tree): all its threads
//   load the leaves, then the tree above with addition i of a level on warp
//   i mod the block's warps, each warp its own slots in dynamic shared
//   memory. g2_add_kernel gives one warp to each pair. Critical paths, in
//   dependent Fp multiplications: an addition 43 on one thread -> 5 (2
//   product stages of G2_HR, 3 of G2_ADD_FIN; a doubling 3); g2_add with its
//   loads and stores 61 -> 7; the tree of 150 keys (256 leaves, 8 levels)
//   ~362 -> 42;
// - the pairing (tm_miller, tm_final_exp): a check is one chain, so it is
//   spread over a warp. One warp per 2-pair chunk (miller_kernel) and per
//   element (final_exp_kernel) runs the stage programs of
//   bls12_381_device.cuh (run_program): each Fp12 operation is a stage of up
//   to 64 independent fq products, two a lane, and stages of additions,
//   with __syncwarp between them, over 32-bit-limb values in shared memory;
//   the two pairs' doubling and addition steps share stages with f's
//   squaring, and a bit's lines multiply together before they meet f. The
//   chunk product (chunk_product_kernel) is a tree of warp-wide products,
//   the products of a level on the block's four warps. Critical paths, in
//   dependent Fp multiplications: Miller 13,972 on one thread -> 332 (the
//   M_* programs: 5 a doubling bit, 8 an addition bit), final
//   exponentiation 8,765 -> 373 (its inversion a binary extended Euclid on
//   one lane, data-dependent halvings and subtractions, where the one
//   thread ran 610 multiplications of Fermat's).
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
constexpr int kProdWarps = 4;
constexpr int kG2TreeWarps = 16;  // warps of a G2 tree's block, at most

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

// the warp: shared-memory slots and __syncwarp
struct DevWarp {
  fq* sm;
  int lane;
  __device__ __forceinline__ fq ld(int s) const { return sm[s]; }
  __device__ __forceinline__ void st(int s, const fq& v) { sm[s] = v; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
};

// one block of warps per tree of the G2 sum: each warp's slots in dynamic
// shared memory (G2_SLOTS fq a warp), the leaves in scratch (nb points of
// six fq a tree)
__global__ void __launch_bounds__(32 * kG2TreeWarps)
    g2_aggregate_kernel(const uint8_t* in, fq* scratch, uint8_t* out, int b,
                        int nb) {
  extern __shared__ fq g2_slots[];
  const int warp = threadIdx.x >> 5;
  DevWarp w{g2_slots + prog::G2_SLOTS * warp, (int)(threadIdx.x & 31)};
  const size_t tree = blockIdx.x;
  g2_tree_w(w, warp, (int)(blockDim.x >> 5), in + tree * b * 288,
            scratch + tree * nb * 6, out + tree * 288, b, nb,
            [] { __syncthreads(); });
}

// one warp per pair of the G2 butterfly's combiner: o[i] = p[i] + q[i]
__global__ void __launch_bounds__(32)
    g2_add_kernel(const uint8_t* p, const uint8_t* q, uint8_t* o) {
  __shared__ fq sm[prog::G2_SLOTS];
  DevWarp w{sm, (int)threadIdx.x};
  const size_t i = blockIdx.x;
  g2_add_bytes_w(w, p + 288 * i, q + 288 * i, o + 288 * i);
}

// one warp per chunk of two (P, Q) pairs: its Miller value, conjugated, in
// Montgomery words into scratch
__global__ void __launch_bounds__(32)
    miller_kernel(const uint8_t* xp, const uint8_t* yp, const uint8_t* xq,
                  const uint8_t* yq, const bool* valid, uint32_t* scratch) {
  __shared__ fq sm[prog::M_SLOTS];
  DevWarp w{sm, (int)threadIdx.x};
  miller_chunk_w(w, xp, yp, xq, yq, valid, blockIdx.x,
                 scratch + 144 * (size_t)blockIdx.x);
}

// product of the c (a power of two) chunk values, as a tree of warp-wide
// products on kProdWarps warps of one block
__global__ void __launch_bounds__(32 * kProdWarps)
    chunk_product_kernel(uint32_t* s, int c, uint8_t* out) {
  __shared__ fq sm[kProdWarps][prog::C_SLOTS];
  const int warp = threadIdx.x >> 5;
  DevWarp w{sm[warp], (int)(threadIdx.x & 31)};
  chunk_product_w(w, warp, kProdWarps, s, c, out, [] { __syncthreads(); });
}

// one warp per element
__global__ void __launch_bounds__(32)
    final_exp_kernel(const uint8_t* in, uint8_t* out) {
  __shared__ fq sm[prog::FE_SLOTS];
  DevWarp w{sm, (int)threadIdx.x};
  final_exp_w(w, in + 576 * (size_t)blockIdx.x, out + 576 * (size_t)blockIdx.x);
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

inline int tree_threads(int nb) {
  return nb / 2 < kTreeThreads ? (nb / 2 > 0 ? nb / 2 : 1) : kTreeThreads;
}

// a warp for each addition of a G2 tree's first level, at most kG2TreeWarps
inline int g2_tree_warps(int nb) {
  return nb / 2 < kG2TreeWarps ? (nb / 2 > 0 ? nb / 2 : 1) : kG2TreeWarps;
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
  if (ntrees <= 0) return (int)cudaGetLastError();
  const int warps = g2_tree_warps(nb);
  const int smem = warps * prog::G2_SLOTS * (int)sizeof(fq);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        g2_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  g2_aggregate_kernel<<<ntrees, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (fq*)scratch, (uint8_t*)out, b, nb);
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
    g2_add_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)p, (const uint8_t*)q, (uint8_t*)out);
  return (int)cudaGetLastError();
}

int tm_miller(const void* xp, const void* yp, const void* xq, const void* yq,
              const void* valid, void* scratch, void* out, int c,
              void* stream) {
  if (c <= 0) return (int)cudaGetLastError();
  miller_kernel<<<c, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)xp, (const uint8_t*)yp, (const uint8_t*)xq,
      (const uint8_t*)yq, (const bool*)valid, (uint32_t*)scratch);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  chunk_product_kernel<<<1, 32 * kProdWarps, 0, (cudaStream_t)stream>>>(
      (uint32_t*)scratch, c, (uint8_t*)out);
  return (int)cudaGetLastError();
}

int tm_final_exp(const void* in, void* out, int n, void* stream) {
  if (n > 0)
    final_exp_kernel<<<n, 32, 0, (cudaStream_t)stream>>>((const uint8_t*)in,
                                                         (uint8_t*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
