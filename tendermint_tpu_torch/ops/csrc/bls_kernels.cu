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
// ~14k Fp multiplications, a final exponentiation ~9k, a G2 addition 43, a
// G1 addition 16.
// Inputs are a few KiB, so no kernel is near the memory roofline. Design:
// - the G1 sums (tm_g1_aggregate, tm_g1_add): a group of lanes per
//   addition, several groups a warp: 4 lanes in the tree (kG1TreeLanes),
//   8 in the pair sum (kG1AddLanes), each the faster of the two widths on
//   an H100 (the tree takes its first level in one round of 128 groups;
//   the pair sum loads its six coordinates in one round). jac_add<fp> runs
//   as the stage programs G1_HR and G1_ADD_FIN, or G1_DBL where h = r = 0, over
//   fq slots in the group's own region of shared memory, its branches taken
//   by the whole group and its syncs __syncwarp over the group's lanes
//   (g1_add_g in bls12_381_device.cuh); the groups of a warp run apart.
//   g1_aggregate_kernel is one block of up to kG1TreeWarps warps of groups
//   per tree: all its threads load the leaves into a global-memory scratch
//   in Montgomery form, then addition i of a level runs on group i mod the
//   block's groups, __syncthreads between levels (level s adds element
//   2is + s into 2is, the JAX package's pairing of neighbours).
//   g1_add_kernel gives one group to each pair. Critical paths, in
//   dependent Fp multiplications: an addition 16 on one thread -> 5 (2
//   product stages of G1_HR, 3 of G1_ADD_FIN; a doubling 3); g1_add with
//   its loads and stores 25 -> 7 (a load a lane on eight lanes); the tree
//   of 150 keys (256 leaves, 8 levels, a level's additions on 128 groups in
//   one round) 137 -> 42;
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

constexpr int kProdWarps = 4;
constexpr int kG2TreeWarps = 16;  // warps of a G2 tree's block, at most
constexpr int kG1TreeLanes = 4;  // lanes of a G1 tree addition's group
constexpr int kG1TreeWarps = 16;  // warps of a G1 tree's block, at most
constexpr int kG1AddLanes = 8;   // lanes of a G1 pair sum's group
constexpr int kG1AddGroups = 32 / kG1AddLanes;  // pair sums a block

// a warp (G = 32), or a group of G lanes of one warp: its slots in shared
// memory and __syncwarp over its own lanes
template <int G>
struct DevLanes {
  static constexpr int kLanes = G;
  fq* sm;
  int lane;  // in the group
  unsigned mask = 0xffffffffu;  // the group's lanes in its warp
  __device__ __forceinline__ fq ld(int s) const { return sm[s]; }
  __device__ __forceinline__ void st(int s, const fq& v) { sm[s] = v; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

using DevWarp = DevLanes<32>;
using G1TreeGroup = DevLanes<kG1TreeLanes>;
using G1AddGroup = DevLanes<kG1AddLanes>;

// one block of lane groups per tree of the G1 sum: each group's slots in
// dynamic shared memory (G1_SLOTS fq a group), the leaves in scratch (nb
// points of three fq a tree)
__global__ void __launch_bounds__(32 * kG1TreeWarps)
    g1_aggregate_kernel(const uint8_t* in, fq* scratch, uint8_t* out, int b,
                        int nb) {
  extern __shared__ fq g1_slots[];
  const int group = threadIdx.x / kG1TreeLanes;
  G1TreeGroup w{g1_slots + prog::G1_SLOTS * group, (int)(threadIdx.x % kG1TreeLanes),
                group_mask<kG1TreeLanes>(threadIdx.x & 31)};
  const size_t tree = blockIdx.x;
  g1_tree_g(w, group, (int)(blockDim.x / kG1TreeLanes), in + tree * b * 144,
            scratch + tree * nb * 3, out + tree * 144, b, nb,
            [] { __syncthreads(); });
}

// one group per pair of the G1 butterfly's combiner, a warp's groups to a
// block: o[i] = p[i] + q[i]
__global__ void __launch_bounds__(32)
    g1_add_kernel(const uint8_t* p, const uint8_t* q, uint8_t* o, int n) {
  __shared__ fq sm[kG1AddGroups][prog::G1_SLOTS];
  const int group = threadIdx.x / kG1AddLanes;
  const size_t i = (size_t)blockIdx.x * kG1AddGroups + group;
  if (i >= (size_t)n) return;  // the whole group
  G1AddGroup w{sm[group], (int)(threadIdx.x % kG1AddLanes),
               group_mask<kG1AddLanes>(threadIdx.x)};
  g1_add_bytes_g(w, p + 144 * i, q + 144 * i, o + 144 * i);
}

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

// a group for each addition of a G1 tree's first level, at most
// kG1TreeWarps warps of them
inline int g1_tree_groups(int nb) {
  constexpr int most = kG1TreeWarps * (32 / kG1TreeLanes);
  return nb / 2 < most ? (nb / 2 > 0 ? nb / 2 : 1) : most;
}

// a warp for each addition of a G2 tree's first level, at most kG2TreeWarps
inline int g2_tree_warps(int nb) {
  return nb / 2 < kG2TreeWarps ? (nb / 2 > 0 ? nb / 2 : 1) : kG2TreeWarps;
}

}  // namespace

extern "C" {

int tm_g1_aggregate(const void* in, void* scratch, void* out, int ntrees,
                    int b, int nb, void* stream) {
  if (ntrees <= 0) return (int)cudaGetLastError();
  const int groups = g1_tree_groups(nb);
  const int smem = groups * prog::G1_SLOTS * (int)sizeof(fq);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        g1_aggregate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  g1_aggregate_kernel<<<ntrees, kG1TreeLanes * groups, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (fq*)scratch, (uint8_t*)out, b, nb);
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
    g1_add_kernel<<<(n + kG1AddGroups - 1) / kG1AddGroups,
                    kG1AddLanes * (n < kG1AddGroups ? n : kG1AddGroups), 0,
                    (cudaStream_t)stream>>>((const uint8_t*)p, (const uint8_t*)q,
                                            (uint8_t*)out, n);
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
