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
// What bounds them on an H100: the latency of one long chain of dependent
// integer multiplies per signature, not throughput and not bytes. A
// small-tier verify is ~3.1k field multiplications of 25 64x64->128-bit
// products each and reads ~12 KiB of table bytes, almost all from L2; a
// big-tier verify ~1.0k multiplications and 8 KiB of gathered table; no
// kernel is near the memory roofline, and at the main path's batches
// (tens to hundreds of rows) few of the 132 SMs hold a warp, so nothing
// hides each multiplication's latency.
//
// tm_verify_table runs four lanes per signature (verify_table_x4 in
// ed25519_device.cuh): each doubling and cached add is split into two
// stages of 4 independent multiplications, one per lane, joined by a
// width-4 shuffle of the four results, so a point operation costs 2
// dependent multiplications instead of 8. Its critical path is 974
// multiplications (64 x 5 point operations x 2, 32 base adds x 2, and the
// 270 of the finish, whose inversion every lane runs alike) against 3,092
// on one thread; the shuffles and the per-lane operand selects come on
// top. What bounds it now is still that chain's latency. Each lane reads
// its quarter of a cached entry; the group exits together on a row whose
// verdict is already decided; lane 0 writes the verdict.
//
// The big tier runs the same four lanes. tm_verify_bigcache
// (verify_bigcache_x4) is four lanes per row: its 64 window adds and the
// 32 adds of [s]B are two independent chains, so the first 32 windows go
// in one pass with the base adds; its critical path is 398
// multiplications (64 adds x 2, then the finish) against 1,044 on one
// thread. tm_neg_pubkey_bigtable (neg_pubkey_bigtable_x4) is four lanes
// per key and column: 275 (decompress) + 28 (row 0's adds) + 64
// (to_cached) + 504 (63 x 4 doublings) = ~870 against ~2,470; each lane
// writes its quarter of every entry.
//
// tm_verify_generic (verify_generic_x4) is four lanes per row too: the
// group decompresses A (every lane alike), builds the 16-entry cached
// table of -A with 14 four-lane cached adds, then runs kernel 3's chain
// (verify_chain_x4, the same code as tm_verify_table's) reading the table
// from shared memory instead of a stored table. Critical path 275
// (decompress) + 1 + 14 x 2 + 1 + 974 = 1,279 multiplications against
// 3,496 on one thread. Each lane keeps only its component of each entry,
// as 5 loose limbs (the one-thread table's), 16 x 5 x 8 = 640 bytes a
// thread, laid out [entry][limb][thread]: a warp's 8-byte loads then fall
// on distinct banks whatever entry each group reads, and a lane reads only
// what it wrote, so no barrier is needed and a group may leave early. The
// block is kGenericThreads = 64 threads, 40 KiB of static shared memory:
// under the 48 KiB a block gets without an opt-in, and an SM's 228 KiB
// hold 5 such blocks (320 threads), where 128-thread blocks at 80 KiB
// would need the dynamic-shared-memory attribute and fit 2 (256
// threads). A row with s >= L or a padding row (s_ok False, as the
// prewarm's rows) leaves before the decompression.
//
// tm_neg_pubkey_table (neg_pubkey_table_x4) is four lanes per key: every
// lane decompresses A alike (275 multiplications, the floor of its path),
// then the group runs kernel 4's table build (neg_table_x4) with the
// canonical-bytes sink: 1 + 14 x 2 + 16 = 45 multiplications against 129
// on one thread, ~320 in all against ~404. An invalid key gets the table
// the formulas give, byte for byte, so the group never leaves early. Lane
// l writes component l of each entry as two 16-byte stores, so a group
// writes each 128-byte entry whole where one thread a key wrote 2 KiB as
// byte stores, rows 2 KiB apart. 64-thread blocks (kGenericThreads), so
// 256 keys spread over 16 SMs where 128-thread blocks of one thread a key
// used 2.
//
// tm_dbl_chain (dbl_chain_x4) is four lanes per point: each of the 256
// doublings is ge_dbl_x4's two stages of 4 independent multiplications,
// so a point's path is 512 dependent multiplications against 2,048 on one
// thread, and 8,192 points are 1,024 warps, about one wave of the card at
// 8 warps an SM, where one thread a point filled 64 SMs with one warp
// each. Each lane holds the whole point; lane l writes coordinate l, so a
// group writes the point's 128 contiguous bytes. The limbs are those of
// the one-thread chain, so the bytes are too.
//
// Rows whose verdict is already decided (invalid key, s >= L, padding,
// idx < 0 or past the store) skip the arithmetic, and no row reads
// outside its inputs.
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
constexpr int kGenericThreads = 64;

inline int blocks_for(int n, int threads = kThreads) {
  return (n + threads - 1) / threads;
}

// The exchange of the four-lane point operations: a width-4 shuffle under
// the group's own 4-bit mask. Groups of one warp may leave the row loop at
// different points and the last warp may be partial, so a full-warp mask
// would name threads that never arrive.
struct Shfl4 {
  unsigned mask;
  __device__ __forceinline__ void all(fe& o0, fe& o1, fe& o2, fe& o3,
                                      const fe& mine) const {
#pragma unroll
    for (int j = 0; j < 5; j++) {
      const unsigned long long v = mine.v[j];
      o0.v[j] = __shfl_sync(mask, v, 0, 4);
      o1.v[j] = __shfl_sync(mask, v, 1, 4);
      o2.v[j] = __shfl_sync(mask, v, 2, 4);
      o3.v[j] = __shfl_sync(mask, v, 3, 4);
    }
  }
};

// 4 * n threads in blocks of kGenericThreads: thread t is lane t % 4 of
// key t / 4 (neg_pubkey_table_x4 in ed25519_device.cuh), grouped as in
// verify_table_kernel; 256 keys are 16 blocks, so 16 SMs share the work.
// Lane l writes component l of each of the key's 16 entries, so the group
// writes each entry's 128 contiguous bytes.
__global__ void __launch_bounds__(kGenericThreads)
neg_pubkey_table_kernel(const uint8_t* __restrict__ pub,
                        uint8_t* __restrict__ tables,
                        uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ kbytes, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * n) return;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  neg_pubkey_table_x4(t >> 2, t & 3, ex, pub, tables, valid, kbytes);
}

// 4 * b threads: thread t is lane t % 4 of row t / 4. kThreads is a
// multiple of 32, so the 4 lanes of a row sit in one warp at threadIdx.x
// & 28; threads past 4 * b leave before any shuffle, as whole groups.
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
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * b) return;
  const int i = t >> 2, lane = t & 3;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  const bool ok = verify_table_x4(i, lane, ex, tables, tvalid, rows, idx, r,
                                  s, k, s_ok, base, kbytes);
  if (lane == 0) out[i] = ok ? 1 : 0;
}

// 4 * b threads in blocks of kGenericThreads, grouped as in
// verify_table_kernel; thread t's table column is tbl + threadIdx.x.
__global__ void __launch_bounds__(kGenericThreads)
verify_generic_kernel(const uint8_t* __restrict__ pub,
                      const uint8_t* __restrict__ r,
                      const uint8_t* __restrict__ s,
                      const uint8_t* __restrict__ k,
                      const uint8_t* __restrict__ s_ok,
                      const uint8_t* __restrict__ base,
                      const uint8_t* __restrict__ kbytes,
                      uint8_t* __restrict__ out, int b) {
  __shared__ uint64_t tbl[16 * 5 * kGenericThreads];
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * b) return;
  const int i = t >> 2, lane = t & 3;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  const TableLimbs<kGenericThreads> tab{tbl + threadIdx.x};
  const bool ok = verify_generic_x4(i, lane, ex, tab, pub, r, s, k, s_ok,
                                    base, kbytes);
  if (lane == 0) out[i] = ok ? 1 : 0;
}

// 4 * b threads: thread t is lane t % 4 of point t / 4 (dbl_chain_x4 in
// ed25519_device.cuh), grouped as in verify_table_kernel; threads past
// 4 * b leave before any shuffle, as whole groups.
__global__ void __launch_bounds__(kThreads)
dbl_chain_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                 int b, int n_dbl) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * b) return;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  dbl_chain_x4(t >> 2, t & 3, ex, in, out, n_dbl);
}

// Big-tier table: T[i, j] = cached([j * 16^i](-A)), 64 rows x 16 columns
// of 128 canonical bytes (128 KiB per key). 64 threads per key: thread t
// is lane t % 4 of column (t / 4) % 16 of key t / 64
// (neg_pubkey_bigtable_x4 in ed25519_device.cuh), so a key is two whole
// warps and a group's lanes sit at threadIdx.x & 28. The 16 columns are
// independent chains of 63 x 4 doublings; each lane writes its own
// quarter of every entry of its column. Threads past 64 * n leave before
// any shuffle, as whole groups.
__global__ void __launch_bounds__(kThreads)
neg_pubkey_bigtable_kernel(const uint8_t* __restrict__ pub,
                           uint8_t* __restrict__ tables,
                           uint8_t* __restrict__ valid,
                           const uint8_t* __restrict__ kbytes, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * 64) return;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  neg_pubkey_bigtable_x4(t >> 6, (t >> 2) & 15, t & 3, ex, pub, tables,
                         valid, kbytes);
}

// Big-tier verify: [s]B + sum_i T[idx, i, k_i] with k's radix-16 digits
// LSB first (window i is nibble i), 64 cached adds and no doublings, by
// 4 x b threads: thread t is lane t % 4 of row t / 4 (verify_bigcache_x4
// in ed25519_device.cuh), grouped as in verify_table_kernel.
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
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 4 * b) return;
  const int i = t >> 2, lane = t & 3;
  Shfl4 ex{0xFu << (threadIdx.x & 28)};
  const bool ok = verify_bigcache_x4(i, lane, ex, tables, tvalid, rows, idx,
                                     r, s, k, s_ok, base, kbytes);
  if (lane == 0) out[i] = ok ? 1 : 0;
}

}  // namespace

extern "C" {

int tm_neg_pubkey_table(const void* pub, void* tables, void* valid,
                        const void* kbytes, int n, void* stream) {
  if (n > 0)
    neg_pubkey_table_kernel<<<blocks_for(4 * n, kGenericThreads),
                              kGenericThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pub, (uint8_t*)tables, (uint8_t*)valid,
        (const uint8_t*)kbytes, n);
  return (int)cudaGetLastError();
}

int tm_verify_table(const void* tables, const void* tvalid, int rows,
                    const void* idx, const void* r, const void* s,
                    const void* k, const void* s_ok, const void* base,
                    const void* kbytes, void* out, int b, void* stream) {
  if (b > 0)
    verify_table_kernel<<<blocks_for(4 * b), kThreads, 0,
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
    verify_generic_kernel<<<blocks_for(4 * b, kGenericThreads),
                            kGenericThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)pub, (const uint8_t*)r, (const uint8_t*)s,
        (const uint8_t*)k, (const uint8_t*)s_ok, (const uint8_t*)base,
        (const uint8_t*)kbytes, (uint8_t*)out, b);
  return (int)cudaGetLastError();
}

int tm_dbl_chain(const void* in, void* out, int b, int n_dbl, void* stream) {
  if (b > 0)
    dbl_chain_kernel<<<blocks_for(4 * b), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const uint8_t*)in, (uint8_t*)out, b, n_dbl);
  return (int)cudaGetLastError();
}

int tm_neg_pubkey_bigtable(const void* pub, void* tables, void* valid,
                           const void* kbytes, int n, void* stream) {
  if (n > 0)
    neg_pubkey_bigtable_kernel<<<blocks_for(n * 64), kThreads, 0,
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
    verify_bigcache_kernel<<<blocks_for(4 * b), kThreads, 0,
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
