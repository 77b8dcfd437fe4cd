// secp256k1 ECDSA verification on the card, for sm_90a:
//   verdict = ok_in & ~inf(R) & (x(R) mod n == r),  R = u1 G + u2 Q.
//
//   tm_secp_verify  <- tendermint_tpu/ops/secp256k1_kernel.py:161
//                      verify_prehashed (its field: ops/vecfield.py:29
//                      make_field)
//
// What bounds it on an H100: integer multiplies, and the latency of their
// chains. A row is 263 doublings (the ladder's 256, 3 in the table of Q and
// 4 inside the table's and the ladder's equal-point cases at most) of 7
// field multiplications and about 135 additions of 16, ~3.9k 256-bit
// multiplications, against 193 bytes read and one written: far above the
// card's ~5 operations per byte, so memory is never the limit. On one
// thread a row that is ~3.9k dependent multiplications, and the window's
// 3,200 live rows fill 100 warps of 132 SMs: nothing hides the latency.
// Design:
// - a row on a group of 4 lanes, 8 rows a warp (secp_row_g in
//   secp256k1_device.cuh): the doublings and additions run as the stage
//   programs S_DBL, S_HR and S_ADD_FIN (secp256k1_programs.cuh, the G1
//   graphs of ops/bls_warp_gen.py compiled by ops/secp_lane_gen.py), a
//   stage of at most 4 independent products, or of a chain of additions a
//   lane, at a time, over the 32-bit-limb field fs (Hopper's native
//   product is 32 x 32 -> 64); a doubling is 3 dependent product stages,
//   an addition 5, so a row's critical path is ~1.4k products, each
//   stage's jobs compile-time constants;
// - the group's slots in shared memory: the programs' 32 slots and the
//   row's table of Q (48), 81 slots (2,592 bytes) a row; its sync is
//   __syncwarp over its own 4 lanes, so the groups of a warp branch apart;
// - the radix-16 Straus ladder of the JAX package, most significant digit
//   first: 64 steps of 4 doublings, one addition from the row's table of
//   16 multiples of Q (built as the JAX package builds it) and one from the
//   16 multiples of G, which the block loads into shared memory once;
// - no inversion: with Z != 0, x(R) == r iff r < p and X == r Z^2, and the
//   wrapped branch x(R) - n == r iff r + n < p and X == (r + n) Z^2 (mod
//   p), the same verdict as the JAX package's invert-then-compare with its
//   borrow guard;
// - a row whose host checks failed (ok_in false, every padding row) leaves
//   at once, its whole group: its verdict is false whatever R is.
// 64 threads a block (16 rows): 43,008 bytes of static shared memory, under
// the 48 KiB default.
//
// Plain C interface, as the other kernels: the launcher runs on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "secp256k1_device.cuh"

using namespace sdev;

namespace {

constexpr int kThreads = 64;
constexpr int kRows = kThreads / kRowLanes;  // rows a block

// a row's group of lanes: its slots in shared memory and __syncwarp over its
// own lanes
struct RowLanes {
  static constexpr int kLanes = kRowLanes;
  fs* sm;
  int lane;  // in the group
  unsigned mask;  // the group's lanes in its warp
  __device__ __forceinline__ fs ld(int s) const { return sm[s]; }
  __device__ __forceinline__ void st(int s, const fs& v) { sm[s] = v; }
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

__global__ void __launch_bounds__(kThreads)
secp_verify_kernel(const int32_t* __restrict__ qx,
                   const int32_t* __restrict__ qy,
                   const uint8_t* __restrict__ u1,
                   const uint8_t* __restrict__ u2,
                   const uint8_t* __restrict__ r_bytes,
                   const bool* __restrict__ ok_in,
                   const uint32_t* __restrict__ gtab, bool* __restrict__ out,
                   int b) {
  __shared__ fs g[16 * 3];
  __shared__ fs slots[kRows][S_REGION];
  static_assert(sizeof(fs) * (kRows * S_REGION + 48) <= 48 * 1024, "static shared memory");
  for (int k = threadIdx.x; k < 16 * 3 * 8; k += blockDim.x) g[k / 8].l[k % 8] = gtab[k];
  __syncthreads();
  const int group = threadIdx.x / kRowLanes;
  const int row = blockIdx.x * kRows + group;
  if (row >= b) return;  // the whole group
  RowLanes w{slots[group], (int)(threadIdx.x % kRowLanes),
             group_mask<kRowLanes>(threadIdx.x & 31)};
  secp_row_g(w, row, qx, qy, u1, u2, r_bytes, ok_in, g, out);
}

}  // namespace

extern "C" {

// gtab: [16][3] points of G as 8 little-endian 32-bit limbs a coordinate
// (the wrapper's [16, 3, 4] 64-bit words, the same bytes)
int tm_secp_verify(const void* qx, const void* qy, const void* u1,
                   const void* u2, const void* r, const void* ok_in,
                   const void* gtab, void* out, int b, void* stream) {
  if (b > 0)
    secp_verify_kernel<<<(b + kRows - 1) / kRows, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)qx, (const int32_t*)qy, (const uint8_t*)u1,
        (const uint8_t*)u2, (const uint8_t*)r, (const bool*)ok_in,
        (const uint32_t*)gtab, (bool*)out, b);
  return (int)cudaGetLastError();
}

}  // extern "C"
