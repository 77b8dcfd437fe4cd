// Host harness of kernel 9's hash, for the CPU tests
// (tests/test_torch_sha256_lanes.py builds it with g++).
//
// It runs the same source as the card: sha256_warp of sha256_device.cuh.
// 32 host threads play the 32 lanes of a warp and walk the batch's warps
// in order, as a warp of sha256_kernel does, over
// one staging buffer laid out as the warp's shared memory. A barrier of
// the 32 threads is __syncwarp, and wp.max(v) goes through a slot array
// between two barriers, as __reduce_max_sync. Each barrier also carries
// the warp and the lane's count of barriers in it: lanes that disagree
// (one lane skipped a staging or synced once more) fail the call instead
// of reading a half-written buffer. Before each warp the buffer is filled
// with a pattern no message has, so a lane that read a row nobody staged
// would give a wrong digest.
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "../tendermint_tpu_torch/ops/csrc/sha256_device.cuh"

using namespace sha256dev;

namespace {

constexpr int kLanes = 32;

struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned gen = 0;
  std::atomic<bool> failed{false};
  long tag[kLanes];
  int slot[kLanes];

  // a barrier of the 32 lanes; after a failure, or 10 s without the other
  // lanes, it no longer waits, so every lane runs to its end
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    if (failed) return;
    const unsigned g = gen;
    if (++arrived == kLanes) {
      arrived = 0;
      gen++;
      cv.notify_all();
      return;
    }
    if (!cv.wait_for(lk, std::chrono::seconds(10),
                     [&] { return gen != g || failed; })) {
      failed = true;
      cv.notify_all();
    }
  }
};

// sha256_warp's Warp on the host: sync() is a barrier of the 32
// threads that checks every lane is at the same barrier of the same warp
struct HostWarp {
  Barrier* bar;
  int lane;
  long warp = -1, seq = 0;

  void sync() {
    bar->tag[lane] = (warp << 20) | ++seq;
    bar->wait();
    for (int j = 0; j < kLanes; j++)
      if (bar->tag[j] != bar->tag[lane]) bar->failed = true;
    bar->wait();
  }

  int max(int v) {
    bar->slot[lane] = v;
    sync();
    int m = bar->slot[0];
    for (int j = 1; j < kLanes; j++) m = bar->slot[j] > m ? bar->slot[j] : m;
    sync();
    return m;
  }
};

}  // namespace

extern "C" {

// tm_sha256's operands on host memory (msg 16-byte aligned): 0, or -1 if
// the lanes fell out of lock-step. With fault 1, lane 5 of warp 0 skips
// its first staging sync (for the test that the harness fails it).
int tm_host_sha256(const uint8_t* msg, int nblk, const int32_t* n_blocks,
                   uint8_t* out, int b, int fault) {
  Barrier bar;
  static_assert(sizeof(w128) == 16, "a staged piece is 16 bytes");
  std::vector<w128> sm(kStagePieces);
  const int nwarps = (b + kLanes - 1) / kLanes;
  std::thread lanes[kLanes];
  for (int lane = 0; lane < kLanes; lane++) {
    lanes[lane] = std::thread([&, lane] {
      HostWarp wp{&bar, lane};
      for (int w = 0; w < nwarps; w++) {
        wp.warp = w;
        wp.seq = 0;
        if (lane == 0) memset(sm.data(), 0xA5, sm.size() * sizeof(w128));
        wp.sync();
        if (fault == 1 && w == 0 && lane == 5) wp.seq++;
        const int row0 = w * kLanes;
        const int nrows = b - row0 < kLanes ? b - row0 : kLanes;
        sha256_warp(lane, wp, sm.data(), msg, nblk, n_blocks, out, row0,
                    nrows);
        wp.sync();
      }
    });
  }
  for (auto& t : lanes) t.join();
  return bar.failed ? -1 : 0;
}

}  // extern "C"
