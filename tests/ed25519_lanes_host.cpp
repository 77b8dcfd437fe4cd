// Host harness of the four-lane small-tier verify (kernel 3), for the CPU
// tests (tests/test_torch_ed25519_lanes.py builds it with g++).
//
// It runs the same source as the card: verify_table_x4 and the _x4 point
// operations of ed25519_device.cuh. Four host threads play the 4 lanes of
// a group and walk the rows in order, as a group of the kernel does; the
// exchange is a slot array the 4 lanes fill, with a barrier on each side,
// so the lanes run in lock-step. Each exchange also carries the row and
// the lane's count of exchanges in that row: lanes that disagree (one lane
// left a row early, or called a different number of stages) fail the call
// instead of reading another lane's stale slot.
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

#include "../tendermint_tpu_torch/ops/csrc/ed25519_device.cuh"

using namespace edev;

namespace {

struct Lockstep {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  unsigned gen = 0;
  std::atomic<bool> failed{false};
  fe slot[4];
  long tag[4];

  // a barrier of the 4 lanes; after a failure, or 10 s without the other
  // lanes, it no longer waits, so every lane runs to its end
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    if (failed) return;
    const unsigned g = gen;
    if (++arrived == 4) {
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

struct HostX4 {
  Lockstep* ls;
  int lane;
  long row = -1, seq = 0;

  void all(fe& o0, fe& o1, fe& o2, fe& o3, const fe& mine) {
    ls->slot[lane] = mine;
    ls->tag[lane] = (row << 20) | ++seq;
    ls->wait();
    for (int j = 0; j < 4; j++)
      if (ls->tag[j] != ls->tag[lane]) ls->failed = true;
    o0 = ls->slot[0];
    o1 = ls->slot[1];
    o2 = ls->slot[2];
    o3 = ls->slot[3];
    ls->wait();
  }
};

}  // namespace

extern "C" {

// tm_verify_table's operands on host memory, lane 0's verdicts in out (as
// the kernel writes them); 0, -1 if the lanes fell out of lock-step, -2 if
// a row's 4 lanes reached different verdicts
int tm_host_verify_table(const uint8_t* tables, const uint8_t* tvalid,
                         int rows, const int32_t* idx, const uint8_t* r,
                         const uint8_t* s, const uint8_t* k,
                         const uint8_t* s_ok, const uint8_t* base,
                         const uint8_t* kbytes, uint8_t* out, int b) {
  Lockstep ls;
  std::vector<uint8_t> verdicts(4 * (size_t)b);
  std::thread lanes[4];
  for (int lane = 0; lane < 4; lane++) {
    lanes[lane] = std::thread([&, lane] {
      HostX4 ex{&ls, lane};
      for (int i = 0; i < b; i++) {
        ex.row = i;
        ex.seq = 0;
        verdicts[4 * (size_t)i + lane] =
            verify_table_x4(i, lane, ex, tables, tvalid, rows, idx, r, s, k,
                            s_ok, base, kbytes) ? 1 : 0;
      }
    });
  }
  for (auto& t : lanes) t.join();
  if (ls.failed) return -1;
  for (int i = 0; i < b; i++) {
    out[i] = verdicts[4 * (size_t)i];
    for (int lane = 1; lane < 4; lane++)
      if (verdicts[4 * (size_t)i + lane] != out[i]) return -2;
  }
  return 0;
}

// For n extended points p (X, Y, Z, T as 32 bytes each) and cached
// operands c (YmX, YpX, T2d, Z2), out[n][12][4][5] uint64 limbs: slot 0
// ge_dbl(p), 1 ge_add_cached(p, c), 2 ge_to_cached(p); 3-6 ge_dbl_x4(p)
// as each lane holds it, 7-10 ge_add_cached_x4(p, c) likewise, 11 the
// lanes' ge_to_cached_lane(p) in lane order. 0, or -1 if the lanes fell
// out of lock-step.
int tm_host_point_ops(const uint8_t* pts, const uint8_t* cached,
                      const uint8_t* kbytes, uint64_t* out, int n) {
  consts kc;
  load_consts(kc, kbytes);
  const size_t stride = 12 * 20;
  for (int i = 0; i < n; i++) {
    ge p, d1, a1;
    ge_cached c, tc;
    fe_frombytes(p.X, pts + i * 128);
    fe_frombytes(p.Y, pts + i * 128 + 32);
    fe_frombytes(p.Z, pts + i * 128 + 64);
    fe_frombytes(p.T, pts + i * 128 + 96);
    ge_cached_frombytes(c, cached + i * 128);
    ge_dbl(d1, p);
    ge_add_cached(a1, p, c);
    ge_to_cached(tc, p, kc);
    uint64_t* o = out + i * stride;
    memcpy(o, &d1, sizeof d1);
    memcpy(o + 20, &a1, sizeof a1);
    memcpy(o + 40, &tc, sizeof tc);
  }
  Lockstep ls;
  std::thread lanes[4];
  for (int lane = 0; lane < 4; lane++) {
    lanes[lane] = std::thread([&, lane] {
      HostX4 ex{&ls, lane};
      for (int i = 0; i < n; i++) {
        ex.row = i;
        ex.seq = 0;
        ge p, d4, a4;
        fe cl, tl;
        fe_frombytes(p.X, pts + i * 128);
        fe_frombytes(p.Y, pts + i * 128 + 32);
        fe_frombytes(p.Z, pts + i * 128 + 64);
        fe_frombytes(p.T, pts + i * 128 + 96);
        fe_frombytes(cl, cached + i * 128 + lane * 32);
        ge_dbl_x4(d4, p, lane, ex);
        ge_add_cached_x4(a4, p, cl, lane, ex);
        ge_to_cached_lane(tl, p, kc, lane);
        uint64_t* o = out + i * stride;
        memcpy(o + (3 + lane) * 20, &d4, sizeof d4);
        memcpy(o + (7 + lane) * 20, &a4, sizeof a4);
        memcpy(o + 11 * 20 + lane * 5, &tl, sizeof tl);
      }
    });
  }
  for (auto& t : lanes) t.join();
  return ls.failed ? -1 : 0;
}

}  // extern "C"
