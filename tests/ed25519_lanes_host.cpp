// Host harness of the four-lane ed25519 kernels, for the CPU tests
// (tests/test_torch_ed25519_lanes.py, test_torch_ed25519_big_lanes.py and
// test_torch_ed25519_generic_lanes.py build it with g++): the small-tier
// verify (kernel 3), the generic verify (kernel 4), the big-tier verify
// (kernel 6), the big-tier table build (kernel 5), the small-tier table
// build (kernel 2; tests/test_torch_ed25519_table_lanes.py) and the
// doubling chain (kernel 1).
//
// It runs the same source as the card: verify_table_x4,
// verify_generic_x4, verify_bigcache_x4, neg_pubkey_bigtable_x4,
// neg_pubkey_table_x4, dbl_chain_x4 and the _x4 point operations of
// ed25519_device.cuh. Four host threads play the
// 4 lanes of a group and walk the groups (rows, or key columns) in order,
// as a group of the kernel does; the exchange is a slot array the 4 lanes
// fill, with a barrier on each side, so the lanes run in lock-step. Each
// exchange also carries the group and the lane's count of exchanges in
// that group: lanes that disagree (one lane left a group early, or called
// a different number of stages) fail the call instead of reading another
// lane's stale slot. Kernel 4's shared-memory table is a host array laid
// out as on the card, [entry][limb][lane], each lane reading its own
// column.
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

// fn(g, lane, ex) for the groups g = 0 .. n - 1 on 4 lanes in lock-step;
// with out, lane 0's results in out (as the kernels write them). 0, -1 if
// the lanes fell out of lock-step, -2 if a group's 4 lanes returned
// different results.
template <class F>
int run_groups(int n, uint8_t* out, F fn) {
  Lockstep ls;
  std::vector<uint8_t> res(4 * (size_t)n);
  std::thread lanes[4];
  for (int lane = 0; lane < 4; lane++) {
    lanes[lane] = std::thread([&, lane] {
      HostX4 ex{&ls, lane};
      for (int g = 0; g < n; g++) {
        ex.row = g;
        ex.seq = 0;
        res[4 * (size_t)g + lane] = fn(g, lane, ex);
      }
    });
  }
  for (auto& t : lanes) t.join();
  if (ls.failed) return -1;
  for (int g = 0; g < n; g++) {
    for (int lane = 1; lane < 4; lane++)
      if (res[4 * (size_t)g + lane] != res[4 * (size_t)g]) return -2;
    if (out) out[g] = res[4 * (size_t)g];
  }
  return 0;
}

}  // namespace

extern "C" {

// tm_verify_table's operands on host memory, lane 0's verdicts in out;
// run_groups' return codes
int tm_host_verify_table(const uint8_t* tables, const uint8_t* tvalid,
                         int rows, const int32_t* idx, const uint8_t* r,
                         const uint8_t* s, const uint8_t* k,
                         const uint8_t* s_ok, const uint8_t* base,
                         const uint8_t* kbytes, uint8_t* out, int b) {
  return run_groups(b, out, [&](int i, int lane, HostX4& ex) {
    return verify_table_x4(i, lane, ex, tables, tvalid, rows, idx, r, s, k,
                           s_ok, base, kbytes) ? 1 : 0;
  });
}

// The generic table of the 4 lanes, laid out as the card's shared array
// with a block of 4 threads: lane l's column starts at l
struct GenericTable {
  uint64_t limbs[16 * 5 * 4];
  TableLimbs<4> lane(int l) { return TableLimbs<4>{limbs + l}; }
};

// tm_verify_generic's operands on host memory, lane 0's verdicts in out;
// run_groups' return codes. With fault 1, lane 3 leaves row 0 before its
// table; with fault 2, lane 3 makes one exchange more on row 0 (both for
// the test that the harness fails them).
int tm_host_verify_generic(const uint8_t* pub, const uint8_t* r,
                           const uint8_t* s, const uint8_t* k,
                           const uint8_t* s_ok, const uint8_t* base,
                           const uint8_t* kbytes, uint8_t* out, int b,
                           int fault) {
  GenericTable tbl;
  return run_groups(b, out, [&](int i, int lane, HostX4& ex) {
    const bool faulty = fault && i == 0 && lane == 3;
    if (faulty && fault == 1) return 0;
    const bool ok = verify_generic_x4(i, lane, ex, tbl.lane(lane), pub, r, s,
                                      k, s_ok, base, kbytes);
    if (faulty && fault == 2) {
      fe x;
      fe_0(x);
      ex.all(x, x, x, x, x);
    }
    return ok ? 1 : 0;
  });
}

// tm_verify_bigcache's operands on host memory, likewise
int tm_host_verify_bigcache(const uint8_t* tables, const uint8_t* tvalid,
                            int rows, const int32_t* idx, const uint8_t* r,
                            const uint8_t* s, const uint8_t* k,
                            const uint8_t* s_ok, const uint8_t* base,
                            const uint8_t* kbytes, uint8_t* out, int b) {
  return run_groups(b, out, [&](int i, int lane, HostX4& ex) {
    return verify_bigcache_x4(i, lane, ex, tables, tvalid, rows, idx, r, s,
                              k, s_ok, base, kbytes) ? 1 : 0;
  });
}

// tm_neg_pubkey_bigtable's operands on host memory: the 16 groups of key
// g / 16 are its columns g % 16, in order; run_groups' return codes
int tm_host_neg_pubkey_bigtable(const uint8_t* pub, uint8_t* tables,
                                uint8_t* valid, const uint8_t* kbytes,
                                int n) {
  return run_groups(16 * n, nullptr, [&](int g, int lane, HostX4& ex) {
    neg_pubkey_bigtable_x4(g >> 4, g & 15, lane, ex, pub, tables, valid,
                           kbytes);
    return 0;
  });
}

// tm_neg_pubkey_table's operands on host memory: group g builds key g's
// table (neg_pubkey_table_x4); run_groups' return codes
int tm_host_neg_pubkey_table(const uint8_t* pub, uint8_t* tables,
                             uint8_t* valid, const uint8_t* kbytes, int n) {
  return run_groups(n, nullptr, [&](int g, int lane, HostX4& ex) {
    neg_pubkey_table_x4(g, lane, ex, pub, tables, valid, kbytes);
    return 0;
  });
}

// The same table by one thread a key, with the one-thread formulas
// (ge_to_cached, ge_add_cached, ge_cached_tobytes) in the order of the
// one-thread kernel 2 this build replaced
void tm_host_neg_pubkey_table_1t(const uint8_t* pub, uint8_t* tables,
                                 uint8_t* valid, const uint8_t* kbytes,
                                 int n) {
  consts kc;
  load_consts(kc, kbytes);
  for (int i = 0; i < n; i++) {
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
}

// For b rows whose idx lies in the store, out[b][15][20] uint64 limbs:
// slots 0-2 acc, sb and q by the one-thread ge_add_cached and
// ge_to_cached in the one-thread kernel's order (64 window adds, 32 base
// adds, to_cached(acc) added to sb), slots 3 + 3l .. 5 + 3l lane l's acc,
// sb and q of bigcache_points_x4. 0, or -1 if the lanes fell out of
// lock-step.
int tm_host_bigcache_points(const uint8_t* tables, const int32_t* idx,
                            const uint8_t* s, const uint8_t* k,
                            const uint8_t* base, const uint8_t* kbytes,
                            uint64_t* out, int b) {
  consts kc;
  load_consts(kc, kbytes);
  const size_t stride = 15 * 20;
  for (int i = 0; i < b; i++) {
    const uint8_t* tab = tables + (size_t)idx[i] * 64 * 16 * 128;
    const uint8_t* ki = k + (size_t)i * 32;
    const uint8_t* si = s + (size_t)i * 32;
    ge acc, sb, q;
    ge_cached e;
    ge_identity(acc);
    for (int w = 0; w < 64; w++) {
      ge_cached_frombytes(e, tab + ((size_t)w * 16 + nibble(ki, w)) * 128);
      ge_add_cached(acc, acc, e);
    }
    ge_identity(sb);
    for (int j = 0; j < 32; j++) {
      ge_cached_frombytes(e, base + ((size_t)j * 256 + si[j]) * 128);
      ge_add_cached(sb, sb, e);
    }
    ge_to_cached(e, acc, kc);
    ge_add_cached(q, sb, e);
    uint64_t* o = out + i * stride;
    memcpy(o, &acc, sizeof acc);
    memcpy(o + 20, &sb, sizeof sb);
    memcpy(o + 40, &q, sizeof q);
  }
  return run_groups(b, nullptr, [&](int i, int lane, HostX4& ex) {
    ge acc, sb, q;
    bigcache_points_x4(acc, sb, q,
                       tables + (size_t)idx[i] * 64 * 16 * 128 + lane * 32,
                       k + (size_t)i * 32, s + (size_t)i * 32, base, kc,
                       lane, ex);
    uint64_t* o = out + i * stride + (3 + 3 * lane) * 20;
    memcpy(o, &acc, sizeof acc);
    memcpy(o + 20, &sb, sizeof sb);
    memcpy(o + 40, &q, sizeof q);
    return 0;
  });
}

// For b rows whose key decompresses, out[b][47][20] uint64 limbs: slots
// 0-15 the one-thread kernel's table of -A (ge_to_cached of the identity,
// -A, then 14 ge_add_cached of cached(-A)), 16-18 acc, sb and q by the
// one-thread ge_dbl and ge_add_cached in its order (64 windows of 4
// doublings and an add, MSB first; 32 base adds; to_cached(acc) added to
// sb); slots 19-34 the table the 4 lanes built (neg_table_x4), component
// l of entry j from lane l; 35 + 3l .. 37 + 3l lane l's acc, sb and q of
// table_points_x4 over it. 0, -1 if the lanes fell out of lock-step, -3
// if a key does not decompress.
int tm_host_generic_points(const uint8_t* pub, const uint8_t* s,
                           const uint8_t* k, const uint8_t* base,
                           const uint8_t* kbytes, uint64_t* out, int b) {
  consts kc;
  load_consts(kc, kbytes);
  const size_t stride = 47 * 20;
  for (int i = 0; i < b; i++) {
    ge a, cur, acc, sb, q;
    if (!ge_decompress(a, pub + (size_t)i * 32, kc)) return -3;
    ge_neg(a);
    ge_cached tbl[16], ac, e;
    ge_to_cached(ac, a, kc);
    ge_identity(cur);
    for (int j = 0; j < 16; j++) {
      if (j == 1) cur = a;
      else if (j > 1) ge_add_cached(cur, cur, ac);
      ge_to_cached(tbl[j], cur, kc);
    }
    const uint8_t* ki = k + (size_t)i * 32;
    const uint8_t* si = s + (size_t)i * 32;
    ge_identity(acc);
    for (int w = 63; w >= 0; w--) {
      for (int d = 0; d < 4; d++) ge_dbl(acc, acc);
      ge_add_cached(acc, acc, tbl[nibble(ki, w)]);
    }
    ge_identity(sb);
    for (int j = 0; j < 32; j++) {
      ge_cached_frombytes(e, base + ((size_t)j * 256 + si[j]) * 128);
      ge_add_cached(sb, sb, e);
    }
    ge_to_cached(e, acc, kc);
    ge_add_cached(q, sb, e);
    uint64_t* o = out + i * stride;
    memcpy(o, tbl, sizeof tbl);
    memcpy(o + 16 * 20, &acc, sizeof acc);
    memcpy(o + 17 * 20, &sb, sizeof sb);
    memcpy(o + 18 * 20, &q, sizeof q);
  }
  GenericTable tbl;
  return run_groups(b, nullptr, [&](int i, int lane, HostX4& ex) {
    ge a, acc, sb, q;
    ge_decompress(a, pub + (size_t)i * 32, kc);
    ge_neg(a);
    const TableLimbs<4> tab = tbl.lane(lane);
    neg_table_x4(tab, a, kc, lane, ex);
    table_points_x4(acc, sb, q, tab, k + (size_t)i * 32, s + (size_t)i * 32,
                    base, kc, lane, ex);
    uint64_t* o = out + i * stride;
    fe c;
    for (int j = 0; j < 16; j++) {
      tab(c, j);
      memcpy(o + (19 + j) * 20 + lane * 5, &c, sizeof c);
    }
    o += (35 + 3 * lane) * 20;
    memcpy(o, &acc, sizeof acc);
    memcpy(o + 20, &sb, sizeof sb);
    memcpy(o + 40, &q, sizeof q);
    return 0;
  });
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

// Kernel 1 on host memory: tm_dbl_chain's operands (in and out [b][128]
// bytes), the 4 lanes running dbl_chain_x4 over the points in order;
// run_groups' return codes.
int tm_host_dbl_chain_x4(const uint8_t* in, uint8_t* out, int b, int n_dbl) {
  return run_groups(b, nullptr, [&](int i, int lane, HostX4& ex) {
    dbl_chain_x4(i, lane, ex, in, out, n_dbl);
    return 0;
  });
}

// The one-thread chain the kernel ran before its lanes: n_dbl ge_dbl of
// each point, its coordinates' canonical bytes in out
void tm_host_dbl_chain_1t(const uint8_t* in, uint8_t* out, int b, int n_dbl) {
  for (int i = 0; i < b; i++) {
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
}

}  // extern "C"
