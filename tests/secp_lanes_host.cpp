// Host harness of the four-lane secp256k1 verify kernel, for the CPU tests
// (tests/test_torch_secp_lanes.py builds it with g++).
//
// It runs the same source as the card: the fs core, run_program over the
// stage programs S_HR, S_ADD_FIN and S_DBL, dbl_g, add_g and secp_row_g of
// ops/csrc/secp256k1_device.cuh, with host threads playing the lanes: 4 a
// row's group, each group over its own slots, several groups at once (a
// block of tm_secp_verify is 16). A group's sync is a barrier of its lanes,
// so they run in lock-step, a stage at a time. At each sync the harness
// checks the stage that ends there:
// - every lane arrives with the same tag (the call and the lane's count of
//   syncs in it): a lane that ran a different number of stages, or left
//   early, fails the call;
// - every lane syncs with its group's mask: the bits of the group's own
//   lanes in its warp, as __syncwarp takes it;
// - no slot was written by two lanes, or written by one lane and read by
//   another, in the stage: on the card, such a read could see either value.
// A lane that reads or writes a slot outside its group's region (on the
// card, another group's slots) fails the call too.
// It also runs the one-thread code of the same header (fe_mul, fe_add,
// fe_sub, fe_from_limbs, pt_add, pt_double, and the one-thread kernel's row
// as it stood before the four-lane kernel), which the tests hold the lane
// functions against.
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#include "../tendermint_tpu_torch/ops/csrc/secp256k1_device.cuh"

using namespace sdev;

namespace {

constexpr long kDone = -1;  // the tag of a lane that has returned
constexpr int kBlockGroups = 16;  // rows a block of tm_secp_verify

// a group's lanes in lock-step over their own slots
struct Lanes {
  const int n;
  const unsigned want;  // the group's lanes in its warp, as __syncwarp's mask
  std::atomic<int> arrived{0};
  std::atomic<unsigned> gen{0};
  std::atomic<bool> failed{false};
  std::atomic<bool> strayed{false};  // a lane touched a slot past the region
  std::vector<fs> sm;
  std::vector<std::vector<int>> rd, wr;
  std::vector<long> tag;
  std::vector<unsigned> mask;
  std::vector<int> writer;

  Lanes(int nlanes, unsigned want_mask, int nslots)
      : n(nlanes), want(want_mask), sm(nslots), rd(nlanes), wr(nlanes),
        tag(nlanes), mask(nlanes), writer(nslots, -1) {
    memset(sm.data(), 0xA5, sizeof(fs) * nslots);  // no slot starts as zero
  }

  // the stage's accesses, by the last lane to arrive
  void check_stage() {
    if (strayed) failed = true;
    for (int l = 0; l < n; l++)
      if (tag[l] != tag[0] || mask[l] != want) failed = true;
    for (int l = 0; l < n; l++)
      for (int s : wr[l]) {
        if (writer[s] != -1 && writer[s] != l) failed = true;
        writer[s] = l;
      }
    for (int l = 0; l < n; l++)
      for (int s : rd[l])
        if (writer[s] != -1 && writer[s] != l) failed = true;
    for (int l = 0; l < n; l++) {
      for (int s : wr[l]) writer[s] = -1;
      rd[l].clear();
      wr[l].clear();
    }
  }

  // a barrier of the n lanes, which sleep on the generation word; the
  // last to arrive checks the stage and wakes them. After a failure it no
  // longer waits, so every lane runs to its end.
  void barrier(int lane, long t, unsigned m) {
    tag[lane] = t;
    mask[lane] = m;
    if (failed) return;
    const unsigned g = gen.load(std::memory_order_acquire);
    if (arrived.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
      check_stage();
      arrived.store(0, std::memory_order_relaxed);
      gen.store(g + 1, std::memory_order_release);
      gen.notify_all();
      return;
    }
    gen.wait(g, std::memory_order_acquire);
  }
};

// the lane type of the device functions: a lane of a row's group, its sync
// __syncwarp(mask)
struct HostLanes {
  static constexpr int kLanes = kRowLanes;
  Lanes* gp;
  int lane;
  unsigned mask;
  long seq = 0;

  bool own(int s) {
    if (s >= 0 && s < (int)gp->sm.size()) return true;
    gp->strayed = true;  // another group's slots, on the card
    return false;
  }
  fs ld(int s) {
    if (!own(s)) return fs{};
    gp->rd[lane].push_back(s);
    return gp->sm[s];
  }
  void st(int s, const fs& v) {
    if (!own(s)) return;
    gp->wr[lane].push_back(s);
    gp->sm[s] = v;
  }
  void sync() { gp->barrier(lane, ++seq, mask); }
};

// fn(w, group) on ngroups groups of 4 lanes, 8 groups to a warp, each group
// in lock-step over its own region of S_REGION slots and ending with a last
// barrier with the tag kDone. A lane's mask is the kernel's group_mask; the
// harness's own is the group's lanes in its warp. The regions as they stand
// at the end go to `keep` (if given). 0, or -1 if a group fell out of
// lock-step, synced with another mask, touched another group's slots or let
// a stage's accesses clash
template <class F>
int run_groups(int ngroups, F fn, std::vector<std::vector<fs>>* keep = nullptr) {
  constexpr int G = kRowLanes;
  std::vector<std::unique_ptr<Lanes>> groups;
  for (int g = 0; g < ngroups; g++)
    groups.emplace_back(new Lanes(G, ((1u << G) - 1u) << (G * g % 32), S_REGION));
  std::vector<std::thread> threads;
  for (int t = 0; t < G * ngroups; t++) {
    threads.emplace_back([&, t] {
      const int g = t / G, lane = t % G;
      HostLanes w{groups[g].get(), lane, group_mask<G>(t % 32)};
      fn(w, g);
      groups[g]->barrier(lane, kDone, w.mask);
    });
  }
  for (auto& t : threads) t.join();
  int rc = 0;
  for (auto& gp : groups) {
    if (gp->failed || gp->strayed) rc = -1;
    if (keep) keep->push_back(gp->sm);
  }
  return rc;
}

// 32 little-endian bytes <-> fe and fs
void fe_raw(fe& a, const uint8_t* b) {
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
    a.v[i] = v;
  }
}

void fs_raw(fs& a, const uint8_t* b) {
  for (int i = 0; i < 8; i++)
    a.l[i] = (uint32_t)b[4 * i] | (uint32_t)b[4 * i + 1] << 8 |
             (uint32_t)b[4 * i + 2] << 16 | (uint32_t)b[4 * i + 3] << 24;
}

void fe_words(uint32_t* o, const fe& a) {
  for (int i = 0; i < 4; i++) {
    o[2 * i] = (uint32_t)a.v[i];
    o[2 * i + 1] = (uint32_t)(a.v[i] >> 32);
  }
}

void pt_words(uint32_t* o, const point& p) {
  fe_words(o, p.x);
  fe_words(o + 8, p.y);
  fe_words(o + 16, p.z);
}

void pt_raw(point& p, const uint8_t* b) {
  fe_raw(p.x, b);
  fe_raw(p.y, b + 32);
  fe_raw(p.z, b + 64);
}

// the one-thread kernel's row (tm_secp_verify before the four-lane kernel):
// its verdict, the table of Q and the ladder's R as words
bool thread_row(int row, const int32_t* qx, const int32_t* qy, const uint8_t* u1,
                const uint8_t* u2, const uint8_t* rb, const bool* ok_in,
                const point* g, uint32_t* tab_words, uint32_t* acc_words) {
  if (!ok_in[row]) return false;
  point q;
  fe_from_limbs(q.x, qx + (size_t)row * 32);
  fe_from_limbs(q.y, qy + (size_t)row * 32);
  fe_set_u64(q.z, 1);
  point tab[16];
  pt_identity(tab[0]);
  tab[1] = q;
  for (int d = 2; d < 16; d++) {
    if (d % 2 == 0)
      pt_double(tab[d], tab[d / 2]);
    else
      pt_add(tab[d], tab[d - 1], q);
  }
  for (int d = 0; d < 16; d++) pt_words(tab_words + 24 * d, tab[d]);
  const uint8_t* s1 = u1 + (size_t)row * 32;
  const uint8_t* s2 = u2 + (size_t)row * 32;
  point acc;
  pt_identity(acc);
  for (int k = 0; k < 64; k++) {
    for (int j = 0; j < 4; j++) pt_double(acc, acc);
    pt_add(acc, acc, tab[nibble(s2, k)]);
    pt_add(acc, acc, g[nibble(s1, k)]);
  }
  pt_words(acc_words, acc);
  if (fe_is_zero(acc.z)) return false;
  fe z2;
  fe_sqr(z2, acc.z);
  uint64_t r[4], rn[4];
  const uint8_t* b = rb + (size_t)row * 32;
  for (int i = 0; i < 4; i++) {
    uint64_t x = 0;
    for (int j = 0; j < 8; j++) x = (x << 8) | b[8 * (3 - i) + j];
    r[i] = x;
  }
  static const uint64_t kN[4] = {0xBFD25E8CD0364141ull, 0xBAAEDCE6AF48A03Bull,
                                 0xFFFFFFFFFFFFFFFEull, 0xFFFFFFFFFFFFFFFFull};
  u128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (u128)r[i] + kN[i];
    rn[i] = (uint64_t)c;
    c >>= 64;
  }
  auto lt_p = [](const uint64_t* v) {
    fe x, t;
    for (int i = 0; i < 4; i++) x.v[i] = v[i];
    return sub_p(t, x) != 0;
  };
  auto matches = [&](const uint64_t* v) {
    fe cf, t;
    for (int i = 0; i < 4; i++) cf.v[i] = v[i];
    fe_mul(t, cf, z2);
    return fe_eq(t, acc.x);
  };
  const bool direct = lt_p(r) && matches(r);
  const bool wrapped = c == 0 && lt_p(rn) && matches(rn);
  return direct || wrapped;
}

// group 0's lanes under a fault of tm_host_secp_selftest
struct FaultyLanes {
  static constexpr int kLanes = kRowLanes;
  HostLanes& w;
  int fault, lane;
  bool wrote = false;
  fs ld(int s) {
    if (s == prog::S_H && fault == 2 && lane == 2) s += S_REGION;
    fs v = w.ld(s);
    if (s == prog::S_H && fault == 4 && lane == 2 && !wrote) {
      w.st(s, v);
      wrote = true;
    }
    return v;
  }
  void st(int s, const fs& v) { w.st(s, v); }
  void sync() { w.sync(); }
};

// load P and Q of 3 fs each into the group's slots, with zero and one
template <class W>
void load_pq(W& w, const uint8_t* p, const uint8_t* q) {
  const int l = w.lane;
  if (l < 2) {
    fs c;
    fs_set_u32(c, (uint32_t)l);
    w.st(l, c);
  }
  for (int c = l; c < 6; c += kRowLanes) {
    fs v;
    fs_raw(v, (c < 3 ? p : q) + 32 * (c % 3));
    w.st(prog::S_P + c, v);
  }
  w.sync();
}

}  // namespace

extern "C" {

// For n pairs of raw 32-byte little-endian integers a, b (any below 2^256
// for the products; the additions' operands are the caller's to keep below
// p), out[n][6][8] words: fs_mul(a, b), fe_mul(a, b), fs_add, fe_add,
// fs_sub, fe_sub
int tm_host_fs_ops(const uint8_t* a, const uint8_t* b, int n, uint32_t* out) {
  for (int i = 0; i < n; i++) {
    fe ea, eb, er;
    fs sa, sb, sr;
    fe_raw(ea, a + 32 * i);
    fe_raw(eb, b + 32 * i);
    fs_raw(sa, a + 32 * i);
    fs_raw(sb, b + 32 * i);
    uint32_t* o = out + 48 * i;
    fs_mul(sr, sa, sb);
    memcpy(o, sr.l, 32);
    fe_mul(er, ea, eb);
    fe_words(o + 8, er);
    fs_add(sr, sa, sb);
    memcpy(o + 16, sr.l, 32);
    fe_add(er, ea, eb);
    fe_words(o + 24, er);
    fs_sub(sr, sa, sb);
    memcpy(o + 32, sr.l, 32);
    fe_sub(er, ea, eb);
    fe_words(o + 40, er);
  }
  return 0;
}

// For n rows of 32 int32 radix-2^8 limbs, out[n][2][8] words:
// fs_from_limbs and fe_from_limbs
int tm_host_fs_from_limbs(const int32_t* limbs, int n, uint32_t* out) {
  for (int i = 0; i < n; i++) {
    fs s;
    fe e;
    fs_from_limbs(s, limbs + 32 * i);
    fe_from_limbs(e, limbs + 32 * i);
    memcpy(out + 16 * i, s.l, 32);
    fe_words(out + 16 * i + 8, e);
  }
  return 0;
}

// For n pairs of points p, q of 96 bytes ([3][32] little-endian, each
// coordinate below p), pair i on group i, all n groups at once: words[n][4]
// [24], the sum by the one-thread pt_add and by add_g, then the double of
// p by pt_double and by dbl_g. 0, or -1 if a group failed its checks.
int tm_host_secp_ops(const uint8_t* p, const uint8_t* q, int n, uint32_t* words) {
  for (int i = 0; i < n; i++) {
    point a, b, r;
    pt_raw(a, p + 96 * i);
    pt_raw(b, q + 96 * i);
    pt_add(r, a, b);
    pt_words(words + 96 * i, r);
    pt_double(r, a);
    pt_words(words + 96 * i + 48, r);
  }
  return run_groups(n, [&](HostLanes& w, int i) {
    uint32_t* o = words + 96 * i;
    const int l = w.lane;
    load_pq(w, p + 96 * i, q + 96 * i);
    add_g(w);
    if (l < 3) memcpy(o + 24 + 8 * l, w.ld(prog::S_P + l).l, 32);
    w.sync();
    load_pq(w, p + 96 * i, q + 96 * i);
    dbl_g(w);
    if (l < 3) memcpy(o + 72 + 8 * l, w.ld(prog::S_P + l).l, 32);
  });
}

// tm_secp_verify's body on host memory (its operands; gtab the wrapper's
// [16][3][4] 64-bit words), the rows on blocks of 16 groups, and the
// one-thread kernel's row: verdict[b][2] (lanes, one thread), tab[b][2][16]
// [24] and acc[b][2][24] words (the table of Q and R; zero where a row left
// before them). 0, or -1 if a group failed its checks.
int tm_host_secp_rows(const int32_t* qx, const int32_t* qy, const uint8_t* u1,
                      const uint8_t* u2, const uint8_t* rb, const bool* ok_in,
                      const uint64_t* gtab, int b, uint8_t* verdict,
                      uint32_t* tab, uint32_t* acc) {
  point gp[16];
  fs g[48];
  for (int d = 0; d < 16; d++)
    for (int c = 0; c < 3; c++) {
      fe& f = c == 0 ? gp[d].x : c == 1 ? gp[d].y : gp[d].z;
      for (int i = 0; i < 4; i++) {
        const uint64_t v = gtab[12 * d + 4 * c + i];
        f.v[i] = v;
        g[3 * d + c].l[2 * i] = (uint32_t)v;
        g[3 * d + c].l[2 * i + 1] = (uint32_t)(v >> 32);
      }
    }
  memset(tab, 0, sizeof(uint32_t) * (size_t)b * 2 * 16 * 24);
  memset(acc, 0, sizeof(uint32_t) * (size_t)b * 2 * 24);
  std::vector<uint8_t> out(b);
  for (int row = 0; row < b; row++)
    verdict[2 * row + 1] = thread_row(row, qx, qy, u1, u2, rb, ok_in, gp,
                                      tab + (size_t)row * 2 * 384 + 384,
                                      acc + (size_t)row * 48 + 24);
  for (int row0 = 0; row0 < b; row0 += kBlockGroups) {
    const int ng = b - row0 < kBlockGroups ? b - row0 : kBlockGroups;
    std::vector<std::vector<fs>> regions;
    if (run_groups(ng, [&](HostLanes& w, int group) {
          secp_row_g(w, row0 + group, qx, qy, u1, u2, rb, ok_in, g,
                     (bool*)out.data());
        }, &regions) != 0)
      return -1;
    for (int k = 0; k < ng; k++) {
      const int row = row0 + k;
      verdict[2 * row] = out[row];
      if (!ok_in[row]) continue;
      for (int s = 0; s < 48; s++)
        memcpy(tab + (size_t)row * 768 + 8 * s, regions[k][S_TAB + s].l, 32);
      for (int c = 0; c < 3; c++)
        memcpy(acc + (size_t)row * 48 + 8 * c, regions[k][prog::S_P + c].l, 32);
    }
  }
  return 0;
}

// The harness's checks on add_g of p + q on group 0 of two groups (group 1
// adds them too, cleanly) under a fault of group 0: 0 none; 1 lane 1 syncs
// once more than the others after it; 2 lane 2 reads the neighbour group's
// h (a slot past its region) where the group tests h; 3 lane 1 syncs with
// the whole warp's mask; 4 lane 2 writes h in the stage where every lane
// reads it. 0, or -1 when the run failed its checks.
int tm_host_secp_selftest(const uint8_t* p, const uint8_t* q, int fault) {
  return run_groups(2, [&](HostLanes& hw, int group) {
    const int f = group == 0 ? fault : 0;
    if (f == 3 && hw.lane == 1) hw.mask = 0xffffffffu;
    FaultyLanes w{hw, f, hw.lane};
    load_pq(w, p, q);
    add_g(w);
    if (f == 1 && w.lane == 1) w.sync();
  });
}

}  // extern "C"
