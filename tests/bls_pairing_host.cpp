// Host harness of the warp-wide BLS12-381 kernels, for the CPU tests
// (tests/test_torch_bls_pairing_lanes.py builds it with g++; the G2 sums'
// tests, tests/test_torch_bls_g2_lanes.py, and the G1 sums',
// tests/test_torch_bls_g1_lanes.py, use the same build).
//
// It runs the same source as the card: the fq core, run_program and the
// stage programs, miller_chunk_w, chunk_product_w, final_exp_w, g2_add_w,
// g2_tree_w, g1_add_g and g1_tree_g of ops/csrc/bls12_381_device.cuh, with
// host threads playing the lanes: 32 a warp over one shared slot array,
// or G a lane group of the G1 sums, each group over its own slots (a
// tree's block: several such warps or groups, and a barrier of all their
// threads for __syncthreads). A warp's or group's sync is a barrier of its
// lanes, so they run in lock-step, a stage at a time. At each sync the
// harness checks the stage that ends there:
// - every lane arrives with the same tag (the call and the lane's count of
//   syncs in it): a lane that ran a different number of stages, or left
//   early, fails the call;
// - every lane syncs with its group's mask: the bits of the group's own
//   lanes in its warp (all 32 for a warp), as __syncwarp takes it;
// - no slot was written by two lanes, or written by one lane and read by
//   another, in the stage: on the card, such a read could see either value.
// A lane that reads or writes a slot outside its group's region (on the
// card, another group's slots) fails the call too.
// It also exports the one-thread functions of the same header (fp_mul,
// f12_mul, f12_sqr, ..., the Miller steps, jac_add<fp2>, jac_double<fp2>,
// jac_add<fp>, jac_double<fp>), which the tests hold the lane functions
// against.
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#include "../tendermint_tpu_torch/ops/csrc/bls12_381_device.cuh"

using namespace bdev;

namespace {

constexpr long kDone = -1;  // the tag of a lane that has returned

// n lanes in lock-step over their own slots: a warp (n = 32) or a group
struct Lanes {
  const int n;
  const unsigned want;  // the group's lanes in its warp, as __syncwarp's mask
  std::atomic<int> arrived{0};
  std::atomic<unsigned> gen{0};
  std::atomic<bool> failed{false};
  std::atomic<bool> strayed{false};  // a lane touched a slot past the region
  std::vector<fq> sm;
  std::vector<std::vector<int>> rd, wr;
  std::vector<long> tag;
  std::vector<unsigned> mask;
  std::vector<int> writer;

  Lanes(int nlanes, unsigned want_mask, int nslots)
      : n(nlanes), want(want_mask), sm(nslots), rd(nlanes), wr(nlanes),
        tag(nlanes), mask(nlanes), writer(nslots, -1) {
    memset(sm.data(), 0xA5, sizeof(fq) * nslots);  // no slot starts as zero
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

// the lane type of the device functions: a lane of a warp (G = 32) or of a
// group of G lanes, its sync __syncwarp(mask)
template <int G>
struct HostLanes {
  static constexpr int kLanes = G;
  Lanes* gp;
  int lane;
  unsigned mask;
  long call = 0, seq = 0;

  bool own(int s) {
    if (s >= 0 && s < (int)gp->sm.size()) return true;
    gp->strayed = true;  // another group's slots, on the card
    return false;
  }
  fq ld(int s) {
    if (!own(s)) return fq{};
    gp->rd[lane].push_back(s);
    return gp->sm[s];
  }
  void st(int s, const fq& v) {
    if (!own(s)) return;
    gp->wr[lane].push_back(s);
    gp->sm[s] = v;
  }
  void sync() { gp->barrier(lane, (call << 32) | ++seq, mask); }
};

using HostWarp = HostLanes<32>;

// fn(w, group, block_sync) on ngroups groups of G lanes (G = 32: warps),
// 32 / G groups to a warp, each group in lock-step over its own slots and
// ending with a last barrier with the tag kDone, block_sync a barrier of
// every thread (the card's __syncthreads). A lane's mask is the kernels'
// group_mask; the harness's own is the group's lanes in its warp. 0, or -1
// if a group fell out of lock-step, synced with another mask, touched
// another group's slots or let a stage's accesses clash
template <int G, class F>
int run_groups(int ngroups, int nslots, F fn) {
  std::vector<std::unique_ptr<Lanes>> groups;
  for (int g = 0; g < ngroups; g++)
    groups.emplace_back(new Lanes(G, G == 32 ? ~0u : ((1u << (G & 31)) - 1u) << (G * g % 32),
                                  nslots));
  std::barrier block(G * ngroups);
  std::vector<std::thread> threads;
  for (int t = 0; t < G * ngroups; t++) {
    threads.emplace_back([&, t] {
      const int g = t / G, lane = t % G;
      HostLanes<G> w{groups[g].get(), lane, group_mask<G>(t % 32)};
      fn(w, g, [&] { block.arrive_and_wait(); });
      groups[g]->barrier(lane, kDone, w.mask);
    });
  }
  for (auto& t : threads) t.join();
  for (auto& gp : groups)
    if (gp->failed || gp->strayed) return -1;
  return 0;
}

// fn(w, warp, block_sync) on nwarps warps
template <class F>
int run_block(int nwarps, int nslots, F fn) {
  return run_groups<32>(nwarps, nslots, fn);
}

// fn(w) on one warp
template <class F>
int run_warp(int nslots, F fn) {
  return run_block(1, nslots, [&](HostWarp& w, int, auto) { fn(w); });
}

void words_of(uint32_t* o, const fp& a) {
  for (int i = 0; i < 6; i++) {
    o[2 * i] = (uint32_t)a.l[i];
    o[2 * i + 1] = (uint32_t)(a.l[i] >> 32);
  }
}

void f12_words(uint32_t* o, const fp12& a) {
  for (int i = 0; i < 6; i++) {
    words_of(o + 24 * i, a.c[i].c0);
    words_of(o + 24 * i + 12, a.c[i].c1);
  }
}

void raw48(fp& a, const uint8_t* b) {
  for (int i = 0; i < 6; i++) {
    uint64_t v = 0;
    for (int j = 7; j >= 0; j--) v = (v << 8) | b[8 * i + j];
    a.l[i] = v;
  }
}

void fq_raw48(fq& a, const uint8_t* b) {
  for (int i = 0; i < 12; i++)
    a.l[i] = (uint32_t)b[4 * i] | (uint32_t)b[4 * i + 1] << 8 |
             (uint32_t)b[4 * i + 2] << 16 | (uint32_t)b[4 * i + 3] << 24;
}

// a test program Z = op(X, Y) on one warp, X and Y loaded from bytes (Y
// may be null); Z's Montgomery words into out[144]
int run_test_program(int first, int n, const uint8_t* x, const uint8_t* y,
                     uint32_t* out) {
  return run_warp(prog::C_SLOTS, [&](HostWarp& w) {
    warp_consts(w);
    const int l = w.lane;
    if (l < 12 || (y && l < 24)) {
      fq v;
      fq_load(v, l < 12 ? x + 48 * l : y + 48 * (l - 12));
      w.st(prog::C_X + l, v);
    }
    w.sync();
    run_program(w, first, n, 0u);
    if (l < 12) {
      const fq v = w.ld(prog::C_Z + l);
      memcpy(out + 12 * l, v.l, 48);
    }
    w.sync();
  });
}

// a lane under a fault of tm_host_g2_selftest
struct FaultyWarp {
  static constexpr int kLanes = 32;
  HostWarp& w;
  int fault, lane;
  bool wrote = false;
  fq ld(int s) {
    fq v = w.ld(s);
    if (s == prog::G2_H && fault == 2 && lane == 3) v.l[0] ^= 1u;
    if (s == prog::G2_H && fault == 3 && lane == 6 && !wrote) {
      w.st(s, v);
      wrote = true;
    }
    return v;
  }
  void st(int s, const fq& v) { w.st(s, v); }
  void sync() { w.sync(); }
};

// the G1 lane functions with groups of G lanes
template <int G>
int g1_ops(const uint8_t* p, const uint8_t* q, int n, uint32_t* words, uint8_t* bytes) {
  for (int i = 0; i < n; i++) {
    const uint8_t* pi = p + 144 * i;
    const uint8_t* qi = q + 144 * i;
    uint32_t* o = words + 4 * 36 * i;
    jac<fp> a, b, r;
    fp_load(a.x, pi);
    fp_load(a.y, pi + 48);
    fp_load(a.z, pi + 96);
    fp_load(b.x, qi);
    fp_load(b.y, qi + 48);
    fp_load(b.z, qi + 96);
    jac_add(r, a, b);
    const fp* coords[3] = {&r.x, &r.y, &r.z};
    for (int c = 0; c < 3; c++) {
      words_of(o + 12 * c, *coords[c]);
      fp_store(bytes + 288 * i + 48 * c, *coords[c]);
    }
    jac_double(r, a);
    for (int c = 0; c < 3; c++) words_of(o + 72 + 12 * c, *coords[c]);
  }
  // pair i on group i, n groups at once: the groups of a warp take their
  // own branches
  return run_groups<G>(n, prog::G1_SLOTS, [&](HostLanes<G>& w, int i, auto) {
    const uint8_t* pi = p + 144 * i;
    const uint8_t* qi = q + 144 * i;
    uint32_t* o = words + 4 * 36 * i;
    const int l = w.lane;
    g1_consts(w);
    for (int c = l; c < 6; c += G) {
      fq v;
      fq_load(v, (c < 3 ? pi : qi) + 48 * (c % 3));
      w.st(prog::G1_P + c, v);
    }
    w.sync();
    const int sum = g1_add_g(w);
    if (l < 3) memcpy(o + 36 + 12 * l, w.ld(sum + l).l, 48);
    w.sync();
    g1_dbl_g(w);
    if (l < 3) memcpy(o + 108 + 12 * l, w.ld(prog::G1_O + l).l, 48);
    w.sync();
    g1_add_bytes_g(w, pi, qi, bytes + 288 * i + 144);
  });
}

template <int G>
int g1_aggregate(const uint8_t* in, int ntrees, int b, int nb, int nwarps, uint8_t* out) {
  std::vector<fq> s(3 * (size_t)nb);
  const int ngroups = nwarps * (32 / G);
  for (int t = 0; t < ntrees; t++) {
    if (run_groups<G>(ngroups, prog::G1_SLOTS, [&](HostLanes<G>& w, int group, auto block_sync) {
          g1_tree_g(w, group, ngroups, in + 144 * (size_t)b * t, s.data(),
                    out + 144 * t, b, nb, block_sync);
        }) != 0)
      return -1;
  }
  return 0;
}

// group 0's lanes under a fault of g1_selftest
template <int G>
struct FaultyLanes {
  static constexpr int kLanes = G;
  HostLanes<G>& w;
  int fault, lane;
  bool wrote = false;
  fq ld(int s) {
    if (s == prog::G1_H && fault == 2 && lane == 2) s += prog::G1_SLOTS;
    fq v = w.ld(s);
    if (s == prog::G1_H && fault == 4 && lane == 2 && !wrote) {
      w.st(s, v);
      wrote = true;
    }
    return v;
  }
  void st(int s, const fq& v) { w.st(s, v); }
  void sync() { w.sync(); }
};

// g1_add_bytes_g of p + q on group 0 of two groups of G lanes (group 1
// adds them too, cleanly) under a fault of group 0: 0 none; 1 lane 1
// syncs once more than the others after it; 2 lane 2 reads the neighbour
// group's h (a slot past its region) where the group tests h; 3 lane 1
// syncs with the whole warp's mask; 4 lane 2 writes h in the stage where
// every lane reads it. (A lane that took G1_ADD_FIN where its group runs
// G1_DBL would pass these checks: both programs have 12 stages, and their
// slots do not meet. The tests' limb-for-limb comparisons of every branch
// catch it.)
template <int G>
int g1_selftest(const uint8_t* p, const uint8_t* q, int fault) {
  return run_groups<G>(2, prog::G1_SLOTS, [&](HostLanes<G>& hw, int group, auto) {
    const int f = group == 0 ? fault : 0;
    if (f == 3 && hw.lane == 1) hw.mask = 0xffffffffu;
    FaultyLanes<G> w{hw, f, hw.lane};
    uint8_t out[144];
    g1_add_bytes_g(w, p, q, out);
    if (f == 1 && w.lane == 1) w.sync();
  });
}

}  // namespace

extern "C" {

// For n pairs of raw 48-byte integers (a < 2^384 any, b < p), out[n][12][12]
// words: fp_mul(a, b) and fq_mul(a, b) of the raw limbs; fp_add and
// fq_add_sub's sum, fp_sub and its difference (of a mod p, b); fp_load(a)
// and fq_load(a); fp_inv(b) (Fermat) and fq_inv(b) (binary extended
// Euclid); the canonical bytes of fp_store(b) and fq_store(b) as words
int tm_host_fq_ops(const uint8_t* a, const uint8_t* b, int n, uint32_t* out) {
  for (int i = 0; i < n; i++) {
    fp pa, pb, r, am;
    fq qa, qb, q;
    raw48(pa, a + 48 * i);
    raw48(pb, b + 48 * i);
    fq_raw48(qa, a + 48 * i);
    fq_raw48(qb, b + 48 * i);
    uint32_t* o = out + 144 * i;
    fp_mul(r, pa, pb);
    words_of(o, r);
    fq_mul(q, qa, qb);
    memcpy(o + 12, q.l, 48);
    // a mod p, for the additions (their operands are canonical)
    fp one;
    fp_zero(one);
    one.l[0] = 1;
    fp r2;
    fp_set(r2, FP_R2);
    fp_mul(am, pa, r2);
    fp_mul(am, am, one);
    fq qam;
    fq_raw48(qam, (const uint8_t*)am.l);
    fp_add(r, am, pb);
    words_of(o + 24, r);
    fq_add_sub(q, qam, qb, false);
    memcpy(o + 36, q.l, 48);
    fp_sub(r, am, pb);
    words_of(o + 48, r);
    fq_add_sub(q, qam, qb, true);
    memcpy(o + 60, q.l, 48);
    fp_load(r, a + 48 * i);
    words_of(o + 72, r);
    fq_load(q, a + 48 * i);
    memcpy(o + 84, q.l, 48);
    fp_inv(r, pb);
    words_of(o + 96, r);
    fq_inv(q, qb);
    memcpy(o + 108, q.l, 48);
    fp_store((uint8_t*)(o + 120), pb);
    fq_store((uint8_t*)(o + 132), qb);
  }
  return 0;
}

// For n pairs of fp12s x, y (canonical bytes [6][2][48]; of y the line
// (l0, l2, l3) is its coefficients 0-2), out[n][2][6][144] words: the
// one-thread f12_mul(x, y), f12_sqr(x), f12_mul_line(x, l0, l2, l3),
// f12_cyclo_sqr(x), f12_frob(x), f12_inv(x), then the warp programs MUL12,
// T_SQR, T_LINE, T_CYC, T_FROB, T_INV on the same operands. 0, or -1 if a
// warp run failed its checks.
int tm_host_f12_ops(const uint8_t* x, const uint8_t* y, int n, uint32_t* out) {
  fp2 gamma[6];
  fp12_gamma(gamma);
  for (int i = 0; i < n; i++) {
    const uint8_t* xi = x + 576 * i;
    const uint8_t* yi = y + 576 * i;
    uint32_t* o = out + 2 * 6 * 144 * i;
    fp12 a, b, r;
    f12_load(a, xi);
    f12_load(b, yi);
    f12_mul(r, a, b);
    f12_words(o, r);
    f12_sqr(r, a);
    f12_words(o + 144, r);
    f12_mul_line(r, a, b.c[0], b.c[1], b.c[2]);
    f12_words(o + 288, r);
    f12_cyclo_sqr(r, a);
    f12_words(o + 432, r);
    f12_frob(r, a, gamma);
    f12_words(o + 576, r);
    f12_inv(r, a);
    f12_words(o + 720, r);
    uint32_t* q = o + 864;
    const int progs[6][2] = {
        {prog::MUL12_FIRST, prog::MUL12_N}, {prog::T_SQR_FIRST, prog::T_SQR_N},
        {prog::T_LINE_FIRST, prog::T_LINE_N}, {prog::T_CYC_FIRST, prog::T_CYC_N},
        {prog::T_FROB_FIRST, prog::T_FROB_N}, {prog::T_INV_FIRST, prog::T_INV_N}};
    for (int k = 0; k < 6; k++) {
      const bool two = k == 0 || k == 2;
      if (run_test_program(progs[k][0], progs[k][1], xi, two ? yi : nullptr,
                           q + 144 * k) != 0)
        return -1;
    }
  }
  return 0;
}

// One Miller bit on both sides for n states. state[n] = f (576 bytes), then
// for pairs k = 0, 1: T_k = X, Y, Z (3 x 96 bytes), P_k = xp, yp (2 x 48),
// Q_k = xq, yq (2 x 96): 576 + 2 * 576 = 1728 bytes. flags[n]: bit k pair
// k valid; with_add: the bit of |x| is set. out[n][2][(12 + 12) 12] words:
// f and T_0, T_1 (X, Y, Z) by the one-thread code (f12_sqr, then each
// pair's miller_dbl_step and, if valid, f12_mul_line; then the same with
// miller_add_step), then by the warp program M_DBL or M_ADD. 0, or -1.
int tm_host_miller_bit(const uint8_t* state, const uint8_t* flags, int n,
                       int with_add, uint32_t* out) {
  for (int i = 0; i < n; i++) {
    const uint8_t* s = state + 1728 * i;
    uint32_t* o = out + 2 * 288 * i;
    fp12 f;
    f12_load(f, s);
    fp2 X[2], Y[2], Z[2], xq[2], yq[2];
    fp xp[2], yp[2];
    for (int k = 0; k < 2; k++) {
      const uint8_t* b = s + 576 + 576 * k;
      f2_load(X[k], b);
      f2_load(Y[k], b + 96);
      f2_load(Z[k], b + 192);
      fp_load(xp[k], b + 288);
      fp_load(yp[k], b + 336);
      f2_load(xq[k], b + 384);
      f2_load(yq[k], b + 480);
    }
    f12_sqr(f, f);
    for (int k = 0; k < 2; k++) {
      fp2 l0, l2, l3;
      miller_dbl_step(l0, l2, l3, X[k], Y[k], Z[k], xp[k], yp[k]);
      if ((flags[i] >> k) & 1) f12_mul_line(f, f, l0, l2, l3);
    }
    if (with_add) {
      for (int k = 0; k < 2; k++) {
        fp2 l0, l2, l3;
        miller_add_step(l0, l2, l3, X[k], Y[k], Z[k], xq[k], yq[k], xp[k], yp[k]);
        if ((flags[i] >> k) & 1) f12_mul_line(f, f, l0, l2, l3);
      }
    }
    f12_words(o, f);
    for (int k = 0; k < 2; k++) {
      words_of(o + 144 + 72 * k, X[k].c0);
      words_of(o + 144 + 72 * k + 12, X[k].c1);
      words_of(o + 144 + 72 * k + 24, Y[k].c0);
      words_of(o + 144 + 72 * k + 36, Y[k].c1);
      words_of(o + 144 + 72 * k + 48, Z[k].c0);
      words_of(o + 144 + 72 * k + 60, Z[k].c1);
    }
    uint32_t* q = o + 288;
    const int rc = run_warp(prog::M_SLOTS, [&](HostWarp& w) {
      warp_consts(w);
      const int l = w.lane;
      // f (12), T (12), P (4), Q (8)
      if (l < 32) {
        int slot;
        const uint8_t* src;
        if (l < 12) {
          slot = prog::M_F + l;
          src = s + 48 * l;
        } else if (l < 24) {
          const int k = (l - 12) / 6, c = (l - 12) % 6;
          slot = prog::M_T + 6 * k + c;
          src = s + 576 + 576 * k + 48 * c;
        } else if (l < 28) {
          const int k = (l - 24) >> 1;
          slot = prog::M_P + (l - 24);
          src = s + 576 + 576 * k + 288 + 48 * ((l - 24) & 1);
        } else {
          // 4 lanes left for 8 Q slots: two each
          slot = -1;
          src = nullptr;
        }
        if (slot >= 0) {
          fq v;
          fq_load(v, src);
          w.st(slot, v);
        } else {
          for (int h = 0; h < 2; h++) {
            const int qi = 2 * (l - 28) + h;  // pair qi / 4, x or y, component
            const int k = qi >> 2;
            fq v;
            fq_load(v, s + 576 + 576 * k + 384 + 96 * ((qi >> 1) & 1) + 48 * (qi & 1));
            w.st(prog::M_Q + qi, v);
          }
        }
      }
      w.sync();
      if (with_add)
        TM_RUN(w, M_ADD, flags[i]);
      else
        TM_RUN(w, M_DBL, flags[i]);
      if (l < 24) {
        const fq v = w.ld(l < 12 ? prog::M_F + l : prog::M_T + l - 12);
        memcpy(q + 12 * l, v.l, 48);
      }
      w.sync();
    });
    if (rc != 0) return -1;
  }
  return 0;
}

// tm_miller's operands on host memory (c chunks): each chunk's
// miller_chunk_w on one warp, then chunk_product_w on one warp; the
// canonical product into out (576 bytes) and the chunk values' words into
// scratch[c][144]. 0, or -1.
int tm_host_miller(const uint8_t* xp, const uint8_t* yp, const uint8_t* xq,
                   const uint8_t* yq, const uint8_t* valid, uint32_t* scratch,
                   uint8_t* out, int c) {
  for (int k = 0; k < c; k++) {
    if (run_warp(prog::M_SLOTS, [&](HostWarp& w) {
          miller_chunk_w(w, xp, yp, xq, yq, (const bool*)valid, k,
                         scratch + 144 * k);
        }) != 0)
      return -1;
  }
  std::vector<uint32_t> s(scratch, scratch + 144 * (size_t)c);
  return run_warp(prog::C_SLOTS, [&](HostWarp& w) {
    chunk_product_w(w, 0, 1, s.data(), c, out, [] {});
  });
}

// tm_final_exp's operands on host memory: each element on one warp. 0, or -1.
int tm_host_final_exp(const uint8_t* in, uint8_t* out, int n) {
  for (int k = 0; k < n; k++) {
    if (run_warp(prog::FE_SLOTS, [&](HostWarp& w) {
          final_exp_w(w, in + 576 * k, out + 576 * k);
        }) != 0)
      return -1;
  }
  return 0;
}

// The one-thread final exponentiation (final_exponentiation) of n elements,
// for the tests' comparison of the two.
int tm_host_final_exp_one_thread(const uint8_t* in, uint8_t* out, int n) {
  fp2 gamma[6];
  fp12_gamma(gamma);
  for (int k = 0; k < n; k++) {
    fp12 f, r;
    f12_load(f, in + 576 * k);
    final_exponentiation(r, f, gamma);
    f12_store(out + 576 * k, r);
  }
  return 0;
}

// For n pairs of G2 points p, q of 288 bytes ([3][2][48], read mod p):
// words[n][4][72], the sum's Montgomery words by the one-thread
// jac_add<fp2>, by g2_add_w on one warp, then the double of p by the
// one-thread jac_double<fp2> and by g2_dbl_w; bytes[n][2][288], the sum's
// canonical bytes by jac_add<fp2> (fe_store) and by g2_add_bytes_w. 0, or
// -1 if a warp run failed its checks.
int tm_host_g2_ops(const uint8_t* p, const uint8_t* q, int n, uint32_t* words,
                   uint8_t* bytes) {
  for (int i = 0; i < n; i++) {
    const uint8_t* pi = p + 288 * i;
    const uint8_t* qi = q + 288 * i;
    uint32_t* o = words + 4 * 72 * i;
    uint8_t* ob = bytes + 2 * 288 * i;
    jac<fp2> a, b, r;
    for (int c = 0; c < 3; c++) {
      f2_load(c == 0 ? a.x : c == 1 ? a.y : a.z, pi + 96 * c);
      f2_load(c == 0 ? b.x : c == 1 ? b.y : b.z, qi + 96 * c);
    }
    const fp2* coords[3] = {&r.x, &r.y, &r.z};
    jac_add(r, a, b);
    for (int c = 0; c < 3; c++) {
      words_of(o + 24 * c, coords[c]->c0);
      words_of(o + 24 * c + 12, coords[c]->c1);
      f2_store(ob + 96 * c, *coords[c]);
    }
    jac_double(r, a);
    for (int c = 0; c < 3; c++) {
      words_of(o + 144 + 24 * c, coords[c]->c0);
      words_of(o + 144 + 24 * c + 12, coords[c]->c1);
    }
    for (int dbl = 0; dbl < 2; dbl++) {
      uint32_t* q_out = o + 72 + 144 * dbl;
      const int rc = run_warp(prog::G2_SLOTS, [&](HostWarp& w) {
        warp_consts(w);
        const int l = w.lane;
        if (l < 12) {
          fq v;
          fq_load(v, (l < 6 ? pi : qi) + 48 * (l % 6));
          w.st(prog::G2_P + l, v);
        }
        w.sync();
        int sum = prog::G2_O;
        if (dbl)
          g2_dbl_w(w);
        else
          sum = g2_add_w(w);
        if (l < 6) memcpy(q_out + 12 * l, w.ld(sum + l).l, 48);
        w.sync();
      });
      if (rc != 0) return -1;
    }
    if (run_warp(prog::G2_SLOTS, [&](HostWarp& w) {
          g2_add_bytes_w(w, pi, qi, ob + 288);
        }) != 0)
      return -1;
  }
  return 0;
}

// tm_g2_aggregate's body on host memory: ntrees trees of b points of 288
// bytes at in, each padded to nb leaves and summed by g2_tree_w on nwarps
// warps (one block a tree); the canonical sums into out[ntrees][288]. 0,
// or -1.
int tm_host_g2_aggregate(const uint8_t* in, int ntrees, int b, int nb,
                         int nwarps, uint8_t* out) {
  std::vector<fq> s(6 * (size_t)nb);
  for (int t = 0; t < ntrees; t++) {
    if (run_block(nwarps, prog::G2_SLOTS, [&](HostWarp& w, int warp, auto block_sync) {
          g2_tree_w(w, warp, nwarps, in + 288 * (size_t)b * t, s.data(),
                    out + 288 * t, b, nb, block_sync);
        }) != 0)
      return -1;
  }
  return 0;
}

// The harness's checks on g2_add_w of p + q (p = q in two representations,
// so the doubling branch runs): fault 0 none; 1 lane 5 syncs once more
// than the others after it; 2 lane 3 reads h as nonzero and runs
// G2_ADD_FIN where the warp runs G2_DBL (a branch that is not
// warp-uniform); 3 lane 6 writes h in the stage where every lane reads it.
// 0, or -1 when the run failed its checks.
int tm_host_g2_selftest(const uint8_t* p, const uint8_t* q, int fault) {
  return run_warp(prog::G2_SLOTS, [&](HostWarp& hw) {
    FaultyWarp w{hw, fault, hw.lane};
    uint8_t out[288];
    g2_add_bytes_w(w, p, q, out);
    if (fault == 1 && w.lane == 5) w.sync();
  });
}

// The harness's own checks on a toy run of two stages: fault 0 none; 1
// lane 5 syncs once more than the others; 2 lane 3 reads the slot lane 4
// writes in the same stage; 3 lanes 6 and 7 both write slot 6. 0, or -1
// when the run failed its checks.
int tm_host_lockstep_selftest(int fault) {
  return run_warp(64, [&](HostWarp& w) {
    const int l = w.lane;
    fq v;
    for (int i = 0; i < 12; i++) v.l[i] = (uint32_t)l;
    w.st(l, v);
    if (fault == 2 && l == 3) (void)w.ld(4);
    if (fault == 3 && l == 7) w.st(6, v);
    w.sync();
    w.st(32 + l, w.ld((l + 1) % 32));  // a neighbour's slot, after the sync
    w.sync();
    if (fault == 1 && l == 5) w.sync();
  });
}

// For n pairs of G1 points p, q of 144 bytes ([3][48], read mod p), on
// groups of `lanes` (4 or 8) lanes, pair i on group i, all n groups at
// once: words[n][4][36], the sum's Montgomery words by the one-thread
// jac_add<fp>, by g1_add_g, then the double of p by the one-thread
// jac_double<fp> and by g1_dbl_g; bytes[n][2][144], the sum's canonical
// bytes by jac_add<fp> (fp_store) and by g1_add_bytes_g. 0, or -1 if a
// group failed its checks.
int tm_host_g1_ops(const uint8_t* p, const uint8_t* q, int n, int lanes,
                   uint32_t* words, uint8_t* bytes) {
  if (lanes == 4) return g1_ops<4>(p, q, n, words, bytes);
  if (lanes == 8) return g1_ops<8>(p, q, n, words, bytes);
  return -2;
}

// tm_g1_aggregate's body on host memory: ntrees trees of b points of 144
// bytes at in, each padded to nb leaves and summed by g1_tree_g on nwarps
// warps of groups of `lanes` lanes (one block a tree); the canonical sums
// into out[ntrees][144]. 0, or -1.
int tm_host_g1_aggregate(const uint8_t* in, int ntrees, int b, int nb,
                         int nwarps, int lanes, uint8_t* out) {
  if (lanes == 4) return g1_aggregate<4>(in, ntrees, b, nb, nwarps, out);
  if (lanes == 8) return g1_aggregate<8>(in, ntrees, b, nb, nwarps, out);
  return -2;
}

// The harness's checks on the G1 groups (g1_selftest). 0, or -1 when the
// run failed its checks.
int tm_host_g1_selftest(const uint8_t* p, const uint8_t* q, int lanes, int fault) {
  if (lanes == 4) return g1_selftest<4>(p, q, fault);
  if (lanes == 8) return g1_selftest<8>(p, q, fault);
  return -2;
}

}  // extern "C"
