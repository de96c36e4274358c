// Fused repair + exact-cost walk of one chain's slab: the annealer's hot
// pass, with the semantics of ops/repair_scan.repair_cost_batched bit for
// bit (same nine outputs, same partial re-cost and snapshot contract).
//
// The walk is written once against a small "warp" policy and compiled two
// ways:
//   * repair_walk.cu (nvcc, sm_90a): one warp per chain.  The chain's
//     probability row (int16) and the 2048-entry log2 table live in shared
//     memory.  A packet compiles to <= 26 distinct probability slots
//     (ops/bitplan.py), so lane s owns slot s: it gathers, prices, adapts
//     and scatters its slot with no conflicts, and the packet cost is one
//     warp reduction.  Per-position decisions (repair, context and rep
//     transitions, site recording, snapshot capture) are computed
//     uniformly by every lane.
//   * repair_walk_cpu.cc (host C++): the same walk with the lane loops run
//     sequentially — the CPU test build of this file.
//
// Unlike the position scan, the walk jumps from one live packet to the
// next: a dead run (the inside of a match) only copies its cells with the
// live bit cleared.
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#define MEG_FN __device__ __forceinline__
#else
#define MEG_FN inline
#endif

namespace meg {

// ---- probability layout (ops/tables.py; checked by meg_layout in tests) --
constexpr int PROB_BITS = 11;
constexpr int PROB_ONE = 1 << PROB_BITS;
constexpr int MOVE_BITS = 5;
constexpr int NUM_STATES = 12;
constexpr int IS_MATCH = 0;
constexpr int IS_REP = IS_MATCH + NUM_STATES;
constexpr int IS_REP_G0 = IS_REP + NUM_STATES;
constexpr int IS_REP_G1 = IS_REP_G0 + NUM_STATES;
constexpr int IS_REP_G2 = IS_REP_G1 + NUM_STATES;
constexpr int IS_REP0_LONG = IS_REP_G2 + NUM_STATES;
constexpr int LEN_CHOICE1 = 0;
constexpr int LEN_CHOICE2 = 1;
constexpr int LEN_LOW = 2;
constexpr int LEN_MID = 10;
constexpr int LEN_HIGH = 18;
constexpr int LEN_CODER_SIZE = LEN_HIGH + 256 + 6;
constexpr int LEN = IS_REP0_LONG + NUM_STATES;
constexpr int REP_LEN = LEN + LEN_CODER_SIZE;
constexpr int DIST_SLOT = REP_LEN + LEN_CODER_SIZE;
constexpr int ALIGN = DIST_SLOT + 4 * 64;
constexpr int POS_CODER = ALIGN + 16;
constexpr int LIT = POS_CODER + 120;
constexpr int MATCH_LEN_MIN = 2;
constexpr int NSLOTS = 26;

// ---- packed packet word (models/packets.py) ------------------------------
constexpr int T_LIT = 0, T_MATCH = 1, T_SREP = 2, T_LREP = 3;
constexpr uint32_t DIST_MASK = (1u << 20) - 1;
constexpr int LEN_SHIFT = 20;
constexpr uint32_t LEN_MASK = (1u << 9) - 1;
constexpr int TYPE_SHIFT = 29;
constexpr uint32_t LIVE_BIT = 1u << 31;

// misc output row: [hi, lo, rec_ctx, rec_d0..3, rec_live, count, 0 x 7,
// snapshot carry x 16] (the carry in repair_scan.CARRY16 order)
constexpr int MISC = 32;
constexpr int SNAP = 16;

struct WalkArgs {
  int C, n, M, P, lc;
  int site_packet;   // 1: u is a live-packet ordinal; 0: a byte position
  int fb_match;      // 1: lrep_fallback="match"; 0: "litsrep"
  int has_mut;       // 1: substitute mut0/mut1 at clip(q)/clip(q)+1
  const uint32_t* slabs;    // [C, n]
  const int32_t* q;         // [C]
  const int32_t* u;         // [C]
  const uint32_t* mut0;     // [C]
  const uint32_t* mut1;     // [C]
  const int32_t* data;      // [n]
  const int32_t* cand_d;    // [n, M]
  const int32_t* cand_l;    // [n, M]
  const int32_t* log2;      // [PROB_ONE]
  const int32_t* sc;        // [2]: start_pos, cap_pos
  const int32_t* probs_in;  // [C, P]
  const int32_t* carry_in;  // [C, 16]
  uint32_t* out_slab;       // [C, n]
  int32_t* snap_probs;      // [C, P]
  int32_t* misc;            // [C, MISC]
};

struct Carry {
  int ctx, d[4], live, hi, lo, since, rctx, rd[4], rlive, ord;
};

MEG_FN int imin(int a, int b) { return a < b ? a : b; }
MEG_FN int imax(int a, int b) { return a > b ? a : b; }
MEG_FN int iclip(int x, int lo, int hi) { return imin(imax(x, lo), hi); }

MEG_FN int bit_length(uint32_t x) {
#ifdef __CUDACC__
  return 32 - __clz(static_cast<int>(x));
#else
  return x ? 32 - __builtin_clz(x) : 0;
#endif
}

MEG_FN void carry_load(Carry& s, const int32_t* c16) {
  s.ctx = c16[0];
  for (int k = 0; k < 4; ++k) s.d[k] = c16[1 + k];
  s.live = c16[5];
  s.hi = c16[6];
  s.lo = c16[7];
  s.since = c16[8];
  s.rctx = c16[9];
  for (int k = 0; k < 4; ++k) s.rd[k] = c16[10 + k];
  s.rlive = c16[14];
  s.ord = c16[15];
}

// The snapshot stores `since` as 0: it counts repairs from THIS pass's q,
// and any later pass that starts here has its q at or beyond this point.
MEG_FN void carry_store_snapshot(const Carry& s, int32_t* c16) {
  c16[0] = s.ctx;
  for (int k = 0; k < 4; ++k) c16[1 + k] = s.d[k];
  c16[5] = s.live;
  c16[6] = s.hi;
  c16[7] = s.lo;
  c16[8] = 0;
  c16[9] = s.rctx;
  for (int k = 0; k < 4; ++k) c16[10 + k] = s.rd[k];
  c16[14] = s.rlive;
  c16[15] = s.ord;
}

MEG_FN void record(Carry& s) {
  s.rctx = s.ctx;
  for (int k = 0; k < 4; ++k) s.rd[k] = s.d[k];
  s.rlive = s.live;
}

// One packet's bit plan, uniform over the lanes (ops/bitplan.make_bit_plan).
struct Plan {
  int ctx, byte, mb, lit_base;
  bool is_lit, is_match, is_rep, b3, b4, b5, len_active, c1, c2;
  int lbase, tree_base, tree_nb, tree_val, len_ctx, ps, nlb, low, rbase;
};

MEG_FN Plan make_plan(int ptype, int dist, int len, int ctx, int byte, int mb,
                      int prev, int lc) {
  Plan p;
  p.ctx = ctx;
  p.byte = byte;
  p.mb = mb;
  p.is_lit = ptype == T_LIT;
  p.is_match = ptype == T_MATCH;
  const bool is_lrep = ptype == T_LREP;
  p.is_rep = ptype == T_SREP || is_lrep;
  p.b3 = is_lrep && dist != 0;
  p.b4 = p.b3 ? dist != 1 : is_lrep;
  p.b5 = dist != 2;
  const int len2 = imax(len - MATCH_LEN_MIN, 0);
  p.len_active = p.is_match || is_lrep;
  p.lbase = p.is_match ? LEN : REP_LEN;
  p.c1 = len2 >= 8;
  p.c2 = len2 >= 16;
  p.tree_base = p.lbase + (!p.c1 ? LEN_LOW : (!p.c2 ? LEN_MID : LEN_HIGH));
  p.tree_nb = p.c2 ? 8 : 3;
  p.tree_val = !p.c1 ? len2 : (!p.c2 ? len2 - 8 : len2 - 16);
  p.lit_base = LIT + (lc ? (prev >> (8 - lc)) * 0x300 : 0);
  const int nlb_t = imax(bit_length(static_cast<uint32_t>(dist)) - 2, 0);
  const int high = dist >> nlb_t;
  p.ps = dist < 4 ? dist : nlb_t * 2 + high;
  p.len_ctx = imin(len2, 3);
  const bool midrange = p.ps >= 4 && p.ps < 14;
  p.nlb = midrange ? (p.ps >> 1) - 1 : 4;
  p.low = dist & ((1 << p.nlb) - 1);
  p.rbase = midrange ? POS_CODER + (high << p.nlb) - p.ps : ALIGN;
  return p;
}

MEG_FN int direct_bits(const Plan& p, int dist) {
  if (!p.is_match || p.ps < 14) return 0;
  return imax(bit_length(static_cast<uint32_t>(dist)) - 2, 0) - 4;
}

// Slot s of the plan (emission order, ops/bitplan.py's slot layout).
// Returns false for an inactive slot.
MEG_FN bool plan_slot(const Plan& p, int s, int& idx, int& bit) {
  if (s < 5) {
    switch (s) {
      case 0: idx = IS_MATCH + p.ctx; bit = !p.is_lit; return true;
      case 1: idx = IS_REP + p.ctx; bit = p.is_rep; return !p.is_lit;
      case 2: idx = IS_REP_G0 + p.ctx; bit = p.b3; return p.is_rep;
      case 3:
        idx = (p.b3 ? IS_REP_G1 : IS_REP0_LONG) + p.ctx;
        bit = p.b4;
        return p.is_rep;
      default:
        idx = IS_REP_G2 + p.ctx;
        bit = p.b5;
        return p.is_rep && p.b3 && p.b4;
    }
  }
  if (s < 15) {
    const int j = s - 5;
    if (p.is_lit) {
      if (j >= 8) return false;
      const int mbit = (p.mb >> (7 - j)) & 1;
      // matched-byte context holds while the top j bits agree
      const bool matched = p.ctx >= 7 && ((p.byte ^ p.mb) >> (8 - j)) == 0;
      const int sym = (1 << j) | (p.byte >> (8 - j));
      idx = p.lit_base + sym + (matched ? (1 + mbit) << 8 : 0);
      bit = (p.byte >> (7 - j)) & 1;
      return true;
    }
    if (j == 0) {
      idx = p.lbase + LEN_CHOICE1;
      bit = p.c1;
      return p.len_active;
    }
    if (j == 1) {
      idx = p.lbase + LEN_CHOICE2;
      bit = p.c2;
      return p.len_active && p.c1;
    }
    const int t = j - 2;
    idx = p.tree_base + ((1 << t) | (p.tree_val >> imax(p.tree_nb - t, 0)));
    bit = (p.tree_val >> imax(p.tree_nb - 1 - t, 0)) & 1;
    return p.len_active && t < p.tree_nb;
  }
  if (s < 21) {
    const int t = s - 15;
    idx = DIST_SLOT + 64 * p.len_ctx + ((1 << t) | (p.ps >> (6 - t)));
    bit = (p.ps >> (5 - t)) & 1;
    return p.is_match;
  }
  const int t = s - 21;
  int rev = 0;
  for (int k = 0; k < t; ++k) rev |= ((p.low >> k) & 1) << (t - 1 - k);
  idx = p.rbase + ((1 << t) | rev);
  bit = (p.low >> t) & 1;
  return p.is_match && p.ps >= 4 && t < p.nlb;
}

// Price slot s under `probs`, adapt it in place; returns its cost.
MEG_FN int slot_cost(const Plan& p, int s, int16_t* probs,
                     const int32_t* log2) {
  int idx, bit;
  if (!plan_slot(p, s, idx, bit)) return 0;
  const int pr = probs[idx];
  const int c = log2[iclip(bit ? PROB_ONE - pr : pr, 0, PROB_ONE - 1)];
  probs[idx] = static_cast<int16_t>(
      bit ? pr - (pr >> MOVE_BITS) : pr + ((PROB_ONE - pr) >> MOVE_BITS));
  return c;
}

MEG_FN int ctx_next(int ctx, int ptype) {
  switch (ptype) {
    case T_LIT: return ctx < 4 ? 0 : (ctx < 10 ? ctx - 3 : ctx - 6);
    case T_MATCH: return ctx < 7 ? 7 : 10;
    case T_SREP: return ctx < 7 ? 9 : 11;
    default: return ctx < 7 ? 8 : 11;
  }
}

MEG_FN void dists_next(int* d, int ptype, int dist) {
  if (ptype == T_MATCH) {
    d[3] = d[2];
    d[2] = d[1];
    d[1] = d[0];
    d[0] = dist;
  } else if (ptype == T_LREP) {
    const int k = iclip(dist, 0, 3);
    const int front = d[k];
    for (int j = k; j >= 1; --j) d[j] = d[j - 1];
    d[0] = front;
  }
}

// Walk chain c.  `probs` holds the chain's probability row (loaded from
// probs_in by the caller); `log2` the cost table.  Contract (as for
// repair_scan): start_pos <= cap_pos, start_pos <= every q, and the carry
// at start_pos is a snapshot captured entering start_pos (live >= start).
template <class W>
MEG_FN void walk_chain(const W& w, const WalkArgs& a, int c, int16_t* probs,
                       const int32_t* log2) {
  const int n = a.n, M = a.M, P = a.P;
  const uint32_t* slab = a.slabs + static_cast<size_t>(c) * n;
  uint32_t* out = a.out_slab + static_cast<size_t>(c) * n;
  int32_t* misc = a.misc + static_cast<size_t>(c) * MISC;
  const int start = iclip(a.sc[0], 0, n);
  const int cap = a.sc[1];
  const int q = a.q[c], u = a.u[c];
  const int mpos = a.has_mut ? iclip(q, 0, n - 1) : -2;
  const uint32_t m0 = a.has_mut ? a.mut0[c] : 0u;
  const uint32_t m1 = a.has_mut ? a.mut1[c] : 0u;
  auto entry = [&](int i) -> uint32_t {
    return i == mpos ? m0 : (i == mpos + 1 ? m1 : slab[i]);
  };
  auto snapshot = [&](const Carry& s) {
    w.sync();
    w.each(0, P, [&](int k) {
      a.snap_probs[static_cast<size_t>(c) * P + k] = probs[k];
    });
    if (w.leader()) carry_store_snapshot(s, misc + SNAP);
  };

  Carry s;
  carry_load(s, a.carry_in + static_cast<size_t>(c) * 16);

  // the unwalked prefix passes through verbatim
  w.each(0, start, [&](int j) { out[j] = entry(j); });

  int i = start;
  while (i < n) {
    if (s.live != i) {
      // dead run [i, e): inside a match, no coder work.  Only byte-mode
      // recording and the snapshot can fire here, in position order.
      const int e = s.live > i ? imin(s.live, n) : n;
      const bool rec_here = !a.site_packet && u >= i && u < e;
      const bool cap_here = cap >= i && cap < e;
      const bool rec_after = rec_here && cap_here && u >= cap;
      if (rec_here && !rec_after) record(s);
      if (cap_here) snapshot(s);
      if (rec_after) record(s);
      w.each(i, e, [&](int j) { out[j] = entry(j) & ~LIVE_BIT; });
      i = e;
      continue;
    }
    if (cap == i) snapshot(s);
    if (a.site_packet ? s.ord == u : u == i) record(s);

    const uint32_t ent = entry(i);
    int ptype = static_cast<int>((ent >> TYPE_SHIFT) & 3u);
    int dist = static_cast<int>(ent & DIST_MASK);
    int len = static_cast<int>((ent >> LEN_SHIFT) & LEN_MASK);
    const int byte = a.data[i];
    const int mb = a.data[iclip(i - s.d[0] - 1, 0, n - 1)];
    const int prev = i > 0 ? a.data[i - 1] : 0;
    const bool in_repair = i >= q;

    if (in_repair) {
      // repair rules (ops/repair_scan._repair_entry)
      const bool srep_ok = i > 0 && i >= s.d[0] + 1 && byte == mb;
      const bool count_ok = s.since < 4;
      if (ptype == T_LIT || ptype == T_SREP) {
        ptype = srep_ok && count_ok ? T_SREP : (srep_ok ? ptype : T_LIT);
        dist = 0;
        len = 1;
      } else if (ptype == T_LREP) {
        const int32_t* cd = a.cand_d + static_cast<size_t>(i) * M;
        const int32_t* cl = a.cand_l + static_cast<size_t>(i) * M;
        const int d0 = s.d[0], d1 = s.d[1], d2 = s.d[2], d3 = s.d[3];
        const int plen = len;
        unsigned hit = w.reduce_or(M, [&](int m) -> unsigned {
          const int dm = cd[m];
          if (cl[m] < plen) return 0u;
          return (dm == d0 ? 1u : 0u) | (dm == d1 ? 2u : 0u) |
                 (dm == d2 ? 4u : 0u) | (dm == d3 ? 8u : 0u);
        });
        unsigned valid = 0;
        for (int k = 0; k < 4; ++k)
          if ((hit >> k & 1u) && s.d[k] + 1 <= i) valid |= 1u << k;
        const int cur = iclip(dist, 0, 3);
        const bool cur_ok = (valid >> cur) & 1u;
        int first = 0;
        while (valid && !((valid >> first) & 1u)) ++first;
        if (cur_ok || valid) {
          ptype = T_LREP;
          dist = cur_ok ? cur : first;
        } else {
          int flen = 0, bd = 0;
          if (a.fb_match) {
            const int ml = w.reduce_max(M, [&](int m) { return cl[m]; });
            bd = w.reduce_min(M, [&](int m) {
              return cl[m] == ml ? cd[m] : (1 << 30);
            });
            flen = imin(ml, n - i);
          }
          if (flen >= 2) {
            ptype = T_MATCH;
            dist = bd;
            len = flen;
          } else {
            ptype = srep_ok && count_ok ? T_SREP : T_LIT;
            dist = 0;
            len = 1;
          }
        }
      }
    }

    const Plan p = make_plan(ptype, dist, len, s.ctx, byte, mb, prev, a.lc);
    const int cost =
        w.reduce_add(NSLOTS, [&](int k) { return slot_cost(p, k, probs, log2); }) +
        (direct_bits(p, dist) << PROB_BITS);
    w.sync();
    s.lo += cost;
    s.hi += s.lo >> 16;
    s.lo &= 0xFFFF;
    s.ctx = ctx_next(s.ctx, ptype);
    dists_next(s.d, ptype, dist);
    s.live += len;
    s.since += in_repair ? 1 : 0;
    s.ord += 1;
    if (w.leader()) {
      out[i] = (static_cast<uint32_t>(dist) & DIST_MASK) |
               ((static_cast<uint32_t>(len) & LEN_MASK) << LEN_SHIFT) |
               ((static_cast<uint32_t>(ptype) & 3u) << TYPE_SHIFT) | LIVE_BIT;
    }
    i += 1;
  }
  if (cap >= n) snapshot(s);   // capture point past the end: final state
  if (w.leader()) {
    misc[0] = s.hi;
    misc[1] = s.lo;
    misc[2] = s.rctx;
    for (int k = 0; k < 4; ++k) misc[3 + k] = s.rd[k];
    misc[7] = s.rlive;
    misc[8] = s.ord;
    for (int k = 9; k < SNAP; ++k) misc[k] = 0;
  }
}

}  // namespace meg
