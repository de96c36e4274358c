// XLA FFI binding shared by the CUDA and the host build of the walk: the
// operand list, its shape checks, and the WalkArgs it fills.
#pragma once

#include <string>

#include "repair_walk.h"
#include "xla/ffi/api/ffi.h"

namespace meg_ffi = ::xla::ffi;   // the macros below expand at any scope

namespace meg {

namespace ffi = xla::ffi;

// Operands (ops/repair_walk.py builds them in this order):
//   slabs u32[C,n], q s32[C], u s32[C], mut0 u32[C], mut1 u32[C],
//   data s32[n], cand_dist s32[n,M], cand_len s32[n,M], log2 s32[2048],
//   sc s32[2] (start_pos, cap_pos), probs_in s32[C,P], carry_in s32[C,16]
// Results: out_slab u32[C,n], snap_probs s32[C,P], misc s32[C,32].
#define MEG_WALK_OPERANDS                               \
  .Arg<meg_ffi::Buffer<meg_ffi::U32>>()                 \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::U32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::U32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Arg<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Ret<meg_ffi::Buffer<meg_ffi::U32>>()             \
      .Ret<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Ret<meg_ffi::Buffer<meg_ffi::S32>>()             \
      .Attr<int32_t>("lc")                              \
      .Attr<int32_t>("site_packet")                     \
      .Attr<int32_t>("fb_match")                        \
      .Attr<int32_t>("has_mut")

#define MEG_WALK_PARAMS                                                  \
  meg_ffi::Buffer<meg_ffi::U32> slabs, meg_ffi::Buffer<meg_ffi::S32> q,  \
      meg_ffi::Buffer<meg_ffi::S32> u, meg_ffi::Buffer<meg_ffi::U32> mut0, \
      meg_ffi::Buffer<meg_ffi::U32> mut1,                                \
      meg_ffi::Buffer<meg_ffi::S32> data,                                \
      meg_ffi::Buffer<meg_ffi::S32> cand_d,                              \
      meg_ffi::Buffer<meg_ffi::S32> cand_l,                              \
      meg_ffi::Buffer<meg_ffi::S32> log2, meg_ffi::Buffer<meg_ffi::S32> sc, \
      meg_ffi::Buffer<meg_ffi::S32> probs_in,                            \
      meg_ffi::Buffer<meg_ffi::S32> carry_in,                            \
      meg_ffi::ResultBuffer<meg_ffi::U32> out_slab,                      \
      meg_ffi::ResultBuffer<meg_ffi::S32> snap_probs,                    \
      meg_ffi::ResultBuffer<meg_ffi::S32> misc, int32_t lc,              \
      int32_t site_packet, int32_t fb_match, int32_t has_mut

#define MEG_WALK_FORWARD                                                   \
  slabs, q, u, mut0, mut1, data, cand_d, cand_l, log2, sc, probs_in,       \
      carry_in, out_slab, snap_probs, misc, lc, site_packet, fb_match,     \
      has_mut

// Fill `a` from the FFI buffers; an error names the first bad operand.
inline ffi::Error make_walk_args(WalkArgs& a, MEG_WALK_PARAMS) {
  auto dims = slabs.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("slabs: rank 2");
  a.C = static_cast<int>(dims[0]);
  a.n = static_cast<int>(dims[1]);
  auto cdims = cand_d.dimensions();
  if (cdims.size() != 2 || cdims[0] != a.n)
    return ffi::Error::InvalidArgument("cand_dist: [n, M]");
  a.M = static_cast<int>(cdims[1]);
  auto pdims = probs_in.dimensions();
  if (pdims.size() != 2 || pdims[0] != a.C)
    return ffi::Error::InvalidArgument("probs_in: [C, P]");
  a.P = static_cast<int>(pdims[1]);
  if (a.n < 1 || a.M < 1)
    return ffi::Error::InvalidArgument("empty block or candidate table");
  if (cand_l.element_count() != cand_d.element_count() ||
      data.element_count() != static_cast<size_t>(a.n) ||
      log2.element_count() != static_cast<size_t>(PROB_ONE) ||
      sc.element_count() != 2 ||
      q.element_count() != static_cast<size_t>(a.C) ||
      u.element_count() != static_cast<size_t>(a.C) ||
      mut0.element_count() != static_cast<size_t>(a.C) ||
      mut1.element_count() != static_cast<size_t>(a.C) ||
      carry_in.element_count() != static_cast<size_t>(a.C) * 16 ||
      misc->element_count() != static_cast<size_t>(a.C) * MISC ||
      snap_probs->element_count() != static_cast<size_t>(a.C) * a.P ||
      out_slab->element_count() != slabs.element_count())
    return ffi::Error::InvalidArgument("operand shapes disagree");
  if (lc < 0 || lc > 4 || a.P < LIT + (0x300 << lc) + 1)
    return ffi::Error::InvalidArgument("probs_in row too short for lc");
  a.lc = lc;
  a.site_packet = site_packet;
  a.fb_match = fb_match;
  a.has_mut = has_mut;
  a.slabs = slabs.typed_data();
  a.q = q.typed_data();
  a.u = u.typed_data();
  a.mut0 = mut0.typed_data();
  a.mut1 = mut1.typed_data();
  a.data = data.typed_data();
  a.cand_d = cand_d.typed_data();
  a.cand_l = cand_l.typed_data();
  a.log2 = log2.typed_data();
  a.sc = sc.typed_data();
  a.probs_in = probs_in.typed_data();
  a.carry_in = carry_in.typed_data();
  a.out_slab = out_slab->typed_data();
  a.snap_probs = snap_probs->typed_data();
  a.misc = misc->typed_data();
  return ffi::Error::Success();
}

}  // namespace meg
