// Host build of the repair+cost walk (repair_walk.h), registered as the
// XLA FFI target's CPU implementation.  The lane loops of the CUDA build
// run sequentially here; the arithmetic is the same source.  This is how
// the kernel's logic is tested without a GPU (tests/test_repair_walk.py).
#include <climits>
#include <vector>

#include "repair_walk_ffi.h"

namespace meg {

struct HostWarp {
  template <class F>
  int reduce_add(int count, F f) const {
    int v = 0;
    for (int k = 0; k < count; ++k) v += f(k);
    return v;
  }
  template <class F>
  unsigned reduce_or(int count, F f) const {
    unsigned v = 0;
    for (int k = 0; k < count; ++k) v |= f(k);
    return v;
  }
  template <class F>
  int reduce_max(int count, F f) const {
    int v = INT_MIN;
    for (int k = 0; k < count; ++k) v = imax(v, f(k));
    return v;
  }
  template <class F>
  int reduce_min(int count, F f) const {
    int v = INT_MAX;
    for (int k = 0; k < count; ++k) v = imin(v, f(k));
    return v;
  }
  template <class F>
  void each(int begin, int end, F f) const {
    for (int k = begin; k < end; ++k) f(k);
  }
  void sync() const {}
  bool leader() const { return true; }
};

ffi::Error RepairWalkCpu(MEG_WALK_PARAMS) {
  WalkArgs a;
  ffi::Error err = make_walk_args(a, MEG_WALK_FORWARD);
  if (err.failure()) return err;
  std::vector<int16_t> probs(a.P);
  for (int c = 0; c < a.C; ++c) {
    for (int k = 0; k < a.P; ++k)
      probs[k] = static_cast<int16_t>(a.probs_in[static_cast<size_t>(c) * a.P + k]);
    walk_chain(HostWarp(), a, c, probs.data(), a.log2);
  }
  return ffi::Error::Success();
}

}  // namespace meg

XLA_FFI_DEFINE_HANDLER_SYMBOL(MegRepairWalkCpu, meg::RepairWalkCpu,
                              xla::ffi::Ffi::Bind() MEG_WALK_OPERANDS);

// The layout constants the walk was compiled with, for the tests to compare
// with ops/tables.py.
extern "C" void meg_walk_layout(int32_t* out) {
  const int32_t v[] = {meg::IS_MATCH, meg::IS_REP,   meg::IS_REP_G0,
                       meg::IS_REP_G1, meg::IS_REP_G2, meg::IS_REP0_LONG,
                       meg::LEN,       meg::REP_LEN,  meg::DIST_SLOT,
                       meg::ALIGN,     meg::POS_CODER, meg::LIT,
                       meg::LEN_LOW,   meg::LEN_MID,  meg::LEN_HIGH,
                       meg::NSLOTS};
  for (int k = 0; k < 16; ++k) out[k] = v[k];
}
