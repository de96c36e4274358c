// Native op-stream emitter: adaptive probability model + LZMA range coder.
//
// The device side compiles the winning parse into a dense op stream
// (per-position fixed-width arrays of (prob-slot, bit, active) plus a
// direct-bits record); this translation unit replays that stream through
// a carry-exact binary range coder.  It is deliberately oblivious to the
// LZMA packet layout -- the single source of truth for bit order lives in
// megalania_tpu/ops/bitplan.py -- so the native layer cannot drift from
// the cost model.  Range-coding semantics per the LZMA spec (reference
// behavior: /root/reference/src/range_encoder.c:18-81).
//
// Build: make -C megalania_tpu/runtime/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 11;
constexpr uint32_t kProbOne = 1u << kProbBits;   // 2048
constexpr uint32_t kMoveBits = 5;
constexpr uint32_t kTopValue = 1u << 24;

class RangeEncoder {
 public:
  RangeEncoder(uint8_t* out, int64_t cap)
      : out_(out), cap_(cap) {}

  bool overflowed() const { return overflow_; }
  int64_t size() const { return size_; }

  void EncodeBit(int bit, uint16_t* prob) {
    uint32_t p = *prob;
    uint32_t bound = (range_ >> kProbBits) * p;
    if (bit) {
      low_ += bound;
      range_ -= bound;
      p -= p >> kMoveBits;
    } else {
      range_ = bound;
      p += (kProbOne - p) >> kMoveBits;
    }
    *prob = static_cast<uint16_t>(p);
    while (range_ < kTopValue) {
      range_ <<= 8;
      ShiftLow();
    }
  }

  void EncodeDirect(uint32_t bits, int num_bits) {
    for (int i = num_bits - 1; i >= 0; --i) {
      range_ >>= 1;
      if ((bits >> i) & 1u) low_ += range_;
      if (range_ < kTopValue) {
        range_ <<= 8;
        ShiftLow();
      }
    }
  }

  void Flush() {
    for (int i = 0; i < 5; ++i) ShiftLow();
  }

 private:
  void Put(uint8_t b) {
    if (size_ < cap_) {
      out_[size_++] = b;
    } else {
      overflow_ = true;
    }
  }

  void ShiftLow() {
    uint32_t low32 = static_cast<uint32_t>(low_);
    uint32_t carry = static_cast<uint32_t>(low_ >> 32);
    if (low32 < 0xFF000000u || carry != 0) {
      Put(static_cast<uint8_t>(cache_ + carry));
      for (uint64_t i = 1; i < cache_size_; ++i) {
        Put(static_cast<uint8_t>(0xFF + carry));
      }
      cache_size_ = 0;
      cache_ = static_cast<uint8_t>(low32 >> 24);
    }
    ++cache_size_;
    low_ = (static_cast<uint64_t>(low32) << 8) & 0xFFFFFFFFull;
  }

  uint8_t* out_;
  int64_t cap_;
  int64_t size_ = 0;
  bool overflow_ = false;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  uint64_t cache_size_ = 1;
};

}  // namespace

extern "C" {

// Replay an op stream.  Arrays are row-major [n_positions, nslots] except
// n_direct/direct_val which are [n_positions].  Direct bits are emitted
// after slot `direct_after`.  Returns total bytes written (header + body),
// or -1 if out_cap was insufficient.
int64_t meg_emit_opstream(const int32_t* idx, const int32_t* bit,
                          const uint8_t* active, const int32_t* n_direct,
                          const int32_t* direct_val, int64_t n_positions,
                          int32_t nslots, int32_t direct_after,
                          int32_t num_probs, const uint8_t* header,
                          int64_t header_len, uint8_t* out, int64_t out_cap) {
  if (header_len > out_cap) return -1;
  std::memcpy(out, header, static_cast<size_t>(header_len));

  std::vector<uint16_t> probs(static_cast<size_t>(num_probs),
                              static_cast<uint16_t>(kProbOne / 2));
  RangeEncoder rc(out + header_len, out_cap - header_len);

  for (int64_t p = 0; p < n_positions; ++p) {
    const int64_t row = p * nslots;
    for (int32_t s = 0; s < nslots; ++s) {
      if (active[row + s]) {
        rc.EncodeBit(bit[row + s], &probs[static_cast<size_t>(idx[row + s])]);
      }
      if (s == direct_after && n_direct[p] > 0) {
        rc.EncodeDirect(static_cast<uint32_t>(direct_val[p]), n_direct[p]);
      }
    }
  }
  rc.Flush();
  if (rc.overflowed()) return -1;
  return header_len + rc.size();
}

}  // extern "C"
