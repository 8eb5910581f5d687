// Adaptive-free (static-frequency) arithmetic coder for quantized weight
// symbols: the native half of the entropy-coding stage (the port's own copy
// of neuroquant_tpu/coding/native/range_coder.cpp; the two write the same
// bytes).
//
// The reference framework deliberately leaves entropy coding out of scope
// ("Any entropy codec ... can be used", readme.md:125-127) and hands the
// caller integer weight codes (quant_model.py:74-80). This module supplies a
// concrete, dependency-free codec so the pipeline produces real bitstreams
// and bpp numbers: a CACM87-style 32-bit arithmetic coder with 64-bit
// intermediates and frequency tables capped at 1<<16 total.
//
// C ABI so Python binds via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kTop = 0xFFFFFFFFu;
constexpr uint32_t kHalf = 0x80000000u;
constexpr uint32_t kQuarter = 0x40000000u;
constexpr uint32_t kThreeQuarter = 0xC0000000u;

class BitWriter {
 public:
  explicit BitWriter(uint8_t* out, size_t cap) : out_(out), cap_(cap) {}
  bool put(int bit) {
    if (pos_ >= cap_ * 8) return false;
    if (bit) out_[pos_ >> 3] |= (uint8_t)(1u << (7 - (pos_ & 7)));
    else out_[pos_ >> 3] &= (uint8_t)~(1u << (7 - (pos_ & 7)));
    ++pos_;
    return true;
  }
  size_t bits() const { return pos_; }

 private:
  uint8_t* out_;
  size_t cap_;
  size_t pos_ = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* in, size_t len) : in_(in), len_(len) {}
  int get() {
    if (pos_ >= len_ * 8) return 0;  // pad with zeros past the end
    int b = (in_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1;
    ++pos_;
    return b;
  }

 private:
  const uint8_t* in_;
  size_t len_;
  size_t pos_ = 0;
};

}  // namespace

extern "C" {

// Encode n symbols (each in [0, n_sym)) with the given frequency table
// (freqs[i] >= 1 required for any symbol that occurs; sum(freqs) <= 1<<16).
// Returns the number of BYTES written, or -1 if out_cap is too small.
long long rc_encode(const int32_t* symbols, long long n,
                    const uint32_t* freqs, int n_sym,
                    uint8_t* out, long long out_cap) {
  std::vector<uint64_t> cum(n_sym + 1, 0);
  for (int i = 0; i < n_sym; ++i) cum[i + 1] = cum[i] + freqs[i];
  const uint64_t total = cum[n_sym];
  if (total == 0 || total > (1u << 16)) return -1;

  std::memset(out, 0, (size_t)out_cap);
  BitWriter bw(out, (size_t)out_cap);
  uint32_t low = 0, high = kTop;
  uint64_t pending = 0;

  auto emit = [&](int bit) -> bool {
    if (!bw.put(bit)) return false;
    while (pending) {
      if (!bw.put(!bit)) return false;
      --pending;
    }
    return true;
  };

  for (long long k = 0; k < n; ++k) {
    const int s = symbols[k];
    if (s < 0 || s >= n_sym || freqs[s] == 0) return -2;
    const uint64_t span = (uint64_t)(high - low) + 1;
    high = low + (uint32_t)(span * cum[s + 1] / total) - 1;
    low = low + (uint32_t)(span * cum[s] / total);
    for (;;) {
      if (high < kHalf) {
        if (!emit(0)) return -1;
      } else if (low >= kHalf) {
        if (!emit(1)) return -1;
        low -= kHalf;
        high -= kHalf;
      } else if (low >= kQuarter && high < kThreeQuarter) {
        ++pending;
        low -= kQuarter;
        high -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
    }
  }
  // flush: one disambiguating bit + pending
  ++pending;
  if (low < kQuarter) {
    if (!emit(0)) return -1;
  } else {
    if (!emit(1)) return -1;
  }
  return (long long)((bw.bits() + 7) / 8);
}

// Decode n symbols; in_len is the byte length of the bitstream.
long long rc_decode(const uint8_t* in, long long in_len,
                    const uint32_t* freqs, int n_sym,
                    int32_t* out, long long n) {
  std::vector<uint64_t> cum(n_sym + 1, 0);
  for (int i = 0; i < n_sym; ++i) cum[i + 1] = cum[i] + freqs[i];
  const uint64_t total = cum[n_sym];
  if (total == 0 || total > (1u << 16)) return -1;

  BitReader br(in, (size_t)in_len);
  uint32_t low = 0, high = kTop, value = 0;
  for (int i = 0; i < 32; ++i) value = (value << 1) | (uint32_t)br.get();

  for (long long k = 0; k < n; ++k) {
    const uint64_t span = (uint64_t)(high - low) + 1;
    // scaled value in [0, total)
    const uint64_t scaled = (((uint64_t)(value - low) + 1) * total - 1) / span;
    // binary search for symbol with cum[s] <= scaled < cum[s+1]
    int lo = 0, hi = n_sym - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (cum[mid + 1] <= scaled) lo = mid + 1;
      else hi = mid;
    }
    const int s = lo;
    out[k] = s;
    high = low + (uint32_t)(span * cum[s + 1] / total) - 1;
    low = low + (uint32_t)(span * cum[s] / total);
    for (;;) {
      if (high < kHalf) {
        // nothing
      } else if (low >= kHalf) {
        low -= kHalf;
        high -= kHalf;
        value -= kHalf;
      } else if (low >= kQuarter && high < kThreeQuarter) {
        low -= kQuarter;
        high -= kQuarter;
        value -= kQuarter;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) | 1;
      value = (value << 1) | (uint32_t)br.get();
    }
  }
  return n;
}

}  // extern "C"
