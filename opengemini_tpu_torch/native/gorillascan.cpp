// Structural scan of one gorilla XOR stream: the host half of the device
// decode (ops/device_decode.py _gorilla_scan). The control bits are
// sequential, so the host walks them once per block and emits the
// per-value vectors the data-parallel decode on the card needs:
//   bitpos[i]  the bit where value i's meaningful bits start
//   mbits[i]   their count (0: a repeat of the previous value)
//   shift[i]   their trailing-zero shift
//   vals[i]    the decoded 64-bit pattern (the running XOR)
// Value 0 is the raw first word (mbits 64, shift 0).
//
// The walk and its bounds checks are the JAX package's
// (opengemini_tpu/ops/device_decode.py _gorilla_scan): a stream that ends
// early or carries an impossible header is malformed, and the scan
// answers -1 (the caller then leaves the block to the host decoder).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 gorillascan.cpp (the port's
// native/__init__.py does this at first use).
#include <cstdint>

namespace {

// k (1..64) bits of the big-endian bit stream from bit `pos`, zero past
// the end (never read there: the caller checks the bounds first).
inline uint64_t read_bits(const uint8_t* p, int64_t nbytes, int64_t pos,
                          int k) {
  const int64_t j = pos >> 3;
  const int o = static_cast<int>(pos & 7);
  unsigned __int128 w = 0;
  for (int b = 0; b < 9; ++b) {
    w <<= 8;
    if (j + b < nbytes) w |= p[j + b];
  }
  const uint64_t mask = k == 64 ? ~0ULL : ((1ULL << k) - 1);
  return static_cast<uint64_t>(w >> (72 - o - k)) & mask;
}

}  // namespace

extern "C" int64_t ogt_gorilla_scan(const uint8_t* payload, int64_t nbytes,
                                    int64_t n, int32_t* bitpos,
                                    uint8_t* mbits, uint8_t* shift,
                                    uint64_t* vals) {
  if (n <= 0) return 0;
  const int64_t nbits = nbytes * 8;
  if (nbits < 64) return -1;
  uint64_t acc = read_bits(payload, nbytes, 0, 64);
  bitpos[0] = 0;
  mbits[0] = 64;
  shift[0] = 0;
  vals[0] = acc;
  int64_t pos = 64;
  int64_t lz = 0, tz = 0;
  for (int64_t i = 1; i < n; ++i) {
    bitpos[i] = 0;
    mbits[i] = 0;
    shift[i] = 0;
    if (pos + 1 > nbits) return -1;
    if (!read_bits(payload, nbytes, pos, 1)) {
      vals[i] = acc;  // a repeat: xor 0
      pos += 1;
      continue;
    }
    if (pos + 2 > nbits) return -1;
    int64_t head = 2;
    if (read_bits(payload, nbytes, pos + 1, 1)) {
      if (pos + 13 > nbits) return -1;
      lz = static_cast<int64_t>(read_bits(payload, nbytes, pos + 2, 5));
      const int64_t sig =
          static_cast<int64_t>(read_bits(payload, nbytes, pos + 7, 6));
      tz = 64 - lz - sig - 1;
      if (tz < 0) return -1;
      head = 13;
    }
    const int64_t mb = 64 - lz - tz;
    if (mb <= 0 || pos + head + mb > nbits) return -1;
    bitpos[i] = static_cast<int32_t>(pos + head);
    mbits[i] = static_cast<uint8_t>(mb);
    shift[i] = static_cast<uint8_t>(tz);
    acc ^= read_bits(payload, nbytes, pos + head, static_cast<int>(mb)) << tz;
    vals[i] = acc;
    pos += head + mb;
  }
  return 0;
}
