// TFRecord framing for the port's data stack: CRC32-C (Castagnoli) and
// record indexing/framing, bound with ctypes by data/tfrecord.py.
//
// The TFRecord container format (public): each record is
//   uint64  length            (little-endian)
//   uint32  masked_crc32c(length bytes)
//   bytes   data[length]
//   uint32  masked_crc32c(data)
// with mask(crc) = ((crc >> 15) | (crc << 17)) + 0xa282ead8.
//
// The port's own copy of the JAX package's native TFRecord codec (same C
// ABI and semantics); data/native.py builds it with g++ at first use.
// CRC32-C is slicing-by-8 in portable C++ (no SSE4.2 dependency).

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    const uint32_t poly = 0x82f63b78u;  // reversed Castagnoli polynomial
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int j = 0; j < 8; ++j) {
        crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
      }
      t[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = t[0][i];
      for (int s = 1; s < 8; ++s) {
        crc = t[0][crc & 0xff] ^ (crc >> 8);
        t[s][i] = crc;
      }
    }
  }
};

// C++11 magic static: thread-safe one-time init (ctypes calls arrive from
// multiple Python prefetch threads with the GIL released).
const CrcTables& Tables() {
  static const CrcTables tables;
  return tables;
}
#define kTable Tables().t

inline uint32_t Crc32cUpdate(uint32_t crc, const uint8_t* data, size_t n) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    word ^= crc;  // little-endian assumed (x86/ARM hosts)
    crc = kTable[7][word & 0xff] ^ kTable[6][(word >> 8) & 0xff] ^
          kTable[5][(word >> 16) & 0xff] ^ kTable[4][(word >> 24) & 0xff] ^
          kTable[3][(word >> 32) & 0xff] ^ kTable[2][(word >> 40) & 0xff] ^
          kTable[1][(word >> 48) & 0xff] ^ kTable[0][(word >> 56) & 0xff];
    data += 8;
    n -= 8;
  }
  while (n--) {
    crc = kTable[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  }
  return ~crc;
}

inline uint32_t Mask(uint32_t crc) {
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

inline uint32_t ReadU32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t ReadU64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

}  // namespace

extern "C" {

uint32_t t2r_crc32c(const uint8_t* data, size_t n) {
  (void)Tables();
  return Crc32cUpdate(0, data, n);
}

uint32_t t2r_masked_crc32c(const uint8_t* data, size_t n) {
  (void)Tables();
  return Mask(Crc32cUpdate(0, data, n));
}

// Scans a TFRecord buffer, writing each record's payload offset and length.
// Returns the record count, or -(byte_position+1) on corruption so Python can
// report where the file went bad. verify_crc=0 skips payload CRC checks
// (header CRC is always checked — it guards the framing).
int64_t t2r_index_records(const uint8_t* buf, size_t n, uint64_t* offsets,
                          uint64_t* lengths, size_t max_records,
                          int verify_crc) {
  (void)Tables();
  size_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    if (pos + 12 > n) return -(int64_t)(pos + 1);
    uint64_t len = ReadU64(buf + pos);
    uint32_t len_crc = ReadU32(buf + pos + 8);
    if (Mask(Crc32cUpdate(0, buf + pos, 8)) != len_crc) {
      return -(int64_t)(pos + 1);
    }
    // Overflow-safe bounds check: a corrupt length near 2^64 must report
    // corruption, not wrap around and read out of bounds.
    size_t remaining = n - (pos + 12);
    if (remaining < 4 || len > remaining - 4) return -(int64_t)(pos + 1);
    if (verify_crc) {
      uint32_t data_crc = ReadU32(buf + pos + 12 + len);
      if (Mask(Crc32cUpdate(0, buf + pos + 12, len)) != data_crc) {
        return -(int64_t)(pos + 1);
      }
    }
    if ((size_t)count < max_records) {
      offsets[count] = pos + 12;
      lengths[count] = len;
    }
    ++count;
    pos += 12 + len + 4;
  }
  return count;
}

// Like t2r_index_records, but for STREAMING use over a block buffer that
// may end mid-record: a trailing incomplete record is not an error.
// Scans complete records only, stops at max_records or the first
// incomplete tail, and reports via *consumed how many leading bytes of
// buf were fully indexed (the caller slides its window by that amount and
// reads more). Corruption inside a complete record (bad header or payload
// CRC) still returns -(byte_position+1). Note a corrupt length field that
// claims more bytes than the buffer holds is indistinguishable from an
// incomplete tail here; the Python caller bounds that case (implausible
// lengths, leftover bytes at EOF) and reports corruption itself.
int64_t t2r_index_records_partial(const uint8_t* buf, size_t n,
                                  uint64_t* offsets, uint64_t* lengths,
                                  size_t max_records, int verify_crc,
                                  uint64_t* consumed) {
  (void)Tables();
  size_t pos = 0;
  int64_t count = 0;
  while (pos < n && (size_t)count < max_records) {
    if (pos + 12 > n) break;  // incomplete header
    uint64_t len = ReadU64(buf + pos);
    uint32_t len_crc = ReadU32(buf + pos + 8);
    if (Mask(Crc32cUpdate(0, buf + pos, 8)) != len_crc) {
      return -(int64_t)(pos + 1);
    }
    size_t remaining = n - (pos + 12);
    if (remaining < 4 || len > remaining - 4) break;  // incomplete payload
    if (verify_crc) {
      uint32_t data_crc = ReadU32(buf + pos + 12 + len);
      if (Mask(Crc32cUpdate(0, buf + pos + 12, len)) != data_crc) {
        return -(int64_t)(pos + 1);
      }
    }
    offsets[count] = pos + 12;
    lengths[count] = len;
    ++count;
    pos += 12 + len + 4;
  }
  *consumed = pos;
  return count;
}

// Frames a single record into out (which must hold 16 + len bytes).
// Returns the framed size.
size_t t2r_frame_record(const uint8_t* data, size_t len, uint8_t* out) {
  (void)Tables();
  uint64_t len64 = len;
  std::memcpy(out, &len64, 8);
  uint32_t len_crc = Mask(Crc32cUpdate(0, out, 8));
  std::memcpy(out + 8, &len_crc, 4);
  std::memcpy(out + 12, data, len);
  uint32_t data_crc = Mask(Crc32cUpdate(0, data, len));
  std::memcpy(out + 12 + len, &data_crc, 4);
  return 16 + len;
}

}  // extern "C"
