// CRC-32C (Castagnoli) for the snappy framing layer of the port's storage
// (grandine_tpu_torch/spec_tests/snappy.py): every database put checksums
// its value, so a byte-at-a-time Python loop would tax every slasher
// flush (9.5 ms a 32 KiB span chunk in Python against ~0.04 ms here).
//
// The port's own copy of the CRC part of grandine_tpu/native/src/
// gtnative.cpp: SSE4.2 has the polynomial in hardware (the crc32
// instruction); the portable path is a table-driven fallback built on
// first use. Built with g++ by grandine_tpu_torch/native/__init__.py and
// loaded with ctypes.
//
// Exported C ABI:
//   gt_crc32c(data, len) -> the CRC-32C of data[0:len]
//   gt_crc32c_hw()       -> 1 if the SSE4.2 instruction is used, else 0

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <cpuid.h>
#include <immintrin.h>
#define GT_X86 1
#endif

namespace {
uint32_t CRC_TABLE[256];
bool g_crc_table_built = false;

void build_crc_table() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int j = 0; j < 8; j++)
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    CRC_TABLE[i] = crc;
  }
  g_crc_table_built = true;
}

uint32_t crc32c_portable(uint32_t crc, const uint8_t* p, uint64_t len) {
  for (uint64_t i = 0; i < len; i++)
    crc = CRC_TABLE[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return crc;
}

#ifdef GT_X86
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, uint64_t len) {
  uint64_t c = crc;
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    len -= 8;
  }
  uint32_t c32 = (uint32_t)c;
  while (len--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool have_sse42() {
  unsigned a, b, c, d;
  return __get_cpuid(1, &a, &b, &c, &d) && (c & (1u << 20));
}
#endif
}  // namespace

extern "C" {

int gt_crc32c_hw(void) {
#ifdef GT_X86
  return have_sse42() ? 1 : 0;
#else
  return 0;
#endif
}

uint32_t gt_crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
#ifdef GT_X86
  static const bool hw = have_sse42();
  if (hw) return crc32c_hw(crc, data, len) ^ 0xFFFFFFFFu;
#endif
  if (!g_crc_table_built) build_crc_table();
  return crc32c_portable(crc, data, len) ^ 0xFFFFFFFFu;
}

}  // extern "C"
