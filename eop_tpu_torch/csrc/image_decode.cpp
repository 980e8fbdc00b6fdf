// Baseline JPEG and PNG pixel decoding for the host, without an image
// library: the port's counterpart of what cv2.imread / cv2.imdecode with
// IMREAD_COLOR return (BGR uint8 [H, W, 3]).
//
// JPEG: SOF0/SOF1 8-bit Huffman frames, one interleaved scan or a sequence
// of non-interleaved ones, restart intervals, 1 or 3 components with every
// sampling factor 1 or 2.  The pixel pipeline is libjpeg's default one:
// jidctint.c's ISLOW IDCT (CONST_BITS 13, PASS1_BITS 2, its post-IDCT range
// table), jdsample.c's fancy (triangle) upsampling with its rounding biases
// and edge replication, and jdcolor.c's fixed-point YCbCr -> RGB tables
// (SCALEBITS 16), written as BGR.  Progressive, lossless, hierarchical,
// arithmetic-coded and 12-bit frames, and 4-component files, return their own
// error code.  Where libjpeg pads truncated entropy data with zeros and
// warns, this returns JPEG_TRUNCATED.  EXIF orientation is the caller's: the
// header pass reports where the first APP1 segment is.
//
// PNG: the per-row unfilter (None, Sub, Up, Average, Paeth), Adam7, and the
// expansion of every colour type and bit depth to BGR uint8 as OpenCV asks
// libpng for it (alpha stripped, gray replicated, 16-bit samples stripped to
// their high byte, 1/2/4-bit gray scaled to 8 bits).  The caller inflates
// the IDAT stream.
//
// Every entry point writes into a buffer the caller allocates and keeps no
// global state, so concurrent calls are safe.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

enum Status {
  OK = 0,
  NOT_JPEG = 1,
  JPEG_CORRUPT = 2,
  JPEG_TRUNCATED = 3,
  JPEG_PROGRESSIVE = 4,
  JPEG_LOSSLESS = 5,
  JPEG_ARITHMETIC = 6,
  JPEG_HIERARCHICAL = 7,
  JPEG_PRECISION = 8,
  JPEG_COMPONENTS = 9,
  JPEG_SAMPLING = 10,
  JPEG_BAD_HUFFMAN = 11,
  JPEG_MISSING_TABLE = 12,
  SIZE_MISMATCH = 13,
  OUT_OF_MEMORY = 14,
  PNG_BAD_FILTER = 20,
  PNG_SHORT_DATA = 21,
  PNG_BAD_PALETTE_INDEX = 22,
  PNG_BAD_HEADER = 23,
};

// zigzag index -> natural index, with libjpeg's 16 extra entries that keep a
// corrupt run length inside the block
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// ---------------------------------------------------------------------------
// ISLOW inverse DCT (jidctint.c)

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// libjpeg's post-IDCT range table, indexed by (value & 1023): value + 128
// clamped to 0..255 for values in [-512, 511], wrapping beyond
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = uint8_t(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = uint8_t(i - 896);
    }
  }
};
const RangeLimit kRange;

// One 8x8 block: coefficients in natural order, dequantized with the int16
// multipliers libjpeg keeps, written to out (row stride `stride`).
void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = int(in[0]) * int(q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16];
    int64_t z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = int(descale(tmp10 + tmp3, s));
    ws[7 * 8 + c] = int(descale(tmp10 - tmp3, s));
    ws[1 * 8 + c] = int(descale(tmp11 + tmp2, s));
    ws[6 * 8 + c] = int(descale(tmp11 - tmp2, s));
    ws[2 * 8 + c] = int(descale(tmp12 + tmp1, s));
    ws[5 * 8 + c] = int(descale(tmp12 - tmp1, s));
    ws[3 * 8 + c] = int(descale(tmp13 + tmp0, s));
    ws[4 * 8 + c] = int(descale(tmp13 - tmp0, s));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = kRange.t[int(descale(w[0], kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits + kPass1Bits + 3;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, s)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, s)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, s)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, s)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, s)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, s)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, s)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, s)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Huffman decoding (jdhuff.c's derived tables, plus a 9-bit lookup)

constexpr int kFastBits = 9;
constexpr int kAcBits = 11;

// An AC symbol and its extra bits resolved from the next kAcBits bits: the
// run, the coefficient (0 for EOB / ZRL) and the bits both take (0: the
// code and its extra bits are longer, decode them one by one).
struct AcFast {
  int16_t value;
  uint8_t run;
  uint8_t len;
};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t fast_len[1 << kFastBits];  // 0: code longer than kFastBits
  uint8_t fast_val[1 << kFastBits];
  AcFast ac[1 << kAcBits];
};

// bits[1..16] = code counts by length; returns false for an invalid table
bool build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals,
                   int count) {
  int sizes[257];
  int codes[256];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) sizes[p++] = l;
  sizes[p] = 0;
  int code = 0, si = sizes[0];
  p = 0;
  while (sizes[p]) {
    while (sizes[p] == si) codes[p++] = code++;
    if (code >= (1 << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      h.valoffset[l] = p - codes[p];
      p += bits[l];
      h.maxcode[l] = codes[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0xFFFFF;
  std::memcpy(h.vals, vals, count);
  std::memset(h.fast_len, 0, sizeof h.fast_len);
  p = 0;
  for (int l = 1; l <= kFastBits; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      int lo = codes[p] << (kFastBits - l);
      for (int j = 0; j < (1 << (kFastBits - l)); j++) {
        h.fast_len[lo + j] = uint8_t(l);
        h.fast_val[lo + j] = vals[p];
      }
    }
  }
  std::memset(h.ac, 0, sizeof h.ac);
  p = 0;
  for (int l = 1; l <= kAcBits; l++) {
    for (int i = 0; i < bits[l]; i++, p++) {
      const int run = vals[p] >> 4, size = vals[p] & 15;
      if (l + size > kAcBits) continue;
      const int rest = kAcBits - l - size;
      for (int e = 0; e < (1 << size); e++) {
        int v = e;
        if (size && v < (1 << (size - 1))) v += 1 - (1 << size);
        const AcFast f = {int16_t(v), uint8_t(run), uint8_t(l + size)};
        const int lo = ((codes[p] << size) | e) << rest;
        for (int j = 0; j < (1 << rest); j++) h.ac[lo + j] = f;
      }
    }
  }
  h.defined = true;
  return true;
}

// MSB-first bit reader over entropy-coded data.  At a marker or the end of
// the data it shifts in zero bits, as libjpeg does, but counts them: a
// decode that consumes one of them is truncated data.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int n = 0;     // valid bits at the top of acc
  int fake = 0;  // of which the last `fake` are padding
  bool at_marker = false;
  const uint8_t* marker = nullptr;  // the 0xFF that starts it

  Bits(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      bool real = false;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
          real = true;
        } else {
          // 0xFF (0xFF fill)* 0x00 is a stuffed 0xFF; anything else a marker
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q < end && *q == 0x00) {
            byte = 0xFF;
            p = q + 1;
            real = true;
          } else {
            at_marker = true;
            marker = q - 1;
          }
        }
      }
      if (!real) fake += 8;
      acc |= uint64_t(byte) << (56 - n);
      n += 8;
    }
  }

  // consume k bits (k <= 16 after fill); false when one was padding
  bool take(int k) {
    if (k > n - fake) return false;
    acc <<= k;
    n -= k;
    return true;
  }

  // drop what is left of the current byte run (before a restart marker)
  void reset() {
    acc = 0;
    n = 0;
    fake = 0;
  }
};

// one Huffman symbol, or -1 (bad code) / -2 (truncated)
inline int decode_symbol(Bits& b, const Huffman& h) {
  if (b.n < 32) b.fill();
  int look = int(b.acc >> (64 - kFastBits));
  int l = h.fast_len[look];
  if (l) {
    if (!b.take(l)) return -2;
    return h.fast_val[look];
  }
  for (l = kFastBits + 1; l <= 16; l++) {
    int32_t code = int32_t(b.acc >> (64 - l));
    if (code <= h.maxcode[l]) {
      if (!b.take(l)) return -2;
      return h.vals[(code + h.valoffset[l]) & 0xFF];
    }
  }
  return -1;
}

// s extra bits as a signed value (jdhuff.c HUFF_EXTEND); false if truncated
inline bool receive_extend(Bits& b, int s, int& v) {
  if (s == 0) {
    v = 0;
    return true;
  }
  if (b.n < 32) b.fill();
  int r = int(b.acc >> (64 - s));
  if (!b.take(s)) return false;
  v = r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  return true;
}

// ---------------------------------------------------------------------------
// JPEG

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled size (jdinput.c)
  int pw = 0, ph = 0;    // plane size, padded to whole MCUs
  std::vector<uint8_t> plane;
  int dc = 0, ac = 0;    // table selectors of the current scan
  int pred = 0;          // DC predictor
  bool decoded = false;
};

struct Jpeg {
  int16_t quant[4][64];  // natural order, as libjpeg's ISLOW_MULT_TYPE
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart = 0;
  bool frame = false;
  int sof = 0;
  int width = 0, height = 0;
  int ncomp = 0;
  Component comp[4];
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int exif_offset = -1, exif_length = 0;  // first APP1 payload
};

int sof_status(int marker) {
  switch (marker) {
    case 0xC0: case 0xC1: return OK;
    case 0xC2: return JPEG_PROGRESSIVE;
    case 0xC3: return JPEG_LOSSLESS;
    case 0xC5: case 0xC6: case 0xC7: return JPEG_HIERARCHICAL;
    default: return JPEG_ARITHMETIC;  // C9-CB, CD-CF
  }
}

bool is_sof(int m) {
  return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
}

// position after the next marker code from pos; returns the code, or -1
int next_marker(const uint8_t* d, size_t n, size_t& pos) {
  while (pos < n) {
    if (d[pos] != 0xFF) {
      pos++;
      continue;
    }
    size_t q = pos + 1;
    while (q < n && d[q] == 0xFF) q++;
    if (q >= n) break;
    pos = q + 1;
    if (d[q] != 0x00) return d[q];
  }
  pos = n;
  return -1;
}

int parse_sof(Jpeg& j, const uint8_t* s, int len) {
  if (len < 6) return JPEG_CORRUPT;
  int precision = s[0];
  j.height = be16(s + 1);
  j.width = be16(s + 3);
  j.ncomp = s[5];
  if (len < 6 + 3 * j.ncomp) return JPEG_CORRUPT;
  if (j.ncomp == 4) return JPEG_COMPONENTS;
  int status = sof_status(j.sof);
  if (status != OK) return status;
  if (precision != 8) return JPEG_PRECISION;
  if (j.ncomp != 1 && j.ncomp != 3) return JPEG_COMPONENTS;
  if (j.width <= 0 || j.height <= 0) return JPEG_CORRUPT;
  j.maxh = j.maxv = 1;
  for (int c = 0; c < j.ncomp; c++) {
    Component& k = j.comp[c];
    k.id = s[6 + 3 * c];
    k.h = s[7 + 3 * c] >> 4;
    k.v = s[7 + 3 * c] & 15;
    k.tq = s[8 + 3 * c];
    if (k.h < 1 || k.h > 2 || k.v < 1 || k.v > 2) return JPEG_SAMPLING;
    if (k.tq > 3) return JPEG_CORRUPT;
    j.maxh = std::max(j.maxh, k.h);
    j.maxv = std::max(j.maxv, k.v);
  }
  j.mcux = (j.width + 8 * j.maxh - 1) / (8 * j.maxh);
  j.mcuy = (j.height + 8 * j.maxv - 1) / (8 * j.maxv);
  for (int c = 0; c < j.ncomp; c++) {
    Component& k = j.comp[c];
    k.dw = (j.width * k.h + j.maxh - 1) / j.maxh;
    k.dh = (j.height * k.v + j.maxv - 1) / j.maxv;
    k.pw = j.mcux * k.h * 8;
    k.ph = j.mcuy * k.v * 8;
  }
  j.frame = true;
  return OK;
}

int parse_dqt(Jpeg& j, const uint8_t* s, int len) {
  int at = 0;
  while (at < len) {
    int pq = s[at] >> 4, tq = s[at] & 15;
    at++;
    if (tq > 3 || pq > 1 || at + 64 * (pq + 1) > len) return JPEG_CORRUPT;
    for (int k = 0; k < 64; k++) {
      int v = pq ? be16(s + at + 2 * k) : s[at + k];
      j.quant[tq][kNaturalOrder[k]] = int16_t(v);
    }
    at += 64 * (pq + 1);
    j.quant_defined[tq] = true;
  }
  return OK;
}

int parse_dht(Jpeg& j, const uint8_t* s, int len) {
  int at = 0;
  while (at < len) {
    if (at + 17 > len) return JPEG_CORRUPT;
    int tc = s[at] >> 4, th = s[at] & 15;
    if (tc > 1 || th > 3) return JPEG_CORRUPT;
    uint8_t bits[17];
    bits[0] = 0;
    int count = 0;
    for (int l = 1; l <= 16; l++) {
      bits[l] = s[at + l];
      count += bits[l];
    }
    at += 17;
    if (count > 256 || at + count > len) return JPEG_CORRUPT;
    Huffman& h = tc ? j.ac[th] : j.dc[th];
    if (!build_huffman(h, bits, s + at, count)) return JPEG_CORRUPT;
    at += count;
  }
  return OK;
}

void parse_app(Jpeg& j, int marker, const uint8_t* s, int len, size_t off) {
  if (marker == 0xE0 && len >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) {
    j.jfif = true;
  } else if (marker == 0xE1 && j.exif_offset < 0) {
    j.exif_offset = int(off);
    j.exif_length = len;
  } else if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
    j.adobe = true;
    j.adobe_transform = s[11];
  }
}

// libjpeg's jpeg_color_space guess for 3 components: RGB or YCbCr
bool is_rgb(const Jpeg& j) {
  if (j.jfif) return false;
  if (j.adobe) return j.adobe_transform == 0;
  return j.comp[0].id == 'R' && j.comp[1].id == 'G' && j.comp[2].id == 'B';
}

int decode_block(Bits& b, Component& k, const Huffman& dc, const Huffman& ac,
                 const int16_t* quant, uint8_t* out) {
  int16_t coef[64];
  std::memset(coef, 0, sizeof coef);
  int s = decode_symbol(b, dc);
  if (s < 0) return s == -2 ? JPEG_TRUNCATED : JPEG_BAD_HUFFMAN;
  int diff;
  if (s > 16 || !receive_extend(b, s, diff)) return JPEG_TRUNCATED;
  k.pred += diff;
  coef[0] = int16_t(k.pred);
  for (int i = 1; i < 64; i++) {
    if (b.n < 32) b.fill();
    const AcFast& f = ac.ac[b.acc >> (64 - kAcBits)];
    if (f.len) {
      if (!b.take(f.len)) return JPEG_TRUNCATED;
      if (f.value) {
        i += f.run;
        coef[kNaturalOrder[std::min(i, 79)]] = f.value;
      } else if (f.run == 15) {
        i += 15;
      } else {
        break;
      }
      continue;
    }
    int rs = decode_symbol(b, ac);
    if (rs < 0) return rs == -2 ? JPEG_TRUNCATED : JPEG_BAD_HUFFMAN;
    int r = rs >> 4, z = rs & 15;
    if (z) {
      i += r;
      int v;
      if (!receive_extend(b, z, v)) return JPEG_TRUNCATED;
      coef[kNaturalOrder[std::min(i, 79)]] = int16_t(v);
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
  idct_islow(coef, quant, out, k.pw);
  return OK;
}

int decode_scan(Jpeg& j, const uint8_t* d, size_t n, size_t& pos,
                Component** scomp, int ns) {
  Bits b(d + pos, d + n);
  int total, per_row;
  if (ns == 1) {
    per_row = (scomp[0]->dw + 7) / 8;
    total = per_row * ((scomp[0]->dh + 7) / 8);
  } else {
    per_row = j.mcux;
    total = j.mcux * j.mcuy;
  }
  for (int c = 0; c < ns; c++) scomp[c]->pred = 0;
  int next_rst = 0;
  for (int m = 0; m < total; m++) {
    if (j.restart && m > 0 && m % j.restart == 0) {
      // the expected RSTn, then fresh predictors and bit buffer
      size_t at = b.at_marker ? size_t(b.marker - d) : size_t(b.p - d);
      int code = next_marker(d, n, at);
      if (code != 0xD0 + next_rst) return code < 0 ? JPEG_TRUNCATED
                                                   : JPEG_CORRUPT;
      next_rst = (next_rst + 1) & 7;
      b = Bits(d + at, d + n);
      for (int c = 0; c < ns; c++) scomp[c]->pred = 0;
    }
    int mx = m % per_row, my = m / per_row;
    for (int c = 0; c < ns; c++) {
      Component& k = *scomp[c];
      const Huffman& dc = j.dc[k.dc];
      const Huffman& ac = j.ac[k.ac];
      const int16_t* quant = j.quant[k.tq];
      int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
      for (int v = 0; v < bv; v++) {
        for (int h = 0; h < bh; h++) {
          int bx = mx * bh + h, by = my * bv + v;
          uint8_t* out = k.plane.data() + size_t(by) * 8 * k.pw + bx * 8;
          int st = decode_block(b, k, dc, ac, quant, out);
          if (st != OK) return st;
        }
      }
    }
  }
  for (int c = 0; c < ns; c++) scomp[c]->decoded = true;
  pos = b.at_marker ? size_t(b.marker - d) : size_t(b.p - d);
  return OK;
}

int parse_sos(Jpeg& j, const uint8_t* s, int len, Component** scomp,
              int& ns) {
  if (!j.frame || len < 1) return JPEG_CORRUPT;
  ns = s[0];
  if (ns < 1 || ns > j.ncomp || len < 4 + 2 * ns) return JPEG_CORRUPT;
  for (int i = 0; i < ns; i++) {
    int id = s[1 + 2 * i], tables = s[2 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; c++)
      if (j.comp[c].id == id) k = &j.comp[c];
    if (k == nullptr || k->decoded) return JPEG_CORRUPT;
    k->dc = tables >> 4;
    k->ac = tables & 15;
    if (k->dc > 3 || k->ac > 3) return JPEG_CORRUPT;
    if (!j.dc[k->dc].defined || !j.ac[k->ac].defined ||
        !j.quant_defined[k->tq])
      return JPEG_MISSING_TABLE;
    scomp[i] = k;
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahl != 0) return JPEG_CORRUPT;
  if (ns > 1) {
    int blocks = 0;
    for (int i = 0; i < ns; i++) blocks += scomp[i]->h * scomp[i]->v;
    if (blocks > 10) return JPEG_CORRUPT;
  }
  return OK;
}

// The header pass (to the first SOS) and, with `decode`, every scan.
int run_jpeg(Jpeg& j, const uint8_t* d, size_t n, bool decode) {
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return NOT_JPEG;
  size_t pos = 2;
  while (true) {
    int m = next_marker(d, n, pos);
    if (m < 0) break;  // no EOI: complete if every component was decoded
    if (m == 0xD9) break;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (pos + 2 > n) return JPEG_TRUNCATED;
    int len = be16(d + pos) - 2;
    if (len < 0 || pos + 2 + size_t(len) > n) return JPEG_TRUNCATED;
    const uint8_t* s = d + pos + 2;
    size_t seg = pos + 2;
    pos += 2 + len;
    int st = OK;
    if (is_sof(m)) {
      if (j.frame) return JPEG_CORRUPT;
      j.sof = m;
      st = parse_sof(j, s, len);
      if (!decode && j.frame) continue;
      if (!decode && st >= JPEG_PROGRESSIVE && st <= JPEG_SAMPLING &&
          j.width > 0 && j.height > 0) {
        j.frame = true;  // the size of a frame this does not decode
        continue;
      }
    } else if (m == 0xDB) {
      st = parse_dqt(j, s, len);
    } else if (m == 0xC4) {
      st = parse_dht(j, s, len);
    } else if (m == 0xDD) {
      if (len < 2) return JPEG_CORRUPT;
      j.restart = be16(s);
    } else if (m >= 0xE0 && m <= 0xEF) {
      parse_app(j, m, s, len, seg);
    } else if (m == 0xDA) {
      if (!decode) return j.frame ? OK : JPEG_CORRUPT;
      Component* scomp[4];
      int ns = 0;
      st = parse_sos(j, s, len, scomp, ns);
      if (st != OK) return st;
      for (int c = 0; c < j.ncomp; c++)
        if (j.comp[c].plane.empty())
          j.comp[c].plane.assign(size_t(j.comp[c].pw) * j.comp[c].ph, 0);
      st = decode_scan(j, d, n, pos, scomp, ns);
    } else if (m == 0xDC) {
      return JPEG_CORRUPT;  // DNL: height defined after the first scan
    }
    // COM, DAC and anything else: skipped
    if (st != OK) return st;
  }
  if (!j.frame) return JPEG_CORRUPT;
  // the header pass ends at the first SOS: data that ends before it holds
  // no image (libjpeg: "JPEG datastream contains no image")
  if (!decode) return JPEG_TRUNCATED;
  for (int c = 0; c < j.ncomp; c++)
    if (!j.comp[c].decoded) return JPEG_TRUNCATED;
  return OK;
}

// One output row of a horizontal 2x fancy upsample (jdsample.c): from the
// dw samples of `in` (column sums where vertical too), out[2i] = (3 in[i] +
// in[i-1] + b0) >> shift and out[2i+1] = (3 in[i] + in[i+1] + b1) >> shift,
// the edges replicated; W output samples.
inline void fancy_row(const int* in, int dw, int W, int b0, int b1,
                      int shift, uint8_t* o) {
  if (dw == 1) {
    o[0] = uint8_t((4 * in[0] + b0) >> shift);
    if (W > 1) o[1] = uint8_t((4 * in[0] + b1) >> shift);
    return;
  }
  o[0] = uint8_t((4 * in[0] + b0) >> shift);
  o[1] = uint8_t((3 * in[0] + in[1] + b1) >> shift);
  for (int i = 1; i < dw - 1; i++) {
    const int c = 3 * in[i];
    o[2 * i] = uint8_t((c + in[i - 1] + b0) >> shift);
    o[2 * i + 1] = uint8_t((c + in[i + 1] + b1) >> shift);
  }
  const int i = dw - 1;
  o[2 * i] = uint8_t((3 * in[i] + in[i - 1] + b0) >> shift);
  if (2 * i + 1 < W) o[2 * i + 1] = uint8_t((4 * in[i] + b1) >> shift);
}

// A component's plane upsampled to the image size as jdsample.c does it
// (fancy where libjpeg is fancy; edges replicate the last real sample).
// Returns the rows to read: the plane itself where no upsampling is needed.
const uint8_t* upsample(const Component& k, int rh, int rv, int W, int H,
                        std::vector<uint8_t>& buf, int& stride) {
  const uint8_t* p = k.plane.data();
  const int pw = k.pw, dw = k.dw, dh = k.dh;
  if (rh == 1 && rv == 1) {
    stride = pw;
    return p;
  }
  buf.resize(size_t(W) * H);
  stride = W;
  uint8_t* dst = buf.data();
  const bool fancy_h = dw > 2;  // jdsample.c: narrow components replicate
  std::vector<int> row(dw);
  for (int y = 0; y < H; y++) {
    const int jr = rv == 2 ? y >> 1 : y;
    const uint8_t* r0 = p + size_t(jr) * pw;
    uint8_t* o = dst + size_t(y) * W;
    if (rh == 2 && !fancy_h) {
      for (int x = 0; x < W; x++) o[x] = r0[x >> 1];
      continue;
    }
    if (rv == 1) {  // h2v1
      for (int i = 0; i < dw; i++) row[i] = r0[i];
      fancy_row(row.data(), dw, W, 1, 2, 2, o);
      continue;
    }
    const int jn = (y & 1) ? std::min(jr + 1, dh - 1) : std::max(jr - 1, 0);
    const uint8_t* r1 = p + size_t(jn) * pw;
    if (rh == 1) {  // h1v2
      const int bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < W; x++)
        o[x] = uint8_t((3 * r0[x] + r1[x] + bias) >> 2);
      continue;
    }
    for (int i = 0; i < dw; i++) row[i] = 3 * r0[i] + r1[i];  // h2v2
    fancy_row(row.data(), dw, W, 8, 7, 4, o);
  }
  return dst;
}

// jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
    auto fix = [](double v) { return int32_t(v * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void to_bgr(const Jpeg& j, uint8_t* out) {
  const int W = j.width, H = j.height;
  std::vector<uint8_t> buf[3];
  const uint8_t* plane[3];
  int stride[3];
  for (int c = 0; c < j.ncomp; c++)
    plane[c] = upsample(j.comp[c], j.maxh / j.comp[c].h, j.maxv / j.comp[c].v,
                        W, H, buf[c], stride[c]);
  const bool rgb = j.ncomp == 3 && is_rgb(j);
  for (int y = 0; y < H; y++) {
    uint8_t* o = out + size_t(y) * W * 3;
    const uint8_t* c0 = plane[0] + size_t(y) * stride[0];
    if (j.ncomp == 1) {
      for (int x = 0; x < W; x++)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = c0[x];
      continue;
    }
    const uint8_t* c1 = plane[1] + size_t(y) * stride[1];
    const uint8_t* c2 = plane[2] + size_t(y) * stride[2];
    if (rgb) {
      for (int x = 0; x < W; x++) {
        o[3 * x] = c2[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c0[x];
      }
      continue;
    }
    for (int x = 0; x < W; x++) {
      const int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x + 2] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

// ---------------------------------------------------------------------------
// PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// row filter in place: cur holds the filtered bytes on entry
bool unfilter_row(int type, uint8_t* cur, const uint8_t* prev, size_t len,
                  int bpp) {
  switch (type) {
    case 0: return true;
    case 1:
      for (size_t i = bpp; i < len; i++)
        cur[i] = uint8_t(cur[i] + cur[i - bpp]);
      return true;
    case 2:
      for (size_t i = 0; i < len; i++) cur[i] = uint8_t(cur[i] + prev[i]);
      return true;
    case 3:
      for (size_t i = 0; i < len; i++) {
        int left = i >= size_t(bpp) ? cur[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + ((left + prev[i]) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < len; i++) {
        int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
        int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        cur[i] = uint8_t(cur[i] + paeth(a, prev[i], c));
      }
      return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

// Header pass of a JPEG: info = {width, height, offset of the first APP1
// payload or -1, its length}.  Reads the size of frames it does not decode
// too (progressive, arithmetic, ...).
int jpeg_info(const uint8_t* data, size_t n, int32_t* info) {
  Jpeg j;
  int st = run_jpeg(j, data, n, false);  // allocates nothing
  if (st != OK) return st;
  info[0] = j.width;
  info[1] = j.height;
  info[2] = j.exif_offset;
  info[3] = j.exif_length;
  return OK;
}

// Decode a baseline JPEG to BGR uint8 [height, width, 3] (EXIF orientation
// not applied).
int jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, int32_t width,
                int32_t height) {
  try {  // no C++ exception may cross the C interface
    Jpeg j;
    int st = run_jpeg(j, data, n, true);
    if (st != OK) return st;
    if (j.width != width || j.height != height) return SIZE_MISMATCH;
    to_bgr(j, out);
    return OK;
  } catch (const std::bad_alloc&) {
    return OUT_OF_MEMORY;
  }
}

// Unfilter the inflated IDAT stream of a PNG (Adam7 where `interlace`) and
// expand it to BGR uint8 [height, width, 3]; `palette` holds `entries` RGB
// triples for colour type 3.
int png_decode(const uint8_t* raw, size_t n, int32_t width, int32_t height,
               int32_t depth, int32_t color_type, int32_t interlace,
               const uint8_t* palette, int32_t entries, uint8_t* out) try {
  int channels;
  switch (color_type) {
    case 0: case 3: channels = 1; break;
    case 2: channels = 3; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return PNG_BAD_HEADER;
  }
  const int bits = channels * depth;
  const int bpp = std::max(1, bits / 8);
  static const int kPasses[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                    {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                    {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = interlace ? kPasses : kWhole;
  const int npasses = interlace ? 7 : 1;
  // 1/2/4-bit gray scaled to 8 bits (libpng's expand_gray_1_2_4_to_8)
  const int gray_scale =
      depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  size_t at = 0;
  std::vector<uint8_t> prev, cur;
  for (int p = 0; p < npasses; p++) {
    const int x0 = passes[p][0], y0 = passes[p][1];
    const int dx = passes[p][2], dy = passes[p][3];
    if (width <= x0 || height <= y0) continue;
    const int pw = (width - x0 + dx - 1) / dx;
    const int ph = (height - y0 + dy - 1) / dy;
    const size_t rowbytes = (size_t(pw) * bits + 7) / 8;
    prev.assign(rowbytes, 0);
    cur.resize(rowbytes);
    for (int r = 0; r < ph; r++) {
      if (at + 1 + rowbytes > n) return PNG_SHORT_DATA;
      int type = raw[at];
      std::memcpy(cur.data(), raw + at + 1, rowbytes);
      at += 1 + rowbytes;
      if (!unfilter_row(type, cur.data(), prev.data(), rowbytes, bpp))
        return PNG_BAD_FILTER;
      uint8_t* orow = out + (size_t(y0) + size_t(r) * dy) * width * 3;
      const uint8_t* c = cur.data();
      for (int i = 0; i < pw; i++) {
        uint8_t* o = orow + (size_t(x0) + size_t(i) * dx) * 3;
        int s0, s1, s2;
        if (depth < 8) {
          int bit = i * depth;
          int v = (c[bit >> 3] >> (8 - depth - (bit & 7))) &
                  ((1 << depth) - 1);
          if (color_type == 3) {
            if (v >= entries) return PNG_BAD_PALETTE_INDEX;
            s0 = palette[3 * v];
            s1 = palette[3 * v + 1];
            s2 = palette[3 * v + 2];
          } else {
            s0 = s1 = s2 = v * gray_scale;
          }
        } else {
          // 16-bit samples keep their high (first) byte
          const int step = depth / 8;
          const uint8_t* px = c + size_t(i) * channels * step;
          if (color_type == 3) {
            int v = px[0];
            if (v >= entries) return PNG_BAD_PALETTE_INDEX;
            s0 = palette[3 * v];
            s1 = palette[3 * v + 1];
            s2 = palette[3 * v + 2];
          } else if (channels <= 2) {
            s0 = s1 = s2 = px[0];
          } else {
            s0 = px[0];
            s1 = px[step];
            s2 = px[2 * step];
          }
        }
        o[0] = uint8_t(s2);
        o[1] = uint8_t(s1);
        o[2] = uint8_t(s0);
      }
      std::swap(prev, cur);
      cur.resize(rowbytes);
    }
  }
  return OK;
} catch (const std::bad_alloc&) {  // no C++ exception may cross the C interface
  return OUT_OF_MEMORY;
}

}  // extern "C"
