// jpeg_codec — the port's own baseline JPEG decoder.
//
// The JAX package's native library decodes through libjpeg
// (attention_based_tbn_tpu/native/tbn_io.cpp). The port's library decodes
// with this file on every host, so that it needs no libjpeg headers, and it
// gives what libjpeg's default decode gives, to the bit:
//
//   * Huffman-coded sequential files (SOF0 / SOF1, 8-bit), 1 or 3 components
//     in one scan, any integral sampling factors (4:4:4, 4:2:2, 4:2:0, ...),
//     restart intervals;
//   * libjpeg's "islow" integer IDCT (jidctint.c) with its range limiting;
//   * fancy (triangle) upsampling of h2v1, h1v2 and h2v2 chroma (jdsample.c),
//     box replication for other factors and for rows of 2 samples or fewer;
//   * libjpeg's fixed-point YCbCr -> RGB tables (jdcolor.c); grayscale output
//     of a YCbCr file is its Y plane.
//
// A progressive, lossless, hierarchical, arithmetic-coded or multi-scan file
// is refused with its type named.

#include "jpeg_codec.h"

#include <algorithm>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace tbn_codec {
namespace {

struct Fail : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag index -> natural index; 16 extra entries catch a corrupt run past 63
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------ the IDCT

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: the value wraps at 10 bits (x & 1023 into
// its table), then clamps after adding the centre 128.
inline uint8_t idct_limit(int32_t x) {
  int32_t v = ((x + 512) & 1023) - 512 + 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jidctint.c jpeg_idct_islow: coef in natural order, q the quant table.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int32_t dc = (in[0] * static_cast<int32_t>(static_cast<int16_t>(qt[0]))) << kPass1Bits;
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    auto dq = [&](int r) {
      return static_cast<int32_t>(in[r * 8]) * static_cast<int16_t>(qt[r * 8]);
    };
    int32_t z2 = dq(2), z3 = dq(6);
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = dq(0);
    z3 = dq(4);
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = dq(7);
    tmp1 = dq(5);
    tmp2 = dq(3);
    tmp3 = dq(1);
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + static_cast<int64_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      std::memset(o, v, 8);
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// ------------------------------------------------------- Huffman decode

struct HuffTable {
  bool defined = false;
  int max_symbol = 0;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t look[512] = {};  // 9-bit lookahead: (length << 8) | symbol, 0 = slow path

  void derive() {  // jdhuff.c jpeg_make_d_derived_tbl
    int huffsize[257], huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        if (p >= 256) throw Fail("corrupt JPEG: bad Huffman table");
        huffsize[p++] = l;
      }
    }
    huffsize[p] = 0;
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) {
        huffcode[p++] = code;
        ++code;
      }
      if (code >= (1 << si)) throw Fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (9 - l);
        for (int ctr = 1 << (9 - l); ctr > 0; --ctr) {
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
        }
      }
    }
    defined = true;
  }
};

// Entropy-coded data: FF00 is a data FF; any other marker ends the data and
// the reader then feeds zero bits, as libjpeg does.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int count = 0;
  bool at_marker = false;

  void fill() {
    while (count <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p < end) {
        byte = *p;
        if (byte == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {
            p = q - 1;  // at the marker's last FF
            at_marker = true;
            byte = 0;
          }
        } else {
          ++p;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - count);
      count += 8;
    }
  }
  int peek(int n) {
    if (count < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    count -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    int look = peek(9);
    uint16_t e = t.look[look];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = get(1);
    int l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // corrupt data: libjpeg warns and returns 0
    }
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // At a restart boundary: drop the buffered bits, find the next marker and
  // require it to be RSTn.
  void restart(int expected) {
    if (!at_marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF)) ++p;
    }
    if (p + 1 >= end || p[1] != 0xD0 + expected) {
      throw Fail("corrupt JPEG: missing restart marker");
    }
    p += 2;
    buf = 0;
    count = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v + ((-1) * (1 << s)) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int blocks_w = 0, blocks_h = 0;  // the blocks that the scan codes
  int width = 0, height = 0;       // downsampled samples: ceil(W * h / hmax)
  std::vector<uint8_t> plane;      // blocks_w * 8 by blocks_h * 8 samples
};

struct Decoder {
  const uint8_t* end;
  const uint8_t* p;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool have_frame = false;
  std::vector<Component> comps;
  uint16_t qt[4][64] = {};
  bool qt_defined[4] = {};
  HuffTable dc[4], ac[4];

  Decoder(const uint8_t* data, int64_t size) : end(data + size), p(data) {}

  int u8() {
    if (p >= end) throw Fail("corrupt JPEG: unexpected end of data");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }
  int next_marker() {  // libjpeg skips garbage before a marker and FF fill bytes
    while (p < end && *p != 0xFF) ++p;
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) throw Fail("corrupt JPEG: no EOI marker");
    return *p++;
  }

  static const char* unsupported(int m) {
    switch (m) {
      case 0xC2: return "progressive JPEG (SOF2) is not supported";
      case 0xC3: return "lossless JPEG (SOF3) is not supported";
      case 0xC5: case 0xC6: case 0xC7: return "hierarchical JPEG (SOF5-7) is not supported";
      case 0xC9: return "arithmetic-coded JPEG (SOF9) is not supported";
      case 0xCA: return "arithmetic-coded progressive JPEG (SOF10) is not supported";
      case 0xCB: return "arithmetic-coded lossless JPEG (SOF11) is not supported";
      case 0xCD: case 0xCE: case 0xCF:
        return "arithmetic-coded hierarchical JPEG (SOF13-15) is not supported";
      case 0xCC: return "arithmetic-coded JPEG (DAC marker) is not supported";
      default: return nullptr;
    }
  }

  void read_frame() {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    int precision = u8();
    if (precision != 8) throw Fail("only 8-bit JPEG is supported");
    height = u16();
    width = u16();
    int n = u8();
    if (height <= 0 || width <= 0) throw Fail("corrupt JPEG: empty image");
    if (n != 1 && n != 3) throw Fail("only 1- or 3-component JPEG is supported");
    comps.assign(n, Component());
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) {
        throw Fail("corrupt JPEG: bad component parameters");
      }
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) throw Fail("non-integral sampling factors are not supported");
      c.width = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
    }
    p = seg_end;
    have_frame = true;
  }

  void read_dqt() {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    while (p < seg_end) {
      int pq_tq = u8();
      int tq = pq_tq & 15, pq = pq_tq >> 4;
      if (tq > 3) throw Fail("corrupt JPEG: bad DQT");
      for (int i = 0; i < 64; ++i) {
        qt[tq][kNaturalOrder[i]] = static_cast<uint16_t>(pq ? u16() : u8());
      }
      qt_defined[tq] = true;
    }
    p = seg_end;
  }

  void read_dht() {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    while (p < seg_end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (th > 3 || tc > 1) throw Fail("corrupt JPEG: bad DHT");
      HuffTable& t = tc ? ac[th] : dc[th];
      int count = 0;
      t.bits[0] = 0;
      for (int l = 1; l <= 16; ++l) {
        t.bits[l] = static_cast<uint8_t>(u8());
        count += t.bits[l];
      }
      if (count > 256) throw Fail("corrupt JPEG: bad DHT");
      std::memset(t.vals, 0, sizeof(t.vals));
      t.max_symbol = 0;
      for (int i = 0; i < count; ++i) {
        t.vals[i] = static_cast<uint8_t>(u8());
        t.max_symbol = std::max<int>(t.max_symbol, t.vals[i]);
      }
      t.derive();
    }
    p = seg_end;
  }

  void read_app(int marker) {
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    if (marker == 0xE0 && len >= 7 && !std::memcmp(p, "JFIF\0", 5)) saw_jfif = true;
    if (marker == 0xEE && len >= 14 && !std::memcmp(p, "Adobe", 5)) {
      saw_adobe = true;
      adobe_transform = p[11];
    }
    p = seg_end;
  }

  void skip_segment() {
    int len = u16();
    p += len - 2;
  }

  // One scan holding every component (libjpeg decodes multi-scan sequential
  // files too; the port's codec refuses them).
  void read_scan() {
    if (!have_frame) throw Fail("corrupt JPEG: SOS before SOF");
    int len = u16();
    const uint8_t* seg_end = p + len - 2;
    int ns = u8();
    if (ns != static_cast<int>(comps.size())) {
      throw Fail("multi-scan sequential JPEG is not supported");
    }
    std::vector<Component*> order;
    for (int i = 0; i < ns; ++i) {
      int cid = u8();
      int tables = u8();
      Component* c = nullptr;
      for (auto& k : comps) {
        if (k.id == cid) c = &k;
      }
      if (c == nullptr) throw Fail("corrupt JPEG: unknown component in SOS");
      c->td = tables >> 4;
      c->ta = tables & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined) {
        throw Fail("corrupt JPEG: Huffman table not defined");
      }
      // a DC symbol is a magnitude of at most 15 bits: libjpeg refuses the
      // table otherwise (jdhuff.c jpeg_make_d_derived_tbl)
      if (dc[c->td].max_symbol > 15) throw Fail("corrupt JPEG: bad DC magnitude in DHT");
      if (!qt_defined[c->tq]) throw Fail("corrupt JPEG: quantization table not defined");
      order.push_back(c);
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) throw Fail("corrupt JPEG: bad sequential scan");
    p = seg_end;

    int mcus_x, mcus_y;
    if (ns == 1) {  // non-interleaved: one block per MCU
      Component& c = *order[0];
      mcus_x = c.blocks_w = (c.width + 7) / 8;
      mcus_y = c.blocks_h = (c.height + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
      for (Component* c : order) {
        c->blocks_w = mcus_x * c->h;
        c->blocks_h = mcus_y * c->v;
      }
    }
    for (Component* c : order) {
      c->plane.assign(static_cast<size_t>(c->blocks_w) * 8 * c->blocks_h * 8, 0);
    }

    BitReader bits{p, end};
    int last_dc[3] = {0, 0, 0};
    int16_t block[64];
    int restarts = 0;
    const int64_t total = static_cast<int64_t>(mcus_x) * mcus_y;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        bits.restart(restarts & 7);
        ++restarts;
        last_dc[0] = last_dc[1] = last_dc[2] = 0;
      }
      const int mx = static_cast<int>(m % mcus_x), my = static_cast<int>(m / mcus_x);
      for (int ci = 0; ci < ns; ++ci) {
        Component& c = *order[ci];
        const int bh = ns == 1 ? 1 : c.v, bw = ns == 1 ? 1 : c.h;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            std::memset(block, 0, sizeof(block));
            int s = bits.decode(dc[c.td]);
            if (s) s = extend(bits.get(s), s);
            last_dc[ci] += s;
            block[0] = static_cast<int16_t>(last_dc[ci]);
            for (int k = 1; k < 64; ++k) {
              int rs = bits.decode(ac[c.ta]);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                block[kNaturalOrder[k]] = static_cast<int16_t>(extend(bits.get(s), s));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            const int row = my * bh + by, col = mx * bw + bx;
            const int stride = c.blocks_w * 8;
            idct_islow(block, qt[c.tq],
                       c.plane.data() + static_cast<int64_t>(row) * 8 * stride + col * 8, stride);
          }
        }
      }
    }
  }

  // The markers up to the frame header (header_only) or through the
  // first scan, which must hold every component.
  void parse(bool header_only) {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8) throw Fail("not a JPEG file (no SOI)");
    p += 2;
    while (true) {
      int m = next_marker();
      if (const char* why = unsupported(m)) throw Fail(why);
      if (m == 0xC0 || m == 0xC1) {
        read_frame();
        if (header_only) return;
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        u16();
        restart_interval = u16();
      } else if (m >= 0xE0 && m <= 0xEF) {
        read_app(m);
      } else if (m == 0xDA) {
        read_scan();
        return;
      } else if (m == 0xD9) {
        throw Fail("corrupt JPEG: EOI before any scan");
      } else if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) {
        continue;  // stand-alone markers
      } else {
        skip_segment();
      }
    }
  }

  bool is_rgb() const {  // jdapimin.c default_decompress_parms for 3 components
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66;
  }
};

// ------------------------------------------------------------ upsampling

// One component upsampled to the full image: row y of the result into out
// (width samples). Fancy upsampling for h2v1, h1v2 and h2v2 (jdsample.c).
struct Upsampler {
  const Component& c;
  int hr, vr;  // integral factors
  bool fancy_h2v1, fancy_h1v2, fancy_h2v2;
  std::vector<uint8_t> tmp;

  Upsampler(const Component& comp, int hmax, int vmax)
      : c(comp), hr(hmax / comp.h), vr(vmax / comp.v) {
    fancy_h2v1 = hr == 2 && vr == 1 && c.width > 2;
    fancy_h1v2 = hr == 1 && vr == 2;
    fancy_h2v2 = hr == 2 && vr == 2 && c.width > 2;
    tmp.resize(static_cast<size_t>(c.blocks_w) * 8 * std::max(hr, 2) + 16);
  }
  const uint8_t* row(int r) const {
    return c.plane.data() + static_cast<int64_t>(r) * c.blocks_w * 8;
  }
  // the row above / below a row in the upsampler's context: the first row
  // repeats above the image, the last real row below it
  const uint8_t* neighbour(int r) const {
    return row(std::min(std::max(r, 0), c.height - 1));
  }

  const uint8_t* at(int y) {
    if (hr == 1 && vr == 1) return row(y);
    const int in_row = y / vr;
    const uint8_t* in = row(in_row);
    uint8_t* out = tmp.data();
    const int dw = c.width;
    if (fancy_h2v1) {
      int v = in[0];
      out[0] = static_cast<uint8_t>(v);
      out[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      int o = 2;
      for (int i = 1; i < dw - 1; ++i) {
        v = in[i] * 3;
        out[o++] = static_cast<uint8_t>((v + in[i - 1] + 1) >> 2);
        out[o++] = static_cast<uint8_t>((v + in[i + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      out[o++] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      out[o++] = static_cast<uint8_t>(v);
      return out;
    }
    if (fancy_h1v2 || fancy_h2v2) {
      const bool upper = (y % 2) == 0;
      const uint8_t* in1 = neighbour(upper ? in_row - 1 : in_row + 1);
      if (fancy_h1v2) {
        const int bias = upper ? 1 : 2;
        for (int i = 0; i < dw; ++i) {
          out[i] = static_cast<uint8_t>((in[i] * 3 + in1[i] + bias) >> 2);
        }
        return out;
      }
      int this_sum = in[0] * 3 + in1[0];
      int next_sum = in[1] * 3 + in1[1];
      out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      int o = 2;
      for (int i = 2; i < dw; ++i) {
        next_sum = in[i] * 3 + in1[i];
        out[o++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        out[o++] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      out[o++] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[o++] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      return out;
    }
    // box replication (int_upsample, h2v1_upsample, h2v2_upsample)
    for (int i = 0, o = 0; i < dw; ++i) {
      for (int k = 0; k < hr; ++k) out[o++] = in[i];
    }
    return out;
  }
};

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int32_t one_half = 1 << 15;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (91881 * x + one_half) >> 16;
      cb_b[i] = (116130 * x + one_half) >> 16;
      cr_g[i] = -46802 * x;
      cb_g[i] = -22554 * x + one_half;
    }
  }
};

const YccTables& ycc_tables() {
  static const YccTables tables;
  return tables;
}

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void write_output(Decoder& d, uint8_t* out, int channels) {
  const int w = d.width;
  if (d.comps.size() == 1) {
    Upsampler up(d.comps[0], d.hmax, d.vmax);
    for (int y = 0; y < d.height; ++y) {
      const uint8_t* g = up.at(y);
      uint8_t* o = out + static_cast<int64_t>(y) * w * channels;
      if (channels == 1) {
        std::memcpy(o, g, w);
      } else {
        for (int x = 0; x < w; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
    }
    return;
  }
  const bool rgb = d.is_rgb();
  if (channels == 1 && !rgb) {  // grayscale of YCbCr: the Y plane
    Upsampler up(d.comps[0], d.hmax, d.vmax);
    for (int y = 0; y < d.height; ++y) {
      std::memcpy(out + static_cast<int64_t>(y) * w, up.at(y), w);
    }
    return;
  }
  Upsampler u0(d.comps[0], d.hmax, d.vmax), u1(d.comps[1], d.hmax, d.vmax),
      u2(d.comps[2], d.hmax, d.vmax);
  const YccTables& t = ycc_tables();
  for (int y = 0; y < d.height; ++y) {
    const uint8_t* c0 = u0.at(y);
    const uint8_t* c1 = u1.at(y);
    const uint8_t* c2 = u2.at(y);
    uint8_t* o = out + static_cast<int64_t>(y) * w * channels;
    for (int x = 0; x < w; ++x) {
      int r, g, b;
      if (rgb) {
        r = c0[x];
        g = c1[x];
        b = c2[x];
      } else {
        const int yy = c0[x], cb = c1[x], cr = c2[x];
        r = clamp255(yy + t.cr_r[cr]);
        g = clamp255(yy + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        b = clamp255(yy + t.cb_b[cb]);
      }
      if (channels == 3) {
        o[3 * x] = static_cast<uint8_t>(b);
        o[3 * x + 1] = static_cast<uint8_t>(g);
        o[3 * x + 2] = static_cast<uint8_t>(r);
      } else {  // jdcolor.c rgb_gray_convert
        o[x] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + (1 << 15)) >> 16);
      }
    }
  }
}

}  // namespace

int info(const uint8_t* data, int64_t size, int* height, int* width, std::string* error) {
  try {
    Decoder d(data, size);
    d.parse(true);
    *height = d.height;
    *width = d.width;
    return 0;
  } catch (const Fail& e) {
    *error = e.what();
    return -1;
  }
}

int decode(const uint8_t* data, int64_t size, uint8_t* out, int channels, std::string* error) {
  try {
    if (channels != 1 && channels != 3) throw Fail("channels must be 1 or 3");
    Decoder d(data, size);
    d.parse(false);
    write_output(d, out, channels);
    return 0;
  } catch (const Fail& e) {
    *error = e.what();
    return -1;
  } catch (const std::bad_alloc&) {
    *error = "out of memory";
    return -1;
  }
}

}  // namespace tbn_codec
