// Image codec of davo_tpu_torch: baseline JPEG (decode and encode) and
// 8-bit PNG (decode and encode over zlib), host C++ with no image
// library. It serves the snippet loader (snippet_loader.cc), the Python
// reader and writers (data/imageio.py), prep and the training summaries,
// so every image the port reads or writes goes through this one file,
// on the CPU here and on the GPU machine alike (neither has to carry
// libjpeg or libpng; zlib is the only dependency).
//
// JPEG follows the IJG / libjpeg-turbo defaults that OpenCV's imread and
// imwrite use, step for step, so that both sides agree on the pixels:
//   decode: Huffman baseline (SOF0/SOF1), 1 or 3 components, luma
//     sampling 1x1, 2x1 or 2x2 over chroma, restart intervals; the ISLOW
//     integer IDCT (jidctint.c), "fancy" triangular chroma upsampling
//     (jdsample.c h2v1/h2v2), the fixed-point YCbCr->RGB tables
//     (jdcolor.c). Progressive, arithmetic-coded, 12-bit and multi-scan
//     files are refused.
//   encode: RGB -> YCbCr (jccolor.c), 4:2:0 box downsampling with the
//     1,2 bias pattern (jcsample.c), edge replication and dummy blocks
//     (jcprepct.c, jccoefct.c), the ISLOW forward DCT (jfdctint.c), the
//     Annex K tables scaled to `quality` (jcparam.c), the standard
//     Huffman tables, a JFIF APP0 header.
// PNG: decode colour types 0, 2, 3, 4 and 6 at bit depth 8, not
// interlaced, all five filters; encode gray or RGB, filter 0.

#pragma once

#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace dvimg {

struct Image {
  int h = 0, w = 0, c = 0;  // c: 1 gray, 3 RGB
  std::vector<uint8_t> px;  // h x w x c, row-major
};

inline bool read_file(const std::string& path, std::vector<uint8_t>* out,
                      std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) {
    *err = "open failed: " + path;
    return false;
  }
  out->clear();
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = fread(buf, 1, sizeof(buf), f)) > 0) out->insert(out->end(), buf, buf + n);
  const bool bad = ferror(f) != 0;
  fclose(f);
  if (bad) *err = "read failed: " + path;
  return !bad;
}

// Written whole under a temporary name, then renamed: a reader never
// sees half a file.
inline bool write_file(const std::string& path, const std::vector<uint8_t>& data,
                       std::string* err) {
  const std::string tmp = path + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) {
    *err = "open for writing failed: " + path;
    return false;
  }
  const bool ok = fwrite(data.data(), 1, data.size(), f) == data.size();
  const bool closed = fclose(f) == 0;
  if (!ok || !closed || rename(tmp.c_str(), path.c_str()) != 0) {
    remove(tmp.c_str());
    *err = "write failed: " + path;
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG: shared tables
// ---------------------------------------------------------------------------

// Natural (row-major) index of the k-th coefficient in zigzag order.
constexpr int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ISLOW fixed-point constants: CONST_BITS 13, PASS1_BITS 2.
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct HuffTable {
  bool present = false;
  uint8_t vals[256] = {};
  int maxcode[18] = {}, valptr[17] = {}, mincode[17] = {};
  uint8_t look_len[512] = {}, look_sym[512] = {};  // 9-bit lookahead

  bool build(const uint8_t* bits, const uint8_t* v, int nvals) {
    memcpy(vals, v, nvals);
    int code = 0, k = 0;
    memset(look_len, 0, sizeof(look_len));
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j) {
            look_len[(code << shift) | j] = uint8_t(l);
            look_sym[(code << shift) | j] = vals[k];
          }
        }
      }
      maxcode[l] = bits[l - 1] ? code - 1 : -1;
      if (code > (1 << l)) return false;  // over-subscribed
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
    return k == nvals;
  }
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  // After a marker or the end of data, zeros are fed (as libjpeg does).
  void fill() {
    while (n_ <= 56) {
      uint64_t b = 0;
      if (!marker_ && p_ < end_) {
        b = *p_;
        if (b == 0xFF) {
          const uint8_t nx = p_ + 1 < end_ ? p_[1] : 0;
          if (nx == 0x00) {
            p_ += 2;
          } else {
            marker_ = true;
            b = 0;
          }
        } else {
          ++p_;
        }
      }
      acc_ |= b << (56 - n_);
      n_ += 8;
    }
  }
  int bits(int k) {  // k in 1..16
    if (n_ < k) fill();
    const int v = int(acc_ >> (64 - k));
    acc_ <<= k;
    n_ -= k;
    return v;
  }
  int receive_extend(int s) {
    if (s == 0) return 0;
    const int v = bits(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  // Returns the symbol, or -1 for a code no table holds.
  int decode(const HuffTable& t) {
    if (n_ < 16) fill();
    const int look = int(acc_ >> (64 - 9));
    if (t.look_len[look]) {
      const int l = t.look_len[look];
      acc_ <<= l;
      n_ -= l;
      return t.look_sym[look];
    }
    for (int l = 10; l <= 16; ++l) {
      const int code = int(acc_ >> (64 - l));
      if (code <= t.maxcode[l]) {
        acc_ <<= l;
        n_ -= l;
        return t.vals[t.valptr[l] + code - t.mincode[l]];
      }
    }
    return -1;
  }
  // At a restart interval: drop the padding bits, skip the RSTn marker.
  bool restart() {
    acc_ = 0;
    n_ = 0;
    marker_ = false;
    while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] >= 0xD0 && p_[1] <= 0xD7)) ++p_;
    if (p_ + 1 >= end_) return false;
    p_ += 2;
    return true;
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t acc_ = 0;
  int n_ = 0;
  bool marker_ = false;
};

// jidctint.c jpeg_idct_islow: dequantized coefficients (natural order)
// -> 8x8 samples written at `out` with row stride `stride`.
inline void idct_islow(const int32_t* in, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* ip = in + c;
    int32_t* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      const int32_t dc = ip[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = ip[16], z3 = ip[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = ip[0];
    z3 = ip[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56];
    tmp1 = ip[40];
    tmp2 = ip[24];
    tmp3 = ip[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    wp[0] = int32_t(descale(tmp10 + tmp3, sh));
    wp[56] = int32_t(descale(tmp10 - tmp3, sh));
    wp[8] = int32_t(descale(tmp11 + tmp2, sh));
    wp[48] = int32_t(descale(tmp11 - tmp2, sh));
    wp[16] = int32_t(descale(tmp12 + tmp1, sh));
    wp[40] = int32_t(descale(tmp12 - tmp1, sh));
    wp[24] = int32_t(descale(tmp13 + tmp0, sh));
    wp[32] = int32_t(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      const uint8_t dc = clamp255(int(descale(wp[0], kPass1Bits + 3)) + 128);
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = clamp255(int(descale(tmp10 + tmp3, sh)) + 128);
    op[7] = clamp255(int(descale(tmp10 - tmp3, sh)) + 128);
    op[1] = clamp255(int(descale(tmp11 + tmp2, sh)) + 128);
    op[6] = clamp255(int(descale(tmp11 - tmp2, sh)) + 128);
    op[2] = clamp255(int(descale(tmp12 + tmp1, sh)) + 128);
    op[5] = clamp255(int(descale(tmp12 - tmp1, sh)) + 128);
    op[3] = clamp255(int(descale(tmp13 + tmp0, sh)) + 128);
    op[4] = clamp255(int(descale(tmp13 - tmp0, sh)) + 128);
  }
}

struct JpegComponent {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int width = 0, height = 0;  // downsampled size (jdiv_round_up)
  int pw = 0, ph = 0;         // plane size, whole blocks of the MCU grid
  int dc_pred = 0;
  std::vector<uint8_t> plane;
};

// jdsample.c h2v2_fancy_upsample / h2v1_fancy_upsample (plain replication
// where the component is at most 2 samples wide), into a W x H plane.
inline void upsample(const JpegComponent& c, int hmax, int vmax, int W, int H,
                     uint8_t* out) {
  const int fx = hmax / c.h, fy = vmax / c.v;
  const int dw = c.width, dh = c.height;
  std::vector<uint8_t> row(size_t(2) * dw + 2);
  std::vector<int> cs(dw);
  for (int oy = 0; oy < H; ++oy) {
    const int iy = oy / fy;
    const uint8_t* r0 = c.plane.data() + size_t(iy) * c.pw;
    if (fx == 1) {
      memcpy(out + size_t(oy) * W, r0, W);
      continue;
    }
    if (dw <= 2) {  // jdsample.c falls back to box replication
      for (int x = 0; x < W; ++x) out[size_t(oy) * W + x] = r0[x / 2];
      continue;
    }
    if (fy == 1) {  // h2v1
      row[0] = r0[0];
      row[1] = uint8_t((r0[0] * 3 + r0[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        row[2 * x] = uint8_t((r0[x] * 3 + r0[x - 1] + 1) >> 2);
        row[2 * x + 1] = uint8_t((r0[x] * 3 + r0[x + 1] + 2) >> 2);
      }
      row[2 * dw - 2] = uint8_t((r0[dw - 1] * 3 + r0[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = r0[dw - 1];
    } else {  // h2v2: the nearer row 3/4, the row above or below 1/4
      int ny = (oy % 2) ? iy + 1 : iy - 1;
      ny = std::min(std::max(ny, 0), dh - 1);
      const uint8_t* r1 = c.plane.data() + size_t(ny) * c.pw;
      for (int x = 0; x < dw; ++x) cs[x] = r0[x] * 3 + r1[x];
      row[0] = uint8_t((cs[0] * 4 + 8) >> 4);
      row[1] = uint8_t((cs[0] * 3 + cs[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        row[2 * x] = uint8_t((cs[x] * 3 + cs[x - 1] + 8) >> 4);
        row[2 * x + 1] = uint8_t((cs[x] * 3 + cs[x + 1] + 7) >> 4);
      }
      row[2 * dw - 2] = uint8_t((cs[dw - 1] * 3 + cs[dw - 2] + 8) >> 4);
      row[2 * dw - 1] = uint8_t((cs[dw - 1] * 4 + 7) >> 4);
    }
    memcpy(out + size_t(oy) * W, row.data(), W);
  }
}

// jdcolor.c ycc_rgb_convert's tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
  }
};

// want_c: 0 = as stored (1 or 3), 1 = gray (refused for colour files),
// 3 = RGB (gray replicated). header_only fills h, w, c and stops.
inline bool decode_jpeg(const uint8_t* data, size_t n, int want_c, Image* out,
                        std::string* err, bool header_only = false) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) {
    *err = "not a JPEG file";
    return false;
  }
  int32_t qt[4][64] = {};  // natural order
  bool qt_set[4] = {};
  HuffTable dc[4], ac[4];
  std::vector<JpegComponent> comps;
  int H = 0, W = 0, restart_interval = 0;
  const uint8_t* p = data + 2;
  const uint8_t* end = data + n;
  auto u16 = [](const uint8_t* q) { return (q[0] << 8) | q[1]; };
  for (;;) {
    while (p < end && *p != 0xFF) ++p;  // tolerate junk between markers
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) {
      *err = "JPEG ended before its scan";
      return false;
    }
    const int marker = *p++;
    if (marker == 0xD9) {
      *err = "JPEG has no scan";
      return false;
    }
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (p + 2 > end) {
      *err = "truncated JPEG marker";
      return false;
    }
    const int len = u16(p);
    const uint8_t* seg = p + 2;
    const uint8_t* seg_end = p + len;
    if (len < 2 || seg_end > end) {
      *err = "truncated JPEG segment";
      return false;
    }
    p = seg_end;
    if (marker == 0xDB) {  // DQT
      for (const uint8_t* q = seg; q < seg_end;) {
        const int pq = q[0] >> 4, tq = q[0] & 15;
        ++q;
        if (tq > 3 || q + 64 * (pq + 1) > seg_end) {
          *err = "bad DQT";
          return false;
        }
        for (int k = 0; k < 64; ++k) {
          qt[tq][kZigzag[k]] = pq ? u16(q + 2 * k) : q[k];
        }
        q += 64 * (pq + 1);
        qt_set[tq] = true;
      }
    } else if (marker == 0xC4) {  // DHT
      for (const uint8_t* q = seg; q < seg_end;) {
        if (q + 17 > seg_end) {
          *err = "bad DHT";
          return false;
        }
        const int tc = q[0] >> 4, th = q[0] & 15;
        int nvals = 0;
        for (int i = 1; i <= 16; ++i) nvals += q[i];
        if (tc > 1 || th > 3 || nvals > 256 || q + 17 + nvals > seg_end ||
            !(tc ? ac[th] : dc[th]).build(q + 1, q + 17, nvals)) {
          *err = "bad DHT";
          return false;
        }
        q += 17 + nvals;
      }
    } else if (marker == 0xC0 || marker == 0xC1) {  // SOF0/SOF1: baseline
      if (len < 8 || seg[0] != 8) {
        *err = "only 8-bit JPEG is supported";
        return false;
      }
      H = u16(seg + 1);
      W = u16(seg + 3);
      const int nc = seg[5];
      if ((nc != 1 && nc != 3) || len < 8 + 3 * nc || H <= 0 || W <= 0) {
        *err = "JPEG with " + std::to_string(nc) + " components is not supported";
        return false;
      }
      comps.resize(nc);
      for (int i = 0; i < nc; ++i) {
        comps[i].id = seg[6 + 3 * i];
        comps[i].h = seg[7 + 3 * i] >> 4;
        comps[i].v = seg[7 + 3 * i] & 15;
        comps[i].tq = seg[8 + 3 * i] & 3;
        if (comps[i].h < 1 || comps[i].h > 2 || comps[i].v < 1 || comps[i].v > 2) {
          *err = "unsupported JPEG sampling factors";
          return false;
        }
      }
      if (header_only) {
        out->h = H;
        out->w = W;
        out->c = nc;
        return true;
      }
    } else if ((marker >= 0xC2 && marker <= 0xC3) || (marker >= 0xC5 && marker <= 0xCF &&
                                                      marker != 0xC8 && marker != 0xCC)) {
      *err = "progressive, lossless or arithmetic-coded JPEG is not supported";
      return false;
    } else if (marker == 0xDD) {  // DRI
      restart_interval = u16(seg);
    } else if (marker == 0xDA) {  // SOS: the scan follows
      const int ns = seg[0];
      if (comps.empty() || ns != int(comps.size())) {
        *err = "multi-scan JPEG is not supported";
        return false;
      }
      for (int i = 0; i < ns; ++i) {
        const int cid = seg[1 + 2 * i];
        bool found = false;
        for (auto& c : comps) {
          if (c.id == cid) {
            c.td = seg[2 + 2 * i] >> 4;
            c.ta = seg[2 + 2 * i] & 15;
            found = c.td < 4 && c.ta < 4 && dc[c.td].present && ac[c.ta].present &&
                    qt_set[c.tq];
          }
        }
        if (!found) {
          *err = "JPEG scan names a missing component or table";
          return false;
        }
      }
      break;
    }
  }
  // Entropy-coded data from p.
  int hmax = 1, vmax = 1;
  for (auto& c : comps) {
    hmax = std::max(hmax, c.h);
    vmax = std::max(vmax, c.v);
  }
  const int nc = int(comps.size());
  if (nc == 3 && (comps[1].h != 1 || comps[1].v != 1 || comps[2].h != 1 || comps[2].v != 1 ||
                  (comps[0].v == 2 && comps[0].h != 2))) {
    *err = "unsupported JPEG chroma sampling";
    return false;
  }
  const bool single = nc == 1;
  if (single) comps[0].h = comps[0].v = hmax = vmax = 1;  // non-interleaved
  const int mcux = (W + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
  for (auto& c : comps) {
    c.width = (W * c.h + hmax - 1) / hmax;
    c.height = (H * c.v + vmax - 1) / vmax;
    c.pw = mcux * c.h * 8;
    c.ph = mcuy * c.v * 8;
    c.plane.assign(size_t(c.pw) * c.ph, 0);
  }
  BitReader br(p, end);
  int32_t coef[64];
  const int total = mcux * mcuy;
  for (int m = 0; m < total; ++m) {
    if (restart_interval && m && m % restart_interval == 0) {
      if (!br.restart()) {
        *err = "JPEG restart marker missing";
        return false;
      }
      for (auto& c : comps) c.dc_pred = 0;
    }
    const int mx = m % mcux, my = m / mcux;
    for (auto& c : comps) {
      for (int by = 0; by < c.v; ++by) {
        for (int bx = 0; bx < c.h; ++bx) {
          memset(coef, 0, sizeof(coef));
          const int s = br.decode(dc[c.td]);
          if (s < 0 || s > 15) {
            *err = "corrupt JPEG data (DC)";
            return false;
          }
          c.dc_pred += br.receive_extend(s);
          const int32_t* q = qt[c.tq];
          coef[0] = c.dc_pred * q[0];
          for (int k = 1; k < 64;) {
            const int rs = br.decode(ac[c.ta]);
            if (rs < 0) {
              *err = "corrupt JPEG data (AC)";
              return false;
            }
            const int r = rs >> 4, sz = rs & 15;
            if (sz == 0) {
              if (r != 15) break;  // EOB
              k += 16;
              continue;
            }
            k += r;
            if (k > 63) {
              *err = "corrupt JPEG data (run past the block)";
              return false;
            }
            const int z = kZigzag[k];
            coef[z] = br.receive_extend(sz) * q[z];
            ++k;
          }
          const int x0 = (mx * c.h + bx) * 8, y0 = (my * c.v + by) * 8;
          idct_islow(coef, c.plane.data() + size_t(y0) * c.pw + x0, c.pw);
        }
      }
    }
  }
  const int oc = want_c ? want_c : nc;
  if (oc == 1 && nc == 3) {
    *err = "colour JPEG read as gray is not supported";
    return false;
  }
  out->h = H;
  out->w = W;
  out->c = oc;
  out->px.resize(size_t(H) * W * oc);
  if (nc == 1) {
    for (int y = 0; y < H; ++y) {
      const uint8_t* src = comps[0].plane.data() + size_t(y) * comps[0].pw;
      uint8_t* dst = out->px.data() + size_t(y) * W * oc;
      for (int x = 0; x < W; ++x)
        for (int k = 0; k < oc; ++k) dst[x * oc + k] = src[x];
    }
    return true;
  }
  std::vector<uint8_t> cb(size_t(W) * H), cr(size_t(W) * H);
  upsample(comps[1], hmax, vmax, W, H, cb.data());
  upsample(comps[2], hmax, vmax, W, H, cr.data());
  static const YccTables t;
  for (int y = 0; y < H; ++y) {
    const uint8_t* yp = comps[0].plane.data() + size_t(y) * comps[0].pw;
    const uint8_t* bp = cb.data() + size_t(y) * W;
    const uint8_t* rp = cr.data() + size_t(y) * W;
    uint8_t* dst = out->px.data() + size_t(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      const int Y = yp[x];
      dst[3 * x] = clamp255(Y + t.cr_r[rp[x]]);
      dst[3 * x + 1] = clamp255(Y + int((t.cb_g[bp[x]] + t.cr_g[rp[x]]) >> 16));
      dst[3 * x + 2] = clamp255(Y + t.cb_b[bp[x]]);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// JPEG encode
// ---------------------------------------------------------------------------

constexpr uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

constexpr uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEncoder {
  uint16_t code[256] = {};
  uint8_t size[256] = {};
  HuffEncoder(const uint8_t* bits, const uint8_t* vals) {
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = uint16_t(c);
        size[vals[k]] = uint8_t(l);
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>* out) : out_(out) {}
  void put(uint32_t v, int n) {
    acc_ = (acc_ << n) | (v & ((1u << n) - 1));
    bits_ += n;
    while (bits_ >= 8) {
      const uint8_t b = uint8_t(acc_ >> (bits_ - 8));
      out_->push_back(b);
      if (b == 0xFF) out_->push_back(0x00);
      bits_ -= 8;
    }
  }
  // Pad the last byte with 1-bits (jchuff.c flush_bits).
  void flush() {
    if (bits_) put((1u << (8 - bits_)) - 1, 8 - bits_);
    bits_ = 0;
  }

 private:
  std::vector<uint8_t>* out_;
  uint64_t acc_ = 0;
  int bits_ = 0;
};

// jfdctint.c jpeg_fdct_islow, in place on centred samples; output scaled by 8.
inline void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * stride;
      const int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      const int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      const int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      const int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int sh = pass ? kConstBits + kPass1Bits : kConstBits - kPass1Bits;
      if (pass) {
        p[0] = int32_t(descale(tmp10 + tmp11, kPass1Bits));
        p[4 * step] = int32_t(descale(tmp10 - tmp11, kPass1Bits));
      } else {
        p[0] = int32_t((tmp10 + tmp11) * (1 << kPass1Bits));
        p[4 * step] = int32_t((tmp10 - tmp11) * (1 << kPass1Bits));
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = int32_t(descale(z1 + tmp13 * F0765, sh));
      p[6 * step] = int32_t(descale(z1 + tmp12 * -F1847, sh));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      const int64_t z5 = (z3 + z4) * F1175;
      const int64_t t4 = tmp4 * F0298, t5 = tmp5 * F2053, t6 = tmp6 * F3072, t7 = tmp7 * F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = int32_t(descale(t4 + z1 + z3, sh));
      p[5 * step] = int32_t(descale(t5 + z2 + z4, sh));
      p[3 * step] = int32_t(descale(t6 + z2 + z3, sh));
      p[step] = int32_t(descale(t7 + z1 + z4, sh));
    }
  }
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline).
inline void scaled_quant(const uint8_t* base, int quality, int* out) {
  quality = std::min(std::max(quality, 1), 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (long(base[i]) * scale + 50) / 100;
    out[i] = int(std::min(std::max(t, 1L), 255L));
  }
}

// RGB (h x w x 3) -> baseline JPEG, 4:2:0, at `quality` (OpenCV's
// imwrite defaults: 95).
inline bool encode_jpeg_rgb(const uint8_t* rgb, int H, int W, int quality,
                            std::vector<uint8_t>* out, std::string* err) {
  if (H <= 0 || W <= 0 || H > 65535 || W > 65535) {
    *err = "bad JPEG size";
    return false;
  }
  int q[2][64];
  scaled_quant(kStdLumaQ, quality, q[0]);
  scaled_quant(kStdChromaQ, quality, q[1]);
  // jccolor.c rgb_ycc_convert tables.
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
  int64_t ry[256], gy[256], by[256], rcb[256], gcb[256], bcb[256], gcr[256], bcr[256];
  for (int i = 0; i < 256; ++i) {
    ry[i] = fix(0.29900) * i;
    gy[i] = fix(0.58700) * i;
    by[i] = fix(0.11400) * i + one_half;
    rcb[i] = -fix(0.16874) * i;
    gcb[i] = -fix(0.33126) * i;
    bcb[i] = fix(0.5) * i + cbcr_off + one_half - 1;  // also R -> Cr
    gcr[i] = -fix(0.41869) * i;
    bcr[i] = -fix(0.08131) * i;
  }
  // Component geometry (jdiv_round_up), padded planes.
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int cw = (W + 1) / 2, ch = (H + 1) / 2;
  const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;    // luma blocks
  const int cbw = (cw + 7) / 8, cbh = (ch + 7) / 8;  // chroma blocks
  const int yph = mcuy * 16, cph = mcuy * 8;
  const int ypw = ybw * 8, fpw = cbw * 16;  // luma, full-res chroma input widths
  std::vector<uint8_t> Y(size_t(ypw) * yph), Cb(size_t(fpw) * yph), Cr(size_t(fpw) * yph);
  const int H2 = ch * 2;  // rows up to the row group (max_v_samp_factor = 2)
  for (int y = 0; y < H2; ++y) {
    const uint8_t* src = rgb + size_t(std::min(y, H - 1)) * W * 3;
    uint8_t* yr = Y.data() + size_t(y) * ypw;
    uint8_t* br = Cb.data() + size_t(y) * fpw;
    uint8_t* rr = Cr.data() + size_t(y) * fpw;
    for (int x = 0; x < W; ++x) {
      const int r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
      yr[x] = uint8_t((ry[r] + gy[g] + by[b]) >> 16);
      br[x] = uint8_t((rcb[r] + gcb[g] + bcb[b]) >> 16);
      rr[x] = uint8_t((bcb[r] + gcr[g] + bcr[b]) >> 16);
    }
    for (int x = W; x < ypw; ++x) yr[x] = yr[W - 1];
    for (int x = W; x < fpw; ++x) br[x] = br[W - 1], rr[x] = rr[W - 1];
  }
  for (int y = H2; y < yph; ++y) memcpy(Y.data() + size_t(y) * ypw, Y.data() + size_t(H2 - 1) * ypw, ypw);
  // h2v2 box downsampling with the alternating 1, 2 bias.
  const int cpw = cbw * 8;
  std::vector<uint8_t> Cbd(size_t(cpw) * cph), Crd(size_t(cpw) * cph);
  for (int cy = 0; cy < cph; ++cy) {
    const int sy = std::min(cy, ch - 1);  // rows past the image: the last one
    for (int k = 0; k < 2; ++k) {
      const uint8_t* r0 = (k ? Cr : Cb).data() + size_t(2 * sy) * fpw;
      const uint8_t* r1 = r0 + fpw;
      uint8_t* d = (k ? Crd : Cbd).data() + size_t(cy) * cpw;
      int bias = 1;
      for (int x = 0; x < cpw; ++x) {
        d[x] = uint8_t((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
  }
  // Headers: SOI, JFIF APP0, DQT x2, SOF0, DHT x4, SOS.
  out->clear();
  auto put16 = [&](int v) {
    out->push_back(uint8_t(v >> 8));
    out->push_back(uint8_t(v));
  };
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0,
                          1, 1, 0, 0, 1, 0, 1, 0, 0};
  out->insert(out->end(), head, head + sizeof(head));
  for (int t = 0; t < 2; ++t) {
    put16(0xFFDB);
    put16(67);
    out->push_back(uint8_t(t));
    for (int k = 0; k < 64; ++k) out->push_back(uint8_t(q[t][kZigzag[k]]));
  }
  put16(0xFFC0);
  put16(17);
  out->push_back(8);
  put16(H);
  put16(W);
  out->push_back(3);
  const uint8_t sof[] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  out->insert(out->end(), sof, sof + 9);
  auto dht = [&](int cls_id, const uint8_t* bits, const uint8_t* vals) {
    int n = 0;
    for (int i = 0; i < 16; ++i) n += bits[i];
    put16(0xFFC4);
    put16(19 + n);
    out->push_back(uint8_t(cls_id));
    out->insert(out->end(), bits, bits + 16);
    out->insert(out->end(), vals, vals + n);
  };
  dht(0x00, kDcLumaBits, kDcVals);
  dht(0x10, kAcLumaBits, kAcLumaVals);
  dht(0x01, kDcChromaBits, kDcVals);
  dht(0x11, kAcChromaBits, kAcChromaVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
  out->insert(out->end(), sos, sos + sizeof(sos));
  // Blocks: MCU order, dummy blocks past the component's blocks repeat
  // the last DC (jccoefct.c compress_data).
  static const HuffEncoder dcl(kDcLumaBits, kDcVals), dcc(kDcChromaBits, kDcVals);
  static const HuffEncoder acl(kAcLumaBits, kAcLumaVals), acc(kAcChromaBits, kAcChromaVals);
  BitWriter bw(out);
  int last_dc[3] = {0, 0, 0};
  int32_t blk[64];
  int qc[64];
  auto fdct_block = [&](const uint8_t* plane, int pw, int x0, int y0, const int* qt) {
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) blk[8 * r + c] = int32_t(plane[size_t(y0 + r) * pw + x0 + c]) - 128;
    fdct_islow(blk);
    for (int i = 0; i < 64; ++i) {
      const int qv = qt[i] << 3;
      int t = blk[i];
      qc[i] = t < 0 ? -((-t + (qv >> 1)) / qv) : (t + (qv >> 1)) / qv;
    }
  };
  auto emit = [&](int ci, const HuffEncoder& dct, const HuffEncoder& act) {
    int t = qc[0] - last_dc[ci], t2 = t;
    last_dc[ci] = qc[0];
    if (t < 0) t = -t, --t2;
    int nbits = 0;
    while (t) ++nbits, t >>= 1;
    bw.put(dct.code[nbits], dct.size[nbits]);
    if (nbits) bw.put(uint32_t(t2), nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      int v = qc[kZigzag[k]];
      if (v == 0) {
        ++r;
        continue;
      }
      while (r > 15) bw.put(act.code[0xF0], act.size[0xF0]), r -= 16;
      int v2 = v;
      if (v < 0) v = -v, --v2;
      int nb = 1;
      while (v >>= 1) ++nb;
      const int sym = (r << 4) + nb;
      bw.put(act.code[sym], act.size[sym]);
      bw.put(uint32_t(v2), nb);
      r = 0;
    }
    if (r > 0) bw.put(act.code[0], act.size[0]);
  };
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      int prev_dc = 0;
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          const int gx = mx * 2 + bx, gy = my * 2 + by;
          if (gy < ybh && gx < ybw) {
            fdct_block(Y.data(), ypw, gx * 8, gy * 8, q[0]);
          } else {
            // Dummy block: right edge repeats the block to its left,
            // bottom row the MCU's previous block.
            memset(qc, 0, sizeof(qc));
            qc[0] = prev_dc;
          }
          prev_dc = qc[0];
          emit(0, dcl, acl);
        }
      }
      for (int ci = 1; ci < 3; ++ci) {
        if (my < cbh && mx < cbw) {
          fdct_block((ci == 1 ? Cbd : Crd).data(), cpw, mx * 8, my * 8, q[1]);
        } else {
          memset(qc, 0, sizeof(qc));
          qc[0] = last_dc[ci];
        }
        emit(ci, dcc, acc);
      }
    }
  }
  bw.flush();
  out->push_back(0xFF);
  out->push_back(0xD9);
  return true;
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

inline bool decode_png(const uint8_t* data, size_t n, int want_c, Image* out,
                       std::string* err, bool header_only = false) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 33 || memcmp(data, sig, 8) != 0 || memcmp(data + 12, "IHDR", 4) != 0) {
    *err = "not a PNG file";
    return false;
  }
  const uint32_t W = be32(data + 16), H = be32(data + 20);
  const int depth = data[24], ctype = data[25], interlace = data[28];
  static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
  if (depth != 8 || ctype > 6 || !kChannels[ctype] || interlace != 0 || !W || !H ||
      W > (1u << 24) || H > (1u << 24)) {
    *err = "unsupported PNG (depth " + std::to_string(depth) + ", colour type " +
           std::to_string(ctype) + ", interlace " + std::to_string(interlace) +
           "): 8-bit, non-interlaced only";
    return false;
  }
  const int sc = kChannels[ctype];
  const int nc = (ctype == 0 || ctype == 4) ? 1 : 3;  // stored colour channels
  if (header_only) {
    out->h = int(H);
    out->w = int(W);
    out->c = nc;
    return true;
  }
  const int oc = want_c ? want_c : nc;
  if (oc == 1 && nc == 3) {
    *err = "colour PNG read as gray is not supported";
    return false;
  }
  std::vector<uint8_t> idat, palette;
  for (size_t p = 8; p + 12 <= n;) {
    const uint32_t len = be32(data + p);
    if (p + 12 + size_t(len) > n) {
      *err = "truncated PNG chunk";
      return false;
    }
    const uint8_t* type = data + p + 4;
    const uint8_t* body = data + p + 8;
    if (!memcmp(type, "IDAT", 4)) idat.insert(idat.end(), body, body + len);
    if (!memcmp(type, "PLTE", 4)) palette.assign(body, body + len);
    if (!memcmp(type, "IEND", 4)) break;
    p += 12 + size_t(len);
  }
  if (ctype == 3 && palette.empty()) {
    *err = "palette PNG without PLTE";
    return false;
  }
  const size_t stride = size_t(W) * sc;
  std::vector<uint8_t> raw((stride + 1) * H);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) {
    *err = "zlib init failed";
    return false;
  }
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  const int zr = inflate(&zs, Z_FINISH);
  const bool full = zs.avail_out == 0;
  inflateEnd(&zs);
  if ((zr != Z_STREAM_END && zr != Z_BUF_ERROR) || !full) {
    *err = "corrupt PNG image data";
    return false;
  }
  // Unfilter in place; the previous row starts as zeros.
  std::vector<uint8_t> px(stride * H);
  std::vector<uint8_t> zero(stride, 0);
  for (uint32_t y = 0; y < H; ++y) {
    const int f = raw[y * (stride + 1)];
    const uint8_t* in = raw.data() + y * (stride + 1) + 1;
    uint8_t* cur = px.data() + y * stride;
    const uint8_t* prev = y ? cur - stride : zero.data();
    for (size_t i = 0; i < stride; ++i) {
      const int a = i >= size_t(sc) ? cur[i - sc] : 0;
      const int b = prev[i];
      const int c = i >= size_t(sc) ? prev[i - sc] : 0;
      int v;
      switch (f) {
        case 0: v = in[i]; break;
        case 1: v = in[i] + a; break;
        case 2: v = in[i] + b; break;
        case 3: v = in[i] + ((a + b) >> 1); break;
        case 4: {
          const int pp = a + b - c;
          const int pa = std::abs(pp - a), pb = std::abs(pp - b), pc = std::abs(pp - c);
          v = in[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c));
          break;
        }
        default:
          *err = "bad PNG filter type";
          return false;
      }
      cur[i] = uint8_t(v);
    }
  }
  out->h = int(H);
  out->w = int(W);
  out->c = oc;
  out->px.resize(size_t(W) * H * oc);
  for (size_t i = 0; i < size_t(W) * H; ++i) {
    uint8_t rgb[3];
    const uint8_t* s = px.data() + i * sc;
    if (ctype == 3) {
      if (size_t(s[0]) * 3 + 2 >= palette.size()) {
        *err = "PNG palette index out of range";
        return false;
      }
      memcpy(rgb, palette.data() + size_t(s[0]) * 3, 3);
    } else if (nc == 1) {
      rgb[0] = rgb[1] = rgb[2] = s[0];  // gray, alpha dropped
    } else {
      memcpy(rgb, s, 3);  // alpha dropped
    }
    memcpy(out->px.data() + i * oc, rgb, oc);
  }
  return true;
}

inline void put_be32(std::vector<uint8_t>* out, uint32_t v) {
  for (int s = 24; s >= 0; s -= 8) out->push_back(uint8_t(v >> s));
}

inline void png_chunk(std::vector<uint8_t>* out, const char* type, const uint8_t* body,
                      size_t len) {
  put_be32(out, uint32_t(len));
  const size_t start = out->size();
  out->insert(out->end(), type, type + 4);
  out->insert(out->end(), body, body + len);
  put_be32(out, uint32_t(crc32(0, out->data() + start, uInt(len + 4))));
}

// Gray (c=1) or RGB (c=3) 8-bit, filter 0 on every row.
inline bool encode_png(const uint8_t* px, int H, int W, int c, std::vector<uint8_t>* out,
                       std::string* err) {
  if ((c != 1 && c != 3) || H <= 0 || W <= 0) {
    *err = "PNG encode takes gray or RGB";
    return false;
  }
  const size_t stride = size_t(W) * c;
  std::vector<uint8_t> raw((stride + 1) * H);
  for (int y = 0; y < H; ++y) {
    raw[y * (stride + 1)] = 0;
    memcpy(raw.data() + y * (stride + 1) + 1, px + y * stride, stride);
  }
  uLongf zlen = compressBound(uLong(raw.size()));
  std::vector<uint8_t> z(zlen);
  if (compress2(z.data(), &zlen, raw.data(), uLong(raw.size()), 6) != Z_OK) {
    *err = "zlib compress failed";
    return false;
  }
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  out->assign(sig, sig + 8);
  uint8_t ihdr[13];
  for (int i = 0; i < 4; ++i) {
    ihdr[i] = uint8_t(uint32_t(W) >> (24 - 8 * i));
    ihdr[4 + i] = uint8_t(uint32_t(H) >> (24 - 8 * i));
  }
  ihdr[8] = 8;
  ihdr[9] = c == 1 ? 0 : 2;
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png_chunk(out, "IHDR", ihdr, 13);
  png_chunk(out, "IDAT", z.data(), zlen);
  png_chunk(out, "IEND", nullptr, 0);
  return true;
}

// Decode a file by its signature (JPEG or PNG).
inline bool decode_file(const std::string& path, int want_c, Image* out, std::string* err,
                        bool header_only = false) {
  std::vector<uint8_t> data;
  if (!read_file(path, &data, err)) return false;
  bool ok;
  if (data.size() >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    ok = decode_jpeg(data.data(), data.size(), want_c, out, err, header_only);
  } else {
    ok = decode_png(data.data(), data.size(), want_c, out, err, header_only);
  }
  if (!ok) *err += ": " + path;
  return ok;
}

}  // namespace dvimg
