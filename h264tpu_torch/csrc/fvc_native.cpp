// Native host-side bit machinery of the fractal codec (FVC container).
//
// The device handles all pixel compute; what remains on the host is
// bit-serial work: the CAVLC and CABAC residual coders of a plane of 4x4
// level blocks, MPM intra-mode resolution and Annex-B emulation prevention.
// This mirrors the role of the reference's C entropy coders
// (FR/src/vlc.c:1504-2508 readSyntaxElement_*_dec).
//
// All VLC and CABAC tables are passed in from Python so there is exactly one
// source of truth for the spec constants (h264tpu_torch/entropy/cavlc.py,
// h264tpu_torch/entropy/cabac_eng.py).
//
// A copy of native/fvc_native.cpp.  Built by h264tpu_torch/entropy/native.py
// at first use (g++ -O2 -fPIC -shared -std=c++17 into h264tpu_torch/_build/).

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
  const uint8_t* data;
  int64_t pos;    // bit position
  int64_t end;    // total bits

  int read1() {
    if (pos >= end) return -1;
    int b = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return b;
  }
  int64_t read(int n) {
    int64_t v = 0;
    for (int i = 0; i < n; i++) {
      int b = read1();
      if (b < 0) return -1;
      v = (v << 1) | b;
    }
    return v;
  }
};

// Decode one prefix code by incremental matching against (len, code) tables
// laid out as len[rows][16] / code[rows][16]; returns the matched column or
// -1.  maxlen bounds the search.
int read_vlc_row(BitReader& br, const uint8_t* lens, const int32_t* codes,
                 int ncols, int maxlen) {
  int len = 0;
  int64_t code = 0;
  while (len < maxlen) {
    int b = br.read1();
    if (b < 0) return -1;
    code = (code << 1) | b;
    len++;
    for (int j = 0; j < ncols; j++) {
      if (lens[j] == len && codes[j] == code) return j;
    }
  }
  return -1;
}

int read_level(BitReader& br, int vlcnum) {
  int prefix = 0;
  for (;;) {
    int b = br.read1();
    if (b < 0) return INT32_MIN;
    if (b) break;
    if (++prefix > 48) return INT32_MIN;
  }
  int shift = vlcnum > 0 ? vlcnum - 1 : 0;
  int64_t labs, sign;
  if (vlcnum == 0) {
    if (prefix < 14) {
      labs = (prefix >> 1) + 1;
      sign = prefix & 1;
    } else if (prefix == 14) {
      int64_t suf = br.read(4);
      labs = 8 + (suf >> 1);
      sign = suf & 1;
    } else {
      int nbits = prefix - 15 + 12;
      int64_t full = (int64_t(1) << nbits) | br.read(nbits);
      labs = (full >> 1) - 2032;
      sign = full & 1;
    }
  } else {
    if (prefix < 15) {
      int64_t suffix = shift ? br.read(shift) : 0;
      sign = br.read(1);
      labs = (int64_t(prefix) << shift) + suffix + 1;
    } else {
      int nbits = prefix - 15 + 12;
      int64_t full = (int64_t(1) << nbits) | br.read(nbits);
      labs = (full >> 1) - 2048 + (int64_t(15) << shift) + 1;
      sign = full & 1;
    }
  }
  return (int)(sign ? -labs : labs);
}

const int64_t INC_VLC[7] = {0, 3, 6, 12, 24, 48, 32768};

}  // namespace

extern "C" {

// Decode a CAVLC-coded plane of cy*cx 4x4 blocks.
// Tables (from h264tpu_torch.entropy.cavlc):
//   tok_len  uint8 [3*4*17], tok_code int32 [3*4*17]
//   tz_len   uint8 [15*16],  tz_code  int32 [15*16]
//   rb_len   uint8 [7*16],   rb_code  int32 [7*16]
// zz_out: int32 [cy*cx*16].  Returns the new bit position, or -1 on error.
int64_t cavlc_decode_plane(const uint8_t* data, int64_t nbits, int64_t bitpos,
                           int cy, int cx, const uint8_t* tok_len,
                           const int32_t* tok_code, const uint8_t* tz_len,
                           const int32_t* tz_code, const uint8_t* rb_len,
                           const int32_t* rb_code, int32_t* zz_out,
                           int32_t* total_scratch) {
  BitReader br{data, bitpos, nbits};
  std::memset(zz_out, 0, sizeof(int32_t) * cy * cx * 16);
  // total_scratch: int32 [cy*cx] workspace for the nC context
  for (int by = 0; by < cy; by++) {
    for (int bx = 0; bx < cx; bx++) {
      int nA = bx > 0 ? total_scratch[by * cx + bx - 1] : 0;
      int nB = by > 0 ? total_scratch[(by - 1) * cx + bx] : 0;
      int nc;
      if (bx > 0 && by > 0) nc = (nA + nB + 1) >> 1;
      else if (bx > 0) nc = nA;
      else if (by > 0) nc = nB;
      else nc = 0;

      int total, t1;
      if (nc >= 8) {
        int64_t code = br.read(6);
        if (code < 0) return -1;
        if (code == 3) { total = 0; t1 = 0; }
        else { total = (int)(code >> 2) + 1; t1 = (int)(code & 3); }
      } else {
        int vt = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
        // search the 4x17 (t1, total) grid: flatten to find by (len, code)
        int len = 0;
        int64_t code = 0;
        total = -1;
        while (len < 17 && total < 0) {
          int b = br.read1();
          if (b < 0) return -1;
          code = (code << 1) | b;
          len++;
          for (int tt = 0; tt < 4 && total < 0; tt++) {
            for (int to = 0; to < 17; to++) {
              int idx = (vt * 4 + tt) * 17 + to;
              if (tok_len[idx] == len && tok_code[idx] == code) {
                total = to;
                t1 = tt;
                break;
              }
            }
          }
        }
        if (total < 0) return -1;
      }
      total_scratch[by * cx + bx] = total;
      if (total == 0) continue;

      int32_t levels[16];
      for (int j = 0; j < t1; j++) {
        int s = br.read1();
        if (s < 0) return -1;
        levels[total - 1 - j] = s ? -1 : 1;
      }
      int vlcnum = (total > 10 && t1 < 3) ? 1 : 0;
      bool first = true;
      for (int k = total - 1 - t1; k >= 0; k--) {
        int lv = read_level(br, vlcnum);
        if (lv == INT32_MIN) return -1;
        if (first && !(total > 3 && t1 == 3)) lv = lv > 0 ? lv + 1 : lv - 1;
        first = false;
        levels[k] = lv;
        int64_t alv = lv < 0 ? -(int64_t)lv : lv;
        if (alv > INC_VLC[vlcnum < 6 ? vlcnum : 6]) vlcnum++;
        if (k == total - 1 - t1 && alv > 3 && vlcnum < 2) vlcnum = 2;
      }

      int tz = 0;
      if (total < 16) {
        tz = read_vlc_row(br, tz_len + (total - 1) * 16,
                          tz_code + (total - 1) * 16, 16, 9);
        if (tz < 0) return -1;
      }
      int runs[16];
      int zerosleft = tz;
      for (int k = total - 1; k >= 1; k--) {
        int rb = 0;
        if (zerosleft > 0) {
          int row = zerosleft - 1 < 6 ? zerosleft - 1 : 6;
          rb = read_vlc_row(br, rb_len + row * 16, rb_code + row * 16, 16, 11);
          if (rb < 0) return -1;
        }
        runs[k] = rb;
        zerosleft -= rb;
      }
      runs[0] = zerosleft;

      int pos = -1;
      int32_t* blk = zz_out + (by * cx + bx) * 16;
      for (int k = 0; k < total; k++) {
        pos += runs[k] + 1;
        if (pos > 15) return -1;
        blk[pos] = levels[k];
      }
    }
  }
  return br.pos;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CABAC (H.264 M-coder) residual plane codec — fast path for
// h264tpu/entropy/cabac_eng.py (bit-exact mirror; spec tables passed in).
// ---------------------------------------------------------------------------

namespace {

constexpr int kHalf = 0x200, kQuarter = 0x100;
// context layout (cabac_eng.py): 4 CBF + 15 SIG + 15 LAST + 10 ABS
constexpr int kCtxCbf = 0, kCtxSig = 4, kCtxLast = 19, kCtxAbs = 34,
              kNumCtx = 44;

struct CabacEnc {
  const uint8_t* rlps;      // [64*4]
  const uint8_t* next_mps;  // [64]
  const uint8_t* next_lps;  // [64]
  uint8_t* out;
  int64_t cap, n = 0;
  uint32_t low = 0, range = kHalf - 2;
  int64_t bits_to_follow = 0;
  uint32_t buf = 0;
  int nbuf = 0;
  bool first = true;
  uint8_t state[kNumCtx] = {0}, mps[kNumCtx] = {0};
  bool overflow = false;

  void putbit(int b) {
    if (first) { first = false; return; }
    buf = (buf << 1) | b;
    if (++nbuf == 8) {
      if (n >= cap) { overflow = true; nbuf = 0; return; }
      out[n++] = (uint8_t)buf;
      buf = 0;
      nbuf = 0;
    }
  }
  void put_outstanding(int b) {
    putbit(b);
    while (bits_to_follow > 0) { bits_to_follow--; putbit(!b); }
  }
  void renorm() {
    while (range < kQuarter) {
      if (low >= kHalf) { put_outstanding(1); low -= kHalf; }
      else if (low < kQuarter) put_outstanding(0);
      else { bits_to_follow++; low -= kQuarter; }
      low <<= 1;
      range <<= 1;
    }
  }
  void bit(int ctx, int b) {
    int st = state[ctx];
    uint32_t r = rlps[st * 4 + ((range >> 6) & 3)];
    range -= r;
    if (b != mps[ctx]) {
      low += range;
      range = r;
      if (st == 0) mps[ctx] = !mps[ctx];
      state[ctx] = next_lps[st];
    } else {
      state[ctx] = next_mps[st];
    }
    renorm();
  }
  void bypass(int b) {
    low <<= 1;
    if (b) low += range;
    if (low >= 2 * kHalf) { put_outstanding(1); low -= 2 * kHalf; }
    else if (low < kHalf) put_outstanding(0);
    else { bits_to_follow++; low -= kHalf; }
  }
  int64_t flush() {
    range -= 2;           // terminate decision (rLPS=2 path)
    low += range;
    range = 2;
    renorm();
    put_outstanding((low >> 9) & 1);
    putbit((low >> 8) & 1);
    putbit(1);
    while (nbuf) putbit(0);
    return overflow ? -1 : n;
  }
};

struct CabacDec {
  const uint8_t* rlps;
  const uint8_t* next_mps;
  const uint8_t* next_lps;
  const uint8_t* data;
  int64_t nbytes, bitpos = 0;
  uint32_t value = 0, range = kHalf - 2;
  uint8_t state[kNumCtx] = {0}, mps[kNumCtx] = {0};

  void init() {
    for (int i = 0; i < 9; i++) value = (value << 1) | read1();
  }
  int read1() {
    int64_t p = bitpos++;
    if ((p >> 3) >= nbytes) return 0;
    return (data[p >> 3] >> (7 - (p & 7))) & 1;
  }
  int bit(int ctx) {
    int st = state[ctx];
    uint32_t r = rlps[st * 4 + ((range >> 6) & 3)];
    range -= r;
    int b;
    if (value < range) {
      b = mps[ctx];
      state[ctx] = next_mps[st];
    } else {
      b = !mps[ctx];
      value -= range;
      range = r;
      if (st == 0) mps[ctx] = !mps[ctx];
      state[ctx] = next_lps[st];
    }
    while (range < kQuarter) {
      range <<= 1;
      value = (value << 1) | read1();
    }
    return b;
  }
  int bypass() {
    value = (value << 1) | read1();
    if (value >= range) { value -= range; return 1; }
    return 0;
  }
};

inline int imin(int a, int b) { return a < b ? a : b; }

}  // namespace

extern "C" {

// Encode a plane of cy*cx 4x4 zig-zag level blocks (int32 [cy*cx*16]).
// Returns the number of bytes written into out, or -1 on overflow.
int64_t cabac_encode_plane(const int32_t* zz, int cy, int cx,
                           const uint8_t* rlps, const uint8_t* next_mps,
                           const uint8_t* next_lps, uint8_t* out,
                           int64_t out_cap, uint8_t* cbf_scratch) {
  CabacEnc e{rlps, next_mps, next_lps, out, out_cap};
  for (int by = 0; by < cy; by++) {
    for (int bx = 0; bx < cx; bx++) {
      const int32_t* blk = zz + (int64_t)(by * cx + bx) * 16;
      int last = -1;
      for (int i = 15; i >= 0; i--)
        if (blk[i]) { last = i; break; }
      int cbf = last >= 0;
      int ca = bx > 0 ? cbf_scratch[by * cx + bx - 1] : 0;
      int cb = by > 0 ? cbf_scratch[(by - 1) * cx + bx] : 0;
      e.bit(kCtxCbf + ca + 2 * cb, cbf);
      cbf_scratch[by * cx + bx] = (uint8_t)cbf;
      if (!cbf) continue;
      for (int i = 0; i < 15; i++) {
        int sig = blk[i] != 0;
        e.bit(kCtxSig + i, sig);
        if (sig) {
          e.bit(kCtxLast + i, i == last);
          if (i == last) break;
        }
      }
      int num_eq1 = 0, num_gt1 = 0;
      for (int i = last; i >= 0; i--) {
        if (!blk[i]) continue;
        int v = blk[i];
        int a = (v < 0 ? -v : v) - 1;
        int c0 = num_gt1 ? kCtxAbs : kCtxAbs + imin(4, 1 + num_eq1);
        int cn = kCtxAbs + 5 + imin(4, num_gt1);
        if (a == 0) {
          e.bit(c0, 0);
        } else {
          e.bit(c0, 1);
          for (int j = 0; j < imin(a, 14) - 1; j++) e.bit(cn, 1);
          if (a < 14) {
            e.bit(cn, 0);
          } else {
            int x = a - 14, k = 0;
            while (x >= (1 << k)) { e.bypass(1); x -= 1 << k; k++; }
            e.bypass(0);
            for (int i2 = k - 1; i2 >= 0; i2--) e.bypass((x >> i2) & 1);
          }
        }
        e.bypass(v < 0);
        if (a == 0) num_eq1++; else num_gt1++;
      }
    }
  }
  return e.flush();
}

// Decode cy*cx blocks from data into zz_out (int32 [cy*cx*16], pre-zeroed
// by the caller).  Returns 0, or -1 on error.
int64_t cabac_decode_plane(const uint8_t* data, int64_t nbytes, int cy, int cx,
                           const uint8_t* rlps, const uint8_t* next_mps,
                           const uint8_t* next_lps, int32_t* zz_out,
                           uint8_t* cbf_scratch) {
  CabacDec d{rlps, next_mps, next_lps, data, nbytes};
  d.init();
  for (int by = 0; by < cy; by++) {
    for (int bx = 0; bx < cx; bx++) {
      int ca = bx > 0 ? cbf_scratch[by * cx + bx - 1] : 0;
      int cb = by > 0 ? cbf_scratch[(by - 1) * cx + bx] : 0;
      int cbf = d.bit(kCtxCbf + ca + 2 * cb);
      cbf_scratch[by * cx + bx] = (uint8_t)cbf;
      if (!cbf) continue;
      int32_t* blk = zz_out + (int64_t)(by * cx + bx) * 16;
      uint8_t sig[16] = {0};
      int last = 15;
      bool found_last = false;
      for (int i = 0; i < 15; i++) {
        if (d.bit(kCtxSig + i)) {
          sig[i] = 1;
          if (d.bit(kCtxLast + i)) { last = i; found_last = true; break; }
        }
      }
      if (!found_last) sig[15] = 1;
      int num_eq1 = 0, num_gt1 = 0;
      for (int i = last; i >= 0; i--) {
        if (!sig[i]) continue;
        int c0 = num_gt1 ? kCtxAbs : kCtxAbs + imin(4, 1 + num_eq1);
        int cn = kCtxAbs + 5 + imin(4, num_gt1);
        int a;
        if (d.bit(c0) == 0) {
          a = 0;
        } else {
          a = 1;
          while (a < 14 && d.bit(cn)) a++;
          if (a == 14) {
            int k = 0;
            while (d.bypass()) { a += 1 << k; k++; }
            int x = 0;
            for (int j = 0; j < k; j++) x = (x << 1) | d.bypass();
            a += x;
          }
        }
        int sign = d.bypass();
        blk[i] = sign ? -(a + 1) : (a + 1);
        if (a == 0) num_eq1++; else num_gt1++;
      }
    }
  }
  return 0;
}

// Emulation prevention (Annex-B EBSP), semantics of the reference's
// RBSPtoEBSP (FR/src/nal.c) / EBSPtoRBSP (decoder half): insert 0x03 after
// any 00 00 when the next byte is <= 0x03; stripping removes it.  Out buffer
// must hold n + n/2 + 16 bytes.  Returns output length.
int64_t ep_insert(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t j = 0;
  int zeros = 0;
  for (int64_t i = 0; i < n; i++) {
    if (zeros == 2 && in[i] <= 3) {
      out[j++] = 3;
      zeros = 0;
    }
    out[j++] = in[i];
    zeros = in[i] == 0 ? zeros + 1 : 0;
  }
  return j;
}

int64_t ep_strip(const uint8_t* in, int64_t n, uint8_t* out) {
  int64_t j = 0;
  int zeros = 0;
  for (int64_t i = 0; i < n; i++) {
    if (zeros == 2 && in[i] == 3) {
      zeros = 0;
      continue;  // drop the emulation-prevention byte
    }
    out[j++] = in[i];
    zeros = in[i] == 0 ? zeros + 1 : 0;
  }
  return j;
}

// Resolve MPM-coded intra modes: flags uint8 [cy*cx] (1 = use mpm),
// rem uint8 [n_rem] consumed in raster order for flag==0 blocks.
// modes_out int32 [cy*cx].
void resolve_intra_modes(const uint8_t* flags, const uint8_t* rem, int cy,
                         int cx, int32_t* modes_out) {
  int64_t ri = 0;
  for (int y = 0; y < cy; y++) {
    for (int x = 0; x < cx; x++) {
      int left = x > 0 ? modes_out[y * cx + x - 1] : 2;
      int top = y > 0 ? modes_out[(y - 1) * cx + x] : 2;
      int mpm = left < top ? left : top;
      if (flags[y * cx + x]) {
        modes_out[y * cx + x] = mpm;
      } else {
        int v = rem[ri++];
        modes_out[y * cx + x] = v < mpm ? v : v + 1;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// CAVLC plane ENCODER (port of h264tpu/entropy/cavlc.py encode_plane /
// encode_blocks; semantics mirror those vectorized numpy writers exactly,
// emitting (codeword, bitlen) symbol pairs the python BitWriter packs).
// ---------------------------------------------------------------------------

namespace {

inline void level_code(int64_t level, int vlcnum, int64_t* code,
                       int64_t* len) {
  int64_t sign = level < 0 ? 1 : 0;
  int64_t labs = level < 0 ? -level : level;
  if (vlcnum == 0) {                       // VLC1
    if (labs < 8) {
      *len = labs * 2 + sign - 1;
      *code = 1;
    } else if (labs < 16) {
      *len = 19;
      *code = 16 | ((labs << 1) - 16) | sign;
    } else {
      int64_t lm16 = labs + 2032;
      int np_ = 0;
      while (lm16 >= ((int64_t)4096 << np_)) np_++;
      int64_t imask = (int64_t)4096 << np_;
      *len = 28 + (np_ << 1);
      *code = imask | ((lm16 << 1) - imask) | sign;
    }
  } else {                                 // VLCN
    int64_t labn = labs - 1;
    int shift = vlcnum - 1;
    int64_t escape = (int64_t)15 << shift;
    int64_t sufmask = ~((int64_t)(-1) << shift);
    if (labn < escape) {
      *len = (labn >> shift) + 1 + vlcnum;
      *code = ((int64_t)2 << shift) | ((labn & sufmask) << 1) | sign;
    } else {
      int64_t lesc = labn - escape + 2048;
      int np_ = 0;
      while (lesc >= ((int64_t)4096 << np_)) np_++;
      int64_t imask = (int64_t)4096 << np_;
      *len = 28 + (np_ << 1);
      *code = imask | ((lesc << 1) - imask) | sign;
    }
  }
}

const int kIncVlc[7] = {0, 3, 6, 12, 24, 48, 32768};

}  // namespace

extern "C" {

// codes/lens: int64 [cy*cx*36] (36 symbol slots per block; zero-length
// entries are skipped by the python packer).  Returns 0.
int64_t cavlc_encode_plane(const int32_t* zz, int cy, int cx,
                           const uint8_t* tok_len, const int32_t* tok_code,
                           const uint8_t* tz_len, const int32_t* tz_code,
                           const uint8_t* rb_len, const int32_t* rb_code,
                           int64_t* codes, int64_t* lens,
                           int32_t* total_scratch) {
  const int MAXS = 36;
  for (int by = 0; by < cy; by++) {
    for (int bx = 0; bx < cx; bx++) {
      int bi = by * cx + bx;
      const int32_t* b = zz + (int64_t)bi * 16;
      int64_t* C = codes + (int64_t)bi * MAXS;
      int64_t* L = lens + (int64_t)bi * MAXS;
      for (int s = 0; s < MAXS; s++) { C[s] = 0; L[s] = 0; }

      // fields
      int total = 0;
      int pos[16];
      int64_t lev[16];
      for (int k = 0; k < 16; k++)
        if (b[k]) { pos[total] = k; lev[total] = b[k]; total++; }
      total_scratch[bi] = total;
      int total_zeros = total > 0 ? pos[total - 1] + 1 - total : 0;
      int t1 = 0;
      int t1_signs[3] = {0, 0, 0};
      for (int j = 0; j < 3; j++) {
        int k = total - 1 - j;
        if (k < 0) break;
        int64_t lv = lev[k];
        if (lv != 1 && lv != -1) break;
        t1_signs[j] = lv < 0 ? 1 : 0;
        t1++;
      }

      // nC (in-plane left/top TotalCoeff context)
      int nA = bx > 0 ? total_scratch[bi - 1] : 0;
      int nB = by > 0 ? total_scratch[bi - cx] : 0;
      int nc;
      if (bx > 0 && by > 0) nc = (nA + nB + 1) >> 1;
      else if (bx > 0) nc = nA;
      else if (by > 0) nc = nB;
      else nc = 0;

      int s = 0;
      // coeff_token
      if (nc >= 8) {
        C[s] = total > 0 ? (((int64_t)(total - 1) << 2) | t1) : 3;
        L[s] = 6;
      } else {
        int vt = nc < 2 ? 0 : (nc < 4 ? 1 : 2);
        C[s] = tok_code[(vt * 4 + t1) * 17 + total];
        L[s] = tok_len[(vt * 4 + t1) * 17 + total];
      }
      s++;
      // trailing-one signs
      for (int j = 0; j < t1; j++) { C[s] = t1_signs[j]; L[s] = 1; s++; }
      // levels, rank total-1-t1 down to 0
      int vlcnum = (total > 10 && t1 < 3) ? 1 : 0;
      bool first = true;
      bool lth = !(total > 3 && t1 == 3);
      for (int k = total - 1 - t1; k >= 0; k--) {
        int64_t lv = lev[k];
        int64_t adj = lv;
        if (first && lth) adj = lv > 0 ? lv - 1 : lv + 1;
        level_code(adj, vlcnum, &C[s], &L[s]);
        s++;
        int64_t labs = lv < 0 ? -lv : lv;
        if (labs > kIncVlc[vlcnum < 6 ? vlcnum : 6]) vlcnum++;
        if (first && labs > 3 && vlcnum < 2) vlcnum = 2;
        first = false;
      }
      // total_zeros
      if (total > 0 && total < 16) {
        int row = total - 1;
        C[s] = tz_code[row * 16 + total_zeros];
        L[s] = tz_len[row * 16 + total_zeros];
        s++;
      }
      // run_before
      int zerosleft = total_zeros;
      for (int k = total - 1; k >= 1 && zerosleft > 0; k--) {
        int run = pos[k] - pos[k - 1] - 1;
        int row = zerosleft - 1;
        if (row > 6) row = 6;
        C[s] = rb_code[row * 16 + run];
        L[s] = rb_len[row * 16 + run];
        s++;
        zerosleft -= run;
      }
    }
  }
  return 0;
}

}  // extern "C"
