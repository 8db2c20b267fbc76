// Native host stages of the conformant AVC encoder in the PyTorch port.
//
// Two inherently serial host stages (h264tpu_torch/avc/device_enc.py makes
// every decision on the device):
//
//  1. avc_pack_slice — variable-length packing of the per-MB symbol
//     arrays into an H.264 slice RBSP (CAVLC, spec 7.3.5/9.2), byte for
//     byte the output of the numpy twin h264tpu_torch/avc/pack.py; every
//     VLC table is passed in from Python (h264tpu_torch/entropy/cavlc.py,
//     h264tpu_torch/avc/tables.py), so the spec constants have one source.
//     Reference semantics: JM/lencod/src/macroblock.c write_one_macroblock,
//     vlc.c writeCoeff4x4_CAVLC / writeSyntaxElement_Level_VLCN.
//
//  2. avc_deblock_frame — the spec 8.7 in-loop filter in MB-raster
//     order, plane for plane the output of h264tpu_torch/avc/deblock.py
//     (JM/ldecod/src/loop_filter_normal.c semantics).
//
// The body below is a copy of the JAX package's native/avc_native.cpp.
// h264tpu_torch/avc/native.py builds it at first use with
// g++ -O2 -fPIC -shared -std=c++17 into h264tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// ---------------------------------------------------------------------------
// Bit writer (continues after a Python-written header)
// ---------------------------------------------------------------------------

struct BW {
  uint8_t* buf;
  int64_t cap;      // bytes
  int64_t pos;      // bit position
  bool overflow = false;

  void put(uint64_t val, int nbits) {
    if (nbits <= 0) return;
    if (((pos + nbits + 7) >> 3) > cap) { overflow = true; return; }
    for (int i = nbits - 1; i >= 0; --i) {
      int bit = (val >> i) & 1;
      buf[pos >> 3] |= (uint8_t)(bit << (7 - (pos & 7)));
      pos++;
    }
  }
  void ue(uint32_t v) {
    uint32_t vp1 = v + 1;
    int n = 0;
    while ((vp1 >> n) > 1) n++;
    put(vp1, 2 * n + 1);
  }
  void se(int32_t v) {
    uint32_t k = v > 0 ? 2 * (uint32_t)v - 1 : (uint32_t)(-2 * (int64_t)v);
    ue(k);
  }
};

// ---------------------------------------------------------------------------
// Table bundle (offsets match h264tpu/avc/native.py _tables_buffer)
// ---------------------------------------------------------------------------

struct Tabs {
  const int32_t* tok_len;    // [3][4][17]
  const int32_t* tok_code;
  const int32_t* tz_len;     // [15][16]
  const int32_t* tz_code;
  const int32_t* rb_len;     // [7][16]
  const int32_t* rb_code;
  const int32_t* cdc_tok_len;   // [4][5]
  const int32_t* cdc_tok_code;
  const int32_t* cdc_tz_len;    // [3][4]
  const int32_t* cdc_tz_code;
  const int32_t* cbp_intra;     // [48]
  const int32_t* cbp_inter;     // [48]
  const int32_t* inc_vlc;       // [7]
  const int32_t* scan_y;        // [16]
  const int32_t* scan_x;        // [16]
};

Tabs load_tabs(const int32_t* t) {
  Tabs s;
  s.tok_len = t;            t += 3 * 4 * 17;
  s.tok_code = t;           t += 3 * 4 * 17;
  s.tz_len = t;             t += 15 * 16;
  s.tz_code = t;            t += 15 * 16;
  s.rb_len = t;             t += 7 * 16;
  s.rb_code = t;            t += 7 * 16;
  s.cdc_tok_len = t;        t += 4 * 5;
  s.cdc_tok_code = t;       t += 4 * 5;
  s.cdc_tz_len = t;         t += 3 * 4;
  s.cdc_tz_code = t;        t += 3 * 4;
  s.cbp_intra = t;          t += 48;
  s.cbp_inter = t;          t += 48;
  s.inc_vlc = t;            t += 7;
  s.scan_y = t;             t += 16;
  s.scan_x = t;
  return s;
}

// ---------------------------------------------------------------------------
// CAVLC residual block writer (port of avc/cavlc.py write_block)
// ---------------------------------------------------------------------------

void write_level(BW& w, int level, int vlcnum) {
  int sign = level < 0 ? 1 : 0;
  int labs = level < 0 ? -level : level;
  if (vlcnum == 0) {
    if (labs < 8) {
      w.put(1, labs * 2 + sign - 1);
    } else if (labs < 16) {
      w.put(16 | ((labs << 1) - 16) | sign, 19);
    } else {
      int64_t lm16 = labs + 2032;
      int npfx = 0;
      while (lm16 >= ((int64_t)4096 << npfx)) npfx++;
      int64_t imask = (int64_t)4096 << npfx;
      w.put((uint64_t)(imask | ((lm16 << 1) - imask) | sign),
            28 + (npfx << 1));
    }
    return;
  }
  int shift = vlcnum - 1;
  int64_t escape = (int64_t)15 << shift;
  int64_t labn = labs - 1;
  if (labn < escape) {
    int64_t sufmask = ((int64_t)1 << shift) - 1;
    w.put((uint64_t)(((int64_t)2 << shift) | ((labn & sufmask) << 1) | sign),
          (int)(labn >> shift) + 1 + vlcnum);
  } else {
    int64_t lesc = labn - escape + 2048;
    int npfx = 0;
    while (lesc >= ((int64_t)4096 << npfx)) npfx++;
    int64_t imask = (int64_t)4096 << npfx;
    w.put((uint64_t)(imask | ((lesc << 1) - imask) | sign),
          28 + (npfx << 1));
  }
}

// zz: scan-order levels, n of them; nc == -1 means chroma DC tables.
// Returns TotalCoeff.
int write_block(BW& w, const int32_t* zz, int n, int nc, const Tabs& T) {
  int pos[16], levels[16], runs[16];
  int total = 0;
  for (int i = 0; i < n; i++) {
    if (zz[i] != 0) {
      pos[total] = i;
      levels[total] = zz[i];
      total++;
    }
  }
  int total_zeros = total ? pos[total - 1] + 1 - total : 0;
  for (int i = 0; i < total; i++)
    runs[i] = i == 0 ? pos[0] : pos[i] - pos[i - 1] - 1;
  int t1 = 0;
  int signs[3];
  for (int i = total - 1; i >= 0 && t1 < 3; --i) {
    int lv = levels[i];
    if (lv == 1 || lv == -1) signs[t1++] = lv < 0 ? 1 : 0;
    else break;
  }

  if (nc == -1) {
    w.put((uint64_t)T.cdc_tok_code[t1 * 5 + total],
          T.cdc_tok_len[t1 * 5 + total]);
  } else {
    int vt = nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3));
    if (vt == 3) {
      w.put(total > 0 ? (uint64_t)(((total - 1) << 2) | t1) : 3, 6);
    } else {
      w.put((uint64_t)T.tok_code[(vt * 4 + t1) * 17 + total],
            T.tok_len[(vt * 4 + t1) * 17 + total]);
    }
  }
  if (total == 0) return 0;

  for (int i = 0; i < t1; i++) w.put(signs[i], 1);

  int vlcnum = (total > 10 && t1 < 3) ? 1 : 0;
  bool first = true;
  bool lth = !(total > 3 && t1 == 3);
  for (int k = total - 1 - t1; k >= 0; --k) {
    int lv = levels[k];
    int adj = (first && lth) ? (lv > 0 ? lv - 1 : lv + 1) : lv;
    write_level(w, adj, vlcnum);
    first = false;
    int labs = lv < 0 ? -lv : lv;
    int cap = vlcnum < 6 ? vlcnum : 6;
    if (labs > T.inc_vlc[cap]) vlcnum++;
    if (k == total - 1 - t1 && labs > 3 && vlcnum < 2) vlcnum = 2;
  }

  if (total < n) {
    if (nc == -1) {
      w.put((uint64_t)T.cdc_tz_code[(total - 1) * 4 + total_zeros],
            T.cdc_tz_len[(total - 1) * 4 + total_zeros]);
    } else {
      w.put((uint64_t)T.tz_code[(total - 1) * 16 + total_zeros],
            T.tz_len[(total - 1) * 16 + total_zeros]);
    }
  }

  int zerosleft = total_zeros;
  for (int k = total - 1; k >= 1; --k) {
    if (zerosleft <= 0) break;
    int run = runs[k];
    int row = zerosleft - 1 < 6 ? zerosleft - 1 : 6;
    w.put((uint64_t)T.rb_code[row * 16 + run], T.rb_len[row * 16 + run]);
    zerosleft -= run;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Slice packing (port of avc/pack.py)
// ---------------------------------------------------------------------------

struct Sym {
  const int32_t *win, *ri, *mvd, *i4flags, *i16mode, *i16dc, *cmode,
      *cbp_luma, *cbp_chroma, *zz, *cdc, *cac;
};

struct Ctx {
  int mb_w, mb_h, row0;
  int* nnz_y;       // [mb_h*4][mb_w*4]
  int* nnz_c;       // [2][mb_h*2][mb_w*2]
};

int nc_luma(const Ctx& c, int by, int bx) {
  bool ha = bx > 0, hb = by > c.row0 * 4;
  int w4 = c.mb_w * 4;
  int na = ha ? c.nnz_y[by * w4 + bx - 1] : 0;
  int nb = hb ? c.nnz_y[(by - 1) * w4 + bx] : 0;
  if (ha && hb) return (na + nb + 1) >> 1;
  return ha ? na : (hb ? nb : 0);
}

int nc_chroma(const Ctx& c, int ci, int by, int bx) {
  bool ha = bx > 0, hb = by > c.row0 * 2;
  int w2 = c.mb_w * 2, h2 = c.mb_h * 2;
  int na = ha ? c.nnz_c[(ci * h2 + by) * w2 + bx - 1] : 0;
  int nb = hb ? c.nnz_c[(ci * h2 + by - 1) * w2 + bx] : 0;
  if (ha && hb) return (na + nb + 1) >> 1;
  return ha ? na : (hb ? nb : 0);
}

void write_luma_residual(BW& w, const Ctx& c, const Tabs& T,
                         const int32_t* zz_mb, int cbp_luma, int mby,
                         int mbx, bool i16, const int32_t* i16dc) {
  if (i16) {
    int nc = nc_luma(c, mby * 4, mbx * 4);
    write_block(w, i16dc, 16, nc, T);
  }
  for (int k = 0; k < 16; k++) {
    int y4 = T.scan_y[k], x4 = T.scan_x[k];
    int by = mby * 4 + y4, bx = mbx * 4 + x4;
    int b8 = (y4 / 2) * 2 + (x4 / 2);
    if (i16) {
      if (cbp_luma) {
        int nc = nc_luma(c, by, bx);
        write_block(w, zz_mb + k * 16, 15, nc, T);
      }
    } else if (cbp_luma & (1 << b8)) {
      int nc = nc_luma(c, by, bx);
      write_block(w, zz_mb + k * 16, 16, nc, T);
    }
  }
}

void write_chroma_residual(BW& w, const Ctx& c, const Tabs& T,
                           const int32_t* cdc, const int32_t* cac,
                           int cbp_chroma, int mby, int mbx) {
  if (cbp_chroma > 0)
    for (int ci = 0; ci < 2; ci++)
      write_block(w, cdc + ci * 4, 4, -1, T);
  if (cbp_chroma == 2)
    for (int ci = 0; ci < 2; ci++)
      for (int by4 = 0; by4 < 2; by4++)
        for (int bx4 = 0; bx4 < 2; bx4++) {
          int nc = nc_chroma(c, ci, mby * 2 + by4, mbx * 2 + bx4);
          write_block(w, cac + ((ci * 2 + by4) * 2 + bx4) * 15, 15, nc, T);
        }
}

void write_intra_payload(BW& w, const Ctx& c, const Tabs& T, const Sym& S,
                         int mby, int mbx, int i, bool use_i16, bool in_p,
                         int transform8) {
  int cbp_luma = S.cbp_luma[i];
  int cbp_chroma = S.cbp_chroma[i];
  int base = in_p ? 5 : 0;
  if (use_i16) {
    int mt = 1 + S.i16mode[i] + 4 * cbp_chroma + 12 * (cbp_luma != 0);
    w.ue(base + mt);
  } else {
    w.ue(base + 0);
    if (transform8) w.put(0, 1);  // transform_size_8x8_flag: I4x4
    const int32_t* fl = S.i4flags + i * 32;
    for (int k = 0; k < 16; k++) {
      w.put(fl[k * 2], 1);
      if (!fl[k * 2]) w.put(fl[k * 2 + 1], 3);
    }
  }
  w.ue(S.cmode[i]);
  if (!use_i16) {
    int cbp = cbp_luma | (cbp_chroma << 4);
    w.ue(T.cbp_intra[cbp]);
    if (cbp > 0) w.se(0);
  } else {
    w.se(0);
  }
  write_luma_residual(w, c, T, S.zz + i * 256, cbp_luma, mby, mbx, use_i16,
                      S.i16dc + i * 16);
  write_chroma_residual(w, c, T, S.cdc + i * 8, S.cac + i * 120, cbp_chroma,
                        mby, mbx);
}

}  // namespace

extern "C" {

// slice_type: 2 = I (all-intra), 0 = P.  hdr: pre-written header bits.
// Returns RBSP byte length (incl. rbsp_stop bit + padding), -1 on overflow.
int64_t avc_pack_slice(int32_t slice_type, int32_t mb_w, int32_t mb_h,
                       int32_t row0, int32_t n_rows, int32_t num_ref,
                       const uint8_t* hdr, int64_t hdr_bits,
                       const int32_t* win, const int32_t* ri,
                       const int32_t* mvd, const int32_t* i4flags,
                       const int32_t* i16mode, const int32_t* i16dc,
                       const int32_t* cmode, const int32_t* cbp_luma,
                       const int32_t* cbp_chroma, const int32_t* zz,
                       const int32_t* cdc, const int32_t* cac,
                       const int32_t* t8, int32_t transform8,
                       const int32_t* tables, uint8_t* out, int64_t cap) {
  Tabs T = load_tabs(tables);
  Sym S{win, ri, mvd, i4flags, i16mode, i16dc, cmode,
        cbp_luma, cbp_chroma, zz, cdc, cac};
  memset(out, 0, cap);
  BW w{out, cap, 0};
  // copy header bits
  for (int64_t b = 0; b < hdr_bits; b++)
    w.put((hdr[b >> 3] >> (7 - (b & 7))) & 1, 1);

  // nnz planes from symbols (decoder-visible TotalCoeff)
  int h4 = mb_h * 4, w4 = mb_w * 4, h2 = mb_h * 2, w2 = mb_w * 2;
  int* nnz_y = (int*)calloc((size_t)h4 * w4, sizeof(int));
  int* nnz_c = (int*)calloc((size_t)2 * h2 * w2, sizeof(int));
  for (int i = 0; i < mb_h * mb_w; i++) {
    int mby = i / mb_w, mbx = i % mb_w;
    for (int k = 0; k < 16; k++) {
      int cnt = 0;
      for (int j = 0; j < 16; j++) cnt += zz[(i * 16 + k) * 16 + j] != 0;
      nnz_y[(mby * 4 + T.scan_y[k]) * w4 + mbx * 4 + T.scan_x[k]] = cnt;
    }
    for (int ci = 0; ci < 2; ci++)
      for (int by4 = 0; by4 < 2; by4++)
        for (int bx4 = 0; bx4 < 2; bx4++) {
          int cnt = 0;
          const int32_t* a = cac + (((i * 2 + ci) * 2 + by4) * 2 + bx4) * 15;
          for (int j = 0; j < 15; j++) cnt += a[j] != 0;
          nnz_c[(ci * h2 + mby * 2 + by4) * w2 + mbx * 2 + bx4] = cnt;
        }
  }
  Ctx c{mb_w, mb_h, row0, nnz_y, nnz_c};

  int skip_run = 0;
  for (int i = row0 * mb_w; i < (row0 + n_rows) * mb_w; i++) {
    int mby = i / mb_w, mbx = i % mb_w;
    int wc = win[i];
    if (slice_type == 0 && wc == 0) { skip_run++; continue; }
    if (slice_type == 0) { w.ue(skip_run); skip_run = 0; }
    if (wc == 5 || wc == 6) {
      write_intra_payload(w, c, T, S, mby, mbx, i, wc == 6,
                          slice_type == 0, transform8);
      continue;
    }
    // inter MB (P slice)
    int mb_type = wc - 1;                 // 1..4 -> 0..3
    w.ue(mb_type);
    int nparts = wc == 1 ? 1 : (wc == 4 ? 4 : 2);
    if (wc == 4)
      for (int p = 0; p < 4; p++) w.ue(0);
    if (num_ref > 1) {
      int r = ri[i];
      for (int p = 0; p < nparts; p++) {
        if (num_ref == 2) w.put(1 - r, 1);
        else w.ue(r);
      }
    }
    for (int p = 0; p < nparts; p++) {
      w.se(mvd[(i * 4 + p) * 2 + 0]);
      w.se(mvd[(i * 4 + p) * 2 + 1]);
    }
    int cbp = cbp_luma[i] | (cbp_chroma[i] << 4);
    w.ue(T.cbp_inter[cbp]);
    if (cbp > 0) {
      // every inter shape we emit is >= 8x8, so the flag is always
      // present when luma is coded (spec 7.3.5)
      if (transform8 && cbp_luma[i] > 0) w.put(t8[i], 1);
      w.se(0);
      write_luma_residual(w, c, T, S.zz + i * 256, cbp_luma[i], mby, mbx,
                          false, nullptr);
      write_chroma_residual(w, c, T, S.cdc + i * 8, S.cac + i * 120,
                            cbp_chroma[i], mby, mbx);
    }
  }
  if (slice_type == 0 && skip_run > 0) w.ue(skip_run);
  w.put(1, 1);                            // rbsp_stop_one_bit
  free(nnz_y);
  free(nnz_c);
  if (w.overflow) return -1;
  return (w.pos + 7) >> 3;
}

// ---------------------------------------------------------------------------
// Deblocking (port of avc/deblock.py; spec 8.7 MB-raster order)
// ---------------------------------------------------------------------------

static void filter_edge(int32_t* plane, int stride, int x0, int y0, int n,
                        bool vertical, const int* bs, int index_a,
                        int index_b, bool luma, const int32_t* alpha_tab,
                        const int32_t* beta_tab, const int32_t* clip_tab) {
  int alpha = alpha_tab[index_a];
  int beta = beta_tab[index_b];
  for (int l = 0; l < n; l++) {
    int b = bs[l];
    if (b == 0) continue;
    int32_t* base = vertical ? plane + (y0 + l) * stride + x0
                             : plane + y0 * stride + x0 + l;
    int st = vertical ? 1 : stride;
    int p3 = base[-4 * st], p2 = base[-3 * st], p1 = base[-2 * st],
        p0 = base[-1 * st];
    int q0 = base[0], q1 = base[1 * st], q2 = base[2 * st], q3 = base[3 * st];
    int d0 = p0 > q0 ? p0 - q0 : q0 - p0;
    if (!(d0 < alpha && abs(p1 - p0) < beta && abs(q1 - q0) < beta)) continue;
    bool ap = abs(p2 - p0) < beta;
    bool aq = abs(q2 - q0) < beta;
    if (b == 4) {
      bool small = d0 < ((alpha >> 2) + 2);
      int np0, np1 = p1, np2 = p2, nq0, nq1 = q1, nq2 = q2;
      if (luma) {
        bool sp = small && ap, sq = small && aq;
        np0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                 : (2 * p1 + p0 + q1 + 2) >> 2;
        nq0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                 : (2 * q1 + q0 + p1 + 2) >> 2;
        if (sp) {
          np1 = (p2 + p1 + p0 + q0 + 2) >> 2;
          np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
        }
        if (sq) {
          nq1 = (q2 + q1 + q0 + p0 + 2) >> 2;
          nq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
        }
      } else {
        np0 = (2 * p1 + p0 + q1 + 2) >> 2;
        nq0 = (2 * q1 + q0 + p1 + 2) >> 2;
      }
      base[-3 * st] = np2; base[-2 * st] = np1; base[-1 * st] = np0;
      base[0] = nq0; base[1 * st] = nq1; base[2 * st] = nq2;
    } else {
      int tc0 = clip_tab[index_a * 5 + (b < 4 ? b : 4)];
      int tc = luma ? tc0 + (ap ? 1 : 0) + (aq ? 1 : 0) : tc0 + 1;
      int delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3;
      if (delta < -tc) delta = -tc;
      if (delta > tc) delta = tc;
      int np0 = p0 + delta;
      int nq0 = q0 - delta;
      np0 = np0 < 0 ? 0 : (np0 > 255 ? 255 : np0);
      nq0 = nq0 < 0 ? 0 : (nq0 > 255 ? 255 : nq0);
      base[-1 * st] = np0;
      base[0] = nq0;
      if (luma) {
        if (ap) {
          int d = (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1;
          if (d < -tc0) d = -tc0;
          if (d > tc0) d = tc0;
          base[-2 * st] = p1 + d;
        }
        if (aq) {
          int d = (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1;
          if (d < -tc0) d = -tc0;
          if (d > tc0) d = tc0;
          base[1 * st] = q1 + d;
        }
      }
    }
  }
}

static const int32_t QP_SCALE_CR[52] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32, 32, 33,
    34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};

int64_t avc_deblock_frame(int32_t* y, int32_t* u, int32_t* v, int32_t mb_w,
                          int32_t mb_h, const int32_t* mb_qp,
                          const uint8_t* mb_intra, const uint8_t* t8,
                          const int32_t* nnz,
                          const int32_t* mv, const int32_t* ref,
                          const int32_t* mv1, const int32_t* ref1,
                          int32_t chroma_qp_offset, int32_t alpha_off,
                          int32_t beta_off, const int32_t* alpha_tab,
                          const int32_t* beta_tab, const int32_t* clip_tab) {
  int W = mb_w * 16, w4 = mb_w * 4, w2c = mb_w * 8;
  auto mv_far = [&](const int32_t* a, int ia, const int32_t* b, int ib) {
    return abs(a[ia * 2] - b[ib * 2]) >= 4 ||
           abs(a[ia * 2 + 1] - b[ib * 2 + 1]) >= 4;
  };
  auto bs_edge = [&](int by_p, int bx_p, int by_q, int bx_q, bool mb_edge) {
    bool intra = mb_intra[(by_p / 4) * mb_w + bx_p / 4] ||
                 mb_intra[(by_q / 4) * mb_w + bx_q / 4];
    if (intra) return mb_edge ? 4 : 3;
    bool coded = nnz[by_p * w4 + bx_p] > 0 || nnz[by_q * w4 + bx_q] > 0;
    if (coded) return 2;
    int ip = by_p * w4 + bx_p, iq = by_q * w4 + bx_q;
    if (ref1 == nullptr) {
      bool moved = mv_far(mv, ip, mv, iq) || ref[ip] != ref[iq];
      return moved ? 1 : 0;
    }
    // two-list derivation (B pictures; twin of avc/deblock.py _bs_edge):
    // ref/ref1 hold PICTURE ids, -1 = list unused
    int rp0 = ref[ip], rp1 = ref1[ip], rq0 = ref[iq], rq1 = ref1[iq];
    int lo_p = rp0 < rp1 ? rp0 : rp1, hi_p = rp0 < rp1 ? rp1 : rp0;
    int lo_q = rq0 < rq1 ? rq0 : rq1, hi_q = rq0 < rq1 ? rq1 : rq0;
    if (lo_p != lo_q || hi_p != hi_q) return 1;       // different pic sets
    int n_p = (rp0 >= 0) + (rp1 >= 0), n_q = (rq0 >= 0) + (rq1 >= 0);
    if (n_p != n_q) return 1;
    bool moved;
    if (n_p == 1) {
      const int32_t* ap = rp0 >= 0 ? mv : mv1;
      const int32_t* aq = rq0 >= 0 ? mv : mv1;
      moved = mv_far(ap, ip, aq, iq);
    } else if (rp0 == rp1) {                          // same pic twice
      bool straight = mv_far(mv, ip, mv, iq) || mv_far(mv1, ip, mv1, iq);
      bool crossed = mv_far(mv, ip, mv1, iq) || mv_far(mv1, ip, mv, iq);
      moved = straight && crossed;
    } else {                                          // two distinct pics
      bool swap = (rp0 == rq1) && (rp0 != rq0);
      moved = swap
          ? (mv_far(mv, ip, mv1, iq) || mv_far(mv1, ip, mv, iq))
          : (mv_far(mv, ip, mv, iq) || mv_far(mv1, ip, mv1, iq));
    }
    return moved ? 1 : 0;
  };
  auto chroma_qp = [&](int qp) {
    int q = qp + chroma_qp_offset;
    q = q < 0 ? 0 : (q > 51 ? 51 : q);
    return (int)QP_SCALE_CR[q];
  };
  auto clip51 = [](int x) { return x < 0 ? 0 : (x > 51 ? 51 : x); };

  int bs[16];
  for (int mby = 0; mby < mb_h; mby++)
    for (int mbx = 0; mbx < mb_w; mbx++) {
      int qp = mb_qp[mby * mb_w + mbx];
      int py = mby * 16, px = mbx * 16;
      int cy = mby * 8, cx = mbx * 8;
      bool is8 = t8[mby * mb_w + mbx] != 0;
      for (int e = 0; e < 4; e++) {       // vertical edges
        if (e == 0 && mbx == 0) continue;
        // 8x8 transform: internal 4x4 luma edges unfiltered (spec 8.7)
        if (is8 && (e == 1 || e == 3)) continue;
        int x = px + 4 * e;
        bool mb_edge = e == 0;
        int qp_p = mb_edge ? mb_qp[mby * mb_w + mbx - 1] : qp;
        int qp_av = (qp_p + qp + 1) >> 1;
        int ia = clip51(qp_av + alpha_off), ib = clip51(qp_av + beta_off);
        int bxq = x / 4;
        for (int r = 0; r < 4; r++) {
          int b = bs_edge(mby * 4 + r, bxq - 1, mby * 4 + r, bxq, mb_edge);
          bs[4 * r] = bs[4 * r + 1] = bs[4 * r + 2] = bs[4 * r + 3] = b;
        }
        filter_edge(y, W, x, py, 16, true, bs, ia, ib, true, alpha_tab,
                    beta_tab, clip_tab);
        if (e == 0 || e == 2) {
          int qpc_av = (chroma_qp(qp_p) + chroma_qp(qp) + 1) >> 1;
          int iac = clip51(qpc_av + alpha_off), ibc = clip51(qpc_av + beta_off);
          int bsc[8];
          for (int r = 0; r < 4; r++) {
            bsc[2 * r] = bs[4 * r];
            bsc[2 * r + 1] = bs[4 * r];
          }
          int xc = cx + 2 * e;
          filter_edge(u, w2c, xc, cy, 8, true, bsc, iac, ibc, false,
                      alpha_tab, beta_tab, clip_tab);
          filter_edge(v, w2c, xc, cy, 8, true, bsc, iac, ibc, false,
                      alpha_tab, beta_tab, clip_tab);
        }
      }
      for (int e = 0; e < 4; e++) {       // horizontal edges
        if (e == 0 && mby == 0) continue;
        if (is8 && (e == 1 || e == 3)) continue;
        int yy = py + 4 * e;
        bool mb_edge = e == 0;
        int qp_p = mb_edge ? mb_qp[(mby - 1) * mb_w + mbx] : qp;
        int qp_av = (qp_p + qp + 1) >> 1;
        int ia = clip51(qp_av + alpha_off), ib = clip51(qp_av + beta_off);
        int byq = yy / 4;
        for (int cidx = 0; cidx < 4; cidx++) {
          int b = bs_edge(byq - 1, mbx * 4 + cidx, byq, mbx * 4 + cidx,
                          mb_edge);
          bs[4 * cidx] = bs[4 * cidx + 1] = bs[4 * cidx + 2] =
              bs[4 * cidx + 3] = b;
        }
        // reorder: bs is per 4x4 cell along x; expand to 16 columns
        int bs16[16];
        for (int cidx = 0; cidx < 4; cidx++)
          for (int k = 0; k < 4; k++) bs16[cidx * 4 + k] = bs[cidx * 4];
        filter_edge(y, W, px, yy, 16, false, bs16, ia, ib, true, alpha_tab,
                    beta_tab, clip_tab);
        if (e == 0 || e == 2) {
          int qpc_av = (chroma_qp(qp_p) + chroma_qp(qp) + 1) >> 1;
          int iac = clip51(qpc_av + alpha_off), ibc = clip51(qpc_av + beta_off);
          int bsc[8];
          for (int cidx = 0; cidx < 4; cidx++) {
            bsc[2 * cidx] = bs[4 * cidx];
            bsc[2 * cidx + 1] = bs[4 * cidx];
          }
          int yc = cy + 2 * e;
          filter_edge(u, w2c, cx, yc, 8, false, bsc, iac, ibc, false,
                      alpha_tab, beta_tab, clip_tab);
          filter_edge(v, w2c, cx, yc, 8, false, bsc, iac, ibc, false,
                      alpha_tab, beta_tab, clip_tab);
        }
      }
    }
  return 0;
}

}  // extern "C"
