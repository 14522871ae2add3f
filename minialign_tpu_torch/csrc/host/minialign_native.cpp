// Copy of native/minialign_native.cpp for minialign_tpu_torch, unchanged
// apart from these two lines; native.py builds it with g++ at first use.
// Native host-side runtime for minialign-tpu.
//
// The TPU (Pallas) kernels own the DP compute; these are the host hot
// paths the reference implements in C (minialign.c / gaba.c) and that
// CPython is too slow for at production scale:
//   * traceback  — the per-alignment mask walk (trace_core,
//                  gaba.c:3111-3239; mask semantics per dp/band.py)
//   * cigar_rle  — path ops -> CIGAR run-length encoding
//                  (gaba_parse.h:148-190 conventions)
//   * md_walk    — MD:Z tag byte string (minialign.c:5240-5298)
//   * parse_fastx— FASTA/FASTQ batch parser + 2-bit encoder
//                  (bseq_read_fasta, minialign.c:1996-2103)
//
// Exact behavioral parity with the Python implementations in
// dp/traceback.py and io/sam.py / io/bseq.py is REQUIRED and enforced
// by tests/test_native.py.
//
// Build: make -C native   (g++ -O3 -shared; loaded via ctypes)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>
#ifdef __SSE4_2__
#include <nmmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// traceback
// ---------------------------------------------------------------------------

struct TraceParams {
  int32_t W;
  int32_t model;      // 0 linear / 1 affine / 2 combined
  int32_t gi, ge, gfa, gfb, gfa_eff, gfb_eff;
};

struct TraceOut {
  int64_t plen;
  int64_t n_ops;
  int64_t dcnt, agcnt, bgcnt;
  int64_t gap_penalty;   // n_open*gi + n_ext*ge + gf_pen
  int64_t e_pen;         // ref-side gap penalty (identity estimate)
  int32_t status;        // 0 ok, 1 out-of-band (None)
};

// masks: (NB, BLK, 16) uint32 cell codes (dp/band.py _pack_codes);
// dirs: (NB,) uint32.
// path_fwd / path_rev must each hold >= 2*(ai+bj) bytes.
// path_fwd: forward-order ops 'D' (query base) / 'R' (ref base).
// path_rev: op-order reversed with diagonals kept as atomic "DR".
int trace_one(const uint32_t* masks, const uint32_t* dirs,
              int32_t nb, int32_t ihead0,
              int64_t score, int64_t ai, int64_t bj,
              const TraceParams* tp,
              char* path_fwd, char* path_rev, char* ops_out,
              TraceOut* out) {
  const int BLK = 32;
  std::memset(out, 0, sizeof(*out));
  if (score <= 0 || (ai == 0 && bj == 0)) {
    out->plen = 0;
    out->status = 0;
    return 0;
  }
  const int64_t steps = (int64_t)nb * BLK;
  // ihead_after[s+1] = ihead after step s (band p = s)
  std::vector<int32_t> ihead_after((size_t)steps + 1);
  ihead_after[0] = ihead0;
  for (int64_t s = 0; s < steps; s++) {
    int d = (dirs[s / BLK] >> (s % BLK)) & 1;
    ihead_after[s + 1] = ihead_after[s] + (1 - d);
  }
  auto dir_at = [&](int64_t pp) -> int {
    return pp >= 0 ? (int)((dirs[pp / BLK] >> (pp % BLK)) & 1) : 0;
  };
  // cell-code layout (dp/band.py _pack_codes): word r of a step packs
  // lane q = r + 16*f's 6-bit plane code at bits [8f, 8f+6)
  auto mbit = [&](int64_t pp, int mi, int qq) -> int {
    uint32_t w = masks[((pp / BLK) * BLK + (pp % BLK)) * 16
                       + (qq & 15)];
    return (w >> (((qq >> 4) << 3) + mi)) & 1;
  };
  // mask indices (dp/band.py: MK_GFA, MK_F, M_GFB, M_E, M_FO, M_EO)
  const int MK_GFA = 0, MK_F = 1, MK_GFB = 2, MK_E = 3,
            MK_FO = 4, MK_EO = 5;
  const int W = tp->W;
  const int64_t gi = tp->gi, ge = tp->ge;

  int64_t i = ai, j = bj;
  int64_t pp = i + j - 2;
  int64_t q = ihead_after[pp + 1] - i;
  if (!(0 <= q && q < W)) { out->status = 1; return 1; }

  // ops built backward into a scratch ('D', 'R', or 'X' for a diag pair)
  std::vector<char> ops;
  ops.reserve((size_t)(ai + bj));
  int64_t dcnt = 0, agcnt = 0, bgcnt = 0;
  int64_t n_open = 0, n_ext = 0, gf_pen = 0, e_pen = 0;
  bool head = true;                // gaba starts in state ts_d (d_head)

  auto move_f = [&]() { q -= (dir_at(pp) == 1 ? 0 : 1); j--; pp--; };
  auto move_e = [&]() { q += (dir_at(pp) == 1 ? 1 : 0); i--; pp--; };
  auto move_diag = [&]() {
    q += (dir_at(pp) == 1 ? 1 : 0) - (dir_at(pp - 1) == 0 ? 1 : 0);
    i--; j--; pp -= 2;
  };

  while (i > 0 || j > 0) {
    if (i == 0) {
      for (int64_t k = 0; k < j; k++) ops.push_back('D');
      bgcnt += j;
      int64_t aff = gi + j * ge;
      if (tp->model == 2 && (int64_t)tp->gfa * j < aff) {
        gf_pen += (int64_t)tp->gfa * j;
      } else {
        n_open += 1; n_ext += j;
      }
      break;
    }
    if (j == 0) {
      for (int64_t k = 0; k < i; k++) ops.push_back('R');
      agcnt += i;
      int64_t aff = gi + i * ge;
      if (tp->model == 2 && (int64_t)tp->gfb * i < aff) {
        gf_pen += (int64_t)tp->gfb * i;
        e_pen += (int64_t)tp->gfb * i;
      } else {
        n_open += 1; n_ext += i; e_pen += aff;
      }
      break;
    }
    if (!(0 <= q && q < W)) { out->status = 1; return 1; }
    // gaba's trace_core state machine (gaba.c:3123-3207): horizontal
    // (R) gaps tested in the d_head state, vertical (D) gaps only in
    // the d_tail state; gap entry takes the one-base gf branch when
    // the folded bit (gh & ~gfh) | open_next is clear, else an affine
    // run continuing while NOT (h == 0 && e == 1) at the arrived cell.
    if (head) {
      if (mbit(pp, MK_E, q) | mbit(pp, MK_GFB, q)) {
        int eb = (mbit(pp, MK_E, q) & (1 - mbit(pp, MK_GFB, q)))
               | mbit(pp, MK_EO, q);
        if (!eb) {
          ops.push_back('R'); agcnt++; gf_pen += tp->gfb_eff;
          e_pen += tp->gfb_eff;
          move_e();
        } else {
          n_open++; e_pen += gi;
          while (true) {
            ops.push_back('R'); agcnt++; n_ext++; e_pen += ge;
            move_e();
            if (i <= 0) break;
            if (!(0 <= q && q < W)) { out->status = 1; return 1; }
            int hb = mbit(pp, MK_E, q) | mbit(pp, MK_GFB, q);
            int eb2 = (mbit(pp, MK_E, q) & (1 - mbit(pp, MK_GFB, q)))
                    | mbit(pp, MK_EO, q);
            if (!hb && eb2) break;
          }
        }
      } else {
        ops.push_back('X');        // diag: backward "RD" / forward "DR"
        dcnt++;
        move_diag();
        head = false;
      }
    } else {
      if (mbit(pp, MK_F, q) | mbit(pp, MK_GFA, q)) {
        int fb = (mbit(pp, MK_F, q) & (1 - mbit(pp, MK_GFA, q)))
               | mbit(pp, MK_FO, q);
        if (!fb) {
          ops.push_back('D'); bgcnt++; gf_pen += tp->gfa_eff;
          move_f();
        } else {
          n_open++;
          while (true) {
            ops.push_back('D'); bgcnt++; n_ext++;
            move_f();
            if (j <= 0) break;
            if (!(0 <= q && q < W)) { out->status = 1; return 1; }
            int vb = mbit(pp, MK_F, q) | mbit(pp, MK_GFA, q);
            int fb2 = (mbit(pp, MK_F, q) & (1 - mbit(pp, MK_GFA, q)))
                    | mbit(pp, MK_FO, q);
            if (!vb && fb2) break;
          }
        }
      } else {
        head = true;
        continue;
      }
    }
    if (!(-1 <= q && q <= W)) { out->status = 1; return 1; }
  }

  // render forward path and the ops-reversed path
  int64_t plen = 0;
  for (char c : ops) plen += (c == 'X') ? 2 : 1;
  {
    int64_t w = plen;
    for (char c : ops) {           // ops are backward; fill from the end
      if (c == 'X') { path_fwd[--w] = 'R'; path_fwd[w - 1] = 'D'; --w; }
      else          { path_fwd[--w] = c; }
    }
  }
  {
    int64_t w = 0;
    for (char c : ops) {           // same order, diag stays "DR"
      if (c == 'X') { path_rev[w++] = 'D'; path_rev[w++] = 'R'; }
      else          { path_rev[w++] = c; }
    }
  }
  {
    int64_t w = 0;                 // pop-order tokens ('X' = pair)
    for (char c : ops) ops_out[w++] = c;
    out->n_ops = w;
  }
  out->plen = plen;
  out->dcnt = dcnt; out->agcnt = agcnt; out->bgcnt = bgcnt;
  out->gap_penalty = n_open * gi + n_ext * ge + gf_pen;
  out->e_pen = e_pen;
  out->status = 0;
  return 0;
}

// ---------------------------------------------------------------------------
// cigar RLE: forward path -> (count<<4 | op) with op 0=M 1=I 2=D,
// following io/sam.py cigar_ops (a 'D' run keeps one op back as a
// potential diagonal start; trailing lone 'D' emits 1I)
// ---------------------------------------------------------------------------

int64_t cigar_rle(const char* path, int64_t n, uint32_t* out) {
  int64_t i = 0, w = 0;
  while (i < n) {
    int64_t m = 0;
    while (i + m < n && path[i + m] == 'D') m++;
    int64_t c = m > 0 ? m - 1 : 0;
    if (c) { out[w++] = (uint32_t)(c << 4) | 1; i += c; }
    m = 0;
    while (i + m < n && path[i + m] == 'R') m++;
    if (m) { out[w++] = (uint32_t)(m << 4) | 2; i += m; }
    m = 0;
    while (i + 1 < n && path[i] == 'D' && path[i + 1] == 'R') {
      m++; i += 2;
    }
    if (m) out[w++] = (uint32_t)(m << 4) | 0;
    else if (i < n && path[i] == 'D') { out[w++] = (1u << 4) | 1; i++; }
  }
  return w;
}

// ---------------------------------------------------------------------------
// gaba reverse path parse (_parser_loop_rv, gaba_parse.h:168-190; the
// parse behind every reference printer — see io/sam.py parse_path_rv):
// scans the up-space bit path chars top-down with 64-bit window
// mechanics (del runs leave one op per window, ins runs split at 64,
// R-D pairs fold to M); chars below `off` are earlier segments, below
// the path head read as 'R' (zero bits). out: (count<<4 | op),
// op 0=M 1=I 2=D. Returns token count, or -1 on overflow.
// ---------------------------------------------------------------------------

int64_t parse_rv(const char* upath, int64_t off, int64_t plen,
                 uint32_t* out, int64_t cap) {
  auto at = [&](int64_t k) -> char {   // scan pos k (from the top)
    int64_t p = off + plen - 1 - k;
    return p >= 0 ? upath[p] : 'R';
  };
  int64_t n = 0, i = 0;
  while (i < plen) {
    int64_t start = i;
    int64_t m = 0;
    while (m < 64 && at(i + m) == 'R') m++;
    int64_t c = std::min(plen - i, m - (m > 0 ? 1 : 0));
    if (c) {
      if (n >= cap) return -1;
      out[n++] = ((uint32_t)c << 4) | 2; i += c;
    }
    m = 0;
    while (m < 64 && at(i + m) == 'D') m++;
    c = std::min(plen - i, m);
    if (c) {
      if (n >= cap) return -1;
      out[n++] = ((uint32_t)c << 4) | 1; i += c;
    }
    m = 0;
    while (at(i + m) == ((m & 1) ? 'D' : 'R')) m++;
    c = std::min(plen - i, m) & ~(int64_t)1;
    if (c) {
      if (n >= cap) return -1;
      out[n++] = ((uint32_t)(c >> 1) << 4) | 0; i += c;
    }
    if (i == start) {           // progress guard (see io/sam.py)
      if (n >= cap) return -1;
      out[n++] = (1u << 4) | (at(i) == 'R' ? 2u : 1u); i += 1;
    }
  }
  return n;
}

// parse_rv fused with ASCII rendering: the Python tuple list + per-
// token f-string formatting cost ~1.5M object constructions per 500
// records (round-3 profile); one call emits the CIGAR bytes directly.
int64_t rv_cigar(const char* upath, int64_t off, int64_t plen,
                 char* out, int64_t cap) {
  static const char OPC[3] = {'M', 'I', 'D'};
  auto at = [&](int64_t k) -> char {
    int64_t p = off + plen - 1 - k;
    return p >= 0 ? upath[p] : 'R';
  };
  auto put = [&](int64_t w, int64_t c, int op) -> int64_t {
    char buf[24];
    int k = 0;
    if (c == 0) buf[k++] = '0';
    while (c > 0) { buf[k++] = '0' + (char)(c % 10); c /= 10; }
    if (w + k + 1 > cap) return -1;
    while (k > 0) out[w++] = buf[--k];
    out[w++] = OPC[op];
    return w;
  };
  int64_t w = 0, i = 0;
  while (i < plen) {
    int64_t start = i;
    int64_t m = 0;
    while (m < 64 && at(i + m) == 'R') m++;
    int64_t c = std::min(plen - i, m - (m > 0 ? 1 : 0));
    if (c) { w = put(w, c, 2); if (w < 0) return -1; i += c; }
    m = 0;
    while (m < 64 && at(i + m) == 'D') m++;
    c = std::min(plen - i, m);
    if (c) { w = put(w, c, 1); if (w < 0) return -1; i += c; }
    m = 0;
    while (at(i + m) == ((m & 1) ? 'D' : 'R')) m++;
    c = std::min(plen - i, m) & ~(int64_t)1;
    if (c) { w = put(w, c >> 1, 0); if (w < 0) return -1; i += c; }
    if (i == start) {
      w = put(w, 1, at(i) == 'R' ? 2 : 1);
      if (w < 0) return -1;
      i += 1;
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// MD tag walk (minialign.c:5240-5298 semantics as in io/sam.py md_tag):
// rcodes/qcodes are int8 2-bit codes (>=4 = N); out gets the MD:Z value
// ---------------------------------------------------------------------------

static const char DEC_F[5] = {'A', 'C', 'G', 'T', 'N'};

static int64_t put_num(char* out, int64_t w, int64_t v) {
  char buf[24];
  int k = 0;
  if (v == 0) buf[k++] = '0';
  while (v > 0) { buf[k++] = '0' + (char)(v % 10); v /= 10; }
  while (k > 0) out[w++] = buf[--k];
  return w;
}

int64_t md_walk(const char* path, int64_t n,
                const int8_t* rcodes, const int8_t* qcodes,
                char* out) {
  int64_t w = 0, run = 0, ri = 0, qi = 0, i = 0;
  auto dec = [](int8_t c) {
    return DEC_F[c < 0 ? 0 : (c > 4 ? 4 : c)];
  };
  while (i < n) {
    // replicate cigar_ops run structure
    int64_t m = 0;
    while (i + m < n && path[i + m] == 'D') m++;
    int64_t c = m > 0 ? m - 1 : 0;
    if (c) { qi += c; i += c; }
    m = 0;
    while (i + m < n && path[i + m] == 'R') m++;
    if (m) {
      w = put_num(out, w, run); run = 0;
      out[w++] = '^';
      for (int64_t k = 0; k < m; k++) out[w++] = dec(rcodes[ri + k]);
      ri += m; i += m;
    }
    m = 0;
    while (i + 1 < n && path[i] == 'D' && path[i + 1] == 'R') {
      m++; i += 2;
    }
    if (m) {
      for (int64_t k = 0; k < m; k++) {
        if (rcodes[ri] == qcodes[qi]) run++;
        else {
          w = put_num(out, w, run);
          out[w++] = dec(rcodes[ri]);
          run = 0;
        }
        ri++; qi++;
      }
    } else if (i < n && path[i] == 'D') { qi++; i++; }
  }
  w = put_num(out, w, run);
  return w;
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ batch parser (bseq semantics, io/bseq.py parity):
// 2-bit encode with _encaf: 3 & ((c>>2) ^ (c>>1)); name = first token,
// comment = rest of header; multi-line seq/qual.
//
// Outputs: recs int64 table (n, 8): name_off, name_len, comment_off,
// comment_len, seq_off (into codes buffer), seq_len, qual_off (into
// data, concatenated into codes buffer after seq), qual_len.
// codes: int8 output buffer (caller sized >= len(data)).
// Returns record count (negative on overflow).
// ---------------------------------------------------------------------------

int64_t parse_fastx(const uint8_t* data, int64_t len, int keep_qual,
                    int64_t min_len, int64_t* recs, int64_t max_recs,
                    int8_t* codes, int64_t codes_cap) {
  int64_t i = 0, nrec = 0, cw = 0;
  // skip leading whitespace
  while (i < len && (data[i] == '\n' || data[i] == '\r' ||
                     data[i] == ' ' || data[i] == '\t')) i++;
  if (i >= len) return 0;
  const int fastq = data[i] == '@';
  auto enc = [](uint8_t c) -> int8_t {
    return (int8_t)(3 & ((c >> 2) ^ (c >> 1)));
  };
  while (i < len) {
    if (data[i] != (fastq ? '@' : '>')) { i++; continue; }
    i++;
    // header: name token (leading separators skipped, as the
    // reference's state machine does for "> name" headers), comment
    // remainder (stripped)
    while (i < len && (data[i] == ' ' || data[i] == '\t')) i++;
    int64_t name_off = i;
    while (i < len && data[i] != ' ' && data[i] != '\t' &&
           data[i] != '\n' && data[i] != '\r') i++;
    int64_t name_len = i - name_off;
    while (i < len && (data[i] == ' ' || data[i] == '\t')) i++;
    int64_t com_off = i;
    while (i < len && data[i] != '\n') i++;
    int64_t com_end = i;
    while (com_end > com_off && (data[com_end - 1] == '\r' ||
                                 data[com_end - 1] == ' ' ||
                                 data[com_end - 1] == '\t')) com_end--;
    if (i < len) i++;  // consume '\n'
    // sequence lines
    int64_t seq_off = cw;
    if (fastq) {
      while (i < len && data[i] != '+') {
        while (i < len && data[i] != '\n') {
          uint8_t c = data[i++];
          if (c != '\r' && c != ' ' && c != '\t') {
            if (cw >= codes_cap) return -1;
            codes[cw++] = enc(c);
          }
        }
        if (i < len) i++;
      }
      int64_t seq_len = cw - seq_off;
      // '+' line
      while (i < len && data[i] != '\n') i++;
      if (i < len) i++;
      // qual lines until seq_len bytes collected
      int64_t qual_off = cw, got = 0;
      while (i < len && got < seq_len) {
        while (i < len && data[i] != '\n') {
          uint8_t c = data[i++];
          if (c != '\r' && c != ' ' && c != '\t') {
            if (keep_qual) {
              if (cw >= codes_cap) return -1;
              codes[cw++] = (int8_t)c;
            }
            got++;
          }
        }
        if (i < len) i++;
      }
      int64_t qual_len = keep_qual ? cw - qual_off : 0;
      if (seq_len >= min_len) {
        if (nrec >= max_recs) return -2;
        int64_t* r = recs + nrec * 8;
        r[0] = name_off; r[1] = name_len;
        r[2] = com_off; r[3] = com_end - com_off;
        r[4] = seq_off; r[5] = seq_len;
        r[6] = qual_off; r[7] = qual_len;
        nrec++;
      } else {
        cw = seq_off;  // discard
      }
    } else {
      while (i < len && data[i] != '>') {
        while (i < len && data[i] != '\n') {
          uint8_t c = data[i++];
          if (c != '\r' && c != ' ' && c != '\t') {
            if (cw >= codes_cap) return -1;
            codes[cw++] = enc(c);
          }
        }
        if (i < len) i++;
      }
      int64_t seq_len = cw - seq_off;
      if (seq_len >= min_len) {
        if (nrec >= max_recs) return -2;
        int64_t* r = recs + nrec * 8;
        r[0] = name_off; r[1] = name_len;
        r[2] = com_off; r[3] = com_end - com_off;
        r[4] = seq_off; r[5] = seq_len;
        r[6] = 0; r[7] = 0;
        nrec++;
      } else {
        cw = seq_off;
      }
    }
  }
  return nrec;
}

// ---------------------------------------------------------------------------
// (w,k)-minimizer sketch (mm_sketch, minialign.c:2349-2448; exact
// parity with index/sketch.py including the tie and emission rules)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_init_done = false;
static void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int b = 0; b < 8; b++) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0);
    crc_table[i] = c;
  }
  crc_init_done = true;
}

static inline uint64_t crc32c_u64(uint64_t crc, uint64_t val) {
#ifdef __SSE4_2__
  // the hardware CRC32-C (same reflected 0x82F63B78 polynomial, no
  // pre/post inversion) computes the identical byte-loop update —
  // the reference's own hash64 uses this instruction
  // (minialign.c:2353 via _mm_crc32_u64)
  return (uint64_t)_mm_crc32_u64((uint32_t)crc, val);
#else
  uint32_t r = (uint32_t)crc;
  for (int i = 0; i < 8; i++) {
    uint32_t byte = (uint32_t)((val >> (8 * i)) & 0xFF);
    r = (r >> 8) ^ crc_table[(r ^ byte) & 0xFF];
  }
  return (uint64_t)r;
#endif
}

// codes: (L,) 2-bit codes. Emits (hash, pos, strand) minimizer
// occurrences; returns the count. Output buffers sized >= L.
// cap: output capacity; returns -1 when it would overflow (the caller
// retries with a bigger buffer — lets callers allocate ~L/4 instead of
// L-sized outputs, which matters on lazily-backed hosts where fresh
// page faults are ~1000x slower than touched memory; see PERF_NOTES)
int64_t sketch_seq(const int8_t* codes, int64_t L, int32_t k, int32_t w,
                   int64_t cap, uint64_t* out_h, int64_t* out_pos,
                   uint8_t* out_strand) {
  crc_init();
  int64_t n = L - k + 1;
  if (n <= 0 || w > 64) return 0;
  const uint64_t mask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int shift1 = 2 * (k - 1);
  std::vector<uint64_t> ring((size_t)w, ~0ULL);   // v ring, head-clipped
  uint64_t k0 = 0, k1 = 0;
  uint64_t prev = 0;                              // previous window min
  int64_t cnt = 0;
  // incremental window min (amortized O(1) per base): the O(w)
  // rescan runs only when the current min's position leaves the
  // window (~2/w of bases). Tie rule: LAST occurrence in window
  // order (oldest..newest scan with <=, new element with <=) —
  // identical to the former full rescan per base.
  uint64_t vmin = ~0ULL;
  int64_t pos_min = -1;
  int64_t rp = 0;                                 // p % w, incremental
  for (int64_t i = 0; i < L; i++) {
    uint64_t c = (uint64_t)(codes[i] & 3);
    k0 = ((k0 << 2) | c) & mask;
    k1 = (k1 >> 2) | ((3ULL ^ c) << shift1);
    if (i < k - 1) continue;
    int64_t p = i - (k - 1);                      // k-mer start pos
    uint64_t strand = (k1 & mask) <= k0 ? 1 : 0;  // tie -> reverse
    uint64_t km = strand ? (k1 & mask) : k0;
    uint64_t kx = strand ? k0 : (k1 & mask);
    uint64_t h = (crc32c_u64(kx, kx) ^ km) & mask;
    uint64_t v = (h << 8) | ((uint64_t)rp) | (strand << 7);
    ring[(size_t)rp] = v;
    if (v <= vmin) {
      vmin = v;
      pos_min = p;
    } else if (pos_min <= p - w) {
      // min left the window: rescan oldest..newest, keep last on tie
      vmin = ~0ULL;
      int64_t pj = p - w + 1;
      int64_t s = rp + 1;
      if (s >= w) s = 0;
      for (int64_t t = 0; t < w; t++, pj++) {
        uint64_t vv = (pj < 0) ? ~0ULL : ring[(size_t)s];
        if (vv <= vmin) { vmin = vv; pos_min = pj; }
        if (++s >= w) s = 0;
      }
    }
    bool emit = (vmin != prev) || (vmin == v);
    int64_t pos = (vmin == v) ? p : pos_min;
    if (emit) {
      if (cnt >= cap) return -1;
      out_h[cnt] = vmin >> 8;
      out_pos[cnt] = pos;
      out_strand[cnt] = (uint8_t)((vmin >> 7) & 1);
      cnt++;
    }
    prev = vmin;
    if (++rp >= w) rp = 0;
  }
  return cnt;
}

// ---------------------------------------------------------------------------
// RLE -> path strings (the device walker's harvest): expand backward
// run entries (op | len << 2; ops 1='D', 2='R', 3=diagonal) into the
// three string forms the pipeline carries (extend.py TraceResult).
// ---------------------------------------------------------------------------

// ent: n uint8 backward run entries. Writes fwd (forward-space path:
// the backward {D,R,"RD"} expansion reversed), rev (backward-space
// {D,R,"DR"}), tok (one char per op, {D,R,X}). Returns the fwd/rev
// byte length, or -1 if cap is too small; *out_nops = op count.
int64_t rle_paths(const uint8_t* ent, int64_t n, char* fwd, char* rev,
                  char* tok, int64_t cap, int64_t* out_nops) {
  int64_t total = 0, nops = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t len = (ent[i] & 3) ? (ent[i] >> 2) : 0;  // op 0 = pad
    int64_t op = ent[i] & 3;
    nops += len;
    total += len * (op == 3 ? 2 : 1);
  }
  if (total > cap || nops > cap) return -1;
  char* r = rev;
  char* t = tok;
  for (int64_t i = 0; i < n; i++) {
    int64_t op = ent[i] & 3;
    int64_t len = op ? (ent[i] >> 2) : 0;
    if (op == 1) {
      for (int64_t k = 0; k < len; k++) *r++ = 'D';
      for (int64_t k = 0; k < len; k++) *t++ = 'D';
    } else if (op == 2) {
      for (int64_t k = 0; k < len; k++) *r++ = 'R';
      for (int64_t k = 0; k < len; k++) *t++ = 'R';
    } else {
      for (int64_t k = 0; k < len; k++) { *r++ = 'D'; *r++ = 'R'; }
      for (int64_t k = 0; k < len; k++) *t++ = 'X';
    }
  }
  // fwd = byte-reverse of the backward {D,R,"RD"} expansion
  // (extend.py: FWD1 chars at starts, 'D' second, buffer reversed).
  // reverse(concat(items)) = concat(reverse(item) for items in
  // reverse order), and reverse("RD") = "DR" — so emit entries in
  // reverse order with {D, R, "DR"} per op.
  char* fp = fwd;
  for (int64_t i = n - 1; i >= 0; i--) {
    int64_t op = ent[i] & 3;
    int64_t len = op ? (ent[i] >> 2) : 0;
    if (op == 1) {
      for (int64_t k = 0; k < len; k++) *fp++ = 'D';
    } else if (op == 2) {
      for (int64_t k = 0; k < len; k++) *fp++ = 'R';
    } else {
      for (int64_t k = 0; k < len; k++) { *fp++ = 'D'; *fp++ = 'R'; }
    }
  }
  *out_nops = nops;
  return total;
}

// ---------------------------------------------------------------------------
// round-0 seed collection (mm_collect_seed, minialign.c:3454-3493):
// sketch + two-stage index lookup + classify + mm_expand
// (minialign.c:3420-3446) fused into one pass, replacing the Python
// sketch-wrapper + vectorized-numpy-lookup + repeat/gather pipeline
// (~1.2 s of the round-3 host worker on 500 x 20 kb reads).
// ---------------------------------------------------------------------------

// codes: (L,) 2-bit query codes. Index arrays are the bucket-major
// layout (index/build.py): keys u64 sorted by (h & (2^b-1), h >> b),
// bkt_off (2^b+1) int64 CSR heads, offsets u32 (nkeys+1) hit-run CSR,
// vals_pos/vals_rid u32. Emits expanded seeds [upos, vpos, rid] (the
// rotated int32 coordinates) in minimizer order, hits in index order
// within a run, and rescue rows [qs, cnt, start] (int64) for runs with
// occ0 < cnt <= max_occ. Returns the seed count, or -1 (-2) when the
// seed (resc) capacity would overflow — callers grow and retry.
int64_t collect_seeds_c(const int8_t* codes, int64_t L, int32_t k,
                        int32_t w,
                        const uint64_t* keys, int64_t nkeys,
                        const int64_t* bkt_off, int32_t b,
                        const uint32_t* offsets,
                        const uint32_t* vals_pos,
                        const uint32_t* vals_rid,
                        int64_t max_occ, int64_t occ0,
                        int32_t* out_upos, int32_t* out_vpos,
                        int32_t* out_rid, int64_t cap_seeds,
                        int64_t* out_resc, int64_t cap_resc,
                        int64_t* out_nresc) {
  static thread_local std::vector<uint64_t> hbuf;
  static thread_local std::vector<int64_t> pbuf;
  static thread_local std::vector<uint8_t> sbuf;
  int64_t cap = L > 0 ? L : 16;
  hbuf.resize((size_t)cap);
  pbuf.resize((size_t)cap);
  sbuf.resize((size_t)cap);
  int64_t nm = sketch_seq(codes, L, k, w, cap, hbuf.data(), pbuf.data(),
                          sbuf.data());
  const uint64_t bmask = (1ull << b) - 1;
  const int32_t OFS_C = 0x40000000;
  int64_t ns = 0, nr = 0;
  for (int64_t m = 0; m < nm; m++) {
    uint64_t h = hbuf[m];
    int64_t lo = bkt_off[h & bmask], hi = bkt_off[(h & bmask) + 1];
    while (lo < hi) {             // lower_bound
      int64_t mid = (lo + hi) >> 1;
      if (keys[mid] < h) lo = mid + 1; else hi = mid;
    }
    if (lo >= nkeys || keys[lo] != h) continue;
    int64_t start = offsets[lo];
    int64_t cnt = (int64_t)offsets[lo + 1] - start;
    if (cnt <= 0 || cnt > max_occ) continue;
    int64_t fr = sbuf[m];
    int64_t q64 = (pbuf[m] + (int64_t)k * fr) ^ (-fr);
    int32_t qs = (int32_t)q64;
    if (cnt > occ0) {             // defer to the rescue rounds
      if (nr >= cap_resc) return -2;
      out_resc[nr * 3 + 0] = (int64_t)qs;
      out_resc[nr * 3 + 1] = cnt;
      out_resc[nr * 3 + 2] = start;
      nr++;
      continue;
    }
    if (ns + cnt > cap_seeds) return -1;
    int64_t q = (int64_t)qs;      // sign-extended int32
    for (int64_t t = start; t < start + cnt; t++) {
      int64_t rev = vals_rid[t] & 1;
      int64_t x = (int64_t)vals_pos[t] + (int64_t)k * rev;
      int64_t y = rev ? ~q : q;
      out_upos[ns] = (int32_t)(2 * x - y + OFS_C);
      out_vpos[ns] = (int32_t)(2 * y - x + OFS_C);
      out_rid[ns] = (int32_t)(vals_rid[t] >> 1);
      ns++;
    }
  }
  *out_nresc = nr;
  return ns;
}

// ---------------------------------------------------------------------------
// seed chaining (mm_chain_seeds + mm_circularize; exact parity with
// chain.py's port of minialign.c:3547-3695)
// ---------------------------------------------------------------------------

// seeds: (n, 3) int64 rows [upos, rid, vpos], sorted by (rid, upos).
// lens: per-rid lengths; circ: per-rid circular flags (may be null).
// out_chains: (max_chains, 3) int64 rows [plen, root_sid, leaf_sid],
// written in chain-creation order including consumed chains as
// plen = -1. Returns the chain count.
int64_t chain_seeds_c(const int64_t* seeds, int64_t n, int64_t twlen,
                      const int64_t* lens, const uint8_t* circ,
                      int64_t n_rid,
                      int64_t* out_chains, int64_t max_chains) {
  auto up = [&](int64_t i) { return seeds[i * 3 + 0]; };
  auto rid = [&](int64_t i) { return seeds[i * 3 + 1]; };
  auto vp = [&](int64_t i) { return seeds[i * 3 + 2]; };

  std::vector<int64_t> lid_of((size_t)n, -1);
  struct Leaf { int64_t rsid, lsid, rid, cid; };
  std::vector<Leaf> leaves;
  struct Chain { int64_t plen, lid; bool consumed; };
  std::vector<Chain> chains;

  int64_t nlsid = 0;
  while (nlsid < n) {
    int64_t lid = (int64_t)leaves.size();
    leaves.push_back({nlsid, nlsid, rid(nlsid), -1});
    int64_t plen0 = up(nlsid) + vp(nlsid);
    int64_t scnt = 1;
    int64_t nrsid = nlsid;
    int64_t nlsid_next = -1;

    while (true) {
      int64_t rsid = nrsid;
      int64_t v0 = vp(rsid);
      int64_t vub = v0 + twlen;
      int64_t uub = up(rsid) + twlen;
      int64_t r0 = rid(rsid);
      int64_t best = -1;
      int64_t sid = rsid + 1;
      while (sid < n) {
        if (rid(sid) > r0 || up(sid) > uub) {
          if (nlsid_next < 0) nlsid_next = sid;
          else if (sid < nlsid_next) nlsid_next = sid;
          break;
        }
        int64_t fv_v = vp(sid), fv_u = up(sid);
        if (!(fv_v > v0 && fv_v <= vub)) {
          if (nlsid_next < 0) nlsid_next = sid;
          else if (sid < nlsid_next) nlsid_next = sid;
          sid++;
          continue;
        }
        int64_t new_uub = uub - (vub - fv_v);
        int64_t new_vub = vub - (uub - fv_u);
        uub = new_uub; vub = new_vub;
        best = sid;
        sid++;
      }
      if (sid >= n && nlsid_next < 0) nlsid_next = n;
      if (best < 0) { nrsid = rsid; break; }
      int64_t nsid = best;
      if (lid_of[(size_t)nsid] != -1) { nrsid = nsid; break; }
      lid_of[(size_t)nsid] = lid;
      scnt++;
      nrsid = nsid;
      if (nlsid_next >= 0 && nlsid_next <= nrsid) nlsid_next = -1;
    }
    nlsid = nlsid_next >= 0 ? nlsid_next : n;

    if (nrsid == leaves[(size_t)lid].lsid) continue;  // nothing linked

    int64_t cid = -1;
    if (lid_of[(size_t)nrsid] != -1 && lid_of[(size_t)nrsid] < lid) {
      int64_t other = lid_of[(size_t)nrsid];
      nrsid = leaves[(size_t)other].rsid;
      int64_t owner = lid_of[(size_t)nrsid];
      if (owner != -1) cid = leaves[(size_t)owner].cid;
    }
    if (cid == -1) {
      cid = (int64_t)chains.size();
      chains.push_back({0, lid, false});
    }
    leaves[(size_t)lid].cid = cid;
    leaves[(size_t)lid].rsid = nrsid;

    double f = 1.0 - 1.0 / (double)scnt;
    int64_t plen = (int64_t)(f * (double)((up(nrsid) + vp(nrsid))
                                          - plen0));
    if (plen > chains[(size_t)cid].plen)
      chains[(size_t)cid] = {plen, lid, false};
  }

  // ---- circularize (chain.py _circularize)
  bool any_circ = false;
  if (circ) for (int64_t r = 0; r < n_rid; r++) any_circ |= circ[r];
  if (any_circ && !chains.empty()) {
    int64_t blid = 0, tlid = (int64_t)leaves.size();
    for (size_t rcid = 0; rcid < chains.size(); rcid++) {
      int64_t rlid = chains[rcid].lid;
      int64_t rsid = leaves[(size_t)rlid].rsid;
      int64_t rr = leaves[(size_t)rlid].rid;
      int64_t rlen = lens[rr];
      // x = _as(seed): trunc((2*ub + vb)/3) with ub/vb bare coords
      const int64_t OFS = 0x40000000;
      int64_t ub_ = up(rsid) - OFS, vb_ = vp(rsid) - OFS;
      int64_t num = 2 * ub_ + vb_;
      int64_t x0 = num / 3;             // C99 trunc division
      if (!circ[rr] || rlen - x0 > twlen) continue;
      int64_t uofs = 2 * rlen, vofs = -rlen;
      int64_t v0 = vp(rsid), u0 = up(rsid);
      int64_t vlb = v0 - vofs, vub = v0 - vofs + twlen;
      int64_t uub = u0 + twlen - uofs;

      while (blid < tlid &&
             rid(leaves[(size_t)blid].lsid) < rr) blid++;
      while (blid < tlid &&
             vp(leaves[(size_t)blid].lsid) > vub) blid++;

      int64_t best_plen = -1, best_lid = -1;
      for (int64_t lid2 = blid; lid2 < tlid; lid2++) {
        int64_t lsid = leaves[(size_t)lid2].lsid;
        int64_t lv = vp(lsid), lu = up(lsid), lr = rid(lsid);
        if (!(lv > vlb && lv <= vub && lr <= rr && lu <= uub)) continue;
        int64_t cid2 = leaves[(size_t)lid2].cid;
        if (cid2 == -1 || chains[(size_t)cid2].consumed ||
            chains[(size_t)cid2].plen < 0) continue;
        int64_t pl = chains[(size_t)cid2].plen;
        if (pl > best_plen ||
            (pl == best_plen && lid2 < best_lid)) {
          best_plen = pl; best_lid = lid2;
        }
      }
      if (best_lid < 0) continue;
      int64_t lcid = leaves[(size_t)best_lid].cid;
      chains[(size_t)lcid].lid = rlid;
      chains[(size_t)lcid].consumed = true;
      // carry the exact int32 value the reference holds after the
      // 0x80000000 mark (and the self-merge subtraction) so the
      // downstream radix key and plen-threshold break are identical
      {
        uint32_t stored_l =
            (uint32_t)(0x40000000u - (uint32_t)chains[(size_t)lcid].plen);
        uint32_t marked = stored_l | 0x80000000u;
        uint32_t st2 = ((size_t)lcid != rcid)
            ? marked
            : (uint32_t)(marked + stored_l - 0x40000000u);
        chains[(size_t)lcid].plen = (int64_t)(int32_t)(0x40000000u - st2);
      }
      if ((size_t)lcid != rcid) chains[rcid].plen += best_plen;
      leaves[(size_t)rlid].rsid = leaves[(size_t)best_lid].rsid;
    }
  }

  int64_t cnt = (int64_t)chains.size();
  if (cnt > max_chains) return -1;
  for (int64_t c = 0; c < cnt; c++) {
    const Chain& ch = chains[(size_t)c];
    out_chains[c * 3 + 0] = ch.plen;   // consumed rows carry their
                                       // marked (hugely negative) plen
    out_chains[c * 3 + 1] = leaves[(size_t)ch.lid].rsid;
    out_chains[c * 3 + 2] = leaves[(size_t)ch.lid].lsid;
  }
  return cnt;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// ksort-compatible radix sorts. The reference orders EVERYTHING with
// ksort.h's in-place MSD (American-flag) radix sort keyed on a PREFIX
// of each record (sort_key_128x = u64[0] of a 16-byte record,
// sort_key_64x = u32[0] of an 8-byte record, minialign.c:203-206), so
// the relative order of equal-key records is the deterministic
// permutation that algorithm produces — NOT stable order. Several
// reference behaviors depend on those tie orders (multi-hit minimizer
// lists, seed order feeding the greedy chainer, equal-score result
// records), so the exact algorithm is reproduced here: 8-bit digits
// from the top byte of the key down, buckets over RS_MIN_SIZE=64
// recurse, smaller buckets finish with a stable insertion sort, and
// arrays of <=64 records are insertion-sorted outright.
//
// Algorithm attribution: this is klib's KRADIX_SORT_INIT
// (https://github.com/attractivechaos/klib ksort.h, MIT license,
// (c) Attractive Chaos), vendored by the reference as ksort.h; the
// structure below necessarily mirrors it because the equal-key
// permutation it produces is observable in the output.
// ---------------------------------------------------------------------------

namespace {

const int RS_MIN = 64;

template <typename R, typename K>
static inline K rkey(const R& r) { return r.key; }

struct Rec128 { uint64_t key; uint64_t payload; };
struct Rec64 { uint32_t key; uint32_t payload; };

template <typename R, typename KT>
static void rs_insertsort(R* beg, R* end) {
  for (R* i = beg + 1; i < end; ++i)
    if (i->key < (i - 1)->key) {
      R tmp = *i;
      R* j;
      for (j = i; j > beg && tmp.key < (j - 1)->key; --j) *j = *(j - 1);
      *j = tmp;
    }
}

template <typename R, typename KT>
static void rs_sort(R* beg, R* end, int n_bits, int s) {
  const int size = 1 << n_bits, m = size - 1;
  struct Bucket { R* b; R* e; } b[256], *be = b + size, *k;
  for (k = b; k != be; ++k) k->b = k->e = beg;
  for (R* i = beg; i != end; ++i) ++b[(i->key >> s) & m].e;
  for (k = b + 1; k != be; ++k)
    k->e += (k - 1)->e - beg, k->b = (k - 1)->e;
  for (k = b; k != be;) {
    if (k->b != k->e) {
      Bucket* l;
      if ((l = b + ((k->b->key >> s) & m)) != k) {
        R tmp = *k->b, swap;
        do {
          swap = tmp;
          tmp = *l->b;
          *l->b++ = swap;
          l = b + ((tmp.key >> s) & m);
        } while (l != k);
        *k->b++ = tmp;
      } else ++k->b;
    } else ++k;
  }
  for (b->b = beg, k = b + 1; k != be; ++k) k->b = (k - 1)->e;
  if (s) {
    s = s > n_bits ? s - n_bits : 0;
    for (k = b; k != be; ++k)
      if (k->e - k->b > RS_MIN) rs_sort<R, KT>(k->b, k->e, n_bits, s);
      else if (k->e - k->b > 1) rs_insertsort<R, KT>(k->b, k->e);
  }
}

template <typename R, typename KT>
static void ks_radix(R* p, int64_t l, int key_bytes) {
  if (l <= RS_MIN) rs_insertsort<R, KT>(p, p + l);
  else rs_sort<R, KT>(p, p + l, 8, key_bytes * 8 - 8);
}

}  // namespace

extern "C" {

// keys: u64 (the reference record's u64[0]); out_order: the
// permutation (indices into the input) after the ksort 128x sort
void ks_radix128(const uint64_t* keys, int64_t n, uint64_t* out_order) {
  std::vector<Rec128> recs((size_t)n);
  for (int64_t i = 0; i < n; i++) recs[i] = {keys[i], (uint64_t)i};
  ks_radix<Rec128, uint64_t>(recs.data(), n, 8);
  for (int64_t i = 0; i < n; i++) out_order[i] = recs[i].payload;
}

void ks_radix64(const uint32_t* keys, int64_t n, uint32_t* out_order) {
  std::vector<Rec64> recs((size_t)n);
  for (int64_t i = 0; i < n; i++) recs[i] = {keys[i], (uint32_t)i};
  ks_radix<Rec64, uint32_t>(recs.data(), n, 4);
  for (int64_t i = 0; i < n; i++) out_order[i] = recs[i].payload;
}

// Whole index-build ordering in one call (the 16k-bucket Python loop
// with per-bucket ctypes round trips measured ~150x too slow at Gb
// scale): stable counting sort into 2^b first-stage buckets by the
// low hash bits (mm_idx_drain's arrival-order scatter,
// minialign.c:2837), then ksort's exact 128x permutation per bucket
// keyed on hrem = h >> b alone (mm_idx_count_occ, minialign.c:2882).
// out_order: indices into the input.
void idx_bucket_sort(const uint64_t* h, int64_t n, int b,
                     uint64_t* out_order) {
  const uint64_t mask = (b >= 64) ? ~0ull : ((1ull << b) - 1);
  const size_t nb = (size_t)1 << b;
  std::vector<int64_t> cnt(nb + 1, 0);
  for (int64_t i = 0; i < n; i++) cnt[(h[i] & mask) + 1]++;
  for (size_t d = 1; d <= nb; d++) cnt[d] += cnt[d - 1];
  std::vector<Rec128> recs((size_t)n);
  {
    std::vector<int64_t> wp(cnt.begin(), cnt.end() - 1);
    for (int64_t i = 0; i < n; i++) {
      int64_t& p = wp[h[i] & mask];
      recs[p] = {h[i] >> b, (uint64_t)i};
      p++;
    }
  }
  for (size_t d = 0; d < nb; d++) {
    int64_t s0 = cnt[d], s1 = cnt[d + 1];
    if (s1 - s0 > 1)
      ks_radix<Rec128, uint64_t>(recs.data() + s0, s1 - s0, 8);
  }
  for (int64_t i = 0; i < n; i++) out_order[i] = recs[i].payload;
}

// ---------------------------------------------------------------------------
// streaming bucket-major index build (round 3): the index keeps the
// reference's own two-stage layout (2^b first-stage buckets by the
// LOW hash bits, mm_idx_t, minialign.c:2693-2748) so no global key
// re-sort or giant permutation gathers are ever materialized. Three
// calls driven from index/build.py:
//   idx_scatter   — append one sketched chunk's (hrem, pos, rid)
//                   triples at the per-bucket cursors (arrival order
//                   == mm_idx_drain's push order, minialign.c:2837)
//   idx_sort_count— per-bucket ksort-exact permutation on hrem
//                   (radix_sort_128x, minialign.c:2882; leading zero
//                   key bytes are identity passes, so the 32-bit-key
//                   instantiation reproduces the 64-bit permutation
//                   for hrem < 2^32), applied in place to the three
//                   SoA arrays; returns the distinct-key total
//   idx_emit      — per-bucket run scan writing keys (full hashes),
//                   CSR offsets, and per-bucket key extents
// hrem must fit u32 (2k - b <= 32; build.py falls back otherwise).

void idx_scatter(const uint64_t* h, const uint32_t* pos,
                 const uint32_t* rid, int64_t n, int b,
                 int64_t* cursors, uint32_t* hs, uint32_t* vp,
                 uint32_t* vr) {
  const uint64_t mask = (1ull << b) - 1;
  for (int64_t i = 0; i < n; i++) {
    int64_t& c = cursors[h[i] & mask];
    hs[c] = (uint32_t)(h[i] >> b);
    vp[c] = pos[i];
    vr[c] = rid[i];
    c++;
  }
}

static int64_t idx_sort_range(uint32_t* hs, uint32_t* vp, uint32_t* vr,
                              const int64_t* boff, int64_t d0,
                              int64_t d1) {
  int64_t maxb = 0;
  for (int64_t d = d0; d < d1; d++)
    maxb = std::max(maxb, boff[d + 1] - boff[d]);
  std::vector<Rec64> recs((size_t)maxb);
  std::vector<uint32_t> tmp((size_t)maxb);
  int64_t nk = 0;
  for (int64_t d = d0; d < d1; d++) {
    int64_t s0 = boff[d], ln = boff[d + 1] - boff[d];
    if (ln <= 0) continue;
    if (ln > 1) {
      for (int64_t i = 0; i < ln; i++)
        recs[(size_t)i] = {hs[s0 + i], (uint32_t)i};
      ks_radix<Rec64, uint32_t>(recs.data(), ln, 4);
      for (int64_t i = 0; i < ln; i++) tmp[i] = recs[i].key;
      std::memcpy(hs + s0, tmp.data(), (size_t)ln * 4);
      for (int64_t i = 0; i < ln; i++)
        tmp[i] = vp[s0 + recs[i].payload];
      std::memcpy(vp + s0, tmp.data(), (size_t)ln * 4);
      for (int64_t i = 0; i < ln; i++)
        tmp[i] = vr[s0 + recs[i].payload];
      std::memcpy(vr + s0, tmp.data(), (size_t)ln * 4);
    }
    nk++;
    for (int64_t i = 1; i < ln; i++) nk += (hs[s0 + i] != hs[s0 + i - 1]);
  }
  return nk;
}

// nthreads > 1 partitions the (independent, in-place, disjoint)
// per-bucket sorts across worker threads — output bytes identical by
// construction (the reference sorts buckets on its pt pool the same
// way, mm_idx_count_occ, minialign.c:2868-2898)
int64_t idx_sort_count(uint32_t* hs, uint32_t* vp, uint32_t* vr,
                       const int64_t* boff, int64_t nbkt,
                       int32_t nthreads) {
  if (nthreads > 1 && nbkt > 1) {
    int64_t T = std::min<int64_t>(nthreads, nbkt);
    std::vector<int64_t> nks((size_t)T, 0);
    std::vector<std::thread> ths;
    for (int64_t t = 0; t < T; t++) {
      int64_t d0 = nbkt * t / T, d1 = nbkt * (t + 1) / T;
      ths.emplace_back([=, &nks]() {
        nks[(size_t)t] = idx_sort_range(hs, vp, vr, boff, d0, d1);
      });
    }
    int64_t nk = 0;
    for (int64_t t = 0; t < T; t++) {
      ths[(size_t)t].join();
      nk += nks[(size_t)t];
    }
    return nk;
  }
  return idx_sort_range(hs, vp, vr, boff, 0, nbkt);
}

void idx_emit(const uint32_t* hs, const int64_t* boff, int64_t nbkt,
              int b, uint64_t* keys, uint32_t* offsets,
              int64_t* bkt_off) {
  int64_t w = 0;
  for (int64_t d = 0; d < nbkt; d++) {
    bkt_off[d] = w;
    int64_t s0 = boff[d], s1 = boff[d + 1];
    for (int64_t i = s0; i < s1; i++) {
      if (i == s0 || hs[i] != hs[i - 1]) {
        keys[w] = ((uint64_t)hs[i] << b) | (uint64_t)d;
        offsets[w] = (uint32_t)i;      // CSR start of key w's run
        w++;
      }
    }
  }
  bkt_off[nbkt] = w;
  offsets[w] = (uint32_t)boff[nbkt];
}

}  // extern "C" (ksort exports)
