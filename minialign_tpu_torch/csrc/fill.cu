// Adaptive-banded semi-global SWG fill, one warp per problem.
//
// Replaces minialign_tpu/dp/pallas_fill.py:make_fill_pallas (Pallas, TPU;
// semantics twin minialign_tpu/dp/band.py:make_fill) and is held against
// minialign_tpu_torch/dp/band.py:fill_plain, bit for bit.
//
// Band geometry: lane q of the band at anti-diagonal step p holds cell
// (i, j) = (ihead - q, p + 2 - ihead + q); its characters are a[i - 1]
// and b[j - 1], NCODE outside the row. Thread t of the problem's warp
// holds lanes NL t .. NL t + NL - 1 (NL = 2 at W = 64, else 1; at W = 16
// threads 16-31 idle at the floor), so a one-lane roll of the band
// (roll_q in band.py) is one shuffle plus register moves.
//
// What bounds it: one problem's serial chain of steps. The engine groups
// requests by length, so a traced launch holds a few problems and the
// kernel's time is one problem's step latency times its ~30-40 k steps;
// bytes (2 characters a lane a step, 64 code bytes a step) and
// operations (~30 integer ops a cell) are far below the card's rates.
// The first version's step took ~850-1,000 cycles: global character
// loads, a 10-shuffle max butterfly and rolls issued after the direction
// was known, all on the chain. Here a step takes ~245-275 cycles traced
// and ~170-195 untraced on an H100, issue-bound: one warp issues the step's
// ~190 instructions in order, with little else to hide their latency.
// The design:
// - Characters come from shared memory. At each 32-step block start the
//   warp stores the W + 64 bases of a and of b that the band can touch in
//   this block (loaded into registers during the previous block, so the
//   global loads are off the chain), and the substitution scores of both
//   candidate cells of the next step are looked up as soon as the
//   direction of this step is known.
// - The step max leaves the step: each thread keeps its best cell (value,
//   first step, row) with strict >, and one warp reduction at the end
//   orders them by value descending, step ascending, lane ascending, which
//   is "the first step whose max beats gmax (init 0), lowest lane".
// - The X-drop accumulator stays on the thread that holds the center lane
//   W/2 and is broadcast once a block, for the test at the block end.
// - Both candidate rolls of S, E and F are issued with the two edge
//   shuffles that decide the direction, then selected; the rolls of the
//   previous S (for the diagonal source) are the ones the previous step
//   already made. A step has 6 shuffles, all independent.
// - A block whose start has every lane at i >= 1 and j >= 1 (the band has
//   left the first row and column; i and j never decrease) runs a bulk
//   step with no boundary or ramp-in code.
// - The max terms use the DPX instructions (__viaddmax_s32, __vimax3_s32).
// - The step loop is unrolled by 4, so that a step's trace code, best
//   cell and drop overlap the next step's shuffles.
// - Trace codes go to shared memory a byte a lane; at the block end the
//   warp packs them into the JAX layout with coalesced 128-byte stores.
// - One warp per thread block, so the problems of a small launch spread
//   over the SMs.
//
// The duo epilogue (D1): an untraced launch given a geometry block writes,
// from the max it holds in registers, each problem's up window as the up
// batch's descriptor rows and the down score, i and j as the summary's
// down rows (duo_window below). It replaces the up-window arithmetic of
// minialign_tpu/extend.py:675-737 (FillEngine._duo_fn, :703 and :710-722,
// and the three down rows it appends to the summary, :731-734), and is
// held against minialign_tpu_torch/dp/duo.py:duo_window_plain. It moves
// ~112 bytes a problem, so a launch of its own would cost more than its
// work; here it costs none, and the step loop does not see it.
//
// The store source (D2): a launch reads its windows either from (B, L)
// rows (rows mode: the sharded fill, kbench, the tests) or straight from
// the flat reference and query stores through the batch's packed
// descriptor block (store mode: the engine's every fill). Store mode is
// minialign_tpu/extend.py:651-669 (FillEngine._fused_fn, both store-window
// gathers and the fill in one dispatch) as one launch: the window loads
// apply the gather's contract (csrc/gather.cu, the JAX twin
// minialign_tpu/extend.py:499-523) cut at the row length L_side that the
// two-launch path would have gathered, so the kernel sees the bytes of
// gather_pair's rows and nothing past them; it is held against the plain
// D2 (gather_pair_plain, then fill_plain) and against the rows-mode
// kernel on gather_pair's rows. The loads stay off the step chain (the
// next block's window is loaded during this one). Two store instances:
// LINEAR, when no side wraps or starts before its segment (the caller
// knows it from the rows it packed; every batch of a linear reference),
// reads each side as a row, p + start with its cap, segment end and L
// folded into one column limit, through the rows-mode loader, its row
// pointers and limits held opaque in registers; GENERAL (circular
// references) takes any row, a wrapped side's window through a call of
// its own, one 64-bit modulo a window and a compare-and-subtract a byte.
// The step loop is the same code in every instance, but ptxas schedules
// it by what surrounds it: arrangements of the loads that kept a side's
// fields in registers across the loop or branched on them before the
// loads cost the traced step up to 35% (PERF.md §6). On an H100 80GB
// HBM3 at 700 W (kbench.py --fused, B=128 x 20 kb, in turns with rows
// mode): the LINEAR instance's traced step 117.2-117.5 ns against rows
// mode's 124.9-125.3, its untraced step 84.8-85.6 against 85.5-86.2.
//
// Trace layout (the JAX package's, unchanged): masks[b][blk][s][r] holds
// the 6-bit codes of lanes r + 16 f at bits [8 f, 8 f + 6).

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 32;
constexpr int NCODE = 4;
constexpr int TAIL_N = 96;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long CAPU_ADD = 4 * 64 + 2 * TAIL_N + 64;  // _slice_cap(.., 64)

struct FillParams {
  int sub[25];   // sub[b * 5 + a]: query base b against ref base a
  int gi, ge, gfa_eff, gfb_eff, gfa, gfb, model, floor_, xdrop;
};

template <int W>
struct Geo {
  static constexpr int NL = W == 64 ? 2 : 1;       // lanes a thread
  static constexpr int NT = W / NL;                // threads that hold lanes
  static constexpr int WIN = W + 64;               // bases a side a block
  static constexpr int NWIN = (WIN + 31) / 32;     // of them a thread loads
  static constexpr int C = W / 2;                  // X-drop center lane
  static constexpr int TC = C / NL, KC = C % NL;   // its thread and slot
};

// One side of one problem in store mode, p = store + base. The window
// byte at column col is (the gather's contract, cut at L)
//   (unsigned)col < lim ? p[idx] : NCODE
//   no wrap:  idx = max(start + col, 0),
//             lim = min(L, cap, seglen - start)
//   wrap > 0: idx = min(floor_mod(start + col, wrap), seglen - 1),
//             lim = min(L, cap)
//   and lim = 0 when seglen <= 0. A negative column (the first windows
//   start at ihead - W) is NCODE, as the gather never made a column < 0;
//   a negative start without wrap reads store[base], as the gather does.
struct Side {
  const int8_t* p;
  int start, lim, wrap, last;   // last = seglen - 1
};

template <int W>
struct Smem {
  int sub[25];
  int8_t sa[Geo<W>::WIN];    // a[abase + x]
  int8_t sb5[Geo<W>::WIN];   // 5 * b[bbase + x]
  uint8_t code[BLK * W];     // the block's cell codes: [s][lane]
  Side side[2];              // store mode: the problem's two sides (their
                             // p is kept in registers too)
};

template <int W>
struct Band {
  static constexpr int NL = Geo<W>::NL;
  int S[NL], Sp[NL], Spu[NL], Spd[NL], E[NL], F[NL];
  int scd[NL], scr[NL];      // this step's scores: down / right cell
  int ihead, rprev, p;
  int bv, bp, bi;            // the thread's best cell: value, step, i
  int cdrop;                 // valid on thread TC
};

// out[q] = x[q + 1], fill at q = W - 1
template <int W>
__device__ __forceinline__ void roll_up(const int* x, int* out, int fill,
                                        int t) {
  constexpr int NL = Geo<W>::NL;
  const int v = __shfl_down_sync(FULL, x[0], 1);
#pragma unroll
  for (int k = 0; k + 1 < NL; ++k) out[k] = x[k + 1];
  out[NL - 1] = t >= Geo<W>::NT - 1 ? fill : v;
}

// out[q] = x[q - 1], fill at q = 0
template <int W>
__device__ __forceinline__ void roll_dn(const int* x, int* out, int fill,
                                        int t) {
  constexpr int NL = Geo<W>::NL;
  const int v = __shfl_up_sync(FULL, x[NL - 1], 1);
#pragma unroll
  for (int k = NL - 1; k > 0; --k) out[k] = x[k - 1];
  out[0] = t == 0 ? fill : v;
}

// The substitution scores of both cells a lane can take at the step
// from (ihead, p): down keeps ihead, right takes ihead + 1.
template <int W>
__device__ __forceinline__ void scores(const Smem<W>& sm, int ihead, int p,
                                       int abase, int bbase, const int* q,
                                       int* scd, int* scr) {
#pragma unroll
  for (int k = 0; k < Geo<W>::NL; ++k) {
    const int ad = ihead - q[k] - 1 - abase;
    const int bd = p + 2 - ihead + q[k] - bbase;
    scd[k] = sm.sub[sm.sb5[bd] + sm.sa[ad]];
    scr[k] = sm.sub[sm.sb5[bd - 1] + sm.sa[ad + 1]];
  }
}

// Where a launch reads its windows. Rows mode (desc null): a (B, LA) and
// a (B, LB) int8 tensor and the lengths alen, blen. Store mode: a and b
// are the flat reference and query stores, desc the batch's packed
// descriptor block (dp/cuda_gather.py:pack_desc, R = 2B rows: side a's B
// rows, then side b's; int32 words: base (int64) [2R], then start, cap,
// seglen, wrap, elen [R each]), LA and LB the row lengths the two-launch
// path would have gathered; the lengths are the block's elen.
struct Src {
  const int8_t* a;
  const int32_t* alen;
  int LA;
  const int8_t* b;
  const int32_t* blen;
  int LB;
  const int32_t* desc;
};

// row[base + x] for this thread's x = t + 32 m, NCODE outside the row
// (rows mode)
template <int W>
__device__ __forceinline__ void load_rows(const int8_t* __restrict__ row,
                                          int L, int base, int t, int* r) {
#pragma unroll
  for (int m = 0; m < Geo<W>::NWIN; ++m) {
    const int x = t + 32 * m, idx = base + x;
    r[m] = (x < Geo<W>::WIN && idx >= 0 && idx < L) ? __ldg(row + idx)
                                                      : NCODE;
  }
}

// side s (0: a, 1: b) of problem prob in store mode, from its store src
// and its row of the packed block desc (B problems), at row length L;
// len gets the problem's length on that side (the row's elen)
__device__ __forceinline__ Side side_of(const int8_t* src, int L,
                                        const int32_t* desc, int s, int prob,
                                        int B, int& len) {
  {
    const int R = 2 * B, r = s * B + prob;
    const long long base = reinterpret_cast<const long long*>(desc)[r];
    const int32_t* f = desc + 2 * R;
    const int start = f[r], cap = f[R + r], seglen = f[2 * R + r];
    const int wrap = f[3 * R + r];
    len = f[4 * R + r];
    long long lim = min(L, cap);
    if (wrap <= 0) lim = min(lim, (long long)seglen - start);
    if (seglen <= 0 || lim < 0) lim = 0;
    return Side{src + base, start, (int)lim, wrap, seglen - 1};
  }
}

// A wrapped side's window (circular references), its bytes packed a
// byte a column: a call of its own, so that its modulo's registers stay
// out of the step loop's. The window's first index is wrapped once; a
// byte's is at most one wrap further unless the wrap is shorter than
// the window.
template <int W>
__device__ __noinline__ uint32_t load_wrapped(const Side s, int base,
                                              int t) {
  using G = Geo<W>;
  long long i0 = ((long long)s.start + base) % s.wrap;
  if (i0 < 0) i0 += s.wrap;
  const unsigned w = s.wrap;
  uint32_t v = 0;
#pragma unroll
  for (int m = 0; m < G::NWIN; ++m) {
    const int x = t + 32 * m, col = base + x;
    unsigned i = (unsigned)i0 + x;
    if (i >= w) i = w >= (unsigned)G::WIN ? i - w : i % w;
    const int c = (x < G::WIN && (unsigned)col < (unsigned)s.lim)
                      ? __ldg(s.p + min((int)i, s.last))
                      : NCODE;
    v |= (uint32_t)c << (8 * m);
  }
  return v;
}

// A store-mode side's window bytes at columns base + x for this
// thread's x = t + 32 m: the side s0 (from shared memory) with its p
// from a register, as rows mode keeps its row pointers
template <int W>
__device__ __forceinline__ void load_window(const int8_t* p, const Side& s0,
                                            int base, int t, int* r) {
  using G = Geo<W>;
  const Side s{p, s0.start, s0.lim, s0.wrap, s0.last};
  if (s.wrap > 0) {
    const uint32_t v = load_wrapped<W>(s, base, t);
#pragma unroll
    for (int m = 0; m < G::NWIN; ++m) r[m] = (v >> (8 * m)) & 0xff;
    return;
  }
#pragma unroll
  for (int m = 0; m < G::NWIN; ++m) {
    const int x = t + 32 * m, col = base + x;
    // start + col wraps only where the column is outside [0, lim)
    const int idx = max((int)((unsigned)s.start + col), 0);
    r[m] = (x < G::WIN && (unsigned)col < (unsigned)s.lim)
               ? __ldg(s.p + idx)
               : NCODE;
  }
}

template <int W, bool TRACE, bool BULK>
__device__ __forceinline__ void step(Band<W>& st, Smem<W>& sm,
                                     const FillParams& P, int t,
                                     const int* q, int s, int abase,
                                     int bbase, uint32_t& dirbits) {
  using G = Geo<W>;
  constexpr int NL = G::NL;
  const int fl = P.floor_, gi = P.gi, ge = P.ge;
  const int gfa = P.gfa_eff, gfb = P.gfb_eff;

  // every roll the step may need, issued with the direction's shuffles
  int Su[NL], Sdn[NL], Eu[NL], Fd[NL];
  roll_up<W>(st.S, Su, fl, t);
  roll_dn<W>(st.S, Sdn, fl, t);
  roll_up<W>(st.E, Eu, fl, t);
  roll_dn<W>(st.F, Fd, fl, t);
  const int s0 = __shfl_sync(FULL, st.S[0], 0);
  const int sW = __shfl_sync(FULL, st.S[NL - 1], G::NT - 1);
  // direction: down iff S[W-1] > S[0], alternating during ramp-in
  bool down = sW > s0;
  if constexpr (!BULK) {
    const bool edge_ok =
        (st.ihead - (W - 1) >= 0) && (st.p + 2 - st.ihead >= 0);
    if (!edge_ok) down = ((st.p + 1) & 1) == 1;
  }
  const int ihn = st.ihead + (down ? 0 : 1);
  const int pn = st.p + 1;
  int nscd[NL], nscr[NL];
  if (s + 1 < BLK) scores<W>(sm, ihn, pn, abase, bbase, q, nscd, nscr);

  int Sn[NL], En[NL], Fn[NL];
  uint32_t cw = 0;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    const int SE = down ? Su[k] : st.S[k];
    const int EE = down ? Eu[k] : st.E[k];
    const int SF = down ? st.S[k] : Sdn[k];
    const int FF = down ? st.F[k] : Fd[k];
    const int Sg = down ? (st.rprev ? st.Sp[k] : st.Spu[k])
                        : (st.rprev ? st.Spd[k] : st.Sp[k]);
    const int sc = down ? st.scd[k] : st.scr[k];
    int e = __viaddmax_s32(SE, -gi, EE) - ge;
    int f = __viaddmax_s32(SF, -gi, FF) - ge;
    int sn = __vimax3_s32(Sg + sc, e, SE - gfb);
    sn = max(__vimax3_s32(sn, f, SF - gfa), fl);
    if constexpr (TRACE) {
      const uint32_t code = (uint32_t)(sn == SF - gfa) |
                            ((uint32_t)(sn == f) << 1) |
                            ((uint32_t)(sn == SE - gfb) << 2) |
                            ((uint32_t)(sn == e) << 3) |
                            ((uint32_t)(sn - gi >= f) << 4) |
                            ((uint32_t)(sn - gi >= e) << 5);
      cw |= code << (8 * k);
    }
    int cand = sn;
    const int i = ihn - q[k];
    if constexpr (!BULK) {
      // true boundary values on the first row / column
      const int j = pn + 2 - i;
      int gaj = -(j > 0 ? gi : 0) - ge * j;
      int gbi = -(i > 0 ? gi : 0) - ge * i;
      if (P.model == 2) {
        gaj = max(gaj, -P.gfa * j);
        gbi = max(gbi, -P.gfb * i);
      }
      gaj = max(gaj, fl);
      gbi = max(gbi, fl);
      const bool on_i0 = i == 0 && j >= 0;
      const bool on_j0 = j == 0 && i >= 0;
      const bool inv = i < 0 || j < 0;
      if (on_i0) sn = gaj;
      if (on_j0) sn = gbi;
      if (inv) sn = fl;
      if (on_j0) e = gbi;
      if (on_i0 || inv) e = fl;
      if (on_i0) f = gaj;
      if (on_j0 || inv) f = fl;
      if (on_i0 || on_j0 || inv) cand = fl;
    }
    if (W == 16 && t >= 16) sn = e = f = cand = fl;   // idle half-warp
    if (cand > st.bv) {
      st.bv = cand;
      st.bp = pn;
      st.bi = i;
    }
    Sn[k] = sn;
    En[k] = e;
    Fn[k] = f;
  }
  // saturating int8 center-lane drop accumulator (gaba.c:1650)
  st.cdrop = min(max(st.cdrop - (Sn[G::KC] - st.S[G::KC]), -128), 127);
  if constexpr (TRACE) {
    if (t < G::NT) {
      if constexpr (NL == 2)
        *reinterpret_cast<uint16_t*>(&sm.code[s * W + 2 * t]) =
            (uint16_t)cw;
      else
        sm.code[s * W + t] = (uint8_t)cw;
    }
    dirbits |= (down ? 1u : 0u) << s;
  }
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    st.Sp[k] = st.S[k];
    st.Spu[k] = Su[k];
    st.Spd[k] = Sdn[k];
    st.S[k] = Sn[k];
    st.E[k] = En[k];
    st.F[k] = Fn[k];
    if (s + 1 < BLK) {
      st.scd[k] = nscd[k];
      st.scr[k] = nscr[k];
    }
  }
  st.ihead = ihn;
  st.rprev = down ? 0 : 1;
  st.p = pn;
}

__device__ __forceinline__ long long clip(long long x, long long lo,
                                          long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Problem b's duo rows from its down max (sc, mi, mj), for B problems:
//   tp0   = clip(cp0 + mi, 1, rlen),  tp1 = clip(cp1 + mj, 1, qlen)
//   ok    = sc > 0
//   lna_u = min(2 tp1 + CAPU_ADD, tp0) * ok,  lnb_u = tp1 * ok
// and the up batch's packed descriptor block (dp/cuda_gather.py:pack_desc,
// R = 2B rows: side a's B rows, then side b's) gets
//   row b     : base rvbase, start rlen - tp0, cap = elen = lna_u,
//               seglen rlen, wrap 0   (the reference's reverse strand)
//   row B + b : base qub,    start qlen - tp1, cap = elen = lnb_u,
//               seglen qlen, wrap 0   (the read's other strand)
// The base stays a separate int64 word and the gather adds the start in
// 64 bits, so rvbase + rlen - tp0 is never folded into an int32 (the
// TPU kernel's offa_u was int32). A failed down (ok = 0) gets empty up
// windows: all-NCODE rows whose fill scores 0 at once.
// geom: the packed geometry block (dp/duo.py:pack_geom), int32 words:
// rvbase (int64) [2B], qub (int64) [2B], then rlen, qlen, cp0, cp1 [B
// each]. desc: 7 int32 words a row (base's two, then start, cap, seglen,
// wrap, elen) over R rows. dsum: the down rows, row stride ld.
__device__ void duo_window(const int32_t* __restrict__ geom,
                           int32_t* __restrict__ desc,
                           int32_t* __restrict__ dsum, long long ld, int b,
                           int B, int sc, int mi, int mj) {
  const long long* g64 = reinterpret_cast<const long long*>(geom);
  const long long rvbase = g64[b], qub = g64[B + b];
  const int32_t* g32 = geom + 4 * B;
  const long long rlen = g32[b], qlen = g32[B + b];
  const long long cp0 = g32[2 * B + b], cp1 = g32[3 * B + b];
  const long long tp0 = clip(cp0 + mi, 1, rlen);
  const long long tp1 = clip(cp1 + mj, 1, qlen);
  const long long ok = sc > 0;
  const long long u = 2 * tp1 + CAPU_ADD;
  const int lna = (int)((u < tp0 ? u : tp0) * ok);
  const int lnb = (int)(tp1 * ok);
  const int R = 2 * B;
  long long* base = reinterpret_cast<long long*>(desc);
  int32_t* f = desc + 2 * R;                 // start, cap, seglen, wrap, elen
  base[b] = rvbase;
  base[B + b] = qub;
  f[b] = (int)(rlen - tp0);
  f[B + b] = (int)(qlen - tp1);
  f[R + b] = lna;
  f[R + B + b] = lnb;
  f[2 * R + b] = (int)rlen;
  f[2 * R + B + b] = (int)qlen;
  f[3 * R + b] = 0;
  f[3 * R + B + b] = 0;
  f[4 * R + b] = lna;
  f[4 * R + B + b] = lnb;
  dsum[b] = sc;
  dsum[ld + b] = mi;
  dsum[2 * ld + b] = mj;
}

// What a launch writes: the results (B each), the trace buffers (null
// when untraced), and the duo epilogue's geometry block, up descriptor
// block and down rows (row stride ld), all null (ld 0) but on an
// untraced duo launch.
struct Outs {
  int32_t *score, *i, *j, *steps, *blocks;
  uint32_t *masks, *dirs;
  int32_t *iheads, *rprevs;
  const int32_t* geom;
  int32_t *up, *dsum;
  long long ld;
};

// Where a launch reads its windows (fill_kernel's SRC): rows; the
// stores, every side a row of its store (LINEAR: no side wraps or starts
// before its segment, which the caller knows from the rows it packed);
// the stores, any side (GENERAL: circular references).
constexpr int ROWS = 0, LINEAR = 1, GENERAL = 2;

template <int W, bool TRACE, int SRC>
__global__ void __launch_bounds__(32)
fill_kernel(FillParams P, const int8_t* __restrict__ a,
            const int32_t* __restrict__ alen, int LA,
            const int8_t* __restrict__ b, const int32_t* __restrict__ blen,
            int LB, const int32_t* __restrict__ desc, int max_blocks,
            int32_t* __restrict__ o_score, int32_t* __restrict__ o_i,
            int32_t* __restrict__ o_j, int32_t* __restrict__ o_steps,
            int32_t* __restrict__ o_blocks, uint32_t* __restrict__ masks,
            uint32_t* __restrict__ dirs, int32_t* __restrict__ iheads,
            int32_t* __restrict__ rprevs, const int32_t* __restrict__ geom,
            int32_t* __restrict__ up, int32_t* __restrict__ dsum,
            long long ld) {
  using G = Geo<W>;
  constexpr int NL = G::NL;
  constexpr int c = G::C;
  __shared__ Smem<W> sm;
  const int t = threadIdx.x;
  const int prob = blockIdx.x;
  if (t < 25) sm.sub[t] = P.sub[t];
  // the problem's rows and their lengths. LINEAR: each side is the row
  // p + start of lim columns. GENERAL: each side's p in the registers
  // that hold the row pointers and the rest in shared memory (held in
  // registers across the step loop they cost the loop its schedule).
  const int8_t* arow = a + (size_t)prob * LA;
  const int8_t* brow = b + (size_t)prob * LB;
  int la = LA, lb = LB;
  int na_ = 0, nb_ = 0;   // store mode: the problem's lengths
  if constexpr (SRC != ROWS) {
    const Side xa = side_of(a, LA, desc, 0, prob, gridDim.x, na_);
    const Side xb = side_of(b, LB, desc, 1, prob, gridDim.x, nb_);
    if constexpr (SRC == LINEAR) {
      arow = xa.p + xa.start;
      brow = xb.p + xb.start;
      la = xa.lim;
      lb = xb.lim;
      // opaque to the compiler, so kept in registers: without this it
      // rebuilt them from the parameters (constant and uniform
      // registers) at every window load, and the step loop's schedule
      // lost 5% untraced and 6% traced (PERF.md §6)
      asm volatile("" : "+l"(arow), "+l"(brow), "+r"(la), "+r"(lb));
    } else {
      arow = xa.p;
      brow = xb.p;
      if (t == 0) {
        sm.side[0] = xa;
        sm.side[1] = xb;
      }
      __syncwarp();
    }
  }
  const int fl = P.floor_;

  int q[NL];   // the thread's lanes (idle threads alias lane W - 1)
#pragma unroll
  for (int k = 0; k < NL; ++k) q[k] = min(NL * t + k, W - 1);

  // band state at p = -1 (band.py _init_band)
  int g1b = -P.gi - P.ge, g1a = -P.gi - P.ge;
  if (P.model == 2) {
    g1b = max(g1b, -P.gfb);
    g1a = max(g1a, -P.gfa);
  }
  g1b = max(g1b, fl);
  g1a = max(g1a, fl);
  Band<W> st;
  const bool idle = W == 16 && t >= 16;
#pragma unroll
  for (int k = 0; k < NL; ++k) {
    st.S[k] = idle ? fl : (q[k] == c - 1 ? g1b : (q[k] == c ? g1a : fl));
    st.E[k] = !idle && q[k] == c - 1 ? g1b : fl;
    st.F[k] = !idle && q[k] == c ? g1a : fl;
    st.Sp[k] = !idle && q[k] == c ? 0 : fl;
  }
  roll_up<W>(st.Sp, st.Spu, fl, t);
  roll_dn<W>(st.Sp, st.Spd, fl, t);
  st.ihead = c;
  st.rprev = 0;
  st.p = -1;
  st.bv = 0;
  st.bp = INT_MAX;
  st.bi = 0;
  st.cdrop = -128;
  int nsteps = 0, nblk = 0;
  const int plim = SRC != ROWS
                       ? min(na_ + nb_ + 2 * TAIL_N, max_blocks * BLK - 2)
                       : min(alen[prob] + blen[prob] + 2 * TAIL_N,
                             max_blocks * BLK - 2);

  // the first block's window is based at its own start; every later
  // block's at the previous block's start, which covers it
  int abase = st.ihead - W, bbase = st.p - st.ihead + 1;
  int ra[G::NWIN], rb[G::NWIN];
  if constexpr (SRC == GENERAL) {
    load_window<W>(arow, sm.side[0], abase, t, ra);
    load_window<W>(brow, sm.side[1], bbase, t, rb);
  } else {
    load_rows<W>(arow, la, abase, t, ra);
    load_rows<W>(brow, lb, bbase, t, rb);
  }

  for (int blk = 0; blk < max_blocks; ++blk) {
    const size_t bi = (size_t)prob * max_blocks + blk;
    __syncwarp();
#pragma unroll
    for (int m = 0; m < G::NWIN; ++m) {
      const int x = t + 32 * m;
      if (x < G::WIN) {
        sm.sa[x] = (int8_t)ra[m];
        sm.sb5[x] = (int8_t)(5 * rb[m]);
      }
    }
    __syncwarp();
    const int na = st.ihead - W, nb = st.p - st.ihead + 1;
    if constexpr (SRC == GENERAL) {          // the next block's window
      load_window<W>(arow, sm.side[0], na, t, ra);
      load_window<W>(brow, sm.side[1], nb, t, rb);
    } else {
      load_rows<W>(arow, la, na, t, ra);
      load_rows<W>(brow, lb, nb, t, rb);
    }
    if (TRACE && t == 0) {
      iheads[bi] = st.ihead;
      rprevs[bi] = st.rprev;
    }
    scores<W>(sm, st.ihead, st.p, abase, bbase, q, st.scd, st.scr);
    uint32_t dirbits = 0;
    if (st.ihead - (W - 1) >= 1 && st.p + 2 - st.ihead >= 1) {
#pragma unroll 4
      for (int s = 0; s < BLK; ++s)
        step<W, TRACE, true>(st, sm, P, t, q, s, abase, bbase, dirbits);
    } else {
#pragma unroll 4
      for (int s = 0; s < BLK; ++s)
        step<W, TRACE, false>(st, sm, P, t, q, s, abase, bbase, dirbits);
    }
    nsteps += BLK;
    ++nblk;
    if constexpr (TRACE) {
      __syncwarp();
      uint32_t* mrow = masks + bi * BLK * 16;
#pragma unroll 4
      for (int w = t; w < BLK * 16; w += 32) {
        const uint8_t* cs = sm.code + (w >> 4) * W + (w & 15);
        uint32_t v = cs[0];
        if (W >= 32) v |= (uint32_t)cs[16] << 8;
        if (W == 64) v |= (uint32_t)cs[32] << 16 | (uint32_t)cs[48] << 24;
        mrow[w] = v;
      }
      if (t == 0) dirs[bi] = dirbits;
    }
    abase = na;
    bbase = nb;
    // X-drop test at block end (gaba.c:1738) + p-limit
    const int cdrop = __shfl_sync(FULL, st.cdrop, G::TC);
    if (cdrop > P.xdrop - 128 || st.p >= plim) break;
  }

  // the best cell: value descending, step ascending, lane ascending
  // (a lower lane at one step is a larger i)
  int bv = st.bv, bp = st.bp, bi = st.bi;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, off);
    const int op = __shfl_xor_sync(FULL, bp, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    if (ov > bv || (ov == bv && (op < bp || (op == bp && oi > bi)))) {
      bv = ov;
      bp = op;
      bi = oi;
    }
  }
  if (t == 0) {
    const int oi = bv > 0 ? bi : 0, oj = bv > 0 ? bp + 2 - bi : 0;
    o_score[prob] = bv;
    o_i[prob] = oi;
    o_j[prob] = oj;
    o_steps[prob] = nsteps;
    o_blocks[prob] = nblk;
    if constexpr (!TRACE) {
      if (geom != nullptr)
        duo_window(geom, up, dsum, ld, prob, gridDim.x, bv, oi, oj);
    }
  }
}

template <int SRC>
int launch(const void* params, const Src& src, int B, int W, int max_blocks,
           int trace, const Outs& o, void* stream) {
  if (o.geom != nullptr &&
      (trace || o.up == nullptr || o.dsum == nullptr || o.ld < B ||
       ((uintptr_t)o.geom | (uintptr_t)o.up) % 8))
    return (int)cudaErrorInvalidValue;
  if (W != 16 && W != 32 && W != 64) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  FillParams P;
  std::memcpy(&P, params, sizeof(P));
  auto st = static_cast<cudaStream_t>(stream);
#define FILL_CASE(WW, TT)                                                 \
  fill_kernel<WW, TT, SRC><<<B, 32, 0, st>>>(                          \
      P, src.a, src.alen, src.LA, src.b, src.blen, src.LB, src.desc,     \
      max_blocks, o.score, o.i, o.j, o.steps, o.blocks, o.masks, o.dirs, \
      o.iheads, o.rprevs, o.geom, o.up, o.dsum, o.ld)
  if (W == 64) {
    if (trace) FILL_CASE(64, true); else FILL_CASE(64, false);
  } else if (W == 32) {
    if (trace) FILL_CASE(32, true); else FILL_CASE(32, false);
  } else {
    if (trace) FILL_CASE(16, true); else FILL_CASE(16, false);
  }
#undef FILL_CASE
  return (int)cudaGetLastError();
}

Outs outs(void* o_score, void* o_i, void* o_j, void* o_steps,
          void* o_blocks, void* masks, void* dirs, void* iheads,
          void* rprevs, const void* geom, void* up, void* dsum,
          long long ld) {
  return Outs{static_cast<int32_t*>(o_score), static_cast<int32_t*>(o_i),
              static_cast<int32_t*>(o_j), static_cast<int32_t*>(o_steps),
              static_cast<int32_t*>(o_blocks), static_cast<uint32_t*>(masks),
              static_cast<uint32_t*>(dirs), static_cast<int32_t*>(iheads),
              static_cast<int32_t*>(rprevs),
              static_cast<const int32_t*>(geom), static_cast<int32_t*>(up),
              static_cast<int32_t*>(dsum), ld};
}

}  // namespace

// Rows mode. geom, up, dsum, ld: the duo epilogue's geometry block, up
// descriptor block and down rows (row stride ld), all null (ld 0) but on
// an untraced duo launch; geom and up 8-byte aligned (their int64 bases).
extern "C" int fill_launch(const void* a, const void* alen, int la,
                           const void* b, const void* blen, int lb, int B,
                           int W, int max_blocks, int trace,
                           const void* params, void* o_score, void* o_i,
                           void* o_j, void* o_steps, void* o_blocks,
                           void* masks, void* dirs, void* iheads,
                           void* rprevs, const void* geom, void* up,
                           void* dsum, long long ld, void* stream) {
  const Src src{static_cast<const int8_t*>(a),
                static_cast<const int32_t*>(alen), la,
                static_cast<const int8_t*>(b),
                static_cast<const int32_t*>(blen), lb, nullptr};
  return launch<ROWS>(params, src, B, W, max_blocks, trace,
                       outs(o_score, o_i, o_j, o_steps, o_blocks, masks,
                            dirs, iheads, rprevs, geom, up, dsum, ld),
                       stream);
}

// Store mode (D2 as one launch): problem b's sides are rows b and B + b
// of desc, a packed block of R = 2B rows (8-byte aligned), read from
// store_a and store_b at row lengths La and Lb; general 0 promises that
// no side wraps or starts before its segment (the LINEAR instance reads
// each side as a row), else GENERAL; the rest as fill_launch.
extern "C" int fill_store_launch(const void* store_a, const void* store_b,
                                 const void* desc, int R, int La, int Lb,
                                 int general, int B, int W, int max_blocks,
                                 int trace,
                                 const void* params, void* o_score,
                                 void* o_i, void* o_j, void* o_steps,
                                 void* o_blocks, void* masks, void* dirs,
                                 void* iheads, void* rprevs,
                                 const void* geom, void* up, void* dsum,
                                 long long ld, void* stream) {
  if (desc == nullptr || (uintptr_t)desc % 8 || R != 2 * B || La < 0 ||
      Lb < 0)
    return (int)cudaErrorInvalidValue;
  const Src src{static_cast<const int8_t*>(store_a), nullptr, La,
                static_cast<const int8_t*>(store_b), nullptr, Lb,
                static_cast<const int32_t*>(desc)};
  const Outs o = outs(o_score, o_i, o_j, o_steps, o_blocks, masks, dirs,
                      iheads, rprevs, geom, up, dsum, ld);
  return general ? launch<GENERAL>(params, src, B, W, max_blocks, trace, o,
                                   stream)
                 : launch<LINEAR>(params, src, B, W, max_blocks, trace, o,
                                  stream);
}

extern "C" const char* cuda_error_string(int rc) {
  return cudaGetErrorString((cudaError_t)rc);
}
