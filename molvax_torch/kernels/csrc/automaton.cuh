// The constrained-decoding automaton on one packed row, as a warp program:
// mask, select, advance. Written once for csrc/automaton.cu, and compiled
// as host C++ for the CPU tests (the stand-in at the end of the warp
// primitives below).
//
// Computes the function of molvax_torch/latent/constrain.py
// (step_mask_rem, advance) and of kernels/automaton.py::select_advance on
// the packed row layout of kernels/automaton.py, bit for bit. Where the
// reference reduces one-hot contractions (a TPU has no vector gather), this
// code indexes the row directly; an index outside an array's range reads 0,
// as a one-hot contraction does, and a write outside it is dropped.
// Floor division is written as such (JAX's // floors for negative values).
//
// One warp works on one row, which lies in shared memory. A value that
// differs between the lanes is a Lanes<T>; every other value is the same
// on all lanes (each lane computes it from the row, or it is the result of
// a collective). The lane pieces are functions of the lane l, handed to
// the primitives:
//   lanes(f)      the value f(l) on each lane
//   ballot(f)     the 32-bit mask of the lanes where f(l) holds
//   each_lane(f)  f(l) on each lane, for its stores
//   lane_max, lane_or, lane_fmax   a reduction over the lanes
//   shfl(x, src)  lane src's x
//   match(x)      on each lane, the mask of the lanes holding the same x
//   on_lane0(f)   f() on lane 0 alone, the warp synchronised around it
// On the card they are the warp intrinsics, each lane calling f with its
// own lane id. In host C++ a Lanes<T> holds 32 values and each primitive
// runs the 32 lanes one after another over those arrays. No collective is
// called under a branch that differs between lanes, so both run the same
// program. The per-lane class attributes, mask words and scores are
// structs of four named members, not arrays: the device path has no array
// that could be indexed at run time, and so no local memory.
//
// The stages of the mask (step_mask_rem):
//   1. ring slot j on lane j: open, partner, closure cost, first-partner
//      test (match), the pooled-pair scan of _dup_wrt spread over all 32
//      lanes (pool entry p on lane p mod 32, or-reduced); each slot set
//      (direct_prev, cred_prev, new_ok, direct_pop, n_att) is a ballot,
//      each histogram the popcounts of a set against the four cost sets;
//   2. stack entry d on lane d: anc, anc_att, anc2 and, for each slot that
//      may close, its anc_pc, each one max-reduction;
//   3. each slot's close check on its own lane, then each class's legality
//      on the lanes that hold it (class c on lane c mod 32);
//   4. the legal set as four ballot words; the pad escape hatch where
//      every word is 0.

#pragma once

#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define AUTO_FN __device__ __forceinline__
#define AUTO_HD __host__ __device__ __forceinline__
#else
#define AUTO_FN inline
#define AUTO_HD inline
#endif

namespace automaton {

constexpr int DMAX = 16;   // branch stack depth
constexpr int NRING = 10;  // ring-digit slots
constexpr int RMAX = 6;    // max simultaneously open rings
constexpr int NSC = 17;    // packed scalars
constexpr int WARP = 32;
constexpr int MAXC = 128;  // token classes a row's mask holds
constexpr int CPL = MAXC / WARP;  // classes per lane
static_assert(CPL == 4, "a lane holds four classes (Classes, Words, Scores)");
static_assert(DMAX <= WARP && NRING <= 16, "a stack entry or ring slot per lane; two pooled sets per word");

// packed table rows (kernels/automaton.py::_TAB_ROWS)
enum TabRow {
  T_BUDGET, T_BOND, T_DIGIT, T_ATOM, T_L, T_R, T_CU, T_BU, T_OPEN, T_CLOSE,
  T_DOT, T_LBR, T_RBR, T_AT, T_H, T_PLUS, T_MINUS, T_PAD, T_ROWS
};
// packed scalars (kernels/automaton.py::_SC_FIELDS)
enum Scalar {
  S_NATOMS, S_PREV, S_PEND, S_SP, S_PN, S_HFIX, S_HORDER, S_B, S_BBUD, S_BH,
  S_BCHG, S_BSIGN, S_FRESH, S_DONE, S_ESC, S_BSYMC, S_BSYMB
};

// Offsets of one packed row: [val A | par A | stack DMAX | rpart NRING |
// rhint NRING | rres NRING | ppa P | ppb P | NSC scalars].
struct Layout {
  int A, P;
  AUTO_HD int val() const { return 0; }
  AUTO_HD int par() const { return A; }
  AUTO_HD int stack() const { return 2 * A; }
  AUTO_HD int rpart() const { return 2 * A + DMAX; }
  AUTO_HD int rhint() const { return 2 * A + DMAX + NRING; }
  AUTO_HD int rres() const { return 2 * A + DMAX + 2 * NRING; }
  AUTO_HD int ppa() const { return 2 * A + DMAX + 3 * NRING; }
  AUTO_HD int ppb() const { return 2 * A + DMAX + 3 * NRING + P; }
  AUTO_HD int sc() const { return 2 * A + DMAX + 3 * NRING + 2 * P; }
  AUTO_HD int width() const { return sc() + NSC; }
};

// Row view: the row's scalars and array pointers.
struct Row {
  int* s;  // the packed row
  Layout L;
  AUTO_FN int* val() const { return s + L.val(); }
  AUTO_FN int* par() const { return s + L.par(); }
  AUTO_FN int* stack() const { return s + L.stack(); }
  AUTO_FN int* rpart() const { return s + L.rpart(); }
  AUTO_FN int* rhint() const { return s + L.rhint(); }
  AUTO_FN int* rres() const { return s + L.rres(); }
  AUTO_FN int* ppa() const { return s + L.ppa(); }
  AUTO_FN int* ppb() const { return s + L.ppb(); }
  AUTO_FN int& sc(int i) const { return s[L.sc() + i]; }
};

// -- the warp primitives --------------------------------------------------------

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

AUTO_FN int lane_id() { return threadIdx.x & (WARP - 1); }

template <class T>
struct Lanes {
  T v;  // this lane's value
  AUTO_FN const T& operator[](int) const { return v; }
};

template <class F>
AUTO_FN auto lanes(F f) -> Lanes<decltype(f(0))> {
  return {f(lane_id())};
}
template <class F>
AUTO_FN unsigned ballot(F f) {
  return __ballot_sync(FULL, f(lane_id()));
}
template <class F>
AUTO_FN void each_lane(F f) {
  f(lane_id());
}
AUTO_FN int lane_max(const Lanes<int>& x) { return __reduce_max_sync(FULL, x.v); }
AUTO_FN unsigned lane_or(const Lanes<unsigned>& x) { return __reduce_or_sync(FULL, x.v); }
// the maximum of values none of which is NaN (each lane may hold its own
// sign of a zero maximum; a comparison does not see it)
AUTO_FN float lane_fmax(const Lanes<float>& x) {
  float m = x.v;
#pragma unroll
  for (int o = WARP / 2; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
  return m;
}
template <class T>
AUTO_FN T shfl(const Lanes<T>& x, int src) {
  return __shfl_sync(FULL, x.v, src);
}
AUTO_FN Lanes<unsigned> match(const Lanes<int>& x) { return {__match_any_sync(FULL, x.v)}; }
template <class F>
AUTO_FN void on_lane0(F f) {
  __syncwarp();
  if (lane_id() == 0) f();
  __syncwarp();
}
AUTO_FN int popc(unsigned x) { return __popc(x); }
AUTO_FN int first_set(unsigned x) { return __ffs(x); }

#else  // the host stand-in: the 32 lanes one after another

template <class T>
struct Lanes {
  T v[WARP];
  const T& operator[](int l) const { return v[l]; }
};

template <class F>
inline auto lanes(F f) -> Lanes<decltype(f(0))> {
  Lanes<decltype(f(0))> x;
  for (int l = 0; l < WARP; ++l) x.v[l] = f(l);
  return x;
}
template <class F>
inline unsigned ballot(F f) {
  unsigned m = 0;
  for (int l = 0; l < WARP; ++l) m |= f(l) ? 1u << l : 0u;
  return m;
}
template <class F>
inline void each_lane(F f) {
  for (int l = 0; l < WARP; ++l) f(l);
}
inline int lane_max(const Lanes<int>& x) {
  int m = x.v[0];
  for (int l = 1; l < WARP; ++l) m = x.v[l] > m ? x.v[l] : m;
  return m;
}
inline unsigned lane_or(const Lanes<unsigned>& x) {
  unsigned m = 0;
  for (int l = 0; l < WARP; ++l) m |= x.v[l];
  return m;
}
// the card's butterfly, lane 0's result
inline float lane_fmax(const Lanes<float>& x) {
  Lanes<float> m = x;
  for (int o = WARP / 2; o > 0; o >>= 1) {
    Lanes<float> n;
    for (int l = 0; l < WARP; ++l) n.v[l] = fmaxf(m.v[l], m.v[l ^ o]);
    m = n;
  }
  return m.v[0];
}
template <class T>
inline T shfl(const Lanes<T>& x, int src) {
  return x.v[src & (WARP - 1)];
}
inline Lanes<unsigned> match(const Lanes<int>& x) {
  return lanes([&](int l) { return ballot([&](int o) { return x.v[o] == x.v[l]; }); });
}
template <class F>
inline void on_lane0(F f) {
  f();
}
inline int popc(unsigned x) { return __builtin_popcount(x); }
inline int first_set(unsigned x) { return __builtin_ffs((int)x); }

#endif

// -- scalar helpers --------------------------------------------------------------

AUTO_FN int imin(int a, int b) { return a < b ? a : b; }
AUTO_FN int imax(int a, int b) { return a > b ? a : b; }

// a // c for c > 0, rounding toward -infinity
AUTO_FN int floordiv(int a, int c) {
  int q = a / c;
  if ((a % c != 0) && (a < 0)) q -= 1;
  return q;
}

// x[i] for i in [0, n), else 0
AUTO_FN int at(const int* x, int n, int i) { return (i >= 0 && i < n) ? x[i] : 0; }

// The open slots whose closure costs 1, 2, 3, 4 (ballots), and the
// histogram of a set of slots over those costs.
struct Costs {
  unsigned c1, c2, c3, c4;
};
struct Hist {
  int n1, n2, n3, n4;
};
AUTO_FN Hist hist(unsigned set, const Costs& c) {
  return {popc(set & c.c1), popc(set & c.c2), popc(set & c.c3), popc(set & c.c4)};
}

// closures of cost c affordable within w, at most h of them; w is spent
AUTO_FN int take1(int& w, int c, int h) {
  const int t = imin(imax(floordiv(w, c), 0), h);
  w -= t * c;
  return t;
}

// greedy number of closures affordable within w from the cost histogram h
AUTO_FN int take(const Hist& h, int w) {
  int m = take1(w, 1, h.n1);
  m += take1(w, 2, h.n2);
  m += take1(w, 3, h.n3);
  m += take1(w, 4, h.n4);
  return m;
}

AUTO_FN int credit(const Hist& h, int ndir, int v, int r, bool partial_only) {
  int k = imin(take(h, v - 1), ndir);
  if (!partial_only) {
    const int kfull = take(h, v);
    if (ndir >= r && kfull >= r) k = r;
  }
  return imin(k, r);
}

AUTO_FN int att_extra(int k, int rr, int natt) { return (natt > 0 && k >= rr - natt) ? 1 : 0; }

// -- the token classes a lane holds ----------------------------------------------

// One class's attributes: budget, bond order, digit, and the 15 flag rows
// T_ATOM..T_PAD as bits (a table entry != 0 is set).
struct Cls {
  int g, bond, dig;
  unsigned flags;
  AUTO_FN bool is(int row) const { return (flags >> (row - T_ATOM)) & 1u; }
};

// classes l, l + 32, l + 64, l + 96 of lane l
struct Classes {
  Cls c0, c1, c2, c3;
  AUTO_FN Cls at(int k) const { return k == 0 ? c0 : k == 1 ? c1 : k == 2 ? c2 : c3; }
  AUTO_FN void set(int k, const Cls& v) {
    if (k == 0) c0 = v;
    if (k == 1) c1 = v;
    if (k == 2) c2 = v;
    if (k == 3) c3 = v;
  }
};

// the legal set: bit l of word k is class l + 32 k
struct Words {
  unsigned w0, w1, w2, w3;
  AUTO_FN unsigned at(int k) const { return k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3; }
  AUTO_FN void set(int k, unsigned v) {
    if (k == 0) w0 = v;
    if (k == 1) w1 = v;
    if (k == 2) w2 = v;
    if (k == 3) w3 = v;
  }
};

// a lane's masked scores, class l + 32 k in member k
struct Scores {
  float s0, s1, s2, s3;
  AUTO_FN float at(int k) const { return k == 0 ? s0 : k == 1 ? s1 : k == 2 ? s2 : s3; }
  AUTO_FN void set(int k, float v) {
    if (k == 0) s0 = v;
    if (k == 1) s1 = v;
    if (k == 2) s2 = v;
    if (k == 3) s3 = v;
  }
};

AUTO_FN Cls class_of(const int* tab, int C, int c) {
  Cls a{0, 0, 0, 0u};
  if (c < C) {
    a.g = tab[T_BUDGET * C + c];
    a.bond = tab[T_BOND * C + c];
    a.dig = tab[T_DIGIT * C + c];
#pragma unroll
    for (int row = T_ATOM; row < T_ROWS; ++row) a.flags |= tab[row * C + c] != 0 ? 1u << (row - T_ATOM) : 0u;
  }
  return a;
}

// each lane's classes from the (18, C) tables (coalesced: class c on lane c mod 32)
AUTO_FN Lanes<Classes> load_classes(const int* tab, int C) {
  return lanes([&](int l) {
    Classes s;
#pragma unroll
    for (int k = 0; k < CPL; ++k) s.set(k, class_of(tab, C, l + WARP * k));
    return s;
  });
}

// token tok's attributes from the lane that holds it (0 outside [0, C))
AUTO_FN Cls token_of(const Lanes<Classes>& cls, int C, int tok) {
  const bool in = tok >= 0 && tok < C;
  const int k = in ? tok / WARP : 0, src = in ? tok % WARP : 0;
  const Lanes<Cls> mine = lanes([&](int l) { return cls[l].at(k); });
  Cls t{shfl(lanes([&](int l) { return mine[l].g; }), src), shfl(lanes([&](int l) { return mine[l].bond; }), src),
        shfl(lanes([&](int l) { return mine[l].dig; }), src),
        shfl(lanes([&](int l) { return mine[l].flags; }), src)};
  if (!in) t = Cls{0, 0, 0, 0u};
  return t;
}

// -- the mask (step_mask_rem) ----------------------------------------------------

// What the mask leaves for the selection and the transition: the legal set
// and the open ring slots.
struct Step {
  Words legal;
  unsigned open;
};

// The legal-token set of the row, rem = tokens remaining after this one.
AUTO_FN Step warp_mask(const Lanes<Classes>& cls, int C, const Row& w, int rem) {
  const int A = w.L.A, P = w.L.P;
  const int* val = w.val();
  const int* par = w.par();
  const int* stack = w.stack();
  const int* rpart = w.rpart();
  const int* rhint = w.rhint();
  const int* rres = w.rres();
  const int* ppa = w.ppa();
  const int* ppb = w.ppb();
  const int n_atoms = w.sc(S_NATOMS), prev = w.sc(S_PREV), pend = w.sc(S_PEND);
  const int sp = w.sc(S_SP), pn = w.sc(S_PN), hfix = w.sc(S_HFIX), horder = w.sc(S_HORDER), b = w.sc(S_B);
  const int bbud = w.sc(S_BBUD), bh = w.sc(S_BH), bchg = w.sc(S_BCHG), bsign = w.sc(S_BSIGN);
  const bool fresh = w.sc(S_FRESH) != 0, done = w.sc(S_DONE) != 0;
  const bool bsymc = w.sc(S_BSYMC) != 0, bsymb = w.sc(S_BSYMB) != 0;

  const bool prev_ok = prev >= 0;
  const int vprev = at(val, A, prev);
  const int o_att = pend > 0 ? pend : (prev_ok ? 1 : 0);
  const bool outside = b == 0 && !done;
  // need_ok(k, sp_, rr, extra): sp_ + 2 rr - k + extra <= rem
#define NEED_OK(k, sp_, rr, extra) ((sp_) + 2 * (rr) - (k) + (extra) <= rem)

  // --- 1. the ring slots, slot j on lane j ---
  const Lanes<int> part = lanes([&](int l) { return l < NRING ? rpart[l] : -1; });
  const Lanes<int> res = lanes([&](int l) { return l < NRING ? imax(rres[l], 1) : 0; });
  const unsigned open = ballot([&](int l) { return l < NRING && part[l] >= 0; });
  const int r = popc(open);
  const Costs cost{ballot([&](int l) { return res[l] == 1; }), ballot([&](int l) { return res[l] == 2; }),
                   ballot([&](int l) { return res[l] == 3; }), ballot([&](int l) { return res[l] == 4; })};
  // first_p: no open slot before j has j's partner
  const Lanes<unsigned> same = match(part);
  const unsigned first = ballot([&](int l) { return (same[l] & open & ((1u << l) - 1u)) == 0; });
  const int popped = at(stack, DMAX, sp > 0 ? sp - 1 : 0);
  // _dup_wrt's pool scan: is (min(part_j, a), max(part_j, a)) a pooled pair,
  // for a = prev (bit j) and a = popped (bit 16 + j). Entries at and past pn
  // were never written (-1, -1) and cannot match max(part_j, a) >= 0 of an
  // open slot, so the scan stops at pn; pool entry p is on lane p mod 32.
  const int used = imin(imax(pn, 0), P);
  const unsigned pooled = lane_or(lanes([&](int l) {
    unsigned bits = 0;
    for (int p = l; p < used; p += WARP) {
      const int pa = ppa[p], pb = ppb[p];
#pragma unroll
      for (int j = 0; j < NRING; ++j) {
        const int pj = rpart[j];
        bits |= (pa == imin(pj, prev) && pb == imax(pj, prev)) ? 1u << j : 0u;
        bits |= (pa == imin(pj, popped) && pb == imax(pj, popped)) ? 1u << (16 + j) : 0u;
      }
    }
    return bits;
  }));
  // _dup_wrt(part_j, a): a pooled pair, or a chain bond (a-parent, partner-parent)
  auto dup = [&](int l, int a, int shift) {
    const int pj = part[l];
    return ((pooled >> (shift + l)) & 1u) != 0 || pj == at(par, A, a) || at(par, A, pj) == a;
  };
  const unsigned at_prev = open & ballot([&](int l) { return part[l] == prev; });
  const unsigned at_pop = open & ballot([&](int l) { return part[l] == popped; });
  const unsigned direct_prev = open & ~at_prev & ~ballot([&](int l) { return l < NRING && dup(l, prev, 0); });
  const unsigned cred_prev = direct_prev & first;
  const unsigned new_ok = open & first & ~at_prev;
  const unsigned direct_pop = open & ~at_pop & first & ~ballot([&](int l) { return l < NRING && dup(l, popped, 16); });
  const int n_att = popc(at_prev), n_att_pop = popc(at_pop);
  const Hist h_prev = hist(cred_prev, cost), h_new = hist(new_ok, cost), h_pop = hist(direct_pop, cost);
  const int ndir_prev = popc(cred_prev), ndir_new = popc(new_ok);

  // --- 2. the ancestors' spare valence, stack entry d on lane d ---
  const Lanes<int> st = lanes([&](int l) { return l < DMAX ? stack[l] : -1; });
  const Lanes<int> stv = lanes([&](int l) { return at(val, A, st[l]); });
  // _anc_spare_max: the max over d < DMAX of the live entries' (d < limit,
  // stack[d] >= 0) val[stack[d]], adj taken off where stack[d] == adj_idx,
  // and 0 for the others
  auto anc_max = [&](int limit, int adj_idx, int adj) {
    return lane_max(lanes([&](int l) {
      if (l >= DMAX) return INT_MIN;
      return (l < limit && st[l] >= 0) ? stv[l] - (st[l] == adj_idx ? adj : 0) : 0;
    }));
  };
  const int anc = anc_max(sp, -1, 0);
  const int anc_att = anc_max(sp, prev, o_att);

  // --- per-row parts of the atom, halogen, bond and bracket rules ---
  const int v_hal = 1 - horder;
  const bool t_hal = !(r > 0 && v_hal == 0 && anc == 0);
  const int k_hal = credit(h_prev, ndir_prev, v_hal, r, false);
  const bool ok_hal_row = outside && v_hal >= 0 && t_hal && NEED_OK(k_hal, sp, r, 0);
  const bool ok_bond_row = outside && prev_ok && pend == 0 && NEED_OK(0, sp, r, 1 + (fresh ? 1 : 0));

  // --- 3. ring digits: slot j's open and close checks on lane j ---
  const int v_po = vprev - o_att;
  const int k_po = credit(h_prev, ndir_prev, v_po, r, true);
  const bool open_row = outside && prev_ok && !fresh && vprev >= o_att && r < RMAX &&
                        (v_po >= 1 || anc_att >= 1) &&
                        NEED_OK(k_po, sp, r + 1, att_extra(k_po, r + 1, n_att + 1));
  const unsigned closing = (outside && prev_ok && !fresh) ? direct_prev : 0u;
  // anc_pc of each slot that may close: the stack lanes' max, prev's entry
  // less o_fin and the partner's less the surplus
  Lanes<int> anc_pc = lanes([&](int) { return 0; });
#pragma unroll
  for (int j = 0; j < NRING; ++j) {
    if ((closing >> j) & 1u) {
      const int o_fin = pend > 0 ? pend : imax(rhint[j], 1);
      const int sur = o_fin - imax(rres[j], 1);
      const int pj = rpart[j];
      const int m = lane_max(lanes([&](int l) {
        if (l >= DMAX) return INT_MIN;
        if (!(l < sp && st[l] >= 0)) return 0;
        return stv[l] - (st[l] == prev ? o_fin : 0) - (st[l] == pj ? sur : 0);
      }));
      anc_pc = lanes([&](int l) { return l == j ? m : anc_pc[l]; });
    }
  }
  const unsigned slot_ok = ballot([&](int l) {
    if (l >= NRING) return false;
    const int pj = part[l];
    const bool ok_open = open_row && pj == -1;
    bool ok_close = false;
    if ((closing >> l) & 1u) {
      const int hint = rhint[l];
      const int o_fin = pend > 0 ? pend : imax(hint, 1);
      const bool mismatch = pend > 0 && hint > 0 && pend != hint;
      const int sur = o_fin - res[l];
      const int vpart = at(val, A, pj);
      const int v_pc = vprev - o_fin;
      const bool t_pc = !((r - 1) > 0 && v_pc == 0 && anc_pc[l] == 0);
      // the direct slots other than those of j's partner
      const unsigned mat = cred_prev & ~same[l];
      const int k_pc = credit(hist(mat, cost), popc(mat), v_pc, r - 1, false);
      ok_close = !mismatch && vprev >= o_fin && vpart >= sur && t_pc &&
                 NEED_OK(k_pc, sp, r - 1, att_extra(k_pc, r - 1, n_att));
    }
    return ok_open || ok_close;
  });

  // --- '(' / ')' / '.' / '[' ---
  const int k_cur = credit(h_prev, ndir_prev, vprev, r, false);
  const bool ok_open_br = outside && prev_ok && !fresh && pend == 0 && sp < DMAX && vprev >= 1 &&
                          NEED_OK(k_cur, sp + 1, r, 1);
  const int vpop = at(val, A, sp > 0 ? popped : -1);
  const int anc2 = anc_max(sp - 1, -1, 0);
  const int k_pop = credit(h_pop, popc(direct_pop), vpop, r, false);
  const bool ok_close_br = outside && sp > 0 && pend == 0 && !fresh &&
                           !(r > 0 && vpop == 0 && anc2 == 0) &&
                           NEED_OK(k_pop, sp - 1, r, att_extra(k_pop, r, n_att_pop));
  const bool ok_dot = outside && prev_ok && pend == 0 && sp == 0 && r == 0 && rem >= 1;
  const bool ok_lbr = outside && (!prev_ok || vprev >= o_att) && NEED_OK(k_cur, sp, r, 2);

  // --- bracket atoms ---
  const bool inb = b > 0 && !done;
  const int extra_v = (r > 0 && anc_att == 0) ? 1 : 0;
  const int o_req = o_att + extra_v;
  const int bud_eff = bbud + bchg - bh;
  const int k_brk = credit(h_new, ndir_new, bud_eff - o_att, r, false);
  const bool fit_rbr = NEED_OK(k_brk, sp, r, 0);
  const bool fit_deco = NEED_OK(k_brk, sp, r, 1);
  const int k_lr = credit(h_new, ndir_new, 1 - o_att, r, false);
  const bool fit_lr = NEED_OK(k_lr, sp, r, 1);
  const bool ok_bl_row = inb && b == 2 && bsymc && 1 >= o_req && fit_lr;
  const bool ok_br_row = inb && b == 2 && bsymb && 1 >= o_req && fit_lr;
  const bool ok_at_row = inb && (b == 2 || b == 3) && fit_deco;
  const int k_h = credit(h_new, ndir_new, bud_eff - 1 - o_att, r, false);
  const bool ok_bh_row = inb && b >= 2 && b <= 4 && bud_eff - 1 >= o_req && NEED_OK(k_h, sp, r, 1);
  const bool sign_new = inb && b >= 2 && b <= 6;
  const bool sign_more = inb && b == 7 && bchg < 3;
  const bool ok_plus_row = (sign_new || (sign_more && bsign > 0)) && fit_deco;
  const bool ok_minus_row = (sign_new || (sign_more && bsign < 0)) && fit_deco;
  const bool ok_bdigc_row = inb && b == 7 && bchg == 1 && fit_deco;
  const bool ok_rbr_row = inb && b >= 2 && bud_eff >= o_req && fit_rbr;
  const bool closed = n_atoms >= 1 && pend == 0 && sp == 0 && r == 0 && b == 0 && prev_ok;
  const bool ok_pad_row = done || closed;

  // --- per class, on the lane that holds it ---
  auto legal = [&](int l, int k) -> bool {
    if (l + WARP * k >= C) return false;
    const Cls t = cls[l].at(k);
    const bool is_pad = t.is(T_PAD);
    if (done) return is_pad;
    const int g = t.g, bond = t.bond, dig = t.dig;
    bool ok = false;
    if (t.is(T_ATOM)) {
      const int v_new = g - o_att;
      const bool t_ok = !(r > 0 && v_new == 0 && anc_att == 0);
      const int k_atom = credit(h_new, ndir_new, v_new, r, false);
      ok = ok || (outside && (!prev_ok || vprev >= o_att) && v_new >= 0 && t_ok && NEED_OK(k_atom, sp, r, 0));
      ok = ok || (inb && b == 1 && g >= o_req && NEED_OK(k_atom, sp, r, 1));
    }
    if (t.is(T_L)) ok = ok || (ok_hal_row && hfix == 1) || ok_bl_row;
    if (t.is(T_R)) ok = ok || (ok_hal_row && hfix == 2) || ok_br_row;
    if (bond > 0) ok = ok || (ok_bond_row && vprev >= bond);
    if (dig > 0) {
      ok = ok || (dig < NRING && ((slot_ok >> dig) & 1u));
      if (inb && b == 5) {
        const int v_hd = bbud + bchg - dig - o_att;
        const int k_hd = credit(h_new, ndir_new, v_hd, r, false);
        ok = ok || (v_hd >= extra_v && NEED_OK(k_hd, sp, r, 1));
      }
      ok = ok || (dig <= 3 && ok_bdigc_row);
    }
    if (t.is(T_OPEN)) ok = ok || ok_open_br;
    if (t.is(T_CLOSE)) ok = ok || ok_close_br;
    if (t.is(T_DOT)) ok = ok || ok_dot;
    if (t.is(T_LBR)) ok = ok || ok_lbr;
    if (t.is(T_AT)) ok = ok || ok_at_row;
    if (t.is(T_H)) ok = ok || ok_bh_row;
    if (t.is(T_PLUS)) ok = ok || ok_plus_row;
    if (t.is(T_MINUS)) ok = ok || ok_minus_row;
    if (t.is(T_RBR)) ok = ok || ok_rbr_row;
    if (is_pad) ok = ok || ok_pad_row;
    return ok;
  };
#undef NEED_OK

  // --- 4. the legal set as ballot words ---
  Words ok{0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (WARP * k < C) ok.set(k, ballot([&](int l) { return legal(l, k); }));
  // defense in depth: a row with no legal token gets the pad escape hatch
  if ((ok.w0 | ok.w1 | ok.w2 | ok.w3) == 0u) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (WARP * k < C) ok.set(k, ballot([&](int l) { return l + WARP * k < C && cls[l].at(k).is(T_PAD); }));
  }
  return {ok, open};
}

// -- the selection ----------------------------------------------------------------

// The first maximum of the masked scores sc[0..C) (illegal = -inf); 0
// (pad) when a legal score is NaN.
AUTO_FN int warp_select(const Words& legal, const float* sc, int C) {
  const Lanes<Scores> ms = lanes([&](int l) {
    Scores s;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int c = l + WARP * k;
      s.set(k, (c < C && ((legal.at(k) >> l) & 1u)) ? sc[c] : -INFINITY);
    }
    return s;
  });
  const bool nan = ballot([&](int l) {
    const Scores s = ms[l];
    return s.s0 != s.s0 || s.s1 != s.s1 || s.s2 != s.s2 || s.s3 != s.s3;
  }) != 0u;
  if (nan) return 0;
  const float mx = lane_fmax(lanes([&](int l) {
    const Scores s = ms[l];
    return fmaxf(fmaxf(s.s0, s.s1), fmaxf(s.s2, s.s3));
  }));
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const unsigned eq = ballot([&](int l) { return l + WARP * k < C && ms[l].at(k) == mx; });
    if (eq != 0u) return WARP * k + first_set(eq) - 1;
  }
  return 0;
}

// -- the transition (advance), on one lane ------------------------------------------

// Apply the token whose attributes are t to the row in place; r_open is the
// number of open ring slots before it.
AUTO_FN void row_advance(const Cls& t, const Row& w, int r_open) {
  const int A = w.L.A, P = w.L.P;
  int* val = w.val();
  int* par = w.par();
  int* stack = w.stack();
  int* rpart = w.rpart();
  int* rhint = w.rhint();
  int* rres = w.rres();
  // the old scalars
  const int n_atoms = w.sc(S_NATOMS), prev = w.sc(S_PREV), pend = w.sc(S_PEND);
  const int sp = w.sc(S_SP), pn = w.sc(S_PN), hfix = w.sc(S_HFIX), horder = w.sc(S_HORDER);
  const int b = w.sc(S_B), bbud = w.sc(S_BBUD), bh = w.sc(S_BH), bchg = w.sc(S_BCHG);
  const int bsign = w.sc(S_BSIGN);
  const bool fresh = w.sc(S_FRESH) != 0, done = w.sc(S_DONE) != 0, esc = w.sc(S_ESC) != 0;
  const bool bsymc = w.sc(S_BSYMC) != 0, bsymb = w.sc(S_BSYMB) != 0;
  // the token's attributes
  const int g_tok = t.g, bond_o = t.bond, dig = t.dig;
  const bool is_atom = t.is(T_ATOM);
  const bool t_l = t.is(T_L), t_r = t.is(T_R), t_cu = t.is(T_CU), t_bu = t.is(T_BU);
  const bool t_open = t.is(T_OPEN), t_close = t.is(T_CLOSE), t_dot = t.is(T_DOT), t_lbr = t.is(T_LBR);
  const bool t_rbr = t.is(T_RBR), t_at = t.is(T_AT), t_h = t.is(T_H), t_plus = t.is(T_PLUS);
  const bool t_minus = t.is(T_MINUS), is_pad = t.is(T_PAD);

  const bool outside = b == 0 && !done;
  const bool prev_ok = prev >= 0;
  const bool prev_in = prev_ok && prev < A;  // the reference's oh_prev
  const bool new_in = n_atoms >= 0 && n_atoms < A;  // its oh_new
  const int o_att = pend > 0 ? pend : (prev_ok ? 1 : 0);
  // reads of the old arrays, before any write
  const bool closed = n_atoms >= 1 && pend == 0 && sp == 0 && r_open == 0 && b == 0 && prev >= 0;
  const int top = stack[imin(imax(sp - 1, 0), DMAX - 1)];

  // --- atom emission (outside bracket) ---
  const bool do_atom = outside && is_atom;
  if (do_atom) {
    if (prev_in) val[prev] -= o_att;
    if (new_in) val[n_atoms] += g_tok - o_att;
    if (prev_ok && new_in) par[n_atoms] = prev;
  }
  int n_atoms2 = n_atoms + (do_atom ? 1 : 0);
  int prev2 = do_atom ? n_atoms : prev;
  int pend2 = do_atom ? 0 : pend;
  bool fresh2 = fresh && !do_atom;
  int hfix2 = (do_atom && t_cu) ? 1 : ((do_atom && t_bu) ? 2 : 0);
  int horder2 = do_atom ? o_att : 0;

  // --- halogen fixup: the fresh C/B's budget becomes 1 - horder ---
  const bool do_hal = outside && (t_l || t_r) && hfix > 0;
  if (do_hal && prev2 >= 0 && prev2 < A) val[prev2] = 1 - horder;

  // --- bond ---
  const bool do_bond = outside && bond_o > 0 && !do_hal;
  if (do_bond) pend2 = bond_o;

  // --- ring digit ---
  const bool do_dig = outside && dig > 0;
  const int slot = do_dig ? dig : 0;
  const bool slot_in = slot >= 0 && slot < NRING;
  const int slot_part = slot_in ? rpart[slot] : 0;
  const int slot_hint = slot_in ? rhint[slot] : 0;
  const int slot_res = imax(slot_in ? rres[slot] : 0, 1);
  const bool is_close = do_dig && slot_part >= 0;
  const bool is_openr = do_dig && !is_close;
  const int res_o = imax(pend, 1);
  if (is_openr) {
    if (slot_in) {
      rpart[slot] = prev;
      rhint[slot] = pend;
      rres[slot] = res_o;
    }
    if (prev_in) val[prev] -= res_o;
  }
  int pn2 = pn;
  if (is_close) {
    const int o_fin = pend > 0 ? pend : imax(slot_hint, 1);
    const int sur = o_fin - slot_res;
    if (prev_in) val[prev] -= o_fin;
    if (slot_part >= 0 && slot_part < A) val[slot_part] -= sur;
    if (pn >= 0 && pn < P) {
      w.ppa()[pn] = imin(prev, slot_part);
      w.ppb()[pn] = imax(prev, slot_part);
    }
    pn2 = pn + 1;
    if (slot_in) rpart[slot] = -1;
  }
  if (do_dig) pend2 = 0;

  // --- '(' / ')' / '.' ---
  const bool do_open = outside && t_open;
  int sp2 = sp;
  if (do_open) {
    if (sp >= 0 && sp < DMAX) stack[sp] = prev;
    sp2 = sp + 1;
  }
  fresh2 = fresh2 || do_open;
  const bool do_close = outside && t_close;
  if (do_close) {
    prev2 = top;
    sp2 = sp - 1;
  }
  fresh2 = fresh2 && !do_close;
  if (outside && t_dot) prev2 = -1;

  // --- bracket machine ---
  int b2 = (outside && t_lbr) ? 1 : b;
  const bool inb = b > 0 && !done;
  const bool do_sym = inb && b == 1 && is_atom;
  if (do_sym) b2 = 2;
  int bbud2 = do_sym ? g_tok : bbud;
  bool bsymc2 = (do_sym && t_cu) || (!do_sym && bsymc);
  bool bsymb2 = (do_sym && t_bu) || (!do_sym && bsymb);
  const bool do_bhal = inb && b == 2 && ((t_l && bsymc) || (t_r && bsymb));
  if (do_bhal) {
    bbud2 = 1;
    bsymc2 = false;
    bsymb2 = false;
  }
  const bool do_at = inb && t_at;
  if (do_at && b == 2) b2 = 3;
  else if (do_at && b == 3) b2 = 4;
  const bool do_bh = inb && t_h;
  if (do_bh) b2 = 5;
  int bh2 = do_bh ? 1 : bh;
  const bool do_bhd = inb && b == 5 && dig > 0;
  if (do_bhd) {
    b2 = 6;
    bh2 = dig;
  }
  const bool do_sign = inb && (t_plus || t_minus);
  const bool first_sign = do_sign && b != 7;
  const bool more_sign = do_sign && b == 7;
  if (do_sign) b2 = 7;
  int bchg2 = first_sign ? 1 : bchg + (more_sign ? 1 : 0);
  int bsign2 = first_sign ? (t_plus ? 1 : -1) : bsign;
  const bool do_bcd = inb && b == 7 && dig > 0;
  if (do_bcd) {
    b2 = 8;
    bchg2 = dig;
  }
  const bool do_rbr = inb && t_rbr && b >= 2;
  if (do_rbr) {
    const int bud_eff = imax(bbud + bchg - bh, 0);
    if (prev_in) val[prev] -= o_att;
    if (new_in) val[n_atoms] += bud_eff - o_att;
    if (prev >= 0 && new_in) par[n_atoms] = prev;
    n_atoms2 += 1;
    prev2 = n_atoms;
    pend2 = 0;
    fresh2 = false;
    b2 = 0;
    bh2 = 0;
    bchg2 = 0;
    bsign2 = 0;
    bbud2 = 0;
  }

  // --- pad / done ---
  const bool esc2 = esc || (is_pad && !done && !closed);
  const bool done2 = done || is_pad;
  if (!do_atom) {
    hfix2 = 0;
    horder2 = 0;
  }

  w.sc(S_NATOMS) = n_atoms2;
  w.sc(S_PREV) = prev2;
  w.sc(S_PEND) = pend2;
  w.sc(S_SP) = sp2;
  w.sc(S_PN) = pn2;
  w.sc(S_HFIX) = hfix2;
  w.sc(S_HORDER) = horder2;
  w.sc(S_B) = b2;
  w.sc(S_BBUD) = bbud2;
  w.sc(S_BH) = bh2;
  w.sc(S_BCHG) = bchg2;
  w.sc(S_BSIGN) = bsign2;
  w.sc(S_FRESH) = fresh2 ? 1 : 0;
  w.sc(S_DONE) = done2 ? 1 : 0;
  w.sc(S_ESC) = esc2 ? 1 : 0;
  w.sc(S_BSYMC) = bsymc2 ? 1 : 0;
  w.sc(S_BSYMB) = bsymb2 ? 1 : 0;
}

// -- one row, as each entry point runs it ------------------------------------------

// n steps (mask, select, advance) over the scores sc (n, C), rem = rem0,
// rem0 - 1, ...; codes[0..n) of the row
AUTO_FN void steps_row(const Lanes<Classes>& cls, int C, const Row& w, const float* sc, int n, int rem0,
                       int* codes) {
  for (int k = 0; k < n; ++k) {
    const Step s = warp_mask(cls, C, w, rem0 - k);
    const int code = warp_select(s.legal, sc + (size_t)k * C, C);
    const Cls t = token_of(cls, C, code);
    on_lane0([&] {
      codes[k] = code;
      row_advance(t, w, popc(s.open));
    });
  }
}

// the mask alone, as bytes out[0..C) of the row
AUTO_FN void mask_row(const Lanes<Classes>& cls, int C, const Row& w, int rem, unsigned char* out) {
  const Step s = warp_mask(cls, C, w, rem);
  each_lane([&](int l) {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (l + WARP * k < C) out[l + WARP * k] = (unsigned char)((s.legal.at(k) >> l) & 1u);
  });
}

// the transition alone, for token tok
AUTO_FN void advance_row(const Lanes<Classes>& cls, int C, const Row& w, int tok) {
  const int* rpart = w.rpart();
  const unsigned open = ballot([&](int l) { return l < NRING && rpart[l] >= 0; });
  const Cls t = token_of(cls, C, tok);
  on_lane0([&] { row_advance(t, w, popc(open)); });
}

}  // namespace automaton
