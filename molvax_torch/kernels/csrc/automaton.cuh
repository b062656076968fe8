// The constrained-decoding automaton on one packed row: mask, select,
// advance. Scalar code for one thread, written once for csrc/automaton.cu.
//
// Computes the function of molvax_torch/latent/constrain.py
// (step_mask_rem, advance) and of kernels/automaton.py::select_advance on
// the packed row layout of kernels/automaton.py, bit for bit. Where the
// reference reduces one-hot contractions (a TPU has no vector gather), this
// code indexes the row directly; an index outside an array's range reads 0,
// as a one-hot contraction does, and a write outside it is dropped.
// Floor division is written as such (JAX's // floors for negative values).
//
// The functions are plain C++ under AUTO_FN, so the row logic also
// compiles as host code.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define AUTO_FN __device__ __forceinline__
#else
#define AUTO_FN inline
#endif

namespace automaton {

constexpr int DMAX = 16;   // branch stack depth
constexpr int NRING = 10;  // ring-digit slots
constexpr int RMAX = 6;    // max simultaneously open rings
constexpr int NSC = 17;    // packed scalars
constexpr int MAXC = 128;  // token classes a row's mask holds
constexpr int MWORDS = MAXC / 64;

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
  AUTO_FN int val() const { return 0; }
  AUTO_FN int par() const { return A; }
  AUTO_FN int stack() const { return 2 * A; }
  AUTO_FN int rpart() const { return 2 * A + DMAX; }
  AUTO_FN int rhint() const { return 2 * A + DMAX + NRING; }
  AUTO_FN int rres() const { return 2 * A + DMAX + 2 * NRING; }
  AUTO_FN int ppa() const { return 2 * A + DMAX + 3 * NRING; }
  AUTO_FN int ppb() const { return 2 * A + DMAX + 3 * NRING + P; }
  AUTO_FN int sc() const { return 2 * A + DMAX + 3 * NRING + 2 * P; }
  AUTO_FN int width() const { return sc() + NSC; }
};

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

// token attribute of table row `row` at class c (0 outside [0, C))
AUTO_FN int tab_at(const int* tab, int C, int row, int c) {
  return (c >= 0 && c < C) ? tab[row * C + c] : 0;
}

// greedy number of closures affordable within w from the cost histogram h
AUTO_FN int take(const int h[4], int w) {
  int m = 0;
  for (int i = 0; i < 4; ++i) {
    const int c = i + 1;
    const int t = imin(imax(floordiv(w, c), 0), h[i]);
    m += t;
    w -= t * c;
  }
  return m;
}

AUTO_FN int credit(const int h[4], int ndir, int v, int r, bool partial_only) {
  int k = imin(take(h, v - 1), ndir);
  if (!partial_only) {
    const int kfull = take(h, v);
    if (ndir >= r && kfull >= r) k = r;
  }
  return imin(k, r);
}

AUTO_FN int att_extra(int k, int rr, int natt) { return (natt > 0 && k >= rr - natt) ? 1 : 0; }

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

// max over the DMAX stack entries of (live ? val[stack[d]] - adj : 0), the
// reference's _anc_spare_max: live = d < limit and stack[d] >= 0; adj is
// subtracted where stack[d] == adj_idx.
AUTO_FN int anc_spare_max(const Row& w, int limit, int adj_idx, int adj) {
  const int* st = w.stack();
  int m = 0;
  for (int d = 0; d < DMAX; ++d) {
    int v = 0;
    if (d < limit && st[d] >= 0) {
      v = at(w.val(), w.L.A, st[d]);
      if (st[d] == adj_idx) v -= adj;
    }
    m = d == 0 ? v : imax(m, v);
  }
  return m;
}

// _dup_wrt for one open slot (part >= 0) at atom a: the closure would
// duplicate a pooled ring bond or a chain bond (a-parent, partner-parent).
// Pool entries at and past pn were never written (-1, -1) and cannot match
// hi = max(part, a) >= 0, so the scan stops at pn.
AUTO_FN bool dup_wrt(const Row& w, int part, int a) {
  const int lo = imin(part, a), hi = imax(part, a);
  const int used = imin(imax(w.sc(S_PN), 0), w.L.P);
  const int* ppa = w.ppa();
  const int* ppb = w.ppb();
  for (int p = 0; p < used; ++p)
    if (ppa[p] == lo && ppb[p] == hi) return true;
  const int par_a = at(w.par(), w.L.A, a);
  const int par_part = at(w.par(), w.L.A, part);
  return part == par_a || par_part == a;
}

AUTO_FN void hist(const bool m[NRING], const int res[NRING], int h[4]) {
  h[0] = h[1] = h[2] = h[3] = 0;
  for (int j = 0; j < NRING; ++j)
    if (m[j] && res[j] >= 1 && res[j] <= 4) h[res[j] - 1] += 1;
}

AUTO_FN int count(const bool m[NRING]) {
  int n = 0;
  for (int j = 0; j < NRING; ++j) n += m[j] ? 1 : 0;
  return n;
}

AUTO_FN void set_bit(uint64_t bits[MWORDS], int c) { bits[c >> 6] |= (uint64_t)1 << (c & 63); }
AUTO_FN bool get_bit(const uint64_t bits[MWORDS], int c) { return (bits[c >> 6] >> (c & 63)) & 1; }

// The legal-token set of the row (step_mask_rem), rem = tokens remaining
// after this one, as bits[0..C).
AUTO_FN void row_mask(const int* tab, int C, const Row& w, int rem, uint64_t bits[MWORDS]) {
  const int A = w.L.A;
  const int* val = w.val();
  const int* stack = w.stack();
  const int* rpart = w.rpart();
  const int* rhint = w.rhint();
  const int* rres = w.rres();
  const int n_atoms = w.sc(S_NATOMS), prev = w.sc(S_PREV), pend = w.sc(S_PEND);
  const int sp = w.sc(S_SP), hfix = w.sc(S_HFIX), horder = w.sc(S_HORDER), b = w.sc(S_B);
  const int bbud = w.sc(S_BBUD), bh = w.sc(S_BH), bchg = w.sc(S_BCHG), bsign = w.sc(S_BSIGN);
  const bool fresh = w.sc(S_FRESH) != 0, done = w.sc(S_DONE) != 0;
  const bool bsymc = w.sc(S_BSYMC) != 0, bsymb = w.sc(S_BSYMB) != 0;

  const bool prev_ok = prev >= 0;
  const int vprev = at(val, A, prev);
  const int anc = anc_spare_max(w, sp, -1, 0);
  bool open_d[NRING];
  int r = 0;
  for (int j = 0; j < NRING; ++j) {
    open_d[j] = rpart[j] >= 0;
    r += open_d[j] ? 1 : 0;
  }
  const int o_att = pend > 0 ? pend : (prev_ok ? 1 : 0);
  const bool outside = b == 0 && !done;

  // --- ring-closure credit machinery ---
  int res[NRING];
  bool first_p[NRING], direct_prev[NRING], cred_prev[NRING], new_ok[NRING];
  int n_att = 0;
  for (int j = 0; j < NRING; ++j) {
    res[j] = imax(rres[j], 1);
    bool seen = false;
    for (int m = 0; m < j; ++m) seen = seen || (open_d[m] && rpart[m] == rpart[j]);
    first_p[j] = !seen;
    direct_prev[j] = open_d[j] && rpart[j] != prev && !dup_wrt(w, rpart[j], prev);
    cred_prev[j] = direct_prev[j] && first_p[j];
    new_ok[j] = open_d[j] && first_p[j] && rpart[j] != prev;
    n_att += (open_d[j] && rpart[j] == prev) ? 1 : 0;
  }
  int h_prev[4], h_new[4];
  hist(cred_prev, res, h_prev);
  hist(new_ok, res, h_new);
  const int ndir_prev = count(cred_prev), ndir_new = count(new_ok);
  // need_ok(k, sp_, rr, extra): sp_ + 2 rr - k + extra <= rem
#define NEED_OK(k, sp_, rr, extra) ((sp_) + 2 * (rr) - (k) + (extra) <= rem)

  // --- per-row parts of the atom, halogen, bond and bracket rules ---
  const int anc_att = anc_spare_max(w, sp, prev, o_att);
  const int v_hal = 1 - horder;
  const bool t_hal = !(r > 0 && v_hal == 0 && anc == 0);
  const int k_hal = credit(h_prev, ndir_prev, v_hal, r, false);
  const bool ok_hal_row = outside && v_hal >= 0 && t_hal && NEED_OK(k_hal, sp, r, 0);
  const bool ok_bond_row = outside && prev_ok && pend == 0 && NEED_OK(0, sp, r, 1 + (fresh ? 1 : 0));

  // --- ring digits: per slot ---
  const int v_po = vprev - o_att;
  const int k_po = credit(h_prev, ndir_prev, v_po, r, true);
  const bool open_row = outside && prev_ok && !fresh && vprev >= o_att && r < RMAX &&
                        (v_po >= 1 || anc_att >= 1) &&
                        NEED_OK(k_po, sp, r + 1, att_extra(k_po, r + 1, n_att + 1));
  bool slot_ok[NRING];
  for (int j = 0; j < NRING; ++j) {
    const bool ok_open = open_row && rpart[j] == -1;
    bool ok_close = false;
    if (outside && prev_ok && direct_prev[j] && !fresh) {
      const int o_fin = pend > 0 ? pend : imax(rhint[j], 1);
      const bool mismatch = pend > 0 && rhint[j] > 0 && pend != rhint[j];
      const int sur = o_fin - res[j];
      const int vpart = at(val, A, rpart[j]);
      const int v_pc = vprev - o_fin;
      int anc_pc = 0;
      for (int d = 0; d < DMAX; ++d) {
        int v = 0;
        if (d < sp && stack[d] >= 0) {
          v = at(val, A, stack[d]);
          if (stack[d] == prev) v -= o_fin;
          if (stack[d] == rpart[j]) v -= sur;
        }
        anc_pc = d == 0 ? v : imax(anc_pc, v);
      }
      const bool t_pc = !((r - 1) > 0 && v_pc == 0 && anc_pc == 0);
      bool direct_mat[NRING];
      for (int m = 0; m < NRING; ++m)
        direct_mat[m] = direct_prev[m] && rpart[j] != rpart[m] && first_p[m];
      int h_mat[4];
      hist(direct_mat, res, h_mat);
      const int k_pc = credit(h_mat, count(direct_mat), v_pc, r - 1, false);
      ok_close = !mismatch && vprev >= o_fin && vpart >= sur && t_pc &&
                 NEED_OK(k_pc, sp, r - 1, att_extra(k_pc, r - 1, n_att));
    }
    slot_ok[j] = ok_open || ok_close;
  }

  // --- '(' / ')' / '.' / '[' ---
  const int k_cur = credit(h_prev, ndir_prev, vprev, r, false);
  const bool ok_open_br = outside && prev_ok && !fresh && pend == 0 && sp < DMAX && vprev >= 1 &&
                          NEED_OK(k_cur, sp + 1, r, 1);
  const int popped = at(stack, DMAX, sp > 0 ? sp - 1 : 0);
  const int vpop = at(val, A, sp > 0 ? popped : -1);
  const int anc2 = anc_spare_max(w, sp - 1, -1, 0);
  bool direct_pop[NRING];
  int n_att_pop = 0;
  for (int j = 0; j < NRING; ++j) {
    direct_pop[j] = open_d[j] && rpart[j] != popped && first_p[j] && !dup_wrt(w, rpart[j], popped);
    n_att_pop += (open_d[j] && rpart[j] == popped) ? 1 : 0;
  }
  int h_pop[4];
  hist(direct_pop, res, h_pop);
  const int k_pop = credit(h_pop, count(direct_pop), vpop, r, false);
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

  // --- per token ---
  for (int i = 0; i < MWORDS; ++i) bits[i] = 0;
  bool any_ok = false;
  for (int c = 0; c < C; ++c) {
    const bool is_pad = tab_at(tab, C, T_PAD, c) != 0;
    bool ok;
    if (done) {
      ok = is_pad;
    } else {
      const int g = tab_at(tab, C, T_BUDGET, c);
      const bool is_atom = tab_at(tab, C, T_ATOM, c) != 0;
      const int bond = tab_at(tab, C, T_BOND, c);
      const int dig = tab_at(tab, C, T_DIGIT, c);
      ok = false;
      if (is_atom) {
        const int v_new = g - o_att;
        const bool t_ok = !(r > 0 && v_new == 0 && anc_att == 0);
        const int k_atom = credit(h_new, ndir_new, v_new, r, false);
        ok = ok || (outside && (!prev_ok || vprev >= o_att) && v_new >= 0 && t_ok &&
                    NEED_OK(k_atom, sp, r, 0));
        ok = ok || (inb && b == 1 && g >= o_req && NEED_OK(k_atom, sp, r, 1));
      }
      if (tab_at(tab, C, T_L, c)) ok = ok || (ok_hal_row && hfix == 1) || ok_bl_row;
      if (tab_at(tab, C, T_R, c)) ok = ok || (ok_hal_row && hfix == 2) || ok_br_row;
      if (bond > 0) ok = ok || (ok_bond_row && vprev >= bond);
      if (dig > 0) {
        ok = ok || (dig < NRING && slot_ok[dig]);
        if (inb && b == 5) {
          const int v_hd = bbud + bchg - dig - o_att;
          const int k_hd = credit(h_new, ndir_new, v_hd, r, false);
          ok = ok || (v_hd >= extra_v && NEED_OK(k_hd, sp, r, 1));
        }
        ok = ok || (dig <= 3 && ok_bdigc_row);
      }
      if (tab_at(tab, C, T_OPEN, c)) ok = ok || ok_open_br;
      if (tab_at(tab, C, T_CLOSE, c)) ok = ok || ok_close_br;
      if (tab_at(tab, C, T_DOT, c)) ok = ok || ok_dot;
      if (tab_at(tab, C, T_LBR, c)) ok = ok || ok_lbr;
      if (tab_at(tab, C, T_AT, c)) ok = ok || ok_at_row;
      if (tab_at(tab, C, T_H, c)) ok = ok || ok_bh_row;
      if (tab_at(tab, C, T_PLUS, c)) ok = ok || ok_plus_row;
      if (tab_at(tab, C, T_MINUS, c)) ok = ok || ok_minus_row;
      if (tab_at(tab, C, T_RBR, c)) ok = ok || ok_rbr_row;
      if (is_pad) ok = ok || ok_pad_row;
    }
    if (ok) {
      set_bit(bits, c);
      any_ok = true;
    }
  }
  // defense in depth: a row with no legal token gets the pad escape hatch
  if (!any_ok)
    for (int c = 0; c < C; ++c)
      if (tab_at(tab, C, T_PAD, c)) set_bit(bits, c);
#undef NEED_OK
}

// The first maximum of the masked scores (illegal = -inf); 0 (pad) when a
// legal score is NaN.
AUTO_FN int row_select(const uint64_t bits[MWORDS], const float* scores, int C) {
  const float neg_inf = -INFINITY;
  float mx = neg_inf;
  for (int c = 0; c < C; ++c) {
    const float s = get_bit(bits, c) ? scores[c] : neg_inf;
    if (s != s) return 0;
    if (c == 0 || s > mx) mx = s;
  }
  for (int c = 0; c < C; ++c) {
    const float s = get_bit(bits, c) ? scores[c] : neg_inf;
    if (s == mx) return c;
  }
  return 0;
}

// Apply token tok to the row in place (advance).
AUTO_FN void row_advance(const int* tab, int C, const Row& w, int tok) {
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
  // the token's attributes (0 outside [0, C))
  const int g_tok = tab_at(tab, C, T_BUDGET, tok);
  const bool is_atom = tab_at(tab, C, T_ATOM, tok) != 0;
  const int bond_o = tab_at(tab, C, T_BOND, tok);
  const int dig = tab_at(tab, C, T_DIGIT, tok);
  const bool t_l = tab_at(tab, C, T_L, tok) != 0, t_r = tab_at(tab, C, T_R, tok) != 0;
  const bool t_cu = tab_at(tab, C, T_CU, tok) != 0, t_bu = tab_at(tab, C, T_BU, tok) != 0;
  const bool t_open = tab_at(tab, C, T_OPEN, tok) != 0, t_close = tab_at(tab, C, T_CLOSE, tok) != 0;
  const bool t_dot = tab_at(tab, C, T_DOT, tok) != 0, t_lbr = tab_at(tab, C, T_LBR, tok) != 0;
  const bool t_rbr = tab_at(tab, C, T_RBR, tok) != 0, t_at = tab_at(tab, C, T_AT, tok) != 0;
  const bool t_h = tab_at(tab, C, T_H, tok) != 0, t_plus = tab_at(tab, C, T_PLUS, tok) != 0;
  const bool t_minus = tab_at(tab, C, T_MINUS, tok) != 0, is_pad = tab_at(tab, C, T_PAD, tok) != 0;

  const bool outside = b == 0 && !done;
  const bool prev_ok = prev >= 0;
  const bool prev_in = prev_ok && prev < A;  // the reference's oh_prev
  const bool new_in = n_atoms >= 0 && n_atoms < A;  // its oh_new
  const int o_att = pend > 0 ? pend : (prev_ok ? 1 : 0);
  // reads of the old arrays, before any write
  int r_open = 0;
  for (int j = 0; j < NRING; ++j) r_open += rpart[j] >= 0 ? 1 : 0;
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

}  // namespace automaton
