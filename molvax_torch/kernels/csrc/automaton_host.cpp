// The automaton's warp program (automaton.cuh) as host C++: the same row
// functions as csrc/automaton.cu's kernels, each warp primitive run by the
// host stand-in over the 32 lanes one after another, row after row, on the
// rows in place. Built with g++ by tests/test_torch_automaton_design.py,
// which holds it bit for bit to the plain versions of kernels/automaton.py;
// nvcc never compiles it (kernels/_build.py builds csrc/*.cu).
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libautomaton_host.so automaton_host.cpp
//
// Same arguments as the kernels' C entry points, without the stream; each
// returns 0, or 1 for a shape the kernels refuse.

#include <stddef.h>

#include "automaton.cuh"

using namespace automaton;

namespace {

bool bad_shape(int C, int B, int A, int P) { return C < 1 || C > MAXC || B < 1 || A < 1 || P < 1; }

}  // namespace

extern "C" int molvax_auto_step_host(const int* tab, int C, int* state, int B, int A, int P, const float* scores,
                                     int n, int rem0, int* codes) {
  if (bad_shape(C, B, A, P) || n < 1) return 1;
  const Layout L{A, P};
  const Lanes<Classes> cls = load_classes(tab, C);
  for (int row = 0; row < B; ++row)
    steps_row(cls, C, Row{state + (size_t)row * L.width(), L}, scores + (size_t)row * n * C, n, rem0,
              codes + (size_t)row * n);
  return 0;
}

extern "C" int molvax_auto_mask_host(const int* tab, int C, int* state, int B, int A, int P, int rem,
                                     unsigned char* mask) {
  if (bad_shape(C, B, A, P)) return 1;
  const Layout L{A, P};
  const Lanes<Classes> cls = load_classes(tab, C);
  for (int row = 0; row < B; ++row)
    mask_row(cls, C, Row{state + (size_t)row * L.width(), L}, rem, mask + (size_t)row * C);
  return 0;
}

extern "C" int molvax_auto_advance_host(const int* tab, int C, int* state, int B, int A, int P, const int* tok) {
  if (bad_shape(C, B, A, P)) return 1;
  const Layout L{A, P};
  const Lanes<Classes> cls = load_classes(tab, C);
  for (int row = 0; row < B; ++row) advance_row(cls, C, Row{state + (size_t)row * L.width(), L}, tok[row]);
  return 0;
}
