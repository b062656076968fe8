// molvax native tokenizer: multithreaded SMILES -> uint8 charset codes.
//
// The port's own copy of molvax/data/_native/tokenizer.cpp, built and loaded
// by molvax_torch/data/native.py.
//
// Role (SURVEY.md 2.2/2.8 + rebuild upgrades): the reference featurizes
// offline in Python/NumPy; molvax keeps featurization on the fly so raw
// SMILES corpora (MOSES 1.9M, BASELINE.json:10) load without a preprocessing
// step. Python-level char loops are the bottleneck at that scale, so the hot
// host path is this small C library (no Python objects touched inside the
// parallel region), reached via ctypes (data/native.py) with a NumPy
// fallback when the shared object is missing.
//
// API (C ABI, ctypes-friendly):
//   mv_encode_batch: concatenated ASCII buffer + offsets -> (n, max_len)
//     uint8 codes, right-padded with pad_code. Returns the number of strings
//     that were clean (known chars, length <= max_len); unknown chars map to
//     pad and oversize strings truncate, mirroring encode_smiles(strict=False).
//   mv_decode_batch: (n, max_len) codes -> concatenated ASCII + lengths
//     (padding stripped from everywhere, matching decode_codes).
//   mv_count_valid: grammar heuristic (charset membership + balanced
//     parens/brackets) over an encoded batch - the valid_fraction metric.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Simple static partitioner: run fn(begin, end) over [0, n) on k threads.
template <typename F>
void parallel_for(int64_t n, F fn) {
  int k = hardware_threads();
  if (n < 4096 || k <= 1) {  // small batches: threading overhead dominates
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + k - 1) / k;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// table: 256 bytes, ascii byte -> code (pad_code for unknown)
// known: 256 bytes, 1 if ascii byte is in the charset
int64_t mv_encode_batch(const char* buf, const int64_t* offsets, int64_t n,
                        const uint8_t* table, const uint8_t* known,
                        int64_t max_len, uint8_t pad_code, uint8_t* out) {
  std::atomic<int64_t> clean{0};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t local_clean = 0;
    for (int64_t i = lo; i < hi; ++i) {
      const char* s = buf + offsets[i];
      int64_t len = offsets[i + 1] - offsets[i];
      uint8_t* row = out + i * max_len;
      bool ok = len <= max_len;
      int64_t m = len < max_len ? len : max_len;
      for (int64_t j = 0; j < m; ++j) {
        uint8_t c = static_cast<uint8_t>(s[j]);
        ok = ok && known[c];
        row[j] = table[c];
      }
      if (m < max_len) std::memset(row + m, pad_code, max_len - m);
      local_clean += ok ? 1 : 0;
    }
    clean.fetch_add(local_clean, std::memory_order_relaxed);
  });
  return clean.load();
}

// dtable: charset_size bytes, code -> ascii byte
void mv_decode_batch(const uint8_t* codes, int64_t n, int64_t max_len,
                     const uint8_t* dtable, uint8_t pad_code, char* out_buf,
                     int64_t* out_lens) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = codes + i * max_len;
      char* dst = out_buf + i * max_len;
      int64_t m = 0;
      for (int64_t j = 0; j < max_len; ++j) {
        if (row[j] != pad_code) dst[m++] = static_cast<char>(dtable[row[j]]);
      }
      out_lens[i] = m;
    }
  });
}

// open_code/close_code: '(' / ')'; sq_open/sq_close: '[' / ']'
int64_t mv_count_valid(const uint8_t* codes, int64_t n, int64_t max_len,
                       uint8_t pad_code, uint8_t open_code, uint8_t close_code,
                       uint8_t sq_open, uint8_t sq_close) {
  std::atomic<int64_t> valid{0};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t local = 0;
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* row = codes + i * max_len;
      int depth = 0, sq = 0;
      bool good = false, bad = false;
      for (int64_t j = 0; j < max_len; ++j) {
        uint8_t c = row[j];
        if (c == pad_code) continue;
        good = true;
        if (c == open_code) depth++;
        else if (c == close_code) depth--;
        else if (c == sq_open) sq++;
        else if (c == sq_close) sq--;
        if (depth < 0 || sq < 0 || sq > 1) { bad = true; break; }
      }
      if (good && !bad && depth == 0 && sq == 0) local++;
    }
    valid.fetch_add(local, std::memory_order_relaxed);
  });
  return valid.load();
}

}  // extern "C"
