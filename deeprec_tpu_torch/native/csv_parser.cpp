// Fast Criteo-TSV batch parser — the port's copy of the native data-plane
// component (deeprec_tpu/native/csv_parser.cpp), built on its own by g++.
//
// DeepRec's input pipeline parses columnar data in C++ kernels
// (core/kernels/data/parquet_batch_reader.cc, CSV via TF ops). Python-side
// pandas parsing can't feed an accelerator at full rate; this parser turns raw TSV
// bytes into ready batch arrays (labels, log-transformed-ready dense floats,
// crc32-hashed categorical ids) in one pass, exposed via ctypes.
//
// Format per line: label \t I1..I13 \t C1..C26 (hex strings), '\t' separated,
// missing fields empty. Output ids use (crc32(token) ^ salt_i) & 0x7fffffff —
// the SAME mapping as data/readers.py so native and python readers agree.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// CRC32 (IEEE, reflected) — table-driven, matches zlib.crc32.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32(const char* data, size_t n) {
  if (!crc_init_done) crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i)
    c = crc_table[(c ^ static_cast<uint8_t>(data[i])) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" {

// Parse up to max_rows lines from buf[0..len). Returns rows parsed; writes
// *consumed = bytes consumed (ends on a line boundary, so callers can stream
// chunks). labels [max_rows], dense [max_rows * num_dense], cats
// [max_rows * num_cat] (row-major). Missing dense -> 0, missing cat -> -1.
int64_t criteo_parse(
    const char* buf, int64_t len, int64_t max_rows, int num_dense, int num_cat,
    float* labels, float* dense, int32_t* cats, int64_t* consumed) {
  int64_t row = 0;
  int64_t pos = 0;
  while (row < max_rows) {
    // find end of line
    int64_t eol = pos;
    while (eol < len && buf[eol] != '\n') ++eol;
    if (eol >= len) break;  // incomplete line: stop, let caller refill

    int64_t p = pos;
    int field = 0;
    const int total_fields = 1 + num_dense + num_cat;
    while (field < total_fields && p <= eol) {
      int64_t start = p;
      while (p < eol && buf[p] != '\t') ++p;
      int64_t flen = p - start;
      if (field == 0) {
        labels[row] = flen ? static_cast<float>(strtol(buf + start, nullptr, 10))
                           : 0.f;
      } else if (field <= num_dense) {
        dense[row * num_dense + (field - 1)] =
            flen ? strtof(buf + start, nullptr) : 0.f;
      } else {
        int ci = field - 1 - num_dense;
        if (flen) {
          uint32_t salt = (uint32_t)(ci + 1) * 0x9E3779B9u & 0x7FFFFFFFu;
          cats[row * num_cat + ci] =
              (int32_t)((crc32(buf + start, flen) ^ salt) & 0x7FFFFFFFu);
        } else {
          cats[row * num_cat + ci] = -1;
        }
      }
      ++field;
      ++p;  // skip the tab / newline
    }
    // zero-fill any missing trailing fields
    for (; field <= num_dense; ++field)
      dense[row * num_dense + (field - 1)] = 0.f;
    for (; field < total_fields; ++field)
      cats[row * num_cat + (field - 1 - num_dense)] = -1;

    pos = eol + 1;
    ++row;
  }
  *consumed = pos;
  return row;
}

// Multi-threaded variant: pass 1 scans line boundaries (memchr), pass 2
// parses disjoint row ranges in parallel — each line writes to its own
// output slice, so no synchronization is needed. Same outputs bit-for-bit
// as criteo_parse. `threads` <= 0 picks the hardware count (capped at 16).
int64_t criteo_parse_mt(
    const char* buf, int64_t len, int64_t max_rows, int num_dense, int num_cat,
    int threads, float* labels, float* dense, int32_t* cats,
    int64_t* consumed) {
  if (!crc_init_done) crc_init();  // once, before threads spawn
  // pass 1: line starts for up to max_rows complete lines
  std::vector<int64_t> starts;
  starts.reserve(static_cast<size_t>(max_rows) + 1);
  int64_t pos = 0;
  while (static_cast<int64_t>(starts.size()) < max_rows) {
    const char* nl = static_cast<const char*>(
        memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    if (!nl) break;
    starts.push_back(pos);
    pos = (nl - buf) + 1;
  }
  const int64_t nrows = static_cast<int64_t>(starts.size());
  starts.push_back(pos);  // sentinel: end of the consumed region
  *consumed = pos;
  if (nrows == 0) return 0;

  int T = threads > 0 ? threads
                      : static_cast<int>(std::thread::hardware_concurrency());
  if (T > 16) T = 16;
  if (T < 1) T = 1;
  if (nrows < 4 * T) T = 1;  // tiny batches: thread spawn costs more

  auto parse_range = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      int64_t dummy;
      criteo_parse(buf + starts[r], starts[r + 1] - starts[r], 1, num_dense,
                   num_cat, labels + r, dense + r * num_dense,
                   cats + r * num_cat, &dummy);
    }
  };
  if (T == 1) {
    parse_range(0, nrows);
    return nrows;
  }
  std::vector<std::thread> pool;
  pool.reserve(T);
  const int64_t per = (nrows + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t r0 = t * per;
    int64_t r1 = r0 + per < nrows ? r0 + per : nrows;
    if (r0 >= r1) break;
    pool.emplace_back(parse_range, r0, r1);
  }
  for (auto& th : pool) th.join();
  return nrows;
}

}  // extern "C"
