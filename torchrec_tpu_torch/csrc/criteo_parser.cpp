// Native Criteo TSV parser — the data-loading hot path in C++.
//
// The reference delegates its native work to FBGEMM/CUDA; its Criteo
// preprocessing (torchrec/datasets/criteo.py:188-253 tsv_to_npys) is a
// per-row Python loop over a TSV reader. Here the parse is a zero-copy
// multithreaded scan: the file is read once, split into chunks at line
// boundaries, and each thread decodes label / 13 decimal ints / 26 hex
// ids straight into preallocated int32 output arrays.
//
// Exposed via a C ABI for ctypes (no pybind11 in the image):
//   count_lines(path)                         -> rows (or -1)
//   parse_criteo_tsv(path, dense, sparse, labels, max_rows, n_threads)
//       dense:  [max_rows * 13] int32 (raw ints; log transform in Python)
//       sparse: [max_rows * 26] int32 (hex-decoded)
//       labels: [max_rows]      int32
//       returns rows parsed (or -1 on error)
//
// Build: utils/native.build_native_lib (g++ -O3 -shared -fPIC -pthread
// -std=c++17), loaded by datasets/criteo.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kIntFeatures = 13;
constexpr int kCatFeatures = 26;

// Read the whole file into a buffer. Returns false on IO error.
bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(size);
}

// Decimal int parse over [p, end) until tab/newline. Missing -> 0.
inline const char* parse_dec(const char* p, const char* end, int32_t* out) {
  int64_t v = 0;
  bool neg = false;
  if (p < end && *p == '-') {
    neg = true;
    ++p;
  }
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = static_cast<int32_t>(neg ? -v : v);
  return p;
}

// Hex parse (lowercase criteo ids) until tab/newline. Missing -> 0.
inline const char* parse_hex(const char* p, const char* end, int32_t* out) {
  uint64_t v = 0;
  while (p < end) {
    char c = *p;
    uint32_t d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = (v << 4) | d;
    ++p;
  }
  // numpy int32 semantics: wrap (the reference stores int32 of the hex id)
  *out = static_cast<int32_t>(static_cast<uint32_t>(v));
  return p;
}

inline const char* skip_field(const char* p, const char* end) {
  if (p < end && *p == '\t') return p + 1;
  return p;
}

// Parse rows in [begin, end) writing to row-major outputs at row `row0`.
void parse_chunk(const char* begin, const char* end, int64_t row0,
                 int64_t max_rows, int32_t* dense, int32_t* sparse,
                 int32_t* labels, int64_t* rows_done) {
  const char* p = begin;
  int64_t row = row0;
  while (p < end && row < max_rows) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;

    int32_t label = 0;
    p = parse_dec(p, line_end, &label);
    labels[row] = label;
    p = skip_field(p, line_end);

    int32_t* drow = dense + row * kIntFeatures;
    for (int i = 0; i < kIntFeatures; ++i) {
      p = parse_dec(p, line_end, &drow[i]);
      p = skip_field(p, line_end);
    }
    int32_t* srow = sparse + row * kCatFeatures;
    for (int i = 0; i < kCatFeatures; ++i) {
      p = parse_hex(p, line_end, &srow[i]);
      p = skip_field(p, line_end);
    }
    ++row;
    p = line_end < end ? line_end + 1 : end;
  }
  *rows_done = row - row0;
}

int64_t count_lines_buf(const std::string& buf) {
  int64_t n = 0;
  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!nl) {
      ++n;  // trailing line without newline
      break;
    }
    ++n;
    p = nl + 1;
  }
  return n;
}

}  // namespace

extern "C" {

int64_t count_lines(const char* path) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  return count_lines_buf(buf);
}

int64_t parse_criteo_tsv(const char* path, int32_t* dense, int32_t* sparse,
                         int32_t* labels, int64_t max_rows,
                         int32_t n_threads) {
  std::string buf;
  if (!read_file(path, &buf)) return -1;
  const char* data = buf.data();
  const char* end = data + buf.size();

  if (n_threads < 1) n_threads = 1;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads > hw && hw > 0) n_threads = hw;

  // Split into chunks at line boundaries, counting rows per chunk so each
  // thread knows its absolute output row offset.
  std::vector<const char*> chunk_begin;
  std::vector<const char*> chunk_end;
  std::vector<int64_t> chunk_row0;
  size_t approx = buf.size() / static_cast<size_t>(n_threads) + 1;
  const char* p = data;
  while (p < end) {
    const char* q = p + approx;
    if (q >= end) {
      q = end;
    } else {
      const char* nl = static_cast<const char*>(
          memchr(q, '\n', static_cast<size_t>(end - q)));
      q = nl ? nl + 1 : end;
    }
    chunk_begin.push_back(p);
    chunk_end.push_back(q);
    p = q;
  }
  // absolute row offsets: count rows per chunk (parallel count)
  std::vector<int64_t> rows_in_chunk(chunk_begin.size(), 0);
  {
    std::vector<std::thread> ts;
    for (size_t c = 0; c < chunk_begin.size(); ++c) {
      ts.emplace_back([&, c] {
        int64_t n = 0;
        const char* cp = chunk_begin[c];
        while (cp < chunk_end[c]) {
          const char* nl = static_cast<const char*>(memchr(
              cp, '\n', static_cast<size_t>(chunk_end[c] - cp)));
          if (!nl) {
            ++n;
            break;
          }
          ++n;
          cp = nl + 1;
        }
        rows_in_chunk[c] = n;
      });
    }
    for (auto& t : ts) t.join();
  }
  chunk_row0.resize(chunk_begin.size());
  int64_t acc = 0;
  for (size_t c = 0; c < chunk_begin.size(); ++c) {
    chunk_row0[c] = acc;
    acc += rows_in_chunk[c];
  }

  std::vector<int64_t> done(chunk_begin.size(), 0);
  std::vector<std::thread> ts;
  for (size_t c = 0; c < chunk_begin.size(); ++c) {
    ts.emplace_back(parse_chunk, chunk_begin[c], chunk_end[c], chunk_row0[c],
                    max_rows, dense, sparse, labels, &done[c]);
  }
  for (auto& t : ts) t.join();

  int64_t total = 0;
  for (int64_t d : done) total += d;
  return total;
}

}  // extern "C"
