// Host preprocessing kernels of the port: murmur3 feature hashing, the
// Criteo text parser, the packed-batch row gather and the raw-text
// stream's chunk-row parsers (the port's copy of fm_murmur3_32,
// fm_hash_bytes_batch, fm_hash_u64_batch, fm_parse_criteo, fm_gather_rows
// and fm_parse_{criteo,avazu,libsvm}_rows of
// fm_spark_tpu/native/fasthash.cpp; the aux builders live in aux.cpp).
//
// Contract: the same ints as the plain numpy/Python versions in
// fm_spark_tpu_torch/data/hashing.py, criteo.py, avazu.py and packed.py
// (tests hold them equal), whatever the chunk split or thread count; the
// chunk-row parsers' OK rows equal data/stream.py's per-line parse.
//
// Build: g++ -O3 -shared -fPIC -pthread (fm_spark_tpu_torch/native).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kC2 = 0x1B873593u;

uint32_t murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  uint32_t h = seed;
  const int64_t nblocks = len / 4;
  for (int64_t i = 0; i < nblocks; ++i) {
    uint32_t k;
    std::memcpy(&k, data + i * 4, 4);  // little-endian host assumed (x86/ARM)
    k *= kC1;
    k = rotl32(k, 15);
    k *= kC2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (len & 3) {
    case 3: k ^= static_cast<uint32_t>(tail[2]) << 16; [[fallthrough]];
    case 2: k ^= static_cast<uint32_t>(tail[1]) << 8; [[fallthrough]];
    case 1:
      k ^= tail[0];
      k *= kC1;
      k = rotl32(k, 15);
      k *= kC2;
      h ^= k;
  }
  h ^= static_cast<uint32_t>(len);
  return fmix32(h);
}

// murmur3 of a u64 key's 8 LE bytes — pairs with hashing.murmur3_u64.
uint32_t murmur3_u64(uint64_t key, uint32_t seed) {
  uint32_t h = seed;
  for (int half = 0; half < 2; ++half) {
    uint32_t k = static_cast<uint32_t>(key >> (32 * half));
    k *= kC1;
    k = rotl32(k, 15);
    k *= kC2;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5u + 0xE6546B64u;
  }
  h ^= 8u;
  return fmix32(h);
}

// Reserved u64 keys for integer features (== hashing.py constants).
constexpr uint64_t kNegKey = 1ull << 40;
constexpr uint64_t kMissKey = (1ull << 40) + 1;

inline int64_t finish_id(uint32_t h, int32_t field, int32_t bucket,
                         int per_field) {
  int64_t id = static_cast<int64_t>(h % static_cast<uint32_t>(bucket));
  if (per_field) id += static_cast<int64_t>(field) * bucket;
  return id;
}

// Integer count feature → log1p² bin key (hashing.int_feature semantics).
inline uint64_t int_bin_key(int64_t x) {
  if (x < 0) return kNegKey;
  double b = std::log1p(static_cast<double>(x));
  return static_cast<uint64_t>(std::floor(b * b));
}


// ---------------------------------------------------------------------
// Streaming chunk-row parsing (the native path of data/native_stream.py).
//
// Contract shared by fm_parse_{criteo,avazu,libsvm}_rows: scan every
// complete line of a caller-provided chunk (the caller guarantees the
// buffer ends on a line boundary) and, per line, emit
//
//   status_out[r]  0 = OK       — parsed natively, output GUARANTEED
//                                 bit-identical to the pure-Python
//                                 parser AND guaranteed to pass the
//                                 RecordGuard value contract;
//                  1 = SKIP     — carries no record (blank line, or a
//                                 libsvm comment-only line): counted by
//                                 the cursor, never by the guard;
//                  2 = REPARSE  — anything else. The Python side
//                                 re-parses JUST this line through the
//                                 per-line oracle, so every accept/
//                                 reject verdict and error string stays
//                                 bit-identical to the Python path.
//   rowlen_out[r]  bytes consumed by the line INCLUDING its newline —
//                  the per-row consumed-bytes array the exactly-once
//                  (epoch, shard, byte_offset, lineno, records) cursor
//                  advances from, so batch boundaries can land mid-
//                  chunk without losing cursor exactness.
//
// The REPARSE class is deliberately conservative: Python's int()/
// float() accept forms ("+1", "1_0", "inf", arbitrary precision) that
// a native fast path cannot reproduce bit-for-bit, so any token
// outside the plain-digits / plain-float grammar routes back to
// Python. Clean production data never pays that fallback.

namespace {

constexpr uint8_t kRowOk = 0;
constexpr uint8_t kRowSkip = 1;
constexpr uint8_t kRowReparse = 2;

// bytes.strip() / bytes.split() whitespace set.
inline bool is_pyspace(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\x0b' ||
         c == '\x0c';
}

inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// Strict non-negative decimal integer (<= 18 digits so int64 holds it
// exactly and the double cast rounds identically to Python's float(int)).
inline bool parse_plain_u64(const char* s, int64_t n, int64_t* out) {
  if (n < 1 || n > 18) return false;
  int64_t v = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!is_digit(s[i])) return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = v;
  return true;
}

// Strict float literal: [+-]?(digits[.digits*]? | .digits+)([eE][+-]?digits+)?
// Converted with strtod (correctly rounded, same as Python float()).
// Everything else — "inf", "nan", "1_0", hex — is REPARSE territory.
inline bool parse_plain_double(const char* s, int64_t n, double* out) {
  if (n < 1 || n > 60) return false;
  int64_t i = 0;
  if (s[i] == '+' || s[i] == '-') ++i;
  int64_t d0 = i;
  while (i < n && is_digit(s[i])) ++i;
  const int64_t int_digits = i - d0;
  int64_t frac_digits = 0;
  if (i < n && s[i] == '.') {
    ++i;
    const int64_t f0 = i;
    while (i < n && is_digit(s[i])) ++i;
    frac_digits = i - f0;
  }
  if (int_digits + frac_digits == 0) return false;
  if (i < n && (s[i] == 'e' || s[i] == 'E')) {
    ++i;
    if (i < n && (s[i] == '+' || s[i] == '-')) ++i;
    const int64_t e0 = i;
    while (i < n && is_digit(s[i])) ++i;
    if (i == e0) return false;
  }
  if (i != n) return false;
  char tmp[64];
  std::memcpy(tmp, s, static_cast<size_t>(n));
  tmp[n] = '\0';
  char* end = nullptr;
  *out = std::strtod(tmp, &end);
  return end == tmp + n;
}

// Python datetime.date(y, m, d).weekday() (Monday = 0), valid-date
// check included (y in [2000, 2099] by construction of the caller).
inline int days_in_month(int y, int m) {
  static const int kDays[12] = {31, 28, 31, 30, 31, 30,
                                31, 31, 30, 31, 30, 31};
  if (m == 2 && (y % 4 == 0 && (y % 100 != 0 || y % 400 == 0))) return 29;
  return kDays[m - 1];
}

inline int weekday_monday0(int y, int m, int d) {
  // Howard Hinnant's days-from-civil; 1970-01-01 (z = 0) was a Thursday.
  y -= m <= 2;
  const int era = y / 400;
  const int yoe = y - era * 400;
  const int doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  const long z = static_cast<long>(era) * 146097 + doe - 719468;
  return static_cast<int>((z + 3) % 7);
}

// Shared line scanner: walks complete lines of buf, strips the
// terminator (all trailing '\r' after dropping '\n' — bytes.rstrip
// semantics), flags all-whitespace lines as SKIP, and hands the line
// body to parse_row(row, line, len) for a status verdict. ``row`` is
// the GLOBAL row index (``row0`` offsets a mid-buffer segment so the
// threaded splitter below can reuse the same per-row output layout).
template <typename F>
int64_t scan_lines_range(const char* buf, int64_t len, int64_t row0,
                         int64_t max_rows, uint8_t* status_out,
                         int64_t* rowlen_out, F&& parse_row) {
  int64_t row = row0;
  int64_t pos = 0;
  while (row < max_rows && pos < len) {
    const char* nl = static_cast<const char*>(
        std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    const int64_t line_end = nl ? (nl - buf) : len;
    const int64_t rowlen = line_end - pos + (nl ? 1 : 0);
    int64_t ce = line_end;
    while (ce > pos && buf[ce - 1] == '\r') --ce;
    bool blank = true;
    for (int64_t q = pos; q < ce && blank; ++q) blank = is_pyspace(buf[q]);
    rowlen_out[row] = rowlen;
    status_out[row] =
        blank ? kRowSkip : parse_row(row, buf + pos, ce - pos);
    pos = line_end + (nl ? 1 : 0);
    ++row;
  }
  return row - row0;
}

// Threaded chunk scan: rows are independent (each writes only its own
// slice of the flat outputs), so the chunk splits at line boundaries
// and worker threads scan disjoint segments. Two passes: a cheap
// newline count fixes each segment's starting row index, then the
// parse runs in parallel. Output is bit-identical to the serial scan
// regardless of thread count; ctypes releases the GIL around the call,
// so this parallelism composes with the Prefetcher's producer thread.
template <typename F>
int64_t scan_lines(const char* buf, int64_t len, int64_t max_rows,
                   uint8_t* status_out, int64_t* rowlen_out, F&& parse_row) {
  const int hw0 = static_cast<int>(std::thread::hardware_concurrency());
  const int hw = hw0 > 0 ? hw0 : 1;
  // Below ~256KB per worker the split/count/join overhead beats the win.
  int n_threads = static_cast<int>(
      std::min<int64_t>(std::min(hw, 16), len / (256 << 10)));
  if (n_threads <= 1) {
    return scan_lines_range(buf, len, 0, max_rows, status_out, rowlen_out,
                            parse_row);
  }
  // Line-aligned segment starts: advance each naive split point past
  // the next newline.
  std::vector<int64_t> seg(static_cast<size_t>(n_threads) + 1, len);
  seg[0] = 0;
  for (int t = 1; t < n_threads; ++t) {
    int64_t p = len * t / n_threads;
    if (p <= seg[t - 1]) p = seg[t - 1];
    const char* nl = static_cast<const char*>(
        std::memchr(buf + p, '\n', static_cast<size_t>(len - p)));
    seg[t] = nl ? (nl - buf) + 1 : len;
  }
  // Starting row index per segment = newlines before it (a final
  // unterminated line can only be in the last segment).
  std::vector<int64_t> row0(static_cast<size_t>(n_threads) + 1, 0);
  for (int t = 0; t < n_threads; ++t) {
    const int64_t n_lines =
        std::count(buf + seg[t], buf + seg[t + 1], '\n') +
        (t == n_threads - 1 && len > 0 && buf[len - 1] != '\n' ? 1 : 0);
    row0[t + 1] = row0[t] + n_lines;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int t = 1; t < n_threads; ++t) {
    threads.emplace_back([&, t]() {
      scan_lines_range(buf + seg[t], seg[t + 1] - seg[t], row0[t],
                       std::min(max_rows, row0[t + 1]), status_out,
                       rowlen_out, parse_row);
    });
  }
  scan_lines_range(buf, seg[1], 0, std::min(max_rows, row0[1]), status_out,
                   rowlen_out, parse_row);
  for (auto& th : threads) th.join();
  return std::min(max_rows, row0[n_threads]);
}

}  // namespace
}  // namespace

extern "C" {

uint32_t fm_murmur3_32(const uint8_t* data, int64_t len, uint32_t seed) {
  return murmur3_32(data, len, seed);
}

// Hash n variable-length tokens (concatenated in buf, bounds in
// offsets[n+1]) with per-token field seeds. out[i] = bucket id.
void fm_hash_bytes_batch(const uint8_t* buf, const int64_t* offsets,
                         int64_t n, const int32_t* fields, int32_t bucket,
                         int per_field, int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t h = murmur3_32(buf + offsets[i], offsets[i + 1] - offsets[i],
                            static_cast<uint32_t>(fields[i]));
    out[i] = finish_id(h, fields[i], bucket, per_field);
  }
}

// Hash n u64 keys with per-element field seeds (integer-feature path).
void fm_hash_u64_batch(const uint64_t* keys, int64_t n,
                       const int32_t* fields, int32_t bucket, int per_field,
                       int64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = finish_id(murmur3_u64(keys[i], fields[i]), fields[i], bucket,
                       per_field);
  }
}

// Parse Criteo click-logs TSV: per line "label \t i1..i13 \t c1..c26"
// (40 tab-separated columns, empty = missing). Writes up to max_rows rows
// of 39 hashed ids + one int8 label each. Returns rows written;
// *consumed = bytes of buf fully processed (ends on a line boundary), so
// callers can stream arbitrary chunk splits. Malformed lines (wrong column
// count, non-integer label or count token) STOP the parse with
// *bad_line_pos = byte offset of the offending line (else -1): same
// garbage-is-worse-than-a-crash contract as the Python oracle
// (data/criteo.py parse_lines).
int64_t fm_parse_criteo(const char* buf, int64_t len, int32_t bucket,
                        int per_field, int64_t max_rows, int32_t* ids_out,
                        int8_t* labels_out, int64_t* consumed,
                        int64_t* bad_line_pos) {
  constexpr int kInts = 13, kCats = 26, kFields = kInts + kCats;
  int64_t row = 0;
  int64_t pos = 0;
  *consumed = 0;
  *bad_line_pos = -1;
  while (row < max_rows) {
    // Find the end of the current line.
    const char* nl = static_cast<const char*>(
        std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    if (nl == nullptr) break;  // incomplete trailing line — leave for caller
    const int64_t line_end = nl - buf;
    int64_t p = pos;

    // Label: optional sign + at least one digit; value>0 → 1.
    int64_t label = 0;
    bool neg = false;
    bool bad = false;
    if (p < line_end && buf[p] == '-') { neg = true; ++p; }
    int64_t label_digits = 0;
    while (p < line_end && buf[p] != '\t') {
      if (buf[p] < '0' || buf[p] > '9') { bad = true; break; }
      label = label * 10 + (buf[p] - '0');
      ++label_digits;
      ++p;
    }
    if (label_digits == 0) bad = true;

    int32_t* ids = ids_out + row * kFields;
    int f = 0;
    for (; f < kFields && !bad; ++f) {
      if (p >= line_end || buf[p] != '\t') { bad = true; break; }
      ++p;  // skip separator
      int64_t tok_start = p;
      while (p < line_end && buf[p] != '\t') ++p;
      const int64_t tok_len = p - tok_start;
      uint32_t h;
      if (f < kInts) {
        uint64_t key;
        if (tok_len == 0) {
          key = kMissKey;
        } else {
          bool vneg = false;
          int64_t v = 0;
          int64_t q = tok_start;
          if (buf[q] == '-') { vneg = true; ++q; }
          if (q == p) { bad = true; break; }  // bare "-"
          for (; q < p; ++q) {
            if (buf[q] < '0' || buf[q] > '9') { bad = true; break; }
            v = v * 10 + (buf[q] - '0');
          }
          if (bad) break;
          key = vneg ? kNegKey : int_bin_key(v);
        }
        h = murmur3_u64(key, static_cast<uint32_t>(f));
      } else {
        // Categorical: hash raw token bytes; empty token = its own id
        // (murmur3 of empty string, seeded by field) — matches hashing.py
        // hash_token(field, b"", bucket).
        h = murmur3_32(reinterpret_cast<const uint8_t*>(buf + tok_start),
                       tok_len, static_cast<uint32_t>(f));
      }
      ids[f] = static_cast<int32_t>(finish_id(h, f, bucket, per_field));
    }
    if (bad || f != kFields || p != line_end) {
      *bad_line_pos = pos;
      return row;
    }
    labels_out[row] = (!neg && label > 0) ? 1 : 0;
    pos = line_end + 1;
    *consumed = pos;
    ++row;
  }
  return row;
}


// Fused batch assembly for the packed-format loader (data/packed.py
// PackedDataset.assemble): one pass does the row gather, the FieldFM
// field-local id conversion (out_id = id - f*bucket when bucket > 0),
// the int8 -> f32 label cast, and (when the dir stores vals) the vals
// gather. The numpy path does these as 3-4 separate full-batch passes
// with temporaries. Row-range
// threaded: batch rows are independent, and memmap page faults inside
// the call run GIL-free (ctypes releases the GIL).
// vals == nullptr means store_vals=false: out_vals is untouched (the
// caller reuses a cached all-ones array instead of refilling 4*B*F
// bytes every batch).
void fm_gather_rows(const int32_t* ids, const float* vals,
                    const int8_t* labels, const int64_t* sel, int64_t B,
                    int32_t F, int32_t bucket, int n_threads,
                    int32_t* out_ids, float* out_vals, float* out_labels) {
  // Conversion as a SECOND flat pass over the gathered output, not
  // fused into the per-row gather: a per-row subtract loop (F=39, odd
  // length, aliasing-uncertain pointers) measured ~2.5x SLOWER than
  // memcpy — the vectorizer punts on it — while a single restrict-
  // qualified in-place sweep over the contiguous [B, F] output
  // vectorizes cleanly and touches cache-hot data.
  std::vector<int32_t> offs(static_cast<size_t>(F));
  for (int32_t f = 0; f < F; ++f) offs[f] = bucket > 0 ? f * bucket : 0;
  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const int64_t row = sel[b];
      std::memcpy(out_ids + b * F, ids + row * F,
                  sizeof(int32_t) * static_cast<size_t>(F));
      if (vals != nullptr) {
        std::memcpy(out_vals + b * F, vals + row * F,
                    sizeof(float) * static_cast<size_t>(F));
      }
      out_labels[b] = static_cast<float>(labels[row]);
    }
    if (bucket > 0 && b1 > b0) {  // b1 > b0: an empty trailing thread
      // range must not even form the out-of-range dst pointer (UB).
      const int32_t* __restrict off = offs.data();
      int32_t* __restrict dst = out_ids + b0 * F;
      const int64_t nrow = b1 - b0;
      for (int64_t b = 0; b < nrow; ++b, dst += F)
        for (int32_t f = 0; f < F; ++f) dst[f] -= off[f];
    }
  };
  if (n_threads <= 0) {
    // Auto: one thread per core, but below ~64k rows per thread the
    // spawn/join overhead dominates, so small batches stay serial.
    // An EXPLICIT n_threads is honored as given (tests exercise the
    // threaded path at small B through it).
    int hw = (int)std::thread::hardware_concurrency();
    n_threads = hw > 0 ? hw : 1;
    int64_t max_useful = B / 65536 + 1;
    if (n_threads > max_useful) n_threads = static_cast<int>(max_useful);
  }
  if (n_threads > B) n_threads = B > 0 ? static_cast<int>(B) : 1;
  if (n_threads <= 1) {
    work(0, B);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t per = (B + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int64_t b0 = t * per;
    threads.emplace_back(work, b0, std::min(B, b0 + per));
  }
  for (auto& th : threads) th.join();
}

// Chunk-row Criteo parse (the raw-text stream). Per OK line: 39 hashed
// ids into ids_out[r*39..] and the 0/1 click label into labels_out[r].
// Integer tokens follow data/criteo.py parse_line EXACTLY: empty →
// MISS_KEY, leading '-' → NEG_KEY (rest of the token NOT validated —
// the Python oracle doesn't either), plain digits → log1p² bin key;
// any other form is REPARSE. num_features > 0 adds the RecordGuard
// id-bound check so an OK row is guaranteed admissible.
int64_t fm_parse_criteo_rows(const char* buf, int64_t len, int32_t bucket,
                             int per_field, int64_t num_features,
                             int64_t max_rows, int32_t* ids_out,
                             float* labels_out, uint8_t* status_out,
                             int64_t* rowlen_out) {
  constexpr int kInts = 13, kCats = 26, kFields = kInts + kCats;
  const bool check_ids =
      num_features > 0 &&
      (per_field ? static_cast<int64_t>(kFields) * bucket
                 : static_cast<int64_t>(bucket)) > num_features;
  auto parse_row = [&](int64_t row, const char* line,
                       int64_t n) -> uint8_t {
    int64_t p = 0;
    // Label: optional '-', then 1..18 plain digits.
    bool neg = false;
    if (p < n && line[p] == '-') {
      neg = true;
      ++p;
    }
    const int64_t l0 = p;
    int64_t label = 0;
    while (p < n && line[p] != '\t') {
      if (!is_digit(line[p]) || p - l0 >= 18) return kRowReparse;
      label = label * 10 + (line[p] - '0');
      ++p;
    }
    if (p == l0) return kRowReparse;
    int32_t* ids = ids_out + row * kFields;
    for (int f = 0; f < kFields; ++f) {
      if (p >= n || line[p] != '\t') return kRowReparse;
      ++p;
      const int64_t t0 = p;
      while (p < n && line[p] != '\t') ++p;
      const int64_t tok_len = p - t0;
      uint32_t h;
      if (f < kInts) {
        uint64_t key;
        if (tok_len == 0) {
          key = kMissKey;
        } else if (line[t0] == '-') {
          key = kNegKey;  // oracle: startswith(b"-") alone decides
        } else {
          int64_t v;
          if (!parse_plain_u64(line + t0, tok_len, &v)) return kRowReparse;
          key = int_bin_key(v);
        }
        h = murmur3_u64(key, static_cast<uint32_t>(f));
      } else {
        h = murmur3_32(reinterpret_cast<const uint8_t*>(line + t0),
                       tok_len, static_cast<uint32_t>(f));
      }
      const int64_t id = finish_id(h, f, bucket, per_field);
      if (check_ids && id >= num_features) return kRowReparse;
      ids[f] = static_cast<int32_t>(id);
    }
    if (p != n) return kRowReparse;  // extra columns
    labels_out[row] = (!neg && label > 0) ? 1.0f : 0.0f;
    return kRowOk;
  };
  return scan_lines(buf, len, max_rows, status_out, rowlen_out, parse_row);
}

// Chunk-row Avazu parse: 24 CSV columns; id dropped, click is the
// label (== b"1", unvalidated — the Python oracle's exact rule), hour
// YYMMDDHH split into day-of-week + hour-of-day tokens, then the 21
// remaining categoricals — 23 hashed fields per row. A malformed
// column count or hour field is REPARSE (Python reproduces the exact
// on_error reason).
int64_t fm_parse_avazu_rows(const char* buf, int64_t len, int32_t bucket,
                            int per_field, int64_t num_features,
                            int64_t max_rows, int32_t* ids_out,
                            float* labels_out, uint8_t* status_out,
                            int64_t* rowlen_out) {
  constexpr int kRawCols = 24, kFields = 23;
  const bool check_ids =
      num_features > 0 &&
      (per_field ? static_cast<int64_t>(kFields) * bucket
                 : static_cast<int64_t>(bucket)) > num_features;
  auto hash_field = [&](int f, const char* s, int64_t tok_len,
                        int32_t* ids) -> bool {
    const uint32_t h = murmur3_32(reinterpret_cast<const uint8_t*>(s),
                                  tok_len, static_cast<uint32_t>(f));
    const int64_t id = finish_id(h, f, bucket, per_field);
    if (check_ids && id >= num_features) return false;
    ids[f] = static_cast<int32_t>(id);
    return true;
  };
  auto parse_row = [&](int64_t row, const char* line,
                       int64_t n) -> uint8_t {
    // Split on ',' — exactly 24 columns.
    int64_t col_start[kRawCols], col_len[kRawCols];
    int ncols = 0;
    int64_t start = 0;
    for (int64_t p = 0; p <= n; ++p) {
      if (p == n || line[p] == ',') {
        if (ncols == kRawCols) return kRowReparse;  // too many columns
        col_start[ncols] = start;
        col_len[ncols] = p - start;
        ++ncols;
        start = p + 1;
      }
    }
    if (ncols != kRawCols) return kRowReparse;
    // hour = cols[2]: first 6 bytes must be plain digits forming a
    // valid YYMMDD date (Python: datetime.date raises → bad hour).
    const char* hour = line + col_start[2];
    const int64_t hour_len = col_len[2];
    if (hour_len < 6) return kRowReparse;
    for (int i = 0; i < 6; ++i)
      if (!is_digit(hour[i])) return kRowReparse;
    const int yy = (hour[0] - '0') * 10 + (hour[1] - '0');
    const int mm = (hour[2] - '0') * 10 + (hour[3] - '0');
    const int dd = (hour[4] - '0') * 10 + (hour[5] - '0');
    if (mm < 1 || mm > 12) return kRowReparse;
    const int year = 2000 + yy;
    if (dd < 1 || dd > days_in_month(year, mm)) return kRowReparse;
    int32_t* ids = ids_out + row * kFields;
    const char dow = static_cast<char>('0' + weekday_monday0(year, mm, dd));
    if (!hash_field(0, &dow, 1, ids)) return kRowReparse;
    // hour-of-day token: raw bytes 6..8 of the hour column (may be
    // shorter or empty — hashed as-is, matching hour[6:8] in Python).
    const int64_t hh_len = hour_len >= 8 ? 2 : hour_len - 6;
    if (!hash_field(1, hour + 6, hh_len, ids)) return kRowReparse;
    for (int c = 3; c < kRawCols; ++c) {
      if (!hash_field(c - 1, line + col_start[c], col_len[c], ids))
        return kRowReparse;
    }
    const char* click = line + col_start[1];
    labels_out[row] = (col_len[1] == 1 && click[0] == '1') ? 1.0f : 0.0f;
    return kRowOk;
  };
  return scan_lines(buf, len, max_rows, status_out, rowlen_out, parse_row);
}

// Chunk-row libSVM parse: "label idx:val ..." with '#' comments and
// variable nnz ≤ max_nnz (the batch's static S). OK rows are written
// zero-padded into ids_out/vals_out[row*S..]; indices are shifted to
// zero-based unless zero_based. Strict plain-number grammar; REPARSE
// covers Python-isms ("+1", "inf", "1_0"), negative/over-bucket
// indices, non-finite values, and nnz overflow — all of which the
// Python fallback then classifies with the oracle's exact error text.
int64_t fm_parse_libsvm_rows(const char* buf, int64_t len, int zero_based,
                             int64_t max_nnz, int64_t num_features,
                             int64_t max_rows, int32_t* ids_out,
                             float* vals_out, float* labels_out,
                             uint8_t* status_out, int64_t* rowlen_out) {
  const int64_t id_bound =
      num_features > 0 ? num_features : (static_cast<int64_t>(INT32_MAX) + 1);
  auto parse_row = [&](int64_t row, const char* line,
                       int64_t n) -> uint8_t {
    // Cut at the first '#' (Python: line.split(b"#")[0]).
    const char* hash = static_cast<const char*>(
        std::memchr(line, '#', static_cast<size_t>(n)));
    if (hash != nullptr) n = hash - line;
    int64_t p = 0;
    auto skip_ws = [&]() {
      while (p < n && is_pyspace(line[p])) ++p;
    };
    skip_ws();
    if (p == n) return kRowSkip;  // comment-only / whitespace line
    // Label token.
    int64_t t0 = p;
    while (p < n && !is_pyspace(line[p])) ++p;
    double label;
    if (!parse_plain_double(line + t0, p - t0, &label) ||
        !std::isfinite(label))
      return kRowReparse;
    int32_t* ids = ids_out + row * max_nnz;
    float* vals = vals_out + row * max_nnz;
    int64_t k = 0;
    while (true) {
      skip_ws();
      if (p == n) break;
      if (k >= max_nnz) return kRowReparse;  // nnz > S: guard rejects
      t0 = p;
      while (p < n && !is_pyspace(line[p])) ++p;
      const char* colon = static_cast<const char*>(
          std::memchr(line + t0, ':', static_cast<size_t>(p - t0)));
      if (colon == nullptr) return kRowReparse;  // no idx:val separator
      const int64_t i_len = colon - (line + t0);
      const int64_t v_off = colon - line + 1;
      const int64_t v_len = p - v_off;
      int64_t idx;
      double val;
      if (!parse_plain_u64(line + t0, i_len, &idx) ||
          !parse_plain_double(line + v_off, v_len, &val) ||
          !std::isfinite(val))
        return kRowReparse;
      idx -= zero_based ? 0 : 1;
      if (idx < 0 || idx >= id_bound) return kRowReparse;
      ids[k] = static_cast<int32_t>(idx);
      vals[k] = static_cast<float>(val);
      ++k;
    }
    for (int64_t q = k; q < max_nnz; ++q) {
      ids[q] = 0;
      vals[q] = 0.0f;
    }
    labels_out[row] = static_cast<float>(label);
    return kRowOk;
  };
  return scan_lines(buf, len, max_rows, status_out, rowlen_out, parse_row);
}

}  // extern "C"
