// Host preprocessing kernels of the port: murmur3 feature hashing, the
// Criteo text parser and the packed-batch row gather (the port's copy of
// fm_murmur3_32, fm_hash_bytes_batch, fm_hash_u64_batch, fm_parse_criteo
// and fm_gather_rows of fm_spark_tpu/native/fasthash.cpp; the aux
// builders live in aux.cpp).
//
// Contract: the same ints as the plain numpy/Python versions in
// fm_spark_tpu_torch/data/hashing.py, criteo.py, avazu.py and packed.py
// (tests hold them equal), whatever the chunk split or thread count.
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

}  // extern "C"
