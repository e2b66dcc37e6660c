// Host-side aux builders of the sparse-SGD steps: a threaded counting sort
// per field (the port's copy of fm_dedup_aux / fm_compact_aux in
// fm_spark_tpu/native/fasthash.cpp).
//
// ids: [B, F] int32 row-major, each value in [0, bucket). Outputs are
// [F, *] row-major, each field's slice contiguous. The counting sort is
// stable, so its permutation equals numpy's stable argsort of each field:
// the numpy builders in ops/scatter.py give the same ints. It takes
// O(B + bucket) per field where argsort takes O(B log B) with strided
// reads; fields are striped over worker threads, each holding one
// O(bucket) scratch vector.
//
// Build: g++ -O3 -shared -fPIC -pthread (fm_spark_tpu_torch/native).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

int worker_count(int32_t fields) {
    const int hw = static_cast<int>(std::thread::hardware_concurrency());
    const int cores = hw > 0 ? hw : 1;
    return fields < cores ? static_cast<int>(fields) : cores;
}

// Runs work(t) for t in [0, n) on n threads (inline when n <= 1).
template <typename Work>
void run_striped(int n, Work work) {
    if (n <= 1) {
        work(0);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve(n);
    for (int t = 0; t < n; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
}

// Column f of ids into col, and its stable counting-sort permutation into
// ord. starts: bucket + 1 entries of scratch.
void sort_field(const int32_t* ids, int64_t B, int32_t F, int32_t f,
                int32_t bucket, std::vector<int64_t>& starts,
                std::vector<int32_t>& col, int32_t* ord) {
    for (int64_t b = 0; b < B; ++b) col[b] = ids[b * F + f];
    std::fill(starts.begin(), starts.end(), 0);
    for (int64_t b = 0; b < B; ++b) ++starts[col[b] + 1];
    for (int64_t i = 0; i < bucket; ++i) starts[i + 1] += starts[i];
    for (int64_t b = 0; b < B; ++b) {
        ord[starts[col[b]]++] = static_cast<int32_t>(b);
    }
}

}  // namespace

extern "C" {

// The dedup aux of ops/scatter.dedup_aux, each output [F, B]:
//   order[f]     stable argsort of ids[:, f];
//   seg[f]       segment of each SORTED lane (duplicates share one);
//   useg[f]      the unique id of each segment, INT32_MAX past the last;
//   ord_first[f] original lane of each segment's first occurrence (0 past
//                the last).
void fmt_dedup_aux(const int32_t* ids, int64_t B, int32_t F, int32_t bucket,
                   int32_t* order, int32_t* seg, int32_t* useg,
                   int32_t* ord_first) {
    const int n_threads = worker_count(F);
    run_striped(n_threads, [&](int t0) {
        std::vector<int64_t> starts(static_cast<size_t>(bucket) + 1);
        std::vector<int32_t> col(static_cast<size_t>(B));
        for (int32_t f = t0; f < F; f += n_threads) {
            int32_t* ord = order + static_cast<int64_t>(f) * B;
            sort_field(ids, B, F, f, bucket, starts, col, ord);
            int32_t* sg = seg + static_cast<int64_t>(f) * B;
            int32_t* us = useg + static_cast<int64_t>(f) * B;
            int32_t* of = ord_first + static_cast<int64_t>(f) * B;
            int64_t s = -1;
            int32_t prev = -1;
            for (int64_t p = 0; p < B; ++p) {
                const int32_t b0 = ord[p];
                const int32_t id = col[b0];
                if (s < 0 || id != prev) {
                    ++s;
                    us[s] = id;
                    of[s] = b0;
                    prev = id;
                }
                sg[p] = static_cast<int32_t>(s);
            }
            for (int64_t p = s + 1; p < B; ++p) {
                us[p] = INT32_MAX;
                of[p] = 0;
            }
        }
    });
}

// The compact aux of ops/scatter.compact_aux: useg, segstart, segend
// [F, cap] (unique ids ascending, then the distinct ascending sentinels
// INT32_MAX - cap + j; first and last sorted lane of each segment, B - 1
// past the last), order and inv [F, B] (stable argsort; segment of each
// ORIGINAL lane). Returns the lowest field whose unique count exceeds cap,
// or -1; on overflow the outputs are not to be used.
int32_t fmt_compact_aux(const int32_t* ids, int64_t B, int32_t F,
                        int32_t bucket, int32_t cap, int32_t* useg,
                        int32_t* segstart, int32_t* segend, int32_t* order,
                        int32_t* inv) {
    const int n_threads = worker_count(F);
    std::vector<int32_t> overflow(n_threads, -1);
    run_striped(n_threads, [&](int t0) {
        std::vector<int64_t> starts(static_cast<size_t>(bucket) + 1);
        std::vector<int32_t> col(static_cast<size_t>(B));
        for (int32_t f = t0; f < F; f += n_threads) {
            int32_t* ord = order + static_cast<int64_t>(f) * B;
            sort_field(ids, B, F, f, bucket, starts, col, ord);
            int32_t* us = useg + static_cast<int64_t>(f) * cap;
            int32_t* ss = segstart + static_cast<int64_t>(f) * cap;
            int32_t* se = segend + static_cast<int64_t>(f) * cap;
            int32_t* iv = inv + static_cast<int64_t>(f) * B;
            int64_t s = -1;
            int32_t prev = -1;
            for (int64_t p = 0; p < B; ++p) {
                const int32_t b0 = ord[p];
                const int32_t id = col[b0];
                if (s < 0 || id != prev) {
                    ++s;
                    if (s >= cap) {
                        overflow[t0] = f;  // fields run in order per thread
                        return;
                    }
                    us[s] = id;
                    ss[s] = static_cast<int32_t>(p);
                    if (s > 0) se[s - 1] = static_cast<int32_t>(p - 1);
                    prev = id;
                }
                iv[b0] = static_cast<int32_t>(s);
            }
            if (s >= 0) se[s] = static_cast<int32_t>(B - 1);
            const int32_t pad = B > 0 ? static_cast<int32_t>(B - 1) : 0;
            for (int64_t p = s + 1; p < cap; ++p) {
                us[p] = (INT32_MAX - cap) + static_cast<int32_t>(p - (s + 1));
                ss[p] = pad;
                se[p] = pad;
            }
        }
    });
    int32_t first = -1;
    for (int t = 0; t < n_threads; ++t) {
        if (overflow[t] >= 0 && (first < 0 || overflow[t] < first)) {
            first = overflow[t];
        }
    }
    return first;
}

}  // extern "C"
