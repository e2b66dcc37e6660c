// Segment totals of lanes grouped by segment, for Hopper (sm_90a): kernel A.
//
// Replaces the TPU kernel fm_spark_tpu/ops/pallas_segsum.py::segment_totals
// (_kernel). For lanes t of a batch whose non-decreasing ranks seg [B]
// group them into segments, and the lane rows x_t (row t of delta, or row
// order[t] of it when an order is given: the caller's sorted view of an
// unsorted delta, read in place),
//
//   out[s] = sum over t with seg[t] = s of x_t        (0 <= s < cap)
//
// into a [cap, w] fp32 output; ranks outside [0, cap) are dropped (the TPU
// kernel's trash row). delta is fp32 or bf16 (widened exactly). Rows no
// lane falls in are zeroed, except, with zero_tail = 0, the rows past the
// batch's last rank: a caller whose ranks are dense from 0 (the device
// dedup, ops/scatter.py) never reads those, and at cap = B they would be
// most of the output. Two callers: the compact update's segment-sum stage
// (compact_apply with segtotal_pallas: cap 12,288, w = 65) and every
// device dedup (cap = B, w = 65 or 369).
//
// Bound: memory. Per call it reads B * w * e + 4 B bytes (e = 4 or 2, plus
// 4 B for an order) and writes the u live rows, u * w * 4 bytes (cap * w * 4
// with zero_tail). At B = 131072: w = 65, cap 12288, 37.8 MB, 11.3 us at
// 3.35 TB/s; the dedup at w = 369, ~0.2 GB, ~60 us.
//
// What held the first design (segment_scan.cuh's tile_pass, which kernel B
// keeps for its carry passes) back, from its source: one thread per
// column in a block of the width rounded up to a warp (96 threads at
// w = 65, 31 idle), so at most 128 columns; each thread's 128-lane walk had
// at most 8 four-byte loads in flight, 1,024 blocks of 3 warps; a memset of
// the whole output and three dependent passes per call (131072 -> 2048 ->
// 32 -> done); and the caller's delta[order] copy before it.
//
// Design, two launches and no memset:
//  1. First pass, one block per tile of kTileLanes consecutive lanes. The
//     block's threads are (lane group, column) items: G groups of
//     kTileLanes / G lanes, G * w <= kTargetThreads (w = 65: 4 x 65 on 288
//     threads; w = 369: 1 x 369 on 384), a column loop past kMaxCols. The
//     tile's ranks (and order entries) are staged once in shared memory;
//     each item loads 8 lanes' elements (16 for a wide row's single
//     group) before it adds any. Runs that start and end inside a group go
//     straight to out; each group's first and last runs go to shared
//     memory, where one thread per column merges them in group order. The
//     tile's first run, if it continues from the tile before, is its head
//     carry; its last, if it continues into the next tile and began in
//     this one, its tail carry; every other run is complete and written.
//     The block also zeroes the rows between its lanes' ranks (gaps) and,
//     with zero_tail, a 1/tiles share of the rows past the last rank.
//  2. Fold, one block per tile, launched as a programmatic dependent of the
//     first pass (its launch overlaps the first pass; griddepcontrol.wait
//     holds it until the first pass is done). A tile with a tail carry owns
//     that segment: it finds the tiles after it whose head carries hold the
//     same rank (ranks are non-decreasing, so these are contiguous), sums
//     their heads in P strided groups of kFoldUnroll loads, adds the P
//     partials to its tail in group order and writes the row. A Zipf head
//     of 33K lanes is 131 heads, summed by P = 15 groups at w = 65.
// No atomics and a fixed order of every sum, so a repeat gives the same
// bits. On an H100 the variants tried were slower: 16, 32 or 64 loads in
// flight at every width (64 and more registers: fewer blocks per SM),
// tiles of 128 or 512 lanes, 8 lane groups, the fold launched plainly.

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTileLanes = 256;      // lanes per first-pass block
constexpr int kTargetThreads = 320;  // G * w at most this, when G > 1
constexpr int kMaxGroups = 16;
constexpr int kMaxCols = 1024;       // columns per pass of a block
// Loads in flight per item: 8 where a block holds several lane groups
// (narrow rows: 43-45 registers, 5 blocks of 288 threads per SM, the
// whole B = 131072 grid in one wave), 16 for one group of a wide row
// (a 256-lane walk per thread).
constexpr int kUnrollNarrow = 8;
constexpr int kUnrollWide = 16;
constexpr int kFoldThreads = 1024;
constexpr int kFoldUnroll = 16;
constexpr int kNone = INT_MIN;       // no neighbour lane
constexpr int kNoCarry = -1;         // a carry slot that holds nothing

__device__ __forceinline__ bool live(int s, int cap) {
    return static_cast<unsigned>(s) < static_cast<unsigned>(cap);
}

__device__ __forceinline__ float widen(const float* p, size_t i) {
    return __ldg(p + i);
}

__device__ __forceinline__ float widen(const unsigned short* p, size_t i) {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(p + i)));
}

struct Plan {
    int n, width, cap, zero_tail;
    int groups;   // lane groups per block
    int lanes;    // lanes per group
    int cols;     // columns per pass (items per group)
};

// Elements [from, to) of the rows from row lo of out set to 0 by the
// block's threads.
__device__ __forceinline__ void zero_rows(float* out, long long lo, int width,
                                          long long from, long long to) {
    float* base = out + lo * width;
    for (long long e = from + threadIdx.x; e < to; e += blockDim.x) {
        base[e] = 0.f;
    }
}

// O: the order's index type (int or long long), void for none; U: loads
// in flight per item.
template <typename T, typename O, int U>
__global__ void __launch_bounds__(kMaxCols)
first_pass(const T* __restrict__ delta, const O* __restrict__ order,
           const int* __restrict__ seg, Plan p, float* __restrict__ out,
           int* __restrict__ cseg, float* __restrict__ cval) {
    constexpr bool ORDER = !std::is_void_v<O>;
    extern __shared__ float s_frag[];               // [groups][2][cols]
    __shared__ int s_seg[kTileLanes + 2];           // lanes t0 - 1 .. t0 + len
    __shared__ int s_row[ORDER ? kTileLanes : 1];
    const int tile = blockIdx.x;
    const int tiles = gridDim.x;
    const int t0 = tile * kTileLanes;
    const int len = min(kTileLanes, p.n - t0);
    const int w = p.width;
    // The fold may start launching now; it waits for this grid to finish
    // (griddepcontrol.wait) before it reads anything.
    asm volatile("griddepcontrol.launch_dependents;");
    for (int i = threadIdx.x; i < len + 2; i += blockDim.x) {
        const int t = t0 - 1 + i;
        s_seg[i] = (t >= 0 && t < p.n) ? __ldg(seg + t) : kNone;
        if constexpr (ORDER) {
            if (i >= 1 && i <= len) s_row[i - 1] = static_cast<int>(order[t]);
        }
    }
    __syncthreads();

    // Rows between two consecutive ranks hold no lane: the tile of the
    // upper lane zeroes them (tile 0 also the rows below its first rank).
    bool gap = false;
    for (int i = 1 + threadIdx.x; i <= len; i += blockDim.x) {
        const long long prev = s_seg[i - 1] == kNone ? -1 : s_seg[i - 1];
        gap |= s_seg[i] > prev + 1 && prev + 1 < p.cap;
    }
    if (__syncthreads_or(gap)) {
        for (int i = 1; i <= len; ++i) {
            const long long prev = s_seg[i - 1] == kNone ? -1 : s_seg[i - 1];
            const long long lo = prev + 1 > 0 ? prev + 1 : 0;
            const long long hi = s_seg[i] < p.cap ? s_seg[i] : p.cap;
            if (hi > lo) zero_rows(out, lo, w, 0, (hi - lo) * w);
        }
    }
    if (p.zero_tail) {
        const long long last = __ldg(seg + p.n - 1);
        const long long lo = last + 1 > 0 ? last + 1 : 0;
        if (lo < p.cap) {
            const long long total = (p.cap - lo) * w;
            zero_rows(out, lo, w, total * tile / tiles,
                      total * (tile + 1) / tiles);
        }
    }

    const int g = threadIdx.x / p.cols;
    const int c0 = threadIdx.x - g * p.cols;
    const bool item = g < p.groups;
    const int a = g * p.lanes;                       // the group's lanes
    const int b = min(a + p.lanes, len);
    const size_t slot = 2 * static_cast<size_t>(tile);
    if (threadIdx.x == 0) {
        cseg[slot] = kNoCarry;
        cseg[slot + 1] = kNoCarry;
    }
    for (int cbase = 0; cbase < w; cbase += p.cols) {
        const int c = cbase + c0;
        float first_acc = 0.f, last_acc = 0.f;
        if (item && c < w && a < b) {
            int cur = s_seg[1 + a];
            bool single = true;
            float acc = 0.f;
            for (int i = a; i < b; i += U) {
                float v[U];
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int l = min(i + u, b - 1);
                    size_t row = t0 + l;
                    if constexpr (ORDER) row = s_row[l];
                    v[u] = i + u < b ? widen(delta, row * w + c) : 0.f;
                }
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    const int l = i + u;
                    if (l >= b) break;
                    const int s = s_seg[1 + l];
                    if (s != cur) {
                        // cur ends inside the group: its first run goes
                        // to the merge, any later one is complete.
                        if (single) {
                            first_acc = acc;
                            single = false;
                        } else if (live(cur, p.cap)) {
                            out[static_cast<size_t>(cur) * w + c] = acc;
                        }
                        cur = s;
                        acc = 0.f;
                    }
                    acc = __fadd_rn(acc, v[u]);
                }
            }
            if (single) {
                first_acc = acc;
            } else {
                last_acc = acc;
            }
        }
        if (item && c < w) {
            s_frag[(2 * g) * p.cols + c0] = first_acc;
            s_frag[(2 * g + 1) * p.cols + c0] = last_acc;
        }
        __syncthreads();

        // Merge the groups' edge runs in lane order (group 0's threads).
        if (g == 0 && c < w) {
            bool have = false, first = true;
            int rs = 0;
            float racc = 0.f;
            auto flush = [&](bool is_last) {
                if (first && s_seg[0] == rs) {               // head carry
                    if (c0 == 0) cseg[slot] = rs;
                    cval[slot * w + c] = racc;
                } else if (is_last && s_seg[len + 1] == rs) {  // tail carry
                    if (c0 == 0) cseg[slot + 1] = rs;
                    cval[(slot + 1) * w + c] = racc;
                } else if (live(rs, p.cap)) {
                    out[static_cast<size_t>(rs) * w + c] = racc;
                }
                first = false;
            };
            auto take = [&](int s, float v) {
                if (have && s == rs) {
                    racc = __fadd_rn(racc, v);
                    return;
                }
                if (have) flush(false);
                have = true;
                rs = s;
                racc = v;
            };
            for (int k = 0; k < p.groups; ++k) {
                const int ka = k * p.lanes;
                if (ka >= len) break;
                const int kb = min(ka + p.lanes, len);
                const int fs = s_seg[1 + ka];
                const int ls = s_seg[kb];
                take(fs, s_frag[(2 * k) * p.cols + c0]);
                if (ls != fs) take(ls, s_frag[(2 * k + 1) * p.cols + c0]);
            }
            flush(true);
        }
        __syncthreads();
    }
}

// One block per tile; blockDim = roundup(groups * cols, 32), shared memory
// [groups][cols] floats.
__global__ void __launch_bounds__(kFoldThreads)
fold(const int* __restrict__ cseg, const float* __restrict__ cval,
     int tiles, int width, int cap, int groups, int cols,
     float* __restrict__ out) {
    extern __shared__ float s_part[];
    __shared__ int s_end;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int u = blockIdx.x;
    const int s = cseg[2 * u + 1];
    if (!live(s, cap)) return;                       // not an owner
    if (threadIdx.x == 0) s_end = tiles;
    __syncthreads();
    // The chain: tiles u + 1 .. end - 1, whose head carries hold s.
    int end = tiles;
    for (int base = u + 1; base < tiles; base += blockDim.x) {
        const int j = base + threadIdx.x;
        if (j < tiles && cseg[2 * j] != s) atomicMin(&s_end, j);
        __syncthreads();
        end = s_end;
        __syncthreads();
        if (end < base + static_cast<int>(blockDim.x)) break;
    }
    const int g = threadIdx.x / cols;
    const int c0 = threadIdx.x - g * cols;
    const size_t w = width;
    for (int cbase = 0; cbase < width; cbase += cols) {
        const int c = cbase + c0;
        if (g < groups && c < width) {
            float acc = 0.f;
            for (int j = u + 1 + g; j < end; j += groups * kFoldUnroll) {
                float v[kFoldUnroll];
#pragma unroll
                for (int k = 0; k < kFoldUnroll; ++k) {
                    const int jj = j + k * groups;
                    v[k] = jj < end ? cval[2 * jj * w + c] : 0.f;
                }
#pragma unroll
                for (int k = 0; k < kFoldUnroll; ++k) acc = __fadd_rn(acc, v[k]);
            }
            s_part[g * cols + c0] = acc;
        }
        __syncthreads();
        if (g == 0 && c < width) {
            float tot = cval[(2 * static_cast<size_t>(u) + 1) * w + c];
            for (int q = 0; q < groups; ++q) {
                tot = __fadd_rn(tot, s_part[q * cols + c0]);
            }
            out[static_cast<size_t>(s) * w + c] = tot;
        }
        __syncthreads();
    }
}

inline int tiles_of(int n) { return (n + kTileLanes - 1) / kTileLanes; }

inline int round_warp(int x) { return (x + 31) / 32 * 32; }

template <typename T, typename O>
cudaError_t launch_first(const void* delta, const void* order, const int* seg,
                         const Plan& p, float* out, int* cseg, float* cval,
                         cudaStream_t s) {
    const int tiles = tiles_of(p.n);
    const int threads = round_warp(p.groups * p.cols);
    const size_t smem = sizeof(float) * 2 * p.groups * p.cols;
    const auto kernel = p.groups > 1 ? first_pass<T, O, kUnrollNarrow>
                                     : first_pass<T, O, kUnrollWide>;
    kernel<<<tiles, threads, smem, s>>>(static_cast<const T*>(delta),
                                        static_cast<const O*>(order), seg, p,
                                        out, cseg, cval);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_first(const void* delta, const void* order, int order_i64,
                         const int* seg, const Plan& p, float* out, int* cseg,
                         float* cval, cudaStream_t s) {
    if (order == nullptr) {
        return launch_first<T, void>(delta, order, seg, p, out, cseg, cval, s);
    }
    return order_i64
        ? launch_first<T, long long>(delta, order, seg, p, out, cseg, cval, s)
        : launch_first<T, int>(delta, order, seg, p, out, cseg, cval, s);
}

}  // namespace

extern "C" {

// delta: [batch, width] (bf16 if delta_bf16, else fp32); order: [batch]
// (int64 if order_i64, else int32) or null (lane t's row is
// delta[order[t]], else delta[t]); seg: [batch] int32, non-decreasing;
// out: [cap, width] fp32, written here (rows past seg[batch - 1] only
// when zero_tail). scratch_seg /
// scratch_val: at least segment_scratch_rows(batch) rows (of one int /
// width floats). Launches on `stream` of `device`; returns
// cudaGetLastError() (0 on success). Does not synchronise.
int segment_totals(const void* delta, int delta_bf16, const void* order,
                   int order_i64, const int* seg, int batch, int width, int cap,
                   int zero_tail, float* out, int* scratch_seg,
                   float* scratch_val, long long scratch_rows, void* stream,
                   int device) {
    if (batch < 1 || width < 1 || cap < 1 ||
        scratch_rows < 2LL * tiles_of(batch)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Plan p{batch, width, cap, zero_tail, 1, kTileLanes, width};
    while (p.groups * 2 <= kMaxGroups &&
           p.groups * 2 * width <= kTargetThreads) {
        p.groups *= 2;
    }
    p.lanes = kTileLanes / p.groups;
    if (p.cols > kMaxCols) p.cols = kMaxCols;
    cudaError_t err = delta_bf16
        ? launch_first<unsigned short>(delta, order, order_i64, seg, p, out,
                                       scratch_seg, scratch_val, s)
        : launch_first<float>(delta, order, order_i64, seg, p, out,
                              scratch_seg, scratch_val, s);
    const int tiles = tiles_of(batch);
    if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
    const int fcols = width < kFoldThreads ? width : kFoldThreads;
    int fgroups = kFoldThreads / fcols;
    if (fgroups > kMaxGroups) fgroups = kMaxGroups;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles);
    cfg.blockDim = dim3(round_warp(fgroups * fcols));
    cfg.dynamicSmemBytes = sizeof(float) * fgroups * fcols;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(
        &cfg, fold, static_cast<const int*>(scratch_seg),
        static_cast<const float*>(scratch_val), tiles, width, cap, fgroups,
        fcols, out));
}

long long segment_scratch_rows(int batch) {
    return 2LL * tiles_of(batch);
}

const char* segment_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
