// Fused FM backward + segment totals for Hopper (sm_90a): kernel B.
//
// Replaces the TPU kernel fm_spark_tpu/ops/pallas_fused.py::
// fm_bwd_segment_totals (_bwd_kernel). For each field f and each lane t of
// the batch in field f's sorted order (o = order[f, t], seg = inv[f, o]),
// with u = urows_f[seg] (a zero row when seg >= cap):
//
//   g = ds[o] * (s1[o] - mask * u * x) * x + rv * u * tch      (x = vals[o, f],
//   out[f, seg] += neg_lr * g                                    tch = w[o] > 0)
//
// where mask zeroes column k and the rv term is optional: the segment
// totals of -lr * g_full that the compact update writes
// (ops/scatter.compact_apply_totals). The F x [B, w] gradient set is never
// written to memory.
//
// With a bf16 compute dtype every elementwise result is rounded to bf16 in
// the order of _bwd_kernel (rows, x*u, s1 - ., ds * ., . * x, rv * u,
// g + .; . * tch is exact, tch being 0 or 1); neg_lr * g is fp32. With
// fp32 compute nothing is rounded. The _rn intrinsics and instructions keep
// the compiler from contracting a multiply and an add into one fma, so each
// step rounds as the plain PyTorch composition does.
//
// Bound: memory. Counting each input read once and each output written
// once: s1 (B * (k+1) * cd_bytes), ds, vals, weights, order and inv (~16 B
// per lane and field of scalars and indices), every field's unique rows
// (cap * w * storage bytes) and the totals (F * cap * w * 4). At B = 131072,
// k = 64, cap 12288, 39 fields, bf16: ~266 MB, 0.079 ms at 3.35 TB/s. The
// kernel reads s1 once per field (the same rows for every field, 17 MB in
// bf16, re-read through L2 for each field after the first: ~0.66 GB from
// L2, not from DRAM).
//
// What held the first design back, from its SASS (cuobjdump -sass, sm_90a,
// bf16 storage and compute): it ran segment_scan.cuh's tile_pass with one
// thread per column (96 threads at w = 65, the third warp one column wide)
// and produced each element where it summed it: 908 instructions per 8
// lanes of its unrolled loop, ~113 per element, 20 of them address
// arithmetic to re-read the lane's scalars from shared memory and its s1
// and urows rows from global memory, 8 scalar cvt.rn.bf16.f32 (F2F) and a
// branch per lane; each lane's urows row was re-read per lane, and each
// lane's two loads waited in its own block before the next lane's issued.
// It was bound by instruction issue, not bytes: the fp32 leg, which moves
// more bytes and rounds nothing, ran faster (1.41 ms) than bf16 (1.63 ms).
//
// Design: a first pass of its own, one block per (tile of kTile sorted
// lanes, field), whose threads are (lane subgroup, column) items: S
// subgroups of kTile / S consecutive lanes, S * w <= kMaxItems (w = 65:
// 4 x 65 items on 288 threads), so no warp runs one column alone.
//  0. transpose_vals copies vals to [F, B] once per call (see there).
//  1. Staging. The tile's lane scalars are loaded once per lane (order,
//     inv[o], ds[o], x rounded, tch = weights[o] > 0, s1's row address)
//     and the tile's runs of equal segments numbered (warp ballots); lane
//     pairs are also kept as bf16x2. Then each run's unique row is copied
//     once, raw, by the 16-byte chunks that cover it (rows of 130 or 260
//     bytes start anywhere in a chunk), all loads in flight together.
//  2. Compute. Each item walks its subgroup's lanes for its column, with
//     the s1 elements of kUnroll lanes loaded together (straight to
//     registers through each lane's row address: each element is used
//     once, so staging it would add a store and a load per element). With
//     bf16 compute it takes two lanes at a time in bf16x2 arithmetic
//     (mul/sub/add.rn.bf16x2: see bmul2), 7 packed operations per pair
//     where the first design spent 8 scalar F2F conversions per element.
//     A batch that lies in one run is summed without a test per lane.
//     Runs that start and end inside a subgroup are complete and go
//     straight to out; each subgroup's first and last runs go to shared
//     memory.
//  3. Combine. One thread per column sums the subgroups' edge partials in
//     subgroup order and writes the tile's runs as tile_pass would: its
//     first and last segments, where they continue into a neighbour tile,
//     as carries in tile_pass's layout.
// The carry passes that follow are segment_scan.cuh's tile_pass over the
// carry rows, unchanged. No atomics and a fixed order of
// every sum: a repeat gives the same bits. The rows no lane writes are
// zeroed by the first pass between compute and combine (its step 4), not
// by a memset of the whole output first: with dense segments that is
// only the rows past each field's last segment, shared out over the
// field's blocks (on an H100: 0.633 against 0.642 ms with the memset,
// bf16).

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "segment_scan.cuh"

#define FM_BWD_MAX_FIELDS 64

namespace {

constexpr int kTile = SEG_TILE;      // lanes per block: tile_pass's layout
constexpr int kMaxItems = 288;       // (subgroup, column) items per block
constexpr int kUnroll = 8;           // lanes whose s1 loads fly together

struct UrowsPtrs {
    const void* t[FM_BWD_MAX_FIELDS];
};

__device__ __forceinline__ float bf16_bits(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
}

template <typename T>
__device__ __forceinline__ float widen(const void* base, size_t i);

template <>
__device__ __forceinline__ float widen<float>(const void* base, size_t i) {
    return __ldg(static_cast<const float*>(base) + i);
}

template <>
__device__ __forceinline__ float widen<__nv_bfloat16>(const void* base,
                                                      size_t i) {
    return bf16_bits(__ldg(static_cast<const unsigned short*>(base) + i));
}

// lo and hi rounded to bf16 (nearest even) and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

// Round to the compute dtype (bf16: to nearest even, as
// __float2bfloat16_rn) and widen back.
template <bool CD_BF16>
__device__ __forceinline__ float rc(float v) {
    if constexpr (CD_BF16) {
        return __uint_as_float(pack_bf16x2(v, v) << 16);
    } else {
        return v;
    }
}

// bf16x2 arithmetic, each result rounded once to nearest even. With bf16
// operands this equals the fp32 operation rounded to bf16 (fp32 carries
// 24 >= 2 * 8 + 2 significand bits: double rounding is innocuous for +, -
// and *), so the packed steps give the plain version's bits. An explicit
// .rn keeps ptxas from contracting a multiply and an add into an fma.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ uint32_t bsub2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// s1[., col] of lanes l .. l + 2N - 1 as N bf16 pairs (low half: even lane).
template <int N>
__device__ __forceinline__ void load_pairs(uint32_t (&dst)[N],
                                           const unsigned short* const* src,
                                           int l, int col) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
        const uint32_t a = __ldg(src[l + 2 * q] + col);
        const uint32_t b = __ldg(src[l + 2 * q + 1] + col);
        dst[q] = a | (b << 16);
    }
}

// vals [n, fields] -> vals_t [fields, n]: a block copies kTransposeRows
// lanes' rows (one contiguous run of floats) into shared memory and writes
// each field's kTransposeRows values. The first pass then reads field f's
// values for its sorted lanes from n * 4 bytes instead of at a stride of
// fields * 4 (one 32-byte sector per lane and field).
constexpr int kTransposeRows = 64;

__global__ void __launch_bounds__(256)
    transpose_vals(const float* __restrict__ vals, int n, int fields,
                   float* __restrict__ vals_t) {
    extern __shared__ float rows_in[];          // [kTransposeRows][fields]
    const int b0 = blockIdx.x * kTransposeRows;
    const int rows = min(kTransposeRows, n - b0);
    const float* src = vals + static_cast<size_t>(b0) * fields;
    for (int i = threadIdx.x; i < rows * fields; i += blockDim.x) {
        rows_in[i] = src[i];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTransposeRows * fields; i += blockDim.x) {
        const int f = i / kTransposeRows, b = i - f * kTransposeRows;
        if (b < rows) {
            vals_t[static_cast<size_t>(f) * n + b0 + b] =
                rows_in[b * fields + f];
        }
    }
}

// The bf16 bits of a float that holds a bf16 value.
__device__ __forceinline__ uint32_t bf16_of(float v) {
    return __float_as_uint(v) >> 16;
}

struct BwdArgs {
    UrowsPtrs urows;           // F x [cap, width]
    const int* order;          // [F, n]
    const int* inv;            // [F, n]
    const void* s1;            // [n, width] compute dtype
    const void* ds;            // [n] compute dtype
    const float* vals;         // [F, n]: vals transposed by transpose_vals
    const float* weights;      // [n]
    const float* neg_lr;       // one fp32 on the device: -lr of the step
    int n, fields, width, cap, k, subgroups;
    float rv_factors, rv_linear;
};

struct __align__(16) Lane {
    float ds, x, tch;
    int roff;                  // where its run's row starts in the staged rows
};

// Shared memory: Lane and s1 row pointer [kPad] (the tile's lanes, then
// inert padding, so a batch of kUnroll lanes never reads past it), the
// lane pairs' scalars as bf16x2 [kPad / 2], seg [kTile + 2] (the tile's
// lanes and its two neighbours), run segment [kTile], ballot counts
// [kTile / 32]; then the subgroups' head and tail partials [2][S][width]
// and the staged rows: [kTile] slots of the storage's raw bits, each run's
// row copied by the 16-byte chunks that cover it.
constexpr int kPad = kTile + kUnroll;
constexpr size_t kFixedBytes =
    (sizeof(Lane) * kPad + sizeof(void*) * kPad + sizeof(uint4) * kPad / 2
     + sizeof(int) * (2 * kTile + 3 + kTile / 32) + 15) / 16 * 16;

// S: lane subgroups of a tile, at most kTile / 2 so that each holds whole
// lane pairs.
inline int subgroups_for(int width) {
    int s = kTile / 2;
    while (s > 1 && s * width > kMaxItems) s >>= 1;
    return s;
}

// Threads of a block: the items, and at least kPad + 1 (phase 1's loaders
// and the pair builders).
inline int threads_for(int width, int subgroups) {
    return std::max((subgroups * width + 31) / 32 * 32,
                    (kPad + 1 + 31) / 32 * 32);
}

// Elements of a staged row's slot: the 16-byte chunks that cover a row at
// any alignment.
__host__ __device__ inline int slot_elems(int width, int ebytes) {
    return (width * ebytes + 30) / 16 * 16 / ebytes;
}

inline size_t smem_bytes(int width, int subgroups, int ebytes) {
    return kFixedBytes + sizeof(float) * 2 * subgroups * width
        + static_cast<size_t>(kTile) * slot_elems(width, ebytes) * ebytes;
}

// St: urows storage (float | __nv_bfloat16); CD_BF16: the compute dtype of
// s1, ds and every elementwise step; RV: the rv * u * tch term is on.
// Grid: tiles x fields. Writes complete segments to out and the tile's two
// carry slots, as tile_pass does.
template <typename St, bool CD_BF16, bool RV>
__global__ void __launch_bounds__(kMaxItems, CD_BF16 ? 6 : 5)
    bwd_first_pass(const BwdArgs p, float* __restrict__ out,
                   int* __restrict__ cseg, float* __restrict__ cval) {
    using Cd = typename std::conditional<CD_BF16, __nv_bfloat16, float>::type;
    using Bits = typename std::conditional<CD_BF16, unsigned short,
                                           float>::type;
    extern __shared__ float4 smem[];
    Lane* s_lane = reinterpret_cast<Lane*>(smem);
    const Bits** s_src = reinterpret_cast<const Bits**>(s_lane + kPad);
    uint4* s_pair = reinterpret_cast<uint4*>(s_src + kPad);
    int* s_seg = reinterpret_cast<int*>(s_pair + kPad / 2);
    int* s_runseg = s_seg + kTile + 2;
    int* s_wcount = s_runseg + kTile;
    int* s_last = s_wcount + kTile / 32;
    const int n = p.n, w = p.width, S = p.subgroups, L = kTile / S;
    float* s_head = reinterpret_cast<float*>(
        reinterpret_cast<char*>(smem) + kFixedBytes);
    float* s_tail = s_head + S * w;
    // The staged rows, raw: bf16 bits or fp32.
    using StBits = typename std::conditional<
        std::is_same<St, __nv_bfloat16>::value, unsigned short, float>::type;
    constexpr int kE = sizeof(StBits);
    const int slot = slot_elems(w, kE);
    StBits* s_rows = reinterpret_cast<StBits*>(s_tail + S * w);

    const int f = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
    const int t0 = tile * kTile;
    const int len = min(kTile, n - t0);
    const int tid = threadIdx.x;
    const int* order = p.order + static_cast<size_t>(f) * n;
    const int* inv = p.inv + static_cast<size_t>(f) * n;
    const Bits* s1 = static_cast<const Bits*>(p.s1);

    // 1. The lanes' scalars, once per lane, and the segments of the tile's
    // two neighbours (INT_MIN where there is none: it matches no segment).
    // Lanes past the tile's end are inert: zero scalars, s1's first row.
    for (int i = tid; i < kPad + 1; i += blockDim.x) {
        const int t = t0 - 1 + i;
        int s = -2147483647 - 1;
        Lane l{0.f, 0.f, 0.f, 0};
        const Bits* src = s1;
        if (t >= 0 && t < n && i <= len + 1) {
            const int o = __ldg(order + t);
            s = __ldg(inv + o);
            if (i >= 1 && i <= len) {
                l.ds = widen<Cd>(p.ds, o);
                l.x = rc<CD_BF16>(
                    __ldg(p.vals + static_cast<size_t>(f) * n + o));
                l.tch = __ldg(p.weights + o) > 0.f ? 1.f : 0.f;
                src = s1 + static_cast<size_t>(o) * w;
            }
        }
        if (i <= kTile + 1) s_seg[i] = s;
        if (i >= 1) {
            s_lane[i - 1] = l;
            s_src[i - 1] = src;
        }
    }
    // The field's last sorted segment, for the rows past it (step 4).
    if (tid == blockDim.x - 1) *s_last = __ldg(inv + __ldg(order + n - 1));
    __syncthreads();

    // Runs of equal segments: a lane's run is the number of run heads up
    // to and including it, less one.
    const int head = tid < len && (tid == 0 || s_seg[tid + 1] != s_seg[tid]);
    const unsigned ball = __ballot_sync(0xffffffffu, head);
    if (tid < kTile && (tid & 31) == 0) s_wcount[tid >> 5] = __popc(ball);
    __syncthreads();
    // A lane's row starts roff elements into the staged rows: its run's
    // slot, plus the row's offset inside its first 16-byte chunk.
    const void* ut = p.urows.t[f];
    int roff = 0;
    if (tid < len) {
        int run = __popc(ball & ((2u << (tid & 31)) - 1u)) - 1;
        for (int v = 0; v < (tid >> 5); ++v) run += s_wcount[v];
        const int seg = s_seg[tid + 1];
        roff = run * slot;
        if (segscan::live(seg, p.cap)) {
            roff += static_cast<int>(((reinterpret_cast<uintptr_t>(ut)
                                       + static_cast<size_t>(seg) * w * kE)
                                      & 15) / kE);
        }
        s_lane[tid].roff = roff;
        if (head) s_runseg[run] = seg;
    }
    if constexpr (CD_BF16) {
        // Lane pairs (2j, 2j + 1) as bf16x2 for the packed arithmetic:
        // x, ds, tch and the two row offsets (< 2^16: w <= 128).
        const Lane me = tid < kPad ? s_lane[tid] : Lane{0.f, 0.f, 0.f, 0};
        const uint32_t x = bf16_of(me.x), ds = bf16_of(me.ds);
        const uint32_t tch = bf16_of(me.tch);
        const uint32_t x1 = __shfl_down_sync(0xffffffffu, x, 1);
        const uint32_t ds1 = __shfl_down_sync(0xffffffffu, ds, 1);
        const uint32_t tch1 = __shfl_down_sync(0xffffffffu, tch, 1);
        const uint32_t roff1 = __shfl_down_sync(0xffffffffu, roff, 1);
        if (tid < kPad && (tid & 1) == 0) {
            s_pair[tid >> 1] = make_uint4(x | (x1 << 16), ds | (ds1 << 16),
                                          tch | (tch1 << 16),
                                          roff | (roff1 << 16));
        }
    }
    int runs = 0;
    for (int v = 0; v < kTile / 32; ++v) runs += s_wcount[v];
    __syncthreads();

    // 2. Each run's unique row, once, by the 16-byte chunks that cover it
    // (a chunk never crosses a page, so reading a row's first and last
    // chunks whole stays inside its table's pages); all loads in flight
    // together. A row past cap is zeros.
    {
        const int rowbytes = w * kE, nch = slot * kE / 16;
        char* srows = reinterpret_cast<char*>(s_rows);
#pragma unroll 8
        for (int i = tid; i < runs * nch; i += blockDim.x) {
            const int r = i / nch, c = i - r * nch;
            const int seg = s_runseg[r];
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (segscan::live(seg, p.cap)) {
                const uintptr_t start = reinterpret_cast<uintptr_t>(ut)
                    + static_cast<size_t>(seg) * rowbytes;
                const uintptr_t a0 = start & ~static_cast<uintptr_t>(15);
                if (a0 + 16 * static_cast<uintptr_t>(c) < start + rowbytes) {
                    v = __ldg(reinterpret_cast<const uint4*>(a0) + c);
                }
            }
            char* dst = srows + static_cast<size_t>(r) * slot * kE;
            reinterpret_cast<uint4*>(dst)[c] = v;
        }
    }
    __syncthreads();

    const int sub = tid / w, col = tid - sub * w;
    const bool active = sub < S;
    const int lo = sub * L, hi = min(lo + L, len);
    const float rv = col < p.k ? p.rv_factors : p.rv_linear;

    // 3. Each item's lanes: the terms, summed per run.
    float* fout = out + static_cast<size_t>(f) * p.cap * w;
    if (active && lo < hi) {
        const bool masked = col < p.k;       // the column takes -x*u
        const float neg_lr = __ldg(p.neg_lr);
        const StBits* rows = s_rows + col;
        const int first = s_lane[lo].roff;
        int cur = first;
        float acc = 0.f;
        // Ends the run `cur` whose last lane is t: the subgroup's first run
        // goes to its head partial, any other is complete.
        const auto flush = [&](int t) {
            if (cur == first) {
                s_head[sub * w + col] = acc;
            } else {
                const int seg = s_seg[t + 1];
                if (segscan::live(seg, p.cap)) {
                    fout[static_cast<size_t>(seg) * w + col] = acc;
                }
            }
        };
        // Adds lane t's term, ending the current run first where t starts
        // another.
        const auto add = [&](int t, int roff, float v) {
            if (roff != cur) {
                flush(t - 1);
                cur = roff;
                acc = 0.f;
            }
            acc = __fadd_rn(acc, v);
        };
        if constexpr (CD_BF16) {
            // Two lanes at a time in bf16x2: r * x, s1 - ., ds * ., . * x
            // and g + rv * r * tch (tch 0 or 1: exact), each rounded once;
            // then -lr * g in fp32.
            const uint32_t rv2 = bf16_of(rv) * 0x10001u;
            for (int l = lo; l < hi; l += kUnroll) {
                uint32_t s1p[kUnroll / 2];
                load_pairs(s1p, s_src, l, col);
                // Runs are contiguous: a batch whose last lane is in the
                // current run lies in it whole.
                const bool whole =
                    l + kUnroll <= hi && s_lane[l + kUnroll - 1].roff == cur;
#pragma unroll
                for (int q = 0; q < kUnroll / 2; ++q) {
                    const int t = l + 2 * q;
                    if (t >= hi) break;
                    const uint4 pr = s_pair[t >> 1];    // x, ds, tch, roffs
                    uint32_t r2;
                    if constexpr (std::is_same<St, __nv_bfloat16>::value) {
                        r2 = rows[pr.w & 0xffffu]
                            | (static_cast<uint32_t>(rows[pr.w >> 16]) << 16);
                    } else {
                        r2 = pack_bf16x2(rows[pr.w & 0xffffu],
                                         rows[pr.w >> 16]);
                    }
                    uint32_t d = s1p[q];
                    if (masked) d = bsub2(d, bmul2(r2, pr.x));
                    uint32_t g2 = bmul2(bmul2(pr.y, d), pr.x);
                    if constexpr (RV) {
                        g2 = badd2(g2, bmul2(bmul2(rv2, r2), pr.z));
                    }
                    const float ga =
                        __fmul_rn(neg_lr, __uint_as_float(g2 << 16));
                    const float gb =
                        __fmul_rn(neg_lr, __uint_as_float(g2 & 0xffff0000u));
                    if (whole) {
                        acc = __fadd_rn(__fadd_rn(acc, ga), gb);
                    } else {
                        add(t, static_cast<int>(pr.w & 0xffffu), ga);
                        if (t + 1 < hi) {
                            add(t + 1, static_cast<int>(pr.w >> 16), gb);
                        }
                    }
                }
            }
        } else {
            for (int l = lo; l < hi; l += kUnroll) {
                float s1v[kUnroll], g[kUnroll];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    s1v[u] = __ldg(s_src[l + u] + col);
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const Lane a = s_lane[l + u];
                    float r;
                    if constexpr (std::is_same<St, __nv_bfloat16>::value) {
                        r = bf16_bits(rows[a.roff]);
                    } else {
                        r = rows[a.roff];
                    }
                    const float t = masked
                        ? __fsub_rn(s1v[u], __fmul_rn(r, a.x)) : s1v[u];
                    float gu = __fmul_rn(__fmul_rn(a.ds, t), a.x);
                    if constexpr (RV) {
                        gu = __fadd_rn(gu, __fmul_rn(__fmul_rn(rv, r), a.tch));
                    }
                    g[u] = __fmul_rn(neg_lr, gu);
                }
                // Runs are contiguous: a batch whose last lane is in the
                // current run lies in it whole.
                if (l + kUnroll <= hi && s_lane[l + kUnroll - 1].roff == cur) {
#pragma unroll
                    for (int u = 0; u < kUnroll; ++u) {
                        acc = __fadd_rn(acc, g[u]);
                    }
                    continue;
                }
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    if (l + u < hi) add(l + u, s_lane[l + u].roff, g[u]);
                }
            }
        }
        if (cur == first) {
            s_head[sub * w + col] = acc;
        } else {
            s_tail[sub * w + col] = acc;
        }
    }
    __syncthreads();

    // 4. The rows no lane writes: the gap between each lane's segment and
    // its sorted predecessor's (tile 0's first lane: from row 0), and,
    // shared out over the field's tiles, the rows past its last segment.
    if (tid < len) {
        const int r1 = min(s_seg[tid + 1], p.cap);
        for (int r = max(s_seg[tid] + 1, 0); r < r1; ++r) {
            for (int c = 0; c < w; ++c) {
                fout[static_cast<size_t>(r) * w + c] = 0.f;
            }
        }
    }
    {
        const long long r0 = max(*s_last + 1, 0);
        const long long total = (p.cap - r0) * w;
        if (total > 0) {
            const long long per = (total + tiles - 1) / tiles;
            const long long e1 = min(per * (tile + 1), total);
            float* base = fout + r0 * w;
            for (long long e = per * tile + tid; e < e1; e += blockDim.x) {
                base[e] = 0.f;
            }
        }
    }

    // 5. One thread per column: the subgroups' edge partials in order, as
    // (run offset, segment, partial).
    if (tid >= w) return;
    const int c = tid;
    const int first_seg = s_seg[1], last_seg = s_seg[len];
    const bool cont_in = s_seg[0] == first_seg;
    const bool cont_out = s_seg[len + 1] == last_seg;
    const size_t slot0 = static_cast<size_t>(f) * 2 * tiles + 2 * tile;
    // A run that ends before the tile's last run.
    const int first_roff = s_lane[0].roff;
    const auto emit = [&](int roff, int seg, float v) {
        if (roff == first_roff && cont_in) {
            if (c == 0) cseg[slot0] = seg;
            cval[slot0 * w + c] = v;
        } else if (segscan::live(seg, p.cap)) {
            fout[static_cast<size_t>(seg) * w + c] = v;
        }
    };
    int cur = first_roff, cur_seg = first_seg;
    float acc = 0.f;
    for (int sb = 0; sb < S; ++sb) {
        const int slo = sb * L;
        if (slo >= len) break;
        const int shi = min(slo + L, len) - 1;
        const int rh = s_lane[slo].roff, rt = s_lane[shi].roff;
        if (rh != cur) {
            emit(cur, cur_seg, acc);
            cur = rh;
            cur_seg = s_seg[slo + 1];
            acc = 0.f;
        }
        acc = __fadd_rn(acc, s_head[sb * w + c]);
        if (rt != rh) {
            emit(cur, cur_seg, acc);
            cur = rt;
            cur_seg = s_seg[shi + 1];
            acc = __fadd_rn(0.f, s_tail[sb * w + c]);
        }
    }
    // The tile's last run, and the unused carry slots.
    if (runs == 1) {                     // one segment fills the tile
        if (cont_in || cont_out) {
            if (c == 0) {
                cseg[slot0] = first_seg;
                cseg[slot0 + 1] = first_seg;
            }
            cval[slot0 * w + c] = acc;
            cval[(slot0 + 1) * w + c] = 0.f;
            return;
        }
        if (segscan::live(first_seg, p.cap)) {
            fout[static_cast<size_t>(first_seg) * w + c] = acc;
        }
        if (c == 0) {
            cseg[slot0] = -1;
            cseg[slot0 + 1] = -1;
        }
        cval[slot0 * w + c] = 0.f;
        cval[(slot0 + 1) * w + c] = 0.f;
        return;
    }
    if (!cont_in) {
        if (c == 0) cseg[slot0] = -1;
        cval[slot0 * w + c] = 0.f;
    }
    if (cont_out) {
        if (c == 0) cseg[slot0 + 1] = last_seg;
        cval[(slot0 + 1) * w + c] = acc;
    } else {
        if (segscan::live(last_seg, p.cap)) {
            fout[static_cast<size_t>(last_seg) * w + c] = acc;
        }
        if (c == 0) cseg[slot0 + 1] = -1;
        cval[(slot0 + 1) * w + c] = 0.f;
    }
}

// Runs transpose_vals and the first pass, then tile_pass over the
// carries until one tile remains.
template <typename St, bool CD_BF16, bool RV>
cudaError_t launch(const BwdArgs& a, const float* vals, float* out,
                   int* scratch_seg, float* scratch_val, cudaStream_t stream) {
    const int fields = a.fields, n = a.n, width = a.width, cap = a.cap;
    transpose_vals<<<(n + kTransposeRows - 1) / kTransposeRows, 256,
                     sizeof(float) * kTransposeRows * fields, stream>>>(
        vals, n, fields, const_cast<float*>(a.vals));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t smem = smem_bytes(width, a.subgroups, sizeof(St));
    const auto kernel = bwd_first_pass<St, CD_BF16, RV>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int tiles = segscan::tiles_of(n);
    int* cseg = scratch_seg;
    float* cval = scratch_val;
    const int threads = threads_for(width, a.subgroups);
    kernel<<<dim3(tiles, fields), threads, smem, stream>>>(a, out, cseg, cval);
    err = cudaGetLastError();
    const dim3 block((width + 31) / 32 * 32);
    while (err == cudaSuccess && tiles > 1) {
        const int m = 2 * tiles;              // carry rows of that pass
        const segscan::PlainProducer pc{cseg, cval, m, width};
        cseg += static_cast<size_t>(fields) * m;
        cval += static_cast<size_t>(fields) * m * width;
        tiles = segscan::tiles_of(m);
        segscan::tile_pass<segscan::PlainProducer>
            <<<dim3(tiles, fields), block, 0, stream>>>(pc, m, width, cap, out,
                                                        cseg, cval);
        err = cudaGetLastError();
    }
    return err;
}

}  // namespace

extern "C" {

// urows_ptrs: a HOST array of `fields` device pointers, each to a
// contiguous [cap, width] table of unique rows (bf16 if store_bf16, else
// fp32). s1 [batch, width] and ds [batch] are in the compute dtype (bf16
// if cd_bf16, else fp32); order / inv [fields, batch] int32; vals
// [batch, fields] and weights [batch] fp32; vals_t: scratch of
// [fields, batch] fp32 (vals transposed here). rv_factors / rv_linear are
// already rounded to the compute dtype. out: [fields, cap, width] fp32
// (every row written here). scratch: at least fm_bwd_scratch_rows(batch)
// rows per field. neg_lr points to one fp32 on the device (-lr of the
// step): read there, not passed by value, so a captured CUDA graph of the
// step takes each replay's learning rate. Launches on `stream` of
// `device`, returns cudaGetLastError();
// does not synchronise.
int fm_fused_bwd(const void* const* urows_ptrs, int fields, int cap,
                 int width, int store_bf16, int cd_bf16, const int* order,
                 const int* inv, const void* s1, const void* ds,
                 const float* vals, float* vals_t, const float* weights,
                 int batch,
                 const float* neg_lr, int use_rv, float rv_factors,
                 float rv_linear,
                 float* out, int* scratch_seg, float* scratch_val,
                 long long scratch_rows, void* stream, int device) {
    if (fields < 1 || fields > FM_BWD_MAX_FIELDS || cap < 1 || width < 2 ||
        width > SEG_MAX_WIDTH || batch < 1 || neg_lr == nullptr ||
        scratch_rows < segscan::scratch_rows(batch) * fields) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    BwdArgs a;
    for (int f = 0; f < FM_BWD_MAX_FIELDS; ++f) {
        a.urows.t[f] = f < fields ? urows_ptrs[f] : nullptr;
    }
    a.order = order;
    a.inv = inv;
    a.s1 = s1;
    a.ds = ds;
    a.vals = vals_t;
    a.weights = weights;
    a.n = batch;
    a.fields = fields;
    a.width = width;
    a.cap = cap;
    a.k = width - 1;
    a.subgroups = subgroups_for(width);
    a.neg_lr = neg_lr;
    a.rv_factors = rv_factors;
    a.rv_linear = rv_linear;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto run = [&](auto st, auto cd, auto rv) {
        return launch<decltype(st), decltype(cd)::value, decltype(rv)::value>(
            a, vals, out, scratch_seg, scratch_val, s);
    };
    using T = std::true_type;
    using F = std::false_type;
    cudaError_t err;
    if (store_bf16) {
        const __nv_bfloat16 st{};
        err = cd_bf16 ? (use_rv ? run(st, T{}, T{}) : run(st, T{}, F{}))
                      : (use_rv ? run(st, F{}, T{}) : run(st, F{}, F{}));
    } else {
        const float st{};
        err = cd_bf16 ? (use_rv ? run(st, T{}, T{}) : run(st, T{}, F{}))
                      : (use_rv ? run(st, F{}, T{}) : run(st, F{}, F{}));
    }
    return static_cast<int>(err);
}

long long fm_bwd_scratch_rows(int batch) {
    return segscan::scratch_rows(batch);
}

const char* fm_bwd_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
