// Deterministic segmented sums over lanes sorted by segment, for Hopper:
// the carry passes of fm_fused_bwd.cu (kernel B).
//
// Kernel B computes out[s] = sum of the lanes t whose segment is s, over
// lanes grouped by segment (equal segments are contiguous), into a
// [cap, width] fp32 output. Its own first pass sums each tile's runs and
// leaves the runs cut by the tile's edges as carries in this file's
// layout; tile_pass then runs over the carry rows (PlainProducer), again
// and again, until one tile remains. (Kernel A, segment_totals.cu, used
// this skeleton for its first pass too until it got a design of its own.)
//
//   * One block per tile of SEG_TILE consecutive lanes, one thread per
//     column. Each thread walks the tile's lanes in order and sums runs of
//     equal segment ids in a register.
//   * A segment that starts and ends inside the tile, and does not touch
//     the tile's edges while continuing into a neighbour, is complete: it
//     is written straight to out (a plain store; no other block holds any
//     of its lanes).
//   * The tile's first segment, if it continues from the previous tile,
//     and its last, if it continues into the next, are partial: they go to
//     two carry slots of the tile, (segment, row). A tile whose lanes all
//     share one continuing segment puts its sum in slot 0 and a zero row
//     of the same segment in slot 1, so the runs of equal ids stay
//     contiguous in the carry array; an unused slot holds segment -1.
//   * The carry array is itself a list of rows grouped by segment, 2 per
//     tile, so the same tile pass runs on it again, and again, until one
//     tile remains, whose segments are all complete. With SEG_TILE = 128,
//     B = 131072 takes 3 passes (131072 -> 2048 -> 32 -> done).
//
// No atomics, and a fixed order of every sum, so a repeat gives the same
// bits. A long run of one segment (a Zipf head: ~25 % of the lanes share
// id 1) costs one carry row per tile it covers and nothing serial: the
// next pass sums those rows 128 at a time.
//
// Segment ids outside [0, cap) are trash: summed, never written.

#pragma once

#include <cuda_runtime.h>

#define SEG_TILE 128
#define SEG_MAX_WIDTH 128
#define SEG_UNROLL 8

namespace segscan {

__device__ __forceinline__ bool live(int s, int cap) {
    return static_cast<unsigned>(s) < static_cast<unsigned>(cap);
}

// Lanes read straight from memory: seg[t] and row t of a [n, width] fp32
// array: every carry pass.
struct PlainProducer {
    struct Lane {
        int pad;
    };
    const int* seg;      // [fields][n]
    const float* val;    // [fields][n][width]
    int n, width;
    __device__ int load(int f, int t, Lane&) const {
        return seg[static_cast<size_t>(f) * n + t];
    }
    __device__ float value(int f, const Lane&, int t, int col) const {
        return val[(static_cast<size_t>(f) * n + t) * width + col];
    }
};

// One pass over tiles of a producer's lanes (grid: tiles x fields, block:
// width rounded up to a warp). out is [fields][cap][width]; cseg/cval are
// this pass's carries, [fields][2 * tiles] and [fields][2 * tiles][width].
template <class P>
__global__ void __launch_bounds__(SEG_MAX_WIDTH)
tile_pass(P p, int n, int width, int cap, float* __restrict__ out,
          int* __restrict__ cseg, float* __restrict__ cval) {
    __shared__ int s_seg[SEG_TILE + 2];          // lanes t0 - 1 .. t1
    __shared__ typename P::Lane s_lane[SEG_TILE];
    const int f = blockIdx.y;
    const int tile = blockIdx.x;
    const int tiles = gridDim.x;
    const int t0 = tile * SEG_TILE;
    const int len = min(SEG_TILE, n - t0);
    // Stage the tile's lanes, and the segment ids of its two neighbours
    // (INT_MIN where there is none, which matches no segment).
    for (int i = threadIdx.x; i < len + 2; i += blockDim.x) {
        const int t = t0 - 1 + i;
        int s = -2147483647 - 1;
        if (i >= 1 && i <= len) {
            s = p.load(f, t, s_lane[i - 1]);
        } else if (t >= 0 && t < n) {
            typename P::Lane unused;
            s = p.load(f, t, unused);
        }
        s_seg[i] = s;
    }
    __syncthreads();

    const int col = threadIdx.x;
    if (col >= width) return;
    const int first = s_seg[1];
    const int last = s_seg[len];
    const bool cont_in = s_seg[0] == first;
    const bool cont_out = s_seg[len + 1] == last;
    float* fout = out + static_cast<size_t>(f) * cap * width;
    const size_t slot0 = static_cast<size_t>(f) * 2 * tiles + 2 * tile;

    int cur = first;
    bool in_first = true;       // still summing the tile's first segment
    float acc = 0.f;
    for (int i = 0; i < len; i += SEG_UNROLL) {
        float v[SEG_UNROLL];
#pragma unroll
        for (int u = 0; u < SEG_UNROLL; ++u) {
            v[u] = i + u < len ? p.value(f, s_lane[i + u], t0 + i + u, col)
                               : 0.f;
        }
#pragma unroll
        for (int u = 0; u < SEG_UNROLL; ++u) {
            if (i + u >= len) break;
            const int s = s_seg[1 + i + u];
            if (s != cur) {
                // `cur` ends here, before the tile's end: complete unless
                // it is the first segment and began in the previous tile.
                if (in_first && cont_in) {
                    if (col == 0) cseg[slot0] = cur;
                    cval[slot0 * width + col] = acc;
                } else if (live(cur, cap)) {
                    fout[static_cast<size_t>(cur) * width + col] = acc;
                }
                in_first = false;
                cur = s;
                acc = 0.f;
            }
            acc = __fadd_rn(acc, v[u]);
        }
    }
    // The tile's last segment.
    if (in_first) {                       // one segment fills the tile
        if (cont_in || cont_out) {
            if (col == 0) {
                cseg[slot0] = cur;
                cseg[slot0 + 1] = cur;
            }
            cval[slot0 * width + col] = acc;
            cval[(slot0 + 1) * width + col] = 0.f;
            return;
        }
        if (live(cur, cap)) fout[static_cast<size_t>(cur) * width + col] = acc;
        if (col == 0) {
            cseg[slot0] = -1;
            cseg[slot0 + 1] = -1;
        }
        cval[slot0 * width + col] = 0.f;
        cval[(slot0 + 1) * width + col] = 0.f;
        return;
    }
    if (!cont_in) {                       // slot 0 unused
        if (col == 0) cseg[slot0] = -1;
        cval[slot0 * width + col] = 0.f;
    }
    if (cont_out) {
        if (col == 0) cseg[slot0 + 1] = cur;
        cval[(slot0 + 1) * width + col] = acc;
    } else {
        if (live(cur, cap)) fout[static_cast<size_t>(cur) * width + col] = acc;
        if (col == 0) cseg[slot0 + 1] = -1;
        cval[(slot0 + 1) * width + col] = 0.f;
    }
}

__host__ __device__ inline int tiles_of(int n) {
    return (n + SEG_TILE - 1) / SEG_TILE;
}

// Carry rows per field that all passes over n lanes write together (the
// last pass, of one tile, writes its two unused slots too).
inline long long scratch_rows(int n) {
    long long rows = 0;
    for (int t = tiles_of(n);; t = tiles_of(2 * t)) {
        rows += 2LL * t;
        if (t == 1) return rows;
    }
}

}  // namespace segscan
