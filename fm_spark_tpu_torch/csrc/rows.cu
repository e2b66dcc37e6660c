// Row gather and in-place row update for Hopper (sm_90a).
//
// Replaces the TPU kernels fm_spark_tpu/ops/pallas_fm.py::gather_rows
// (_gather_kernel) and ::update_rows_add (_update_kernel), the row access of
// the fused sparse-SGD steps under TrainConfig.use_pallas:
//
//   gather:  out[m, :] = table[clamp(ids[m], 0, n - 1), :]
//   update:  table[ids[m], :] = T(float(table[ids[m], :]) + float(delta[m, :]))
//            for every lane m with valid[m] != 0
//
// for a row-major table [n, w] of type T (fp32 or bf16), ids and valid [B]
// int32 and delta [B, w] (fp32 or bf16). The update's ids are unique among
// the valid lanes (the caller deduplicates first), so no two lanes write one
// row and no atomics are needed; a valid lane whose id lies outside [0, n)
// is skipped (the TPU kernel's DMA would leave the table). The gather clamps
// its ids into the table, as scatter.pallas_gather does before it calls the
// TPU kernel. Accumulation is fp32 (__fadd_rn, no fma contraction) and each
// element is rounded once to T (__float2bfloat16_rn for bf16), as
// _update_kernel's astype pair: kernel and plain version give the same bits.
//
// Bound: memory. The gather reads each distinct row once and writes B rows:
// u * w * e + B * w * e + 4 B bytes for u distinct ids and e bytes per
// element. The update reads and writes each valid lane's row and reads its
// delta, and reads the ids of the lanes it covers: v * w * (2 e + e_delta)
// + 4 u bytes for v valid lanes of u (8 u with valid flags). At config 3
// (w = 65 fp32, B = 131,072 Zipf ids, ~12,000 distinct per field) a gather
// moves ~37 MB (11 us at 3.35 TB/s) and an update ~9 MB; at config 4
// (w = 369 fp32) a gather moves ~207 MB (62 us).
//
// Gather design: the flat output. The output [B, w] is contiguous and
// fresh, so it is cut into 16-byte chunks (4 fp32 or 8 bf16 elements);
// each thread owns kChunks of them, strided by the block so that a warp's
// stores cover 512 contiguous bytes, and issues every load of all its
// chunks before its first store. A chunk's first element finds its row by
// a multiply-shift (the wrapper's divider for w; 64-bit division only past
// 2^31 elements) and walks into the next row where the chunk crosses one,
// reading each row's id once. Loads are element by element: the rows the
// repo's configurations gather (w = 65, 369 or 17 elements, all odd)
// start at every element offset of a 16-byte chunk, so a path of 16-byte
// loads would run for none of them.
//
// What held the first design (one warp per lane, its threads striding the
// row one element at a time) back, from its SASS (cuobjdump -sass, sm_90a):
// at w = 65 every thread ran the remainder loop of its #pragma unroll 4,
// one 4-byte LDG and one dependent 4-byte STG per trip, so each thread had
// one load in flight; the third sweep of a 65-element row had 1 of 32
// threads active; bf16 made every access 2 bytes (64 B per warp request);
// at w = 369 a thread held at most four loads before its stores. No store
// was wider than the element.
//
// TMA bulk copies do not fit these rows: cp.async.bulk needs 16-byte
// aligned sources and sizes, and rows of 260 B (w = 65 fp32), 130 B (bf16)
// or 1,476 B (w = 369 fp32) are neither.
//
// Update design: the flat [count, w] element space of the live lanes. The
// caller (the device dedup, ops/scatter.py) hands over per-segment arrays
// of B lanes of which only the first u are live, with u on the device: the
// optional `count` (one int32) is read once by each thread, after its
// first sweep's id loads are in flight, and nothing past count * w is
// touched; a null `valid` makes every lane valid. A persistent grid
// (kUpdBlocksPerSm blocks per SM) strides over that space; each thread
// takes kUpdElems elements per sweep, strided by the block so a warp's
// accesses are contiguous, loads every element's id (and valid flag),
// then every table and delta element, then stores. Each element finds its
// lane by the multiply-shift divider of the gather (64-bit division past
// 2^31 elements), and reads delta at its flat index. What held the first
// design (a warp per lane, 8 lanes per block, ceil(B / 8) blocks, its
// threads striding the row) back: at config 3 it launched 16,384 blocks
// for ~12,000 valid lanes, every warp made three dependent loads (valid,
// id, then the row) before any work, and at w = 65 each thread ran the
// remainder of its #pragma unroll 4, one load in flight. The TPU kernels'
// 256 async row DMAs per grid program, their 128-lane width rule, the
// B % 256 rule and the scalar-prefetch id cap are not carried over: any
// width and any batch are taken.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

namespace {

template <bool BF16>
struct Ty;

template <>
struct Ty<false> {
    using S = float;
    __device__ static float widen(S v) { return v; }
    __device__ static S narrow(float v) { return v; }
};

template <>
struct Ty<true> {
    using S = unsigned short;  // bf16 bits
    __device__ static float widen(S v) {
        return __bfloat162float(__ushort_as_bfloat16(v));
    }
    __device__ static S narrow(float v) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
};

constexpr int kGatherThreads = 256;
constexpr int kChunks = 2;                 // 16-byte chunks per thread

// q = x / d for 0 <= x < 2^31 by the wrapper's divider (magic, shift) of
// d, or by a 64-bit division past that (WIDE).
template <bool WIDE>
__device__ __forceinline__ long long div_by(long long x, long long d,
                                            unsigned magic, int shift) {
    if constexpr (WIDE) {
        return x / d;
    } else {
        return static_cast<long long>(
            (static_cast<unsigned long long>(x) * magic) >> shift);
    }
}

__device__ __forceinline__ long long clamp_id(const int* ids, long long m,
                                              long long n) {
    const long long id = __ldg(ids + m);
    return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__device__ __forceinline__ uint4 pack(const uint32_t (&v)[4]) {
    return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint4 pack(const uint16_t (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        w[i] = static_cast<uint32_t>(v[2 * i])
            | (static_cast<uint32_t>(v[2 * i + 1]) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// E: an unsigned integer type of the element's size (the gather copies
// bits); V elements make a 16-byte chunk. `total` = B * w elements; the
// last chunk may be partial and is stored element by element. (magic,
// shift) divide by the width.
template <typename E, bool WIDE>
__global__ void __launch_bounds__(kGatherThreads)
    gather_elems(const E* __restrict__ table, long long n, int width,
                 const int* __restrict__ ids, int batch, long long total,
                 unsigned magic, int shift, E* __restrict__ out) {
    constexpr int V = 16 / sizeof(E);
    const long long chunks = (total + V - 1) / V;
    const long long first = static_cast<long long>(blockIdx.x)
        * (kGatherThreads * kChunks) + threadIdx.x;
    E v[kChunks][V];
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
        const long long c = first + static_cast<long long>(k) * kGatherThreads;
        if (c >= chunks) break;
        long long m = div_by<WIDE>(c * V, width, magic, shift);
        int col = static_cast<int>(c * V - m * width);
        const E* src = table + clamp_id(ids, m, n) * width;
#pragma unroll
        for (int i = 0; i < V; ++i) {
            if (col == width) {            // the chunk runs into the next row
                col = 0;
                ++m;
                src = table + clamp_id(ids, m < batch ? m : batch - 1, n)
                    * width;
            }
            v[k][i] = __ldg(src + col);
            ++col;
        }
    }
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
        const long long c = first + static_cast<long long>(k) * kGatherThreads;
        if (c >= chunks) break;
        if ((c + 1) * V <= total) {
            reinterpret_cast<uint4*>(out)[c] = pack(v[k]);
        } else {
#pragma unroll
            for (int i = 0; i < V; ++i) {
                if (c * V + i < total) out[c * V + i] = v[k][i];
            }
        }
    }
}

inline unsigned gather_blocks(long long chunks) {
    constexpr long long per_block = kGatherThreads * kChunks;
    return static_cast<unsigned>((chunks + per_block - 1) / per_block);
}

template <typename E>
cudaError_t launch_gather(const void* table, long long n, int width,
                          const int* ids, int batch, unsigned magic,
                          int shift, void* out, cudaStream_t s) {
    constexpr int V = 16 / sizeof(E);
    const long long total = static_cast<long long>(batch) * width;
    const long long chunks = (total + V - 1) / V;
    const auto* t = static_cast<const E*>(table);
    auto* o = static_cast<E*>(out);
    if (chunks * V < (1LL << 31)) {
        gather_elems<E, false><<<gather_blocks(chunks), kGatherThreads, 0, s>>>(
            t, n, width, ids, batch, total, magic, shift, o);
    } else {
        gather_elems<E, true><<<gather_blocks(chunks), kGatherThreads, 0, s>>>(
            t, n, width, ids, batch, total, magic, shift, o);
    }
    return cudaGetLastError();
}

constexpr int kUpdThreads = 256;
constexpr int kUpdElems = 2;               // elements per thread per sweep
constexpr int kUpdBlocksPerSm = 8;

template <bool TBF16, bool DBF16, bool WIDE>
__global__ void __launch_bounds__(kUpdThreads)
    update_elems(typename Ty<TBF16>::S* __restrict__ table, long long n,
                 int width, const int* __restrict__ ids,
                 const int* __restrict__ valid,
                 const typename Ty<DBF16>::S* __restrict__ delta, int batch,
                 const int* __restrict__ count, unsigned magic, int shift) {
    const long long stride =
        static_cast<long long>(gridDim.x) * kUpdThreads * kUpdElems;
    long long total = static_cast<long long>(batch) * width;
    bool counted = count == nullptr;
    for (long long base = static_cast<long long>(blockIdx.x)
             * kUpdThreads * kUpdElems + threadIdx.x;
         base < total; base += stride) {
        long long e[kUpdElems], id[kUpdElems];
        bool ok[kUpdElems];
#pragma unroll
        for (int k = 0; k < kUpdElems; ++k) {
            e[k] = base + static_cast<long long>(k) * kUpdThreads;
            ok[k] = e[k] < total;
            if (ok[k]) {
                const long long m = div_by<WIDE>(e[k], width, magic, shift);
                id[k] = __ldg(ids + m) * static_cast<long long>(width)
                    + (e[k] - m * width);
                ok[k] = (valid == nullptr || __ldg(valid + m) != 0)
                    && id[k] >= 0 && id[k] < n * width;
            }
        }
        if (!counted) {
            // Read once, after the first sweep's id loads are in flight.
            total = static_cast<long long>(max(0, min(__ldg(count), batch)))
                * width;
            counted = true;
        }
        float t[kUpdElems], d[kUpdElems];
#pragma unroll
        for (int k = 0; k < kUpdElems; ++k) {
            ok[k] = ok[k] && e[k] < total;
            if (ok[k]) {
                t[k] = Ty<TBF16>::widen(table[id[k]]);
                d[k] = Ty<DBF16>::widen(__ldg(delta + e[k]));
            }
        }
#pragma unroll
        for (int k = 0; k < kUpdElems; ++k) {
            if (ok[k]) table[id[k]] = Ty<TBF16>::narrow(__fadd_rn(t[k], d[k]));
        }
    }
}

template <bool TBF16, bool DBF16>
cudaError_t launch_update(void* table, long long n, int width, const int* ids,
                          const int* valid, const void* delta, int batch,
                          const int* count, unsigned magic, int shift,
                          int sms, cudaStream_t stream) {
    constexpr long long per_block = kUpdThreads * kUpdElems;
    const long long total = static_cast<long long>(batch) * width;
    const long long blocks = std::min<long long>(
        (total + per_block - 1) / per_block,
        static_cast<long long>(sms) * kUpdBlocksPerSm);
    auto* t = static_cast<typename Ty<TBF16>::S*>(table);
    const auto* d = static_cast<const typename Ty<DBF16>::S*>(delta);
    if (total < (1LL << 31)) {
        update_elems<TBF16, DBF16, false>
            <<<static_cast<unsigned>(blocks), kUpdThreads, 0, stream>>>(
                t, n, width, ids, valid, d, batch, count, magic, shift);
    } else {
        update_elems<TBF16, DBF16, true>
            <<<static_cast<unsigned>(blocks), kUpdThreads, 0, stream>>>(
                t, n, width, ids, valid, d, batch, count, magic, shift);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [n, width] row-major of `elem` (2 or 4) bytes per element, ids
// [batch] int32, out [batch, width] of the table's type; all contiguous,
// out 16-byte aligned. (magic, shift) divide by the width:
// x / width = (x * magic) >> shift for 0 <= x < 2^31. Launches on `stream`
// of `device`; returns cudaGetLastError() (0 on success). Does not
// synchronise. batch = 0 launches nothing.
int rows_gather(const void* table, long long n, int width, int elem,
                const int* ids, int batch, void* out, unsigned magic,
                int shift, void* stream, int device) {
    if (n < 1 || width < 1 || batch < 0 || (elem != 2 && elem != 4)
        || (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (batch == 0) return 0;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = elem == 4
        ? launch_gather<uint32_t>(table, n, width, ids, batch, magic, shift,
                                  out, s)
        : launch_gather<uint16_t>(table, n, width, ids, batch, magic, shift,
                                  out, s);
    return static_cast<int>(err);
}

// In place: table [n, width] (bf16 if table_bf16, else fp32), ids and valid
// [batch] int32, delta [batch, width] (bf16 if delta_bf16, else fp32); all
// contiguous. Ids must be unique among the lanes with valid != 0 (every
// lane, when valid is null). count: null, or one int32 on the device;
// lanes at or past it are skipped unread. (magic, shift) divide by the width as for rows_gather. Launches
// on `stream` of `device`; returns cudaGetLastError(). Does not
// synchronise. batch = 0 launches nothing.
int rows_update_add(void* table, long long n, int width, int table_bf16,
                    const int* ids, const int* valid, const void* delta,
                    int delta_bf16, int batch, const int* count,
                    unsigned magic, int shift, void* stream, int device) {
    if (n < 1 || width < 1 || batch < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (batch == 0) return 0;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto launch = table_bf16
        ? (delta_bf16 ? launch_update<true, true> : launch_update<true, false>)
        : (delta_bf16 ? launch_update<false, true>
                      : launch_update<false, false>);
    return static_cast<int>(launch(table, n, width, ids, valid, delta, batch,
                                   count, magic, shift, sms, s));
}

const char* rows_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
