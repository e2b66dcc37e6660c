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
// delta: v * w * (2 e + e_delta) + 8 B bytes for v valid lanes. At config 3
// (w = 65 fp32, B = 131,072 Zipf ids, ~12,000 distinct per field) a gather
// moves ~37 MB (11 us at 3.35 TB/s) and an update ~9 MB.
//
// Design: one warp per lane, 8 lanes per block. The warp's threads stride
// the row's elements, so every row read and write is one coalesced sweep.
// Rows of 260 B (w = 65 fp32) or 130 B (bf16) are only element-aligned, so
// the copies are element by element, not 16-byte vectors. The TPU kernels'
// 256 async row DMAs per grid program, their 128-lane width rule, the
// B % 256 rule and the scalar-prefetch id cap are not carried over: the
// grid is the batch, any width is taken, and many warps in flight on each SM
// give the depth of outstanding row reads that the DMA queue gave.

#include <cuda_bf16.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// E: an unsigned integer type of the element's size; the gather copies bits.
template <typename E>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const E* __restrict__ table, long long n, int width,
                  const int* __restrict__ ids, int batch, E* __restrict__ out) {
    const long long m =
        static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (m >= batch) return;
    const int lane = threadIdx.x & 31;
    long long id = ids[m];
    id = id < 0 ? 0 : (id >= n ? n - 1 : id);
    const E* src = table + id * width;
    E* dst = out + m * width;
#pragma unroll 4
    for (int c = lane; c < width; c += 32) dst[c] = src[c];
}

template <bool TBF16, bool DBF16>
__global__ void __launch_bounds__(kThreads)
    update_kernel(typename Ty<TBF16>::S* __restrict__ table, long long n,
                  int width, const int* __restrict__ ids,
                  const int* __restrict__ valid,
                  const typename Ty<DBF16>::S* __restrict__ delta, int batch) {
    const long long m =
        static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (m >= batch || valid[m] == 0) return;
    const long long id = ids[m];
    if (id < 0 || id >= n) return;
    const int lane = threadIdx.x & 31;
    typename Ty<TBF16>::S* row = table + id * width;
    const typename Ty<DBF16>::S* d = delta + m * width;
#pragma unroll 4
    for (int c = lane; c < width; c += 32) {
        row[c] = Ty<TBF16>::narrow(
            __fadd_rn(Ty<TBF16>::widen(row[c]), Ty<DBF16>::widen(d[c])));
    }
}

inline unsigned blocks_for(int batch) {
    return static_cast<unsigned>((batch + kWarps - 1) / kWarps);
}

template <bool TBF16, bool DBF16>
cudaError_t launch_update(void* table, long long n, int width, const int* ids,
                          const int* valid, const void* delta, int batch,
                          cudaStream_t stream) {
    update_kernel<TBF16, DBF16><<<blocks_for(batch), kThreads, 0, stream>>>(
        static_cast<typename Ty<TBF16>::S*>(table), n, width, ids, valid,
        static_cast<const typename Ty<DBF16>::S*>(delta), batch);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [n, width] row-major of `elem` (2 or 4) bytes per element, ids
// [batch] int32, out [batch, width] of the table's type; all contiguous.
// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success). Does not synchronise. batch = 0 launches nothing.
int rows_gather(const void* table, long long n, int width, int elem,
                const int* ids, int batch, void* out, void* stream,
                int device) {
    if (n < 1 || width < 1 || batch < 0 || (elem != 2 && elem != 4)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (batch == 0) return 0;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (elem == 4) {
        gather_kernel<uint32_t><<<blocks_for(batch), kThreads, 0, s>>>(
            static_cast<const uint32_t*>(table), n, width, ids, batch,
            static_cast<uint32_t*>(out));
    } else {
        gather_kernel<uint16_t><<<blocks_for(batch), kThreads, 0, s>>>(
            static_cast<const uint16_t*>(table), n, width, ids, batch,
            static_cast<uint16_t*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

// In place: table [n, width] (bf16 if table_bf16, else fp32), ids and valid
// [batch] int32, delta [batch, width] (bf16 if delta_bf16, else fp32); all
// contiguous. Ids must be unique among the lanes with valid != 0. Launches
// on `stream` of `device`; returns cudaGetLastError(). Does not
// synchronise. batch = 0 launches nothing.
int rows_update_add(void* table, long long n, int width, int table_bf16,
                    const int* ids, const int* valid, const void* delta,
                    int delta_bf16, int batch, void* stream, int device) {
    if (n < 1 || width < 1 || batch < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (batch == 0) return 0;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (table_bf16) {
        err = delta_bf16 ? launch_update<true, true>(table, n, width, ids,
                                                     valid, delta, batch, s)
                         : launch_update<true, false>(table, n, width, ids,
                                                      valid, delta, batch, s);
    } else {
        err = delta_bf16 ? launch_update<false, true>(table, n, width, ids,
                                                      valid, delta, batch, s)
                         : launch_update<false, false>(table, n, width, ids,
                                                       valid, delta, batch, s);
    }
    return static_cast<int>(err);
}

const char* rows_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
