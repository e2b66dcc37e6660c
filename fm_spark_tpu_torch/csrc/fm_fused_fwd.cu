// Fused gather -> FM-interaction forward for Hopper (sm_90a).
//
// Replaces the TPU kernel fm_spark_tpu/ops/pallas_fused.py::fm_fused_scores
// (_fwd_kernel / _fwd_field): per sample row b over F field tables
// [bucket, w] (w = k + 1, column k is the fused linear weight),
//
//   acc[b, j] = sum_f x_f * row_f[j]                 (j < w)
//   ssq[b]    = sum_f sum_{j<k} (x_f * row_f[j])^2
//   scores[b] = 0.5 * (sum_{j<k} acc[b, j]^2 - ssq[b])
//               + use_linear * acc[b, k] + (*w0 if w0 != NULL)
//
// with row_f = table_f[clamp(ids[b, f], 0, bucket - 1)], tables stored in
// fp32 or bf16 and every sum taken in fp32.
//
// Bound: memory. Per sample the kernel reads F random rows of w elements
// plus F ids and values, and writes w + 1 floats; it does ~4 flops per
// byte read, far below the card's ~20 fp32 flops per byte. The TPU version
// chains one call per field through an accumulator in device memory; here
// the loop over fields runs inside the kernel, so the accumulator lives in
// registers and only the final acc row and score are written.
//
// Design: one warp per sample row, FM_WARPS_PER_BLOCK rows per block. Lane
// j holds columns j, j + 32, j + 64, ... (NC = ceil(w / 32) of them) in
// fp32 registers; lane f holds field f's id and value (two slots, so up to
// 64 fields) and broadcasts them by shuffle. FM_FIELD_UNROLL fields' row
// loads are issued before any is used, to keep enough random row reads in
// flight. Each lane reads single elements: neighbouring lanes read
// neighbouring columns (one coalesced transaction per 32 columns) and no
// vector load ever straddles the odd 65th column, whose rows are only 4 B
// (fp32) or 2 B (bf16) aligned. Warp shuffles reduce sum s^2, ssq and the
// linear column.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#define FM_MAX_FIELDS 64
#define FM_MAX_COLS_PER_LANE 4
#define FM_WARPS_PER_BLOCK 8
#define FM_FIELD_UNROLL 8

namespace {

// Table base pointers, passed by value in the kernel's parameter space so
// no device array of pointers has to be allocated or copied per call.
struct TablePtrs {
    const void* t[FM_MAX_FIELDS];
};

// Storage formats. A row element is loaded as its raw bits and widened to
// fp32 only in the compute phase: widening right after each load makes
// the compiler wait for that load before issuing the next one, which
// serialises the row reads (on an H100, bf16 ran 3x slower at B <= 512).
template <typename T>
struct Storage;

template <>
struct Storage<float> {
    using Raw = float;
    static __device__ __forceinline__ Raw load(const float* p) { return __ldg(p); }
    static __device__ __forceinline__ float widen(Raw r) { return r; }
};

template <>
struct Storage<__nv_bfloat16> {
    using Raw = unsigned short;
    static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
        return __ldg(reinterpret_cast<const unsigned short*>(p));
    }
    static __device__ __forceinline__ float widen(Raw r) {
        return __bfloat162float(__ushort_as_bfloat16(r));
    }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(FM_WARPS_PER_BLOCK * 32)
fm_fused_fwd_kernel(TablePtrs tables, int num_fields, int bucket, int width,
                    const int* __restrict__ ids,
                    const float* __restrict__ vals, int batch,
                    const float* __restrict__ w0, int use_linear,
                    float* __restrict__ scores, float* __restrict__ acc) {
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * FM_WARPS_PER_BLOCK + (threadIdx.x >> 5);
    // `row` is the same for all 32 lanes of a warp, so a warp leaves
    // whole and the full-mask shuffles below stay legal.
    if (row >= batch) return;
    const int k = width - 1;

    const int* row_ids = ids + static_cast<size_t>(row) * num_fields;
    const float* row_vals = vals + static_cast<size_t>(row) * num_fields;
    int id_lo = 0, id_hi = 0;
    float x_lo = 0.f, x_hi = 0.f;
    if (lane < num_fields) {
        id_lo = min(max(row_ids[lane], 0), bucket - 1);
        x_lo = row_vals[lane];
    }
    if (lane + 32 < num_fields) {
        id_hi = min(max(row_ids[lane + 32], 0), bucket - 1);
        x_hi = row_vals[lane + 32];
    }

    float s[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = 0.f;
    float ssq = 0.f;

    using S = Storage<T>;
    for (int f0 = 0; f0 < num_fields; f0 += FM_FIELD_UNROLL) {
        typename S::Raw v[FM_FIELD_UNROLL][NC];
        float x[FM_FIELD_UNROLL];
#pragma unroll
        for (int u = 0; u < FM_FIELD_UNROLL; ++u) {
            const int f = f0 + u;
            const bool live = f < num_fields;
            // f is warp-uniform, so every lane takes the same slot.
            const int id = __shfl_sync(0xffffffffu, f < 32 ? id_lo : id_hi, f & 31);
            const float xf = __shfl_sync(0xffffffffu, f < 32 ? x_lo : x_hi, f & 31);
            x[u] = live ? xf : 0.f;
            const T* rowp = live
                ? static_cast<const T*>(tables.t[f]) + static_cast<size_t>(id) * width
                : nullptr;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const int col = lane + 32 * c;
                v[u][c] = (live && col < width) ? S::load(rowp + col)
                                                : typename S::Raw(0);
            }
        }
#pragma unroll
        for (int u = 0; u < FM_FIELD_UNROLL; ++u) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float xv = x[u] * S::widen(v[u][c]);
                s[c] += xv;
                if (lane + 32 * c < k) ssq += xv * xv;
            }
        }
    }

    float ss = 0.f, lin = 0.f;
    float* acc_row = acc + static_cast<size_t>(row) * width;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < k) {
            ss += s[c] * s[c];
        } else if (col == k) {
            lin = s[c];
        }
        if (col < width) acc_row[col] = s[c];
    }
    ss = warp_sum(ss);
    ssq = warp_sum(ssq);
    lin = warp_sum(lin);
    if (lane == 0) {
        float score = 0.5f * (ss - ssq);
        if (use_linear) score += lin;
        if (w0 != nullptr) score += *w0;
        scores[row] = score;
    }
}

template <typename T>
void launch(const TablePtrs& t, int num_fields, int bucket, int width,
            const int* ids, const float* vals, int batch, const float* w0,
            int use_linear, float* scores, float* acc, cudaStream_t stream) {
    const dim3 block(FM_WARPS_PER_BLOCK * 32);
    const dim3 grid((batch + FM_WARPS_PER_BLOCK - 1) / FM_WARPS_PER_BLOCK);
    switch ((width + 31) / 32) {
        case 1:
            fm_fused_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
                t, num_fields, bucket, width, ids, vals, batch, w0, use_linear, scores, acc);
            break;
        case 2:
            fm_fused_fwd_kernel<T, 2><<<grid, block, 0, stream>>>(
                t, num_fields, bucket, width, ids, vals, batch, w0, use_linear, scores, acc);
            break;
        case 3:
            fm_fused_fwd_kernel<T, 3><<<grid, block, 0, stream>>>(
                t, num_fields, bucket, width, ids, vals, batch, w0, use_linear, scores, acc);
            break;
        default:
            fm_fused_fwd_kernel<T, 4><<<grid, block, 0, stream>>>(
                t, num_fields, bucket, width, ids, vals, batch, w0, use_linear, scores, acc);
            break;
    }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of device `device` and returns
// cudaGetLastError() (0 on success). `table_ptrs` is a HOST array of
// `num_fields` device pointers, each to a contiguous [bucket, width]
// table; `is_bf16` selects bf16 storage (else fp32). `w0` may be NULL.
// Does not synchronise. The library links its own CUDA runtime, so the
// device is set here rather than inherited from the caller's runtime.
int fm_fused_fwd(const void* const* table_ptrs, int num_fields, int bucket,
                 int width, int is_bf16, const int* ids, const float* vals,
                 int batch, const float* w0, int use_linear, float* scores,
                 float* acc, void* stream, int device) {
    if (num_fields < 1 || num_fields > FM_MAX_FIELDS || bucket < 1 ||
        width < 2 || width > 32 * FM_MAX_COLS_PER_LANE || batch < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    TablePtrs t;
    for (int f = 0; f < FM_MAX_FIELDS; ++f) {
        t.t[f] = f < num_fields ? table_ptrs[f] : nullptr;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        launch<__nv_bfloat16>(t, num_fields, bucket, width, ids, vals, batch,
                              w0, use_linear, scores, acc, s);
    } else {
        launch<float>(t, num_fields, bucket, width, ids, vals, batch, w0,
                      use_linear, scores, acc, s);
    }
    return static_cast<int>(cudaGetLastError());
}

const char* fm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
