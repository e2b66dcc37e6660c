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
// . * tch, g + .); neg_lr * g is fp32. With fp32 compute nothing is
// rounded. The _rn intrinsics keep the compiler from contracting a
// multiply and an add into one fma, so each step rounds as the plain
// PyTorch composition does.
//
// Bound: memory. Per field it reads B * (k+1) * cd_bytes of s1 rows (the
// same rows for every field, so L2 serves most of them), ~16 B per lane of
// scalars and indices, and cap * w * storage bytes of urows (1.6 MB at
// cap 12288 in bf16: L2-resident), and writes cap * w * 4. At B = 131072,
// k = 64, bf16 that is ~24 MB per field, ~0.93 GB per step of 39 fields:
// 0.28 ms at 3.35 TB/s.
//
// Design: the tile-and-carry skeleton of segment_scan.cuh (shared with
// kernel A) with a producer that computes each lane's row. The TPU version
// reorders s1, dscores, vals, touched and inv into sorted order in memory
// for every field before the kernel; here a tile stages its lanes' order
// index, segment and scalars in shared memory and reads the unsorted s1
// row and the segment's urows row directly, so no reordered copy exists.
// One launch covers all fields (grid: tiles x fields); the carry passes
// follow in two more launches at B = 131072.

#include <cuda_bf16.h>

#include <type_traits>

#include "segment_scan.cuh"

#define FM_BWD_MAX_FIELDS 64

namespace {

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

// Round to the compute dtype.
template <bool CD_BF16>
__device__ __forceinline__ float rc(float v) {
    if constexpr (CD_BF16) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

// St: urows storage (float | __nv_bfloat16); CD_BF16: the compute dtype of
// s1, ds and every elementwise step.
template <typename St, bool CD_BF16>
struct BwdProducer {
    using Cd = typename std::conditional<CD_BF16, __nv_bfloat16, float>::type;
    struct Lane {
        int o, seg;
        float ds, x, tch;
    };
    UrowsPtrs urows;           // F x [cap, width]
    const int* order;          // [F, n]
    const int* inv;            // [F, n]
    const void* s1;            // [n, width] compute dtype
    const void* ds;            // [n] compute dtype
    const float* vals;         // [n, F]
    const float* weights;      // [n]
    int n, fields, width, cap, k, use_rv;
    float neg_lr, rv_factors, rv_linear;

    __device__ int load(int f, int t, Lane& l) const {
        const int o = order[static_cast<size_t>(f) * n + t];
        l.o = o;
        l.seg = inv[static_cast<size_t>(f) * n + o];
        l.ds = widen<Cd>(ds, o);
        l.x = rc<CD_BF16>(vals[static_cast<size_t>(o) * fields + f]);
        l.tch = weights[o] > 0.f ? 1.f : 0.f;
        return l.seg;
    }

    __device__ float value(int f, const Lane& l, int, int col) const {
        const float u = segscan::live(l.seg, cap)
            ? widen<St>(urows.t[f], static_cast<size_t>(l.seg) * width + col)
            : 0.f;
        const float r = rc<CD_BF16>(u);
        const float s1v = widen<Cd>(s1, static_cast<size_t>(l.o) * width + col);
        const float xv = rc<CD_BF16>(__fmul_rn(r, l.x));
        const float t1 = rc<CD_BF16>(__fsub_rn(s1v, col < k ? xv : 0.f));
        const float base = rc<CD_BF16>(__fmul_rn(l.ds, t1));
        float g = rc<CD_BF16>(__fmul_rn(base, l.x));
        if (use_rv) {
            const float rv = col < k ? rv_factors : rv_linear;
            const float reg = rc<CD_BF16>(
                __fmul_rn(rc<CD_BF16>(__fmul_rn(rv, r)), l.tch));
            g = rc<CD_BF16>(__fadd_rn(g, reg));
        }
        return __fmul_rn(neg_lr, g);
    }
};

template <typename St, bool CD_BF16>
cudaError_t launch(const UrowsPtrs& urows, int fields, int cap, int width,
                   const int* order, const int* inv, const void* s1,
                   const void* ds, const float* vals, const float* weights,
                   int batch, float neg_lr, int use_rv, float rv_factors,
                   float rv_linear, float* out, int* scratch_seg,
                   float* scratch_val, cudaStream_t stream) {
    const BwdProducer<St, CD_BF16> p{
        urows, order, inv, s1, ds, vals, weights, batch, fields, width, cap,
        width - 1, use_rv, neg_lr, rv_factors, rv_linear};
    return segscan::run(p, fields, batch, width, cap, out, scratch_seg,
                        scratch_val, stream);
}

}  // namespace

extern "C" {

// urows_ptrs: a HOST array of `fields` device pointers, each to a
// contiguous [cap, width] table of unique rows (bf16 if store_bf16, else
// fp32). s1 [batch, width] and ds [batch] are in the compute dtype (bf16
// if cd_bf16, else fp32); order / inv [fields, batch] int32; vals
// [batch, fields] and weights [batch] fp32. rv_factors / rv_linear are
// already rounded to the compute dtype. out: [fields, cap, width] fp32
// (zeroed here). scratch: at least fm_bwd_scratch_rows(batch) rows per
// field. Launches on `stream` of `device`, returns cudaGetLastError();
// does not synchronise.
int fm_fused_bwd(const void* const* urows_ptrs, int fields, int cap,
                 int width, int store_bf16, int cd_bf16, const int* order,
                 const int* inv, const void* s1, const void* ds,
                 const float* vals, const float* weights, int batch,
                 float neg_lr, int use_rv, float rv_factors, float rv_linear,
                 float* out, int* scratch_seg, float* scratch_val,
                 long long scratch_rows, void* stream, int device) {
    if (fields < 1 || fields > FM_BWD_MAX_FIELDS || cap < 1 || width < 2 ||
        width > SEG_MAX_WIDTH || batch < 1 ||
        scratch_rows < segscan::scratch_rows(batch) * fields) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    UrowsPtrs u;
    for (int f = 0; f < FM_BWD_MAX_FIELDS; ++f) {
        u.t[f] = f < fields ? urows_ptrs[f] : nullptr;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FM_BWD_ARGS u, fields, cap, width, order, inv, s1, ds, vals, weights, \
    batch, neg_lr, use_rv, rv_factors, rv_linear, out, scratch_seg,           \
    scratch_val, s
    cudaError_t err;
    if (store_bf16) {
        err = cd_bf16 ? launch<__nv_bfloat16, true>(FM_BWD_ARGS)
                      : launch<__nv_bfloat16, false>(FM_BWD_ARGS);
    } else {
        err = cd_bf16 ? launch<float, true>(FM_BWD_ARGS)
                      : launch<float, false>(FM_BWD_ARGS);
    }
#undef FM_BWD_ARGS
    return static_cast<int>(err);
}

long long fm_bwd_scratch_rows(int batch) {
    return segscan::scratch_rows(batch);
}

const char* fm_bwd_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
