// Sel-blocked FFM interaction for Hopper (sm_90a): forward and backward.
//
// Replaces the TPU kernels fm_spark_tpu/ops/pallas_fused.py::ffm_sel_scores
// (_ffm_fwd_kernel) and ::ffm_sel_bwd (_ffm_bwd_kernel). One row b of
// rows_stacked [B, F, F*k] is R [F, F, k]: R[i, j] is the factor vector that
// owner field i's feature uses toward field j. With x = vals[b]:
//
//   forward:  acc[b] = sum_i ( sum_j prod[i, j] - prod[i, i] ),
//             prod[i, j] = sum_kk (R[i, j, kk] x_i) (R[j, i, kk] x_j)
//   backward: dvs[b, i, j*k + kk] = [i != j] (ds[b] (R[j, i, kk] x_j)) x_i
//
// The scores are acc / 2; the caller applies the half.
//
// Roundings (compute dtype T = the rows' dtype, fp32 or bf16): every
// elementwise product is rounded to T where _ffm_fwd_kernel and
// _ffm_bwd_kernel round it (sel, selT and their product; ds * selT, then
// * x_i); the sums over kk and over j accumulate in fp32 in index order and
// round to T once, as jnp.sum on bf16 does; acc's two updates per owner
// field each round to T. The plain versions in ops/ffm_sel.py sum in the
// same order, so kernel and plain give the same bits. The _rn intrinsics
// keep the compiler from contracting a multiply and an add into one fma.
//
// Bound: memory. Each kernel reads the F^2 k values of every row once
// (33,856 B in fp32, 16,928 B in bf16 at F = 23, k = 16) and the backward
// writes as many; the forward's 2 F^2 k operations per row are far below
// what the card does in the time those bytes take.
//
// Design: one block per row. The block stages the row's slab in shared
// memory with coalesced 16-byte loads, each k-vector at a stride of an odd
// number of 16-byte units, so the 16-byte shared reads of a quarter-warp
// fall in distinct banks both along R[i, j] and along its transpose
// R[j, i]. Forward: a thread per (i, j) pair dots the two k-vectors; the
// per-owner sums and acc follow from a [F, F] table in shared memory. The
// TPU kernel's [128, F, F*k] tile and its unrolled owner loop are not
// carried over. Backward: a thread per 16-byte chunk of the output reads
// the transposed chunk from shared memory and writes its chunk coalesced.
// A shape whose k-vectors are not whole 16-byte chunks, or an unaligned
// pointer, takes the same path element by element. No padding to a tile:
// the grid is the batch.

#include <cuda_bf16.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnit = 16;                    // bytes of one vector access
constexpr size_t kMaxSmem = 232448;          // shared memory a block can use
constexpr size_t kDefaultSmem = 48 * 1024;   // above this: opt in per kernel

template <bool BF16>
struct Ty;

template <>
struct Ty<false> {
    using S = float;
    __device__ static float widen(S v) { return v; }
    __device__ static float round(float v) { return v; }
    __device__ static S narrow(float v) { return v; }
};

template <>
struct Ty<true> {
    using S = unsigned short;  // bf16 bits
    __device__ static float widen(S v) {
        return __bfloat162float(__ushort_as_bfloat16(v));
    }
    __device__ static float round(float v) {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
    __device__ static S narrow(float v) {
        return __bfloat16_as_ushort(__float2bfloat16_rn(v));
    }
};

template <typename S>
union Vec {
    uint4 u;
    S e[kUnit / sizeof(S)];
};

// Elements between two staged k-vectors: an odd number of 16-byte units.
__host__ __device__ inline int kvec_stride(int rank, int elem) {
    int units = (rank * elem + kUnit - 1) / kUnit;
    if (units % 2 == 0) ++units;
    return units * kUnit / elem;
}

inline size_t slab_bytes(int fields, int rank, int elem) {
    return static_cast<size_t>(fields) * fields * kvec_stride(rank, elem) *
           elem;
}

// Forward: slab, x [F], prod [F, F], per-owner sums [F] (fp32).
inline size_t fwd_smem(int fields, int rank, int elem) {
    return slab_bytes(fields, rank, elem) +
           sizeof(float) * (2 * static_cast<size_t>(fields) +
                            static_cast<size_t>(fields) * fields);
}

// Backward: slab, x [F] and ds (fp32).
inline size_t bwd_smem(int fields, int rank, int elem) {
    return slab_bytes(fields, rank, elem) + sizeof(float) * (fields + 1);
}

// Copy one row's [F*F, k] slab into shared memory at `stride` elements per
// k-vector.
template <typename S>
__device__ __forceinline__ void stage(S* slab, const S* __restrict__ row,
                                      int n, int rank, int stride, bool vec) {
    constexpr int V = kUnit / sizeof(S);
    if (vec) {
        const uint4* src = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
        for (int v = threadIdx.x; v < n / V; v += blockDim.x) {
            const int e = v * V;
            const int kv = e / rank;
            *reinterpret_cast<uint4*>(slab + kv * stride + (e - kv * rank)) =
                __ldg(src + v);
        }
    } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
            const int kv = e / rank;
            slab[kv * stride + (e - kv * rank)] = row[e];
        }
    }
}

// One kk term of prod[i, j], added to the running fp32 sum s.
template <bool BF16>
__device__ __forceinline__ float pair_term(float s, typename Ty<BF16>::S a,
                                           typename Ty<BF16>::S t, float xi,
                                           float xj, bool first) {
    using T = Ty<BF16>;
    const float sel = T::round(__fmul_rn(T::widen(a), xi));
    const float selt = T::round(__fmul_rn(T::widen(t), xj));
    const float pr = T::round(__fmul_rn(sel, selt));
    return first ? pr : __fadd_rn(s, pr);
}

// One element of dvs from R[j, i, kk].
template <bool BF16>
__device__ __forceinline__ typename Ty<BF16>::S dvs_term(
    typename Ty<BF16>::S r, float xi, float xj, float ds, bool diag) {
    using T = Ty<BF16>;
    const float selt = T::round(__fmul_rn(T::widen(r), xj));
    const float dsel = diag ? 0.f : T::round(__fmul_rn(ds, selt));
    return T::narrow(__fmul_rn(dsel, xi));
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    ffm_fwd_kernel(const typename Ty<BF16>::S* __restrict__ rows,
                   const typename Ty<BF16>::S* __restrict__ vals,
                   typename Ty<BF16>::S* __restrict__ out, int fields,
                   int rank, int stride, int vec) {
    using T = Ty<BF16>;
    using S = typename T::S;
    constexpr int V = kUnit / sizeof(S);
    extern __shared__ __align__(16) unsigned char smem[];
    const int F = fields, FF = fields * fields;
    S* slab = reinterpret_cast<S*>(smem);
    float* xs = reinterpret_cast<float*>(
        smem + static_cast<size_t>(FF) * stride * sizeof(S));
    float* prod = xs + F;
    float* rsum = prod + FF;
    const size_t b = blockIdx.x;

    stage(slab, rows + b * FF * rank, FF * rank, rank, stride, vec);
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        xs[f] = T::widen(vals[b * F + f]);
    }
    __syncthreads();

    for (int p = threadIdx.x; p < FF; p += blockDim.x) {
        const int i = p / F, j = p - i * F;
        const S* a = slab + static_cast<size_t>(p) * stride;            // R[i, j]
        const S* t = slab + static_cast<size_t>(j * F + i) * stride;    // R[j, i]
        const float xi = xs[i], xj = xs[j];
        float s = 0.f;
        if (vec) {
            for (int c = 0; c < rank; c += V) {
                Vec<S> va, vt;
                va.u = *reinterpret_cast<const uint4*>(a + c);
                vt.u = *reinterpret_cast<const uint4*>(t + c);
#pragma unroll
                for (int q = 0; q < V; ++q) {
                    s = pair_term<BF16>(s, va.e[q], vt.e[q], xi, xj,
                                        c + q == 0);
                }
            }
        } else {
            for (int c = 0; c < rank; ++c) {
                s = pair_term<BF16>(s, a[c], t[c], xi, xj, c == 0);
            }
        }
        prod[p] = T::round(s);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < F; i += blockDim.x) {
        float s = prod[i * F];
        for (int j = 1; j < F; ++j) s = __fadd_rn(s, prod[i * F + j]);
        rsum[i] = T::round(s);
    }
    __syncthreads();

    if (threadIdx.x == 0) {
        float acc = 0.f;
        for (int i = 0; i < F; ++i) {
            acc = T::round(__fadd_rn(acc, rsum[i]));
            acc = T::round(__fsub_rn(acc, prod[i * F + i]));
        }
        out[b] = T::narrow(acc);
    }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    ffm_bwd_kernel(const typename Ty<BF16>::S* __restrict__ rows,
                   const typename Ty<BF16>::S* __restrict__ vals,
                   const typename Ty<BF16>::S* __restrict__ dscores,
                   typename Ty<BF16>::S* __restrict__ out, int fields,
                   int rank, int stride, int vec) {
    using T = Ty<BF16>;
    using S = typename T::S;
    constexpr int V = kUnit / sizeof(S);
    extern __shared__ __align__(16) unsigned char smem[];
    const int F = fields, FF = fields * fields, n = FF * rank;
    S* slab = reinterpret_cast<S*>(smem);
    float* xs = reinterpret_cast<float*>(
        smem + static_cast<size_t>(FF) * stride * sizeof(S));
    const size_t b = blockIdx.x;

    stage(slab, rows + b * n, n, rank, stride, vec);
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
        xs[f] = T::widen(vals[b * F + f]);
    }
    if (threadIdx.x == 0) xs[F] = T::widen(dscores[b]);
    __syncthreads();

    const float ds = xs[F];
    S* orow = out + b * n;
    if (vec) {
        for (int v = threadIdx.x; v < n / V; v += blockDim.x) {
            const int e = v * V;
            const int kv = e / rank, c = e - kv * rank;
            const int i = kv / F, j = kv - i * F;
            Vec<S> src, dst;
            src.u = *reinterpret_cast<const uint4*>(
                slab + static_cast<size_t>(j * F + i) * stride + c);
#pragma unroll
            for (int q = 0; q < V; ++q) {
                dst.e[q] = dvs_term<BF16>(src.e[q], xs[i], xs[j], ds, i == j);
            }
            *reinterpret_cast<uint4*>(orow + e) = dst.u;
        }
    } else {
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
            const int kv = e / rank, c = e - kv * rank;
            const int i = kv / F, j = kv - i * F;
            orow[e] = dvs_term<BF16>(
                slab[static_cast<size_t>(j * F + i) * stride + c], xs[i],
                xs[j], ds, i == j);
        }
    }
}

bool aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % kUnit == 0;
}

// Shapes both kernels take: a row's slab indexed by int, staged in the
// shared memory a block can have.
bool shape_ok(int batch, int fields, int rank, int elem) {
    return batch >= 1 && fields >= 1 && rank >= 1 &&
           static_cast<long long>(fields) * fields * rank < INT_MAX &&
           fwd_smem(fields, rank, elem) <= kMaxSmem &&
           bwd_smem(fields, rank, elem) <= kMaxSmem;
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
    if (smem <= kDefaultSmem) return cudaSuccess;
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
}

template <bool BF16>
cudaError_t launch_fwd(const void* rows, const void* vals, void* out,
                       int batch, int fields, int rank, cudaStream_t stream) {
    using S = typename Ty<BF16>::S;
    const int elem = sizeof(S);
    const size_t smem = fwd_smem(fields, rank, elem);
    const int vec = rank % (kUnit / elem) == 0 && aligned(rows);
    auto kernel = ffm_fwd_kernel<BF16>;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<batch, kThreads, smem, stream>>>(
        static_cast<const S*>(rows), static_cast<const S*>(vals),
        static_cast<S*>(out), fields, rank, kvec_stride(rank, elem), vec);
    return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_bwd(const void* rows, const void* vals, const void* ds,
                       void* out, int batch, int fields, int rank,
                       cudaStream_t stream) {
    using S = typename Ty<BF16>::S;
    const int elem = sizeof(S);
    const size_t smem = bwd_smem(fields, rank, elem);
    const int vec =
        rank % (kUnit / elem) == 0 && aligned(rows) && aligned(out);
    auto kernel = ffm_bwd_kernel<BF16>;
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<batch, kThreads, smem, stream>>>(
        static_cast<const S*>(rows), static_cast<const S*>(vals),
        static_cast<const S*>(ds), static_cast<S*>(out), fields, rank,
        kvec_stride(rank, elem), vec);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows [batch, fields, fields * rank], vals [batch, fields] and out [batch],
// all contiguous in one dtype: bf16 if is_bf16, else fp32. Writes acc (the
// caller halves it). Launches on `stream` of `device`; returns
// cudaGetLastError() (0 on success). Does not synchronise.
int ffm_sel_fwd(const void* rows, const void* vals, void* out, int batch,
                int fields, int rank, int is_bf16, void* stream, int device) {
    if (!shape_ok(batch, fields, rank, is_bf16 ? 2 : 4)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        is_bf16 ? launch_fwd<true>(rows, vals, out, batch, fields, rank, s)
                : launch_fwd<false>(rows, vals, out, batch, fields, rank, s));
}

// rows and out [batch, fields, fields * rank], vals [batch, fields],
// dscores [batch], all contiguous in one dtype (bf16 if is_bf16, else fp32).
// Writes dvs with the diagonal blocks zeroed. Launches on `stream` of
// `device`; returns cudaGetLastError(). Does not synchronise.
int ffm_sel_bwd(const void* rows, const void* vals, const void* dscores,
                void* out, int batch, int fields, int rank, int is_bf16,
                void* stream, int device) {
    if (!shape_ok(batch, fields, rank, is_bf16 ? 2 : 4)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return static_cast<int>(
        is_bf16 ? launch_bwd<true>(rows, vals, dscores, out, batch, fields,
                                   rank, s)
                : launch_bwd<false>(rows, vals, dscores, out, batch, fields,
                                    rank, s));
}

// Shared memory a block of either kernel stages for one row (the larger
// of the two), in bytes.
long long ffm_sel_smem_bytes(int fields, int rank, int elem) {
    const size_t f = fwd_smem(fields, rank, elem);
    const size_t b = bwd_smem(fields, rank, elem);
    return static_cast<long long>(f > b ? f : b);
}

const char* ffm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
