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
// fp32 or bf16 (each at any element-aligned address) and every sum taken
// in fp32, at any width and field count.
//
// bf16 compute (cd_bf16, a template flag): as JAX's bf16 spec.scores does,
// the row and x are rounded to bf16, each x * row product is rounded to
// bf16, and so is w0; the sums stay fp32.
//
// Bound: memory. Per sample the kernel reads F random rows of w elements
// plus F ids and values, and writes w + 1 floats; it does ~4 flops per
// byte read, far below the card's ~20 fp32 flops per byte. The TPU version
// chains one call per field through an accumulator in device memory; here
// the loop over fields runs inside the kernel and only the final acc row
// and score are written. Every sum runs in a fixed order and no atomics
// are used, so a call repeats bit for bit. Both launch forms below take
// the same order (acc and ssq per column over the fields, then per lane
// over columns j, j + 32, ..., then across lanes), so a sample's bits do
// not depend on which form runs or on the batch it came in.
//
// Two launch forms, chosen per call by the host code below:
//
// - The staged form (every bf16 table; fp32 tables below
//   FM_WARP_MIN_ROWS_PER_SM rows per SM, or past 128 columns or
//   FM_PARAM_FIELDS fields). A block takes a tile of samples. It reads
//   the tile's ids and values (one round trip), then copies every row of
//   the tile into shared memory with cp.async, as the 16-byte-aligned
//   chunks of the flat table that cover the row, all in flight at once (a
//   second round trip): a row of any alignment moves in
//   ceil((offset + bytes) / 16) 16-byte loads, never touching a byte
//   outside its table's 16-byte-aligned span. One thread per (sample,
//   column) then sums the fields in order, reading each row at its own
//   byte offset, and one warp per sample folds the columns with shuffles.
//   A bf16 row of 130 bytes moves in 9 chunk loads where single elements
//   took three 64-byte warp loads. The tile is one sample until the batch
//   gives FM_MIN_BLOCKS_PER_SM tiles per SM (at B = 512 the 512 blocks
//   spread over every SM, with all ~20,000 row reads in flight after the
//   ids); larger batches take tiles of ~FM_TILE_ITEMS (sample, column)
//   items, as many as fit FM_STAGE_BUDGET bytes of staging. Columns run
//   in windows of at most FM_MAX_WINDOW and fields in groups that fit the
//   budget; a window's partial sums stay in shared memory between groups.
// - The warp form (fp32 tables of at most 128 columns and FM_PARAM_FIELDS
//   fields, from FM_WARP_MIN_ROWS_PER_SM rows per SM up): one warp per
//   sample, the first design of this kernel. Single-element loads already
//   read an fp32 row in coalesced 128-byte runs; there the staged form
//   was slower, its shared memory holding fewer samples' rows in flight
//   per SM (39 fields of 65 columns at B = 131,072 on an H100 80GB HBM3
//   at 700 W: 0.6021 against 0.5944 ms on uniform ids, 0.3675 against
//   0.3027 ms on Zipf(1.3) ids).

// Table pointers travel in the kernel's parameter space up to
// FM_PARAM_FIELDS fields and in a device array (the caller's) beyond.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <atomic>
#include <mutex>

#define FM_PARAM_FIELDS 64
#define FM_MAX_THREADS 1024
#define FM_MAX_WINDOW 1024
#define FM_MAX_DEVICES 64
#define FM_STAGE_BUDGET (48 * 1024)
#define FM_TILE_ITEMS 512
#define FM_MIN_BLOCKS_PER_SM 32
#define FM_WARP_MIN_ROWS_PER_SM 4
#define FM_WARPS_PER_BLOCK 4
#define FM_FIELD_UNROLL 8

namespace {

// Table base pointers, passed by value in the kernel's parameter space.
struct TablePtrs {
    const void* t[FM_PARAM_FIELDS];
};

struct FwdArgs {
    // Table base pointers by value (fields <= FM_PARAM_FIELDS), or NULL
    // here and a device array in tab_dev.
    TablePtrs tab;
    const void* const* tab_dev;
    const int* ids;
    const float* vals;
    const float* w0;
    float* scores;
    float* acc;
    int num_fields, bucket, width, batch, use_linear;
    int tile;     // samples per tile
    int group;    // fields per staging round
    int window;   // columns per window
    int cw;       // 16-byte chunk slots per row window
};

template <typename T>
struct Storage;

template <>
struct Storage<float> {
    using Raw = float;
    static __device__ __forceinline__ float widen(Raw r) { return r; }
};

template <>
struct Storage<__nv_bfloat16> {
    using Raw = unsigned short;
    static __device__ __forceinline__ float widen(Raw r) {
        return __uint_as_float(static_cast<unsigned>(r) << 16);
    }
};

// Round to bf16 when the compute dtype is bf16.
template <bool CD_BF16>
__device__ __forceinline__ float rc(float v) {
    if constexpr (CD_BF16) {
        return __bfloat162float(__float2bfloat16_rn(v));
    } else {
        return v;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

// The score from the folded sums, in one order for both launch forms.
template <bool CD_BF16>
__device__ __forceinline__ float finish_score(float ss, float ssq, float lin,
                                              int use_linear, const float* w0) {
    float score = __fmul_rn(0.5f, __fsub_rn(ss, ssq));
    if (use_linear) score = __fadd_rn(score, lin);
    if (w0 != nullptr) score = __fadd_rn(score, rc<CD_BF16>(*w0));
    return score;
}

__device__ __forceinline__ void cp_async16(void* dst, unsigned long long src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    // Through L1 (.ca): on Zipf ids the hot rows' chunks coalesce there;
    // .cg was 10-20 % slower on an H100.
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared memory of a block, in this order: the staged chunks
// [tile * group][cw] x 16 B; each staged row's global address of its
// window and its {shared byte offset, x}; the window's partial acc and
// ssq per (sample, column); per sample the folded sum s^2, ssq and
// linear term.
inline size_t smem_bytes(int tile, int group, int window, int cw) {
    const size_t rows = static_cast<size_t>(tile) * group;
    return rows * cw * 16 + rows * 16 + static_cast<size_t>(tile) * window * 8 +
           static_cast<size_t>(tile) * 3 * 4;
}

template <typename T, bool CD_BF16>
__global__ void __launch_bounds__(FM_MAX_THREADS)
fm_fused_fwd_kernel(const FwdArgs a) {
    extern __shared__ uint4 smem_raw[];
    using S = Storage<T>;
    using Raw = typename S::Raw;
    constexpr int E = sizeof(T);

    const int tid = threadIdx.x, nt = blockDim.x;
    const int tile = a.tile, group = a.group, window = a.window, cw = a.cw;
    const int F = a.num_fields, w = a.width, k = w - 1;
    const int b0 = blockIdx.x * tile;
    const int nb = min(tile, a.batch - b0);
    const size_t row_bytes = static_cast<size_t>(w) * E;

    char* stage = reinterpret_cast<char*>(smem_raw);
    const size_t rows_max = static_cast<size_t>(tile) * group;
    auto* addr = reinterpret_cast<unsigned long long*>(stage + rows_max * cw * 16);
    auto* meta = reinterpret_cast<int2*>(addr + rows_max);
    auto* accs = reinterpret_cast<float*>(meta + rows_max);
    float* ssqs = accs + tile * window;
    float* tot = ssqs + tile * window;

    for (int i = tid; i < nb * 3; i += nt) tot[i] = 0.f;

    for (int j0 = 0; j0 < w; j0 += window) {
        const int wc = min(window, w - j0);
        const int wbytes = wc * E;
        for (int f0 = 0; f0 < F; f0 += group) {
            const int fg = min(group, F - f0);
            const int nrows = nb * fg;       // row r = s * fg + f
            // 1. Ids and values of this group: each row's address.
            for (int r = tid; r < nrows; r += nt) {
                const int s = r / fg, f = f0 + (r - s * fg);
                const size_t o = static_cast<size_t>(b0 + s) * F + f;
                const int id = min(max(__ldg(a.ids + o), 0), a.bucket - 1);
                const float x = rc<CD_BF16>(__ldg(a.vals + o));
                const char* base = static_cast<const char*>(
                    a.tab_dev != nullptr ? a.tab_dev[f] : a.tab.t[f]);
                const unsigned long long p = reinterpret_cast<unsigned long long>(
                    base + static_cast<size_t>(id) * row_bytes +
                    static_cast<size_t>(j0) * E);
                addr[r] = p;
                meta[r] = make_int2(r * cw * 16 + static_cast<int>(p & 15),
                                    __float_as_int(x));
            }
            __syncthreads();
            // 2. Every chunk of every row in flight at once.
            {
                const int total = nrows * cw;
                int r = tid / cw, c = tid - r * cw;
                const int dr = nt / cw, dc = nt - dr * cw;
                for (int i = tid; i < total; i += nt) {
                    const unsigned long long p = addr[r];
                    if (c < ((static_cast<int>(p & 15) + wbytes + 15) >> 4)) {
                        cp_async16(stage + (static_cast<size_t>(r) * cw + c) * 16,
                                   (p & ~15ull) + static_cast<unsigned long long>(c) * 16);
                    }
                    c += dc;
                    r += dr;
                    if (c >= cw) {
                        c -= cw;
                        ++r;
                    }
                }
                cp_async_wait_all();
            }
            __syncthreads();
            // 3. One thread per (sample, column): this group's fields in order.
            for (int it = tid; it < nb * wc; it += nt) {
                const int s = it / wc, j = it - s * wc;
                const int slot = s * window + j;
                float acc = f0 == 0 ? 0.f : accs[slot];
                float ssq = f0 == 0 ? 0.f : ssqs[slot];
                const bool inter = j0 + j < k;
                const int2* m = meta + s * fg;
                const char* col = stage + j * E;
#pragma unroll 4
                for (int f = 0; f < fg; ++f) {
                    const int2 mf = m[f];
                    const float v = rc<CD_BF16>(
                        S::widen(*reinterpret_cast<const Raw*>(col + mf.x)));
                    const float xv = rc<CD_BF16>(__fmul_rn(__int_as_float(mf.y), v));
                    acc += xv;
                    if (inter) ssq = fmaf(xv, xv, ssq);
                }
                accs[slot] = acc;
                ssqs[slot] = ssq;
            }
            __syncthreads();
        }
        // 4. One warp per sample: write the window's acc columns and fold
        // sum s^2, ssq and the linear column.
        const int lane = tid & 31, nw = nt >> 5;
        for (int s = tid >> 5; s < nb; s += nw) {
            float ss = 0.f, ssq = 0.f, lin = 0.f;
            float* out = a.acc + static_cast<size_t>(b0 + s) * w + j0;
            for (int j = lane; j < wc; j += 32) {
                const float v = accs[s * window + j];
                out[j] = v;
                if (j0 + j < k) {
                    ss = fmaf(v, v, ss);
                    ssq += ssqs[s * window + j];
                } else {
                    lin = v;
                }
            }
            ss = warp_sum(ss);
            ssq = warp_sum(ssq);
            lin = warp_sum(lin);
            if (lane == 0) {
                tot[3 * s] += ss;
                tot[3 * s + 1] += ssq;
                tot[3 * s + 2] += lin;
            }
        }
        __syncthreads();
    }
    for (int s = tid; s < nb; s += nt) {
        a.scores[b0 + s] = finish_score<CD_BF16>(
            tot[3 * s], tot[3 * s + 1], tot[3 * s + 2], a.use_linear, a.w0);
    }
}


// The warp form, for fp32 tables of at most 128 columns and 64 fields
// at batches that fill the card: one warp per sample row, lane j holding
// columns j, j + 32, j + 64, ... (NC of them) and their ssq terms in fp32
// registers, summed in the staged form's order; lane f
// holds field f's id and value (two slots) and broadcasts them by
// shuffle; FM_FIELD_UNROLL fields' row loads are issued before any is
// used. A lane reads single elements, so a warp reads each 128-byte run
// of an fp32 row in one coalesced transaction, and no shared memory
// holds a sample's rows between their loads and their use.
template <int NC, bool CD_BF16>
__global__ void __launch_bounds__(FM_WARPS_PER_BLOCK * 32)
fm_fused_fwd_warp_kernel(TablePtrs tables, int num_fields, int bucket,
                         int width, const int* __restrict__ ids,
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

    float s[NC], q[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) s[c] = q[c] = 0.f;

    for (int f0 = 0; f0 < num_fields; f0 += FM_FIELD_UNROLL) {
        float v[FM_FIELD_UNROLL][NC];
        float x[FM_FIELD_UNROLL];
#pragma unroll
        for (int u = 0; u < FM_FIELD_UNROLL; ++u) {
            const int f = f0 + u;
            const bool live = f < num_fields;
            // f is warp-uniform, so every lane takes the same slot.
            const int id = __shfl_sync(0xffffffffu, f < 32 ? id_lo : id_hi, f & 31);
            const float xf = __shfl_sync(0xffffffffu, f < 32 ? x_lo : x_hi, f & 31);
            x[u] = live ? rc<CD_BF16>(xf) : 0.f;
            const float* rowp = live
                ? static_cast<const float*>(tables.t[f]) + static_cast<size_t>(id) * width
                : nullptr;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const int col = lane + 32 * c;
                v[u][c] = (live && col < width) ? __ldg(rowp + col) : 0.f;
            }
        }
#pragma unroll
        for (int u = 0; u < FM_FIELD_UNROLL; ++u) {
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float xv = rc<CD_BF16>(__fmul_rn(x[u], rc<CD_BF16>(v[u][c])));
                s[c] += xv;
                if (lane + 32 * c < k) q[c] = fmaf(xv, xv, q[c]);
            }
        }
    }

    float ss = 0.f, ssq = 0.f, lin = 0.f;
    float* acc_row = acc + static_cast<size_t>(row) * width;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < k) {
            ss = fmaf(s[c], s[c], ss);
            ssq += q[c];
        } else if (col == k) {
            lin = s[c];
        }
        if (col < width) acc_row[col] = s[c];
    }
    ss = warp_sum(ss);
    ssq = warp_sum(ssq);
    lin = warp_sum(lin);
    if (lane == 0) {
        scores[row] = finish_score<CD_BF16>(ss, ssq, lin, use_linear, w0);
    }
}

struct Plan {
    int tile, group, window, cw, threads;
    size_t smem;
};

// The launch form. tile: one sample while the batch gives fewer than
// FM_MIN_BLOCKS_PER_SM tiles per SM (latency), else ~FM_TILE_ITEMS
// (sample, column) items, shrunk until all fields' rows fit the staging
// budget; group: the fields per staging round that fit it.
Plan plan(int num_fields, int width, int elem, int batch, int sms) {
    Plan p;
    p.window = width < FM_MAX_WINDOW ? width : FM_MAX_WINDOW;
    // Chunks covering a slice of window * elem bytes that starts at any
    // elem-aligned offset within a chunk.
    p.cw = (p.window * elem + 16 - elem + 15) / 16;
    const size_t row = static_cast<size_t>(p.cw) * 16 + 16;
    int tile = FM_TILE_ITEMS / p.window;
    if (tile < 1) tile = 1;
    const long long fill = static_cast<long long>(FM_MIN_BLOCKS_PER_SM) * sms;
    if (batch / fill < tile) tile = static_cast<int>(batch / fill);
    if (tile < 1) tile = 1;
    while (tile > 1 && tile * num_fields * row > FM_STAGE_BUDGET) --tile;
    size_t group = FM_STAGE_BUDGET / (tile * row);
    if (group < 1) group = 1;
    p.group = group < static_cast<size_t>(num_fields) ? static_cast<int>(group)
                                                      : num_fields;
    p.tile = tile;
    const int threads = (tile * p.window + 31) / 32 * 32;
    p.threads = threads < FM_MAX_THREADS ? threads : FM_MAX_THREADS;
    p.smem = smem_bytes(p.tile, p.group, p.window, p.cw);
    return p;
}

// Callers may launch from several host threads at once: the per-device
// caches below are atomic, and the shared-memory opt-in is checked, set
// and recorded under one lock.
int sm_count(int device) {
    static std::atomic<int> cached[FM_MAX_DEVICES];  // zero: static
    const bool known = device >= 0 && device < FM_MAX_DEVICES;
    if (known) {
        const int n = cached[device].load(std::memory_order_relaxed);
        if (n > 0) return n;
    }
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || n < 1) {
        n = 1;
    }
    if (known) cached[device].store(n, std::memory_order_relaxed);
    return n;
}

template <typename T, bool CD_BF16>
cudaError_t launch(const FwdArgs& args, const Plan& p, cudaStream_t stream,
                   int device) {
    auto kernel = fm_fused_fwd_kernel<T, CD_BF16>;
    // Dynamic shared memory above 48 KB needs the function's opt-in, set
    // on each device to the largest size asked for so far.
    if (p.smem > 48 * 1024) {
        static std::mutex lock;
        static size_t allowed[FM_MAX_DEVICES] = {0};
        const std::lock_guard<std::mutex> hold(lock);
        const bool known = device >= 0 && device < FM_MAX_DEVICES;
        if (!(known && p.smem <= allowed[device])) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(p.smem));
            if (e != cudaSuccess) return e;
            if (known) allowed[device] = p.smem;
        }
    }
    const unsigned grid = static_cast<unsigned>((args.batch + p.tile - 1) / p.tile);
    kernel<<<grid, p.threads, p.smem, stream>>>(args);
    return cudaGetLastError();
}

template <bool CD_BF16>
cudaError_t launch_warp(const FwdArgs& a, cudaStream_t stream) {
    const dim3 block(FM_WARPS_PER_BLOCK * 32);
    const dim3 grid((a.batch + FM_WARPS_PER_BLOCK - 1) / FM_WARPS_PER_BLOCK);
#define FM_WARP_ARGS a.tab, a.num_fields, a.bucket, a.width, a.ids, a.vals, \
    a.batch, a.w0, a.use_linear, a.scores, a.acc
    switch ((a.width + 31) / 32) {
        case 1:
            fm_fused_fwd_warp_kernel<1, CD_BF16><<<grid, block, 0, stream>>>(FM_WARP_ARGS);
            break;
        case 2:
            fm_fused_fwd_warp_kernel<2, CD_BF16><<<grid, block, 0, stream>>>(FM_WARP_ARGS);
            break;
        case 3:
            fm_fused_fwd_warp_kernel<3, CD_BF16><<<grid, block, 0, stream>>>(FM_WARP_ARGS);
            break;
        default:
            fm_fused_fwd_warp_kernel<4, CD_BF16><<<grid, block, 0, stream>>>(FM_WARP_ARGS);
            break;
    }
#undef FM_WARP_ARGS
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of device `device` and returns a CUDA
// error code (0 on success). `table_ptrs` is a HOST array of `num_fields`
// device pointers, each to a contiguous [bucket, width] table at any
// element-aligned address; above 64 fields the kernel reads them instead
// from `table_ptrs_dev`, a DEVICE array of the same pointers that the
// caller keeps alive until the kernel has run (NULL up to 64 fields).
// `is_bf16` selects bf16 storage (else fp32), `cd_bf16` the bf16 compute
// rounding (else fp32). `w0` may be NULL.
// Does not synchronise. The library links its own CUDA runtime, so the
// device is set here rather than inherited from the caller's runtime.
int fm_fused_fwd(const void* const* table_ptrs,
                 const void* const* table_ptrs_dev, int num_fields, int bucket,
                 int width, int is_bf16, int cd_bf16, const int* ids,
                 const float* vals,
                 int batch, const float* w0, int use_linear, float* scores,
                 float* acc, void* stream, int device) {
    if (num_fields < 1 || bucket < 1 || width < 2 || batch < 1 ||
        (num_fields > FM_PARAM_FIELDS && table_ptrs_dev == nullptr)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    FwdArgs args;
    for (int f = 0; f < FM_PARAM_FIELDS; ++f) {
        args.tab.t[f] = f < num_fields && num_fields <= FM_PARAM_FIELDS
            ? table_ptrs[f] : nullptr;
    }
    args.tab_dev = num_fields > FM_PARAM_FIELDS ? table_ptrs_dev : nullptr;
    args.ids = ids;
    args.vals = vals;
    args.w0 = w0;
    args.scores = scores;
    args.acc = acc;
    args.num_fields = num_fields;
    args.bucket = bucket;
    args.width = width;
    args.batch = batch;
    args.use_linear = use_linear;
    const int sms = sm_count(device);
    const Plan p = plan(num_fields, width, is_bf16 ? 2 : 4, batch, sms);
    args.tile = p.tile;
    args.group = p.group;
    args.window = p.window;
    args.cw = p.cw;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (!is_bf16 && width <= 128 && num_fields <= FM_PARAM_FIELDS &&
        batch >= FM_WARP_MIN_ROWS_PER_SM * sms) {
        err = cd_bf16 ? launch_warp<true>(args, s) : launch_warp<false>(args, s);
    } else if (is_bf16) {
        err = cd_bf16 ? launch<__nv_bfloat16, true>(args, p, s, device)
                      : launch<__nv_bfloat16, false>(args, p, s, device);
    } else {
        err = cd_bf16 ? launch<float, true>(args, p, s, device)
                      : launch<float, false>(args, p, s, device);
    }
    return static_cast<int>(err);
}

const char* fm_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
