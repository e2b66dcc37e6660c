// Stochastic-rounding noise bits for Hopper (sm_90a): JAX's threefry key
// schedule on the card.
//
// No TPU kernel has this job: the JAX steps draw the bits of a bf16
// dedup_sr write with jax.random (fm_spark_tpu/ops/scatter.py:44-67):
//
//   key  = fold_in(fold_in(jax.random.key(seed), step), field)
//   bits = jax.random.bits(key, shape, uint32) & 0xFFFF
//
// with the threefry-2x32 PRNG under jax_threefry_partitionable: key(s) is
// the pair (0, s); fold_in(k, d) is threefry2x32(k, (0, d)); element e of
// the flat output hashes the counter pair (e >> 32, e & 0xFFFFFFFF) and
// keeps the xor of the two words. This kernel writes the same bits, as
// int32 values in [0, 65536), for element e of a [rows, w] block:
//
//   out[e] = (b0 ^ b1) & 0xFFFF,  (b0, b1) = threefry2x32(key, (e >> 32, e))
//
// The step is read from device memory, not passed by value, so a captured
// CUDA graph of the training step draws each replay's own bits; the seed
// and the field are fixed per call site and passed by value.
//
// Bound: the output's bytes, 4 per element, written once (nothing is
// read but the step): [12,288, 65] int32 is 3.2 MB, ~0.001 ms at
// 3.35 TB/s, and ~80 integer operations per element (20 rounds of add,
// rotate, xor, and the key injections). Design: every thread derives the
// key itself (two hashes, no shared memory and no barrier) and then hashes
// kPerThread elements strided by the grid's width, so a warp's stores
// are contiguous.

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
    return __funnelshift_l(x, x, r);
}

// The 20-round threefry-2x32 hash of (x0, x1) under key (k0, k1), as
// jax._src.prng._threefry2x32_lowering computes it.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = rotl(x1, rot[i & 1][j]);
            x1 ^= x0;
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
}

__global__ void __launch_bounds__(kThreads)
sr_bits_kernel(const int* __restrict__ step, uint32_t seed, uint32_t field,
               long long n, int* __restrict__ out) {
    // key(seed) = (0, seed); each fold_in hashes (0, data) under the key.
    uint32_t k0 = 0u, k1 = static_cast<uint32_t>(__ldg(step));
    threefry2x32(0u, seed, k0, k1);
    uint32_t f0 = 0u, f1 = field;
    threefry2x32(k0, k1, f0, f1);
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    long long e = static_cast<long long>(blockIdx.x) * kThreads * kPerThread +
                  threadIdx.x;
    for (; e < n; e += stride * kPerThread) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
            const long long i = e + static_cast<long long>(j) * kThreads;
            if (i < n) {
                uint32_t x0 = static_cast<uint32_t>(
                                 static_cast<unsigned long long>(i) >> 32),
                         x1 = static_cast<uint32_t>(i);
                threefry2x32(f0, f1, x0, x1);
                out[i] = static_cast<int>((x0 ^ x1) & 0xFFFFu);
            }
        }
    }
}

}  // namespace

extern "C" {

// step: one int32 on the device (the training step); seed: the schedule's
// seed (TrainConfig.seed + 0x5EED, as a 32-bit word); field: the field's
// index; out: `count` int32 elements (the flat [rows, w] block). Launches
// on `stream` of `device`, returns cudaGetLastError(); does not
// synchronise.
int sr_bits(const int* step, unsigned int seed, unsigned int field,
            long long count, int* out, void* stream, int device) {
    if (step == nullptr || out == nullptr || count < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (count == 0) return 0;
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    const long long per_block = static_cast<long long>(kThreads) * kPerThread;
    const long long blocks = (count + per_block - 1) / per_block;
    const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks
                                                                  : (1 << 20));
    sr_bits_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        step, seed, field, count, out);
    return static_cast<int>(cudaGetLastError());
}

const char* sr_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
