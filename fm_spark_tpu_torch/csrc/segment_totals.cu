// Segment totals of sorted deltas for Hopper (sm_90a): kernel A.
//
// Replaces the TPU kernel fm_spark_tpu/ops/pallas_segsum.py::segment_totals
// (_kernel): for fp32 deltas sdelta [B, w] sorted by segment and their
// non-decreasing dense ranks seg [B],
//
//   out[s] = sum over t with seg[t] = s of sdelta[t]        (s < cap)
//
// into a [cap, w] fp32 output; ranks >= cap are dropped (the TPU kernel's
// trash row). The compact update's segment-sum stage (compact_apply with
// segtotal_pallas).
//
// Bound: memory. Per call it reads B * w * 4 + 4 * B bytes and writes
// cap * w * 4; one add per element read. At B = 131072, w = 65,
// cap = 12288 that is 37.8 MB, 11.3 us at 3.35 TB/s.
//
// Design: the tile-and-carry skeleton of segment_scan.cuh with lanes read
// straight from sdelta (one thread per column, so a lane's row is one
// coalesced read across the block). The TPU version keeps the whole
// output resident in VMEM and walks the tiles in order; here tiles run in
// parallel and the segments cut by tile edges are summed by further
// passes over the carries, with no atomics.

#include "segment_scan.cuh"

extern "C" {

// out: [cap, width] fp32 (zeroed here). scratch_seg / scratch_val: at
// least segment_scratch_rows(batch) rows. Launches on `stream` of
// `device`; returns cudaGetLastError() (0 on success). Does not
// synchronise.
int segment_totals(const float* sdelta, const int* seg, int batch, int width,
                   int cap, float* out, int* scratch_seg, float* scratch_val,
                   long long scratch_rows, void* stream, int device) {
    if (batch < 1 || width < 1 || width > SEG_MAX_WIDTH || cap < 1 ||
        scratch_rows < segscan::scratch_rows(batch)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaError_t set = cudaSetDevice(device);
    if (set != cudaSuccess) return static_cast<int>(set);
    const segscan::PlainProducer p{seg, sdelta, batch, width};
    return static_cast<int>(segscan::run(
        p, 1, batch, width, cap, out, scratch_seg, scratch_val,
        static_cast<cudaStream_t>(stream)));
}

long long segment_scratch_rows(int batch) {
    return segscan::scratch_rows(batch);
}

const char* segment_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
