// Kernel A: bilinear event binning for the histogram voting backend.
//
// Replaces dvs_mcemvs_tpu/kernels/binning_pallas.py:bin_events_pallas_windowed
// (Pallas body _kernel_windowed), which computes per group g
//     hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e]),
// hat(d) = max(0, 1 - |d|), as row-windowed one-hot matmuls on the TPU's MXU.
//
// What bounds it on an H100: at the headline shape (G = 64 groups of
// E = 16384 events into 64 x 576 x 896 bins) the work is four float atomic
// adds per event (4 Mi atomics) into a 132 MB f32 accumulator, larger than the
// 50 MB L2.  Each atomic is a read-modify-write at a scattered address, so the
// kernel is bound by L2 atomic throughput and by the accumulator's DRAM
// traffic (zeroing, atomics, the bf16 cast pass), not by arithmetic.
//
// What the design does about it: one thread per event and exactly the four
// taps it touches -- no one-hot matrices and no row sort (the TPU sorted rows
// only to trim MXU work, which a scatter does not do).  Zero-weight events
// (padding, dropped, invalid packets) return before any atomic.  The rounding
// points are the TPU kernel's: bf16(hat_y * w) * bf16(hat_x), an exact f32
// product, accumulated in f32; then one pass casts the accumulator to bf16
// when a bf16 histogram is asked for.  Shared-memory strip tiles over
// row-sorted events, to keep the atomics on chip, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// hat(coord - bin) with the TPU kernel's f32 operations, none contracted.
__device__ __forceinline__ float hat(float coord, int bin) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(coord, (float)bin))));
}

__global__ void bin_events_kernel(const float* __restrict__ hx,
                                  const float* __restrict__ hy,
                                  const float* __restrict__ w,
                                  float* __restrict__ hist, int64_t n_events,
                                  int E, int hs, int ws) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_events) return;
  const float wt = w[i];
  if (wt == 0.0f) return;
  const float x = hx[i];
  const float y = hy[i];
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  float* h = hist + (i / E) * (int64_t)hs * ws;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int q = y0 + dy;
    if (q < 0 || q >= hs) continue;
    const float ay = round_bf16(__fmul_rn(hat(y, q), wt));
    if (ay == 0.0f) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int p = x0 + dx;
      if (p < 0 || p >= ws) continue;
      const float ax = round_bf16(hat(x, p));
      if (ax != 0.0f) atomicAdd(h + (int64_t)q * ws + p, ay * ax);
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ in,
                                 __nv_bfloat16* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = __float2bfloat16_rn(in[i]);
  }
}

}  // namespace

// hx, hy, w: (G, E) f32, coordinates clipped to [0, ws-1] / [0, hs-1];
// hist_f32: (G, hs, ws) f32, zeroed by the caller, accumulated in place;
// hist_bf16: (G, hs, ws) bf16 copy of the result, or null for none.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int bin_events(const float* hx, const float* hy, const float* w,
                          float* hist_f32, void* hist_bf16, int G, int E,
                          int hs, int ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int64_t n_events = (int64_t)G * E;
  if (n_events > 0) {
    const unsigned blocks = (unsigned)((n_events + threads - 1) / threads);
    bin_events_kernel<<<blocks, threads, 0, s>>>(hx, hy, w, hist_f32, n_events,
                                                 E, hs, ws);
  }
  const int64_t n_bins = (int64_t)G * hs * ws;
  if (hist_bf16 != nullptr && n_bins > 0) {
    int64_t blocks = (n_bins + threads - 1) / threads;
    if (blocks > 132 * 64) blocks = 132 * 64;
    cast_bf16_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        hist_f32, static_cast<__nv_bfloat16*>(hist_bf16), n_bins);
  }
  return (int)cudaGetLastError();
}
