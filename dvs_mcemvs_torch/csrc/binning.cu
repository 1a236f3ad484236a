// Kernel A: bilinear event binning for the histogram voting backend.
//
// Replaces both binning kernels of dvs_mcemvs_tpu/kernels/binning_pallas.py:
//   bin_events_pallas_windowed (Pallas body _kernel_windowed) -- the row-sorted
//                               form, on grids with hs % 64 == 0;
//   bin_events_pallas          (Pallas body _kernel) -- the dense form, on any
//                               hs % 8 == 0.
// Both compute per group g
//     hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e]),
// hat(d) = max(0, 1 - |d|), as one-hot matmuls on the TPU's MXU; they differ
// only in how much of the matmul the row sort lets the MXU skip.  A scatter
// touches exactly the four taps of an event whatever the row order, so one
// kernel serves both, on any hs.
//
// What bounds it on an H100: at the headline shape (G = 64 groups of
// E = 16384 events into 64 x 576 x 896 bins) the work is four atomic adds per
// event (4 Mi atomics) into an accumulator larger than the 50 MB L2 (132 MB
// f32, 264 MB in the int8 mode's 64-bit integers).  Each atomic is a
// read-modify-write at a scattered address, so the kernel is bound by L2
// atomic throughput and by the accumulator's DRAM traffic (zeroing, atomics,
// the output pass), not by arithmetic.
//
// What the design does about it: one thread per event and exactly the four
// taps it touches -- no one-hot matrices and no row sort (the TPU sorted rows
// only to trim MXU work).  Zero-weight events (padding, dropped, invalid
// packets) return before any atomic.  Shared-memory strip tiles over
// row-sorted events, to keep the atomics on chip, are later work.
//
// Rounding, as the TPU kernels round:
//   f32/bf16 mode: bf16(hat_y * w) * bf16(hat_x), an exact f32 product,
//     accumulated in f32; one pass casts the accumulator to bf16 when a bf16
//     histogram is asked for.
//   int8 mode: integer taps rint(fl(hat_y * w) * 127) and rint(hat_x * 127)
//     (round half to even, as jnp.round), their product summed exactly in
//     64-bit integers, then one f32 multiply by the constant 1/(127*127) and,
//     for a bf16 histogram, one cast of that f32 value.  A 32-bit sum would
//     not do: a group holds up to 1024 x 1024 events and a bin can gather
//     16129 per event, past 2^31 after ~133,000 events.  The TPU kernel sums
//     int32 per 1024-event block and adds the blocks in f32, exact while a
//     bin stays below 2^24 (~1040 full-weight events), so the two agree
//     exactly on any real chunk and the 64-bit sum stays exact beyond it.
// The tap arithmetic uses __fsub_rn/__fmul_rn so nvcc contracts none of it
// into FMAs that the TPU kernels do not have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInt8Scale = 1.0f / (127.0f * 127.0f);

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// hat(coord - bin) with the TPU kernel's f32 operations, none contracted.
__device__ __forceinline__ float hat(float coord, int bin) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(coord, (float)bin))));
}

// Taps of one event in one mode: the f32 modes return bf16-rounded floats,
// the int8 mode the integer taps as floats (exact: |tap| <= 127).
struct FloatTaps {
  __device__ __forceinline__ static float y(float hy, int q, float w) {
    return round_bf16(__fmul_rn(hat(hy, q), w));
  }
  __device__ __forceinline__ static float x(float hx, int p) {
    return round_bf16(hat(hx, p));
  }
};

struct Int8Taps {
  __device__ __forceinline__ static float y(float hy, int q, float w) {
    return (float)__float2int_rn(__fmul_rn(__fmul_rn(hat(hy, q), w), 127.0f));
  }
  __device__ __forceinline__ static float x(float hx, int p) {
    return (float)__float2int_rn(__fmul_rn(hat(hx, p), 127.0f));
  }
};

__device__ __forceinline__ void accumulate(float* h, float ay, float ax) {
  atomicAdd(h, ay * ax);  // exact: two bf16 values multiply exactly in f32
}

__device__ __forceinline__ void accumulate(unsigned long long* h, float ay,
                                           float ax) {
  atomicAdd(h, (unsigned long long)((int)ay * (int)ax));  // 0 <= product <= 16129
}

template <typename Taps, typename Acc>
__global__ void bin_events_kernel(const float* __restrict__ hx,
                                  const float* __restrict__ hy,
                                  const float* __restrict__ w,
                                  Acc* __restrict__ hist, int64_t n_events,
                                  int E, int hs, int ws) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_events) return;
  const float wt = w[i];
  if (wt == 0.0f) return;
  const float x = hx[i];
  const float y = hy[i];
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  Acc* h = hist + (i / E) * (int64_t)hs * ws;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int q = y0 + dy;
    if (q < 0 || q >= hs) continue;
    const float ay = Taps::y(y, q, wt);
    if (ay == 0.0f) continue;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int p = x0 + dx;
      if (p < 0 || p >= ws) continue;
      const float ax = Taps::x(x, p);
      if (ax != 0.0f) accumulate(h + (int64_t)q * ws + p, ay, ax);
    }
  }
}

__device__ __forceinline__ float finish(float v) { return v; }
__device__ __forceinline__ float finish(unsigned long long v) {
  return __fmul_rn(__ull2float_rn(v), kInt8Scale);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[i] = finish(acc[i]): the f32 accumulator's bf16 cast, or the int8
// accumulator's scaled value in f32 or bf16.
template <typename Acc, typename Out>
__global__ void finish_kernel(const Acc* __restrict__ acc,
                              Out* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    store(out + i, finish(acc[i]));
  }
}

constexpr int kThreads = 256;

template <typename Taps, typename Acc>
void launch_bin(const float* hx, const float* hy, const float* w, Acc* acc,
                int G, int E, int hs, int ws, cudaStream_t s) {
  const int64_t n_events = (int64_t)G * E;
  if (n_events <= 0) return;
  const unsigned blocks = (unsigned)((n_events + kThreads - 1) / kThreads);
  bin_events_kernel<Taps, Acc><<<blocks, kThreads, 0, s>>>(hx, hy, w, acc,
                                                           n_events, E, hs, ws);
}

template <typename Acc, typename Out>
void launch_finish(const Acc* acc, Out* out, int64_t n, cudaStream_t s) {
  if (n <= 0) return;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  finish_kernel<Acc, Out><<<(unsigned)blocks, kThreads, 0, s>>>(acc, out, n);
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
  launch_bin<FloatTaps, float>(hx, hy, w, hist_f32, G, E, hs, ws, s);
  if (hist_bf16 != nullptr)
    launch_finish(hist_f32, static_cast<__nv_bfloat16*>(hist_bf16),
                  (int64_t)G * hs * ws, s);
  return (int)cudaGetLastError();
}

// The int8 mode: w in [0, 1] (checked by the caller); acc: (G, hs, ws)
// 64-bit integers, zeroed by the caller; out: (G, hs, ws) f32 (out_bf16 = 0)
// or bf16 (out_bf16 = 1).  Launches on `stream`; returns cudaGetLastError().
extern "C" int bin_events_int8(const float* hx, const float* hy,
                               const float* w, unsigned long long* acc,
                               void* out, int out_bf16, int G, int E, int hs,
                               int ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch_bin<Int8Taps, unsigned long long>(hx, hy, w, acc, G, E, hs, ws, s);
  const int64_t n = (int64_t)G * hs * ws;
  if (out_bf16)
    launch_finish(acc, static_cast<__nv_bfloat16*>(out), n, s);
  else
    launch_finish(acc, static_cast<float*>(out), n, s);
  return (int)cudaGetLastError();
}
