// Kernel B: banded separable affine resample-and-accumulate.
//
// Replaces both resample kernels of dvs_mcemvs_tpu/kernels/resample_pallas.py
// with one device function:
//   banded_resample_sum   (Pallas body _kernel)       -- the butterfly merge,
//   banded_resample_fanin (Pallas body _kernel_fanin) -- the plane sweep.
// Item j produces output plane out_idx[j] from K sources:
//   out[o_j, v, u] = sum_k sum_p bf16(hat(p*sx + tx - u)) *
//                    acc( sum_q bf16(hat(q*sy + ty - v)) * src[s_jk, q, p] )
// with (sy, ty, sx, tx) = maps[j, k], s_jk = src_idx[j, k] and hat(d) =
// max(0, 1 - |d|).  acc() rounds to the accumulation type, as the TPU
// kernel's `resy` scratch does: bf16 for bf16 sources (whose taps are bf16
// too), no rounding and f32 taps for f32 sources.  Sums are f32; one cast to
// the output type at the end.
//
// What bounds it on an H100: at the headline sweep (100 planes, 4 sources
// each, 480 x 640 outputs from 576 x 896 bf16 histograms) an output pixel
// reads about K * 3 * 3 source values, all within a few rows and columns of
// its own position.  The sources of one segment (4 MB) stay in L2 while the
// segment's planes are produced, so the kernel is bound by load issue and
// tap arithmetic in the SMs, not by DRAM bandwidth.
//
// What the design does about it: one thread per output pixel in 32 x 8
// blocks (neighbouring threads read neighbouring columns, so loads coalesce),
// one grid z-slice per item.  The thread loops over k, over the few columns p
// whose x-tap is nonzero and the few rows q whose y-tap is nonzero -- the
// band of the affine map -- so every sum is exact for ANY scale: a small
// scale only lengthens the loops (the TPU kernel's `scale_min` strips have no
// counterpart).  Each output is written by exactly one thread, without
// atomics; the wrapper gives every output plane one item, which also settles
// the TPU fan-in's duplicate writers.  Staging the band in shared memory and
// a tensor-core product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Round to the accumulation type of the source type.
__device__ __forceinline__ float to_acc(float v, const float*) { return v; }
__device__ __forceinline__ float to_acc(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// hat(i*s + t - o) with the TPU kernel's f32 operations, none contracted.
__device__ __forceinline__ float tap(int i, float s, float t, int o) {
  const float d = __fsub_rn(__fadd_rn(__fmul_rn((float)i, s), t), (float)o);
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(d)));
}

// Inclusive range [*lo, *hi] of indices in [0, n) whose tap against output
// position o can be nonzero: |i*s + t - o| < 1.  One index of margin on either
// side absorbs the rounding of the division; the tap itself is evaluated
// exactly afterwards.  A zero scale scans the whole axis; a non-finite map
// contributes nothing (an empty range).
__device__ __forceinline__ void band(int o, float s, float t, int n, int* lo,
                                     int* hi) {
  if (s == 0.0f) {
    *lo = 0;
    *hi = n - 1;
    return;
  }
  const float a = ((float)o - 1.0f - t) / s;
  const float b = ((float)o + 1.0f - t) / s;
  if (!(isfinite(a) && isfinite(b))) {
    *lo = 0;
    *hi = -1;
    return;
  }
  const float mn = fminf(fmaxf(fminf(a, b), -2.0f), (float)n + 1.0f);
  const float mx = fminf(fmaxf(fmaxf(a, b), -2.0f), (float)n + 1.0f);
  *lo = max((int)floorf(mn) - 1, 0);
  *hi = min((int)ceilf(mx) + 1, n - 1);
}

template <typename Tin, typename Tout>
__global__ void resample_kernel(const Tin* __restrict__ src,
                                const int* __restrict__ src_idx,
                                const float* __restrict__ sy,
                                const float* __restrict__ ty,
                                const float* __restrict__ sx,
                                const float* __restrict__ tx,
                                const int* __restrict__ out_idx,
                                Tout* __restrict__ out, int K, int hs, int ws,
                                int Ho, int Wo) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  const int j = blockIdx.z;
  if (u >= Wo || v >= Ho) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) {
    const int m = j * K + k;
    const float syk = sy[m], tyk = ty[m], sxk = sx[m], txk = tx[m];
    const Tin* h = src + (int64_t)src_idx[m] * hs * ws;
    int q_lo, q_hi, p_lo, p_hi;
    band(v, syk, tyk, hs, &q_lo, &q_hi);
    band(u, sxk, txk, ws, &p_lo, &p_hi);
    for (int p = p_lo; p <= p_hi; ++p) {
      const float cx = to_acc(tap(p, sxk, txk, u), src);
      if (cx == 0.0f) continue;
      float r = 0.0f;
      for (int q = q_lo; q <= q_hi; ++q) {
        const float cy = to_acc(tap(q, syk, tyk, v), src);
        if (cy != 0.0f) r += cy * load(h + (int64_t)q * ws + p);
      }
      acc += to_acc(r, src) * cx;
    }
  }
  store(out + ((int64_t)out_idx[j] * Ho + v) * Wo + u, acc);
}

template <typename Tin, typename Tout>
void launch(const void* src, const int* src_idx, const float* sy,
            const float* ty, const float* sx, const float* tx,
            const int* out_idx, void* out, int J, int K, int hs, int ws,
            int Ho, int Wo, cudaStream_t s) {
  const dim3 block(32, 8);
  const dim3 grid((Wo + 31) / 32, (Ho + 7) / 8, J);
  resample_kernel<Tin, Tout><<<grid, block, 0, s>>>(
      static_cast<const Tin*>(src), src_idx, sy, ty, sx, tx, out_idx,
      static_cast<Tout*>(out), K, hs, ws, Ho, Wo);
}

}  // namespace

// src: (n_src, hs, ws) f32 or bf16 (src_bf16); src_idx, sy, ty, sx, tx:
// (J, K); out_idx: (J,) distinct output planes; out: (n_out, Ho, Wo) f32 or
// bf16 (out_bf16).  J <= 65535.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int banded_resample(const void* src, int src_bf16,
                               const int* src_idx, const float* sy,
                               const float* ty, const float* sx,
                               const float* tx, const int* out_idx, void* out,
                               int out_bf16, int J, int K, int hs, int ws,
                               int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J > 0 && Ho > 0 && Wo > 0) {
    if (src_bf16 && out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(src, src_idx, sy, ty, sx, tx,
                                           out_idx, out, J, K, hs, ws, Ho, Wo, s);
    else if (src_bf16)
      launch<__nv_bfloat16, float>(src, src_idx, sy, ty, sx, tx, out_idx, out,
                                   J, K, hs, ws, Ho, Wo, s);
    else if (out_bf16)
      launch<float, __nv_bfloat16>(src, src_idx, sy, ty, sx, tx, out_idx, out,
                                   J, K, hs, ws, Ho, Wo, s);
    else
      launch<float, float>(src, src_idx, sy, ty, sx, tx, out_idx, out, J, K,
                           hs, ws, Ho, Wo, s);
  }
  return (int)cudaGetLastError();
}
