// Kernel B: banded separable affine resample-and-accumulate.
//
// Replaces both resample kernels of dvs_mcemvs_tpu/kernels/resample_pallas.py
// with one templated body:
//   banded_resample_sum   (Pallas body _kernel)       -- the butterfly merge,
//   banded_resample_fanin (Pallas body _kernel_fanin) -- the plane sweep.
// Item j produces output plane out_idx[j] from K sources:
//   out[o_j, v, u] = sum_k sum_p bf16(hat(p*sx + tx - u)) *
//                    acc( sum_q bf16(hat(q*sy + ty - v)) * src[s_jk, q, p] )
// with (sy, ty, sx, tx) = maps[j, k], s_jk = src_idx[j, k] and hat(d) =
// max(0, 1 - |d|).  acc() rounds to the accumulation type, as the TPU
// kernel's `resy` scratch does: bf16 for bf16 sources (whose taps are bf16
// too), no rounding and f32 taps for f32 sources.  Sums are f32, k outer, p
// and q ascending; one cast to the output type at the end.
//
// What bounds it on an H100: bytes.  Each source is read once and each output
// written once: 0.0394 ms for one radix-4 merge level (64 items x 4 sources,
// 576 x 896 bf16) and 0.0564 ms for the plane sweep (100 planes x 4 sources
// into 480 x 640 f32) at 3.35 TB/s.  Per output and source the work is ~2
// taps in each stage, far below the card's bf16 ops-per-byte line, so tensor
// cores would idle; what costs is load issue and tap arithmetic when every
// output pixel recomputes its taps and re-reads its 3 x 3 neighbourhood, as a
// one-thread-per-pixel loop does.
//
// What the design does about it: one block per (16 x 128 output tile, item).
// For each source k the affine map sends the tile to one source band, found
// from the tile's corner rows and columns.  A band that fits the staging
// buffer (every map with scale >= 0.4, the headline and ss2 maps included) is
//   1. staged in shared memory with cp.async (16-byte copies from 16-byte
//      aligned rows; element copies at a row end or on unaligned rows; never
//      past the source), double-buffered over k while two bands fit;
//   2. y-stage: taps computed once per output row, resy[v][p] =
//      acc(sum_q cy * band[q][p]) in shared memory, one warp per row;
//   3. x-stage: taps computed once per output column, out[v][u] +=
//      resy[v][p] * cx in registers, 8 outputs a thread.
// Any other (tile, source) -- a smaller scale, a zero scale, a non-finite
// map, or more than NT nonzero taps in a row or column -- runs the
// one-thread-per-pixel band loop (`pixel_source`) for that source only.  Both
// paths add the same nonzero terms in the same order and round at the same
// points.  The choice is made per block from the maps alone; a warp never
// diverges on it.
//
// Grid order: the item is blockIdx.x, the fastest-varying index, so the
// items of one output tile run together and share their sources' bands in
// L2 (the 4 ranges of a merge node read the same 4 parents; every plane of a
// sweep segment reads the segment's sources).  Each output is written by
// exactly one thread, without atomics; the wrapper gives every output plane
// one item, which also settles the TPU fan-in's duplicate writers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TV = 16;          // output tile rows
constexpr int TU = 128;         // output tile columns
constexpr int NTHREADS = 256;
constexpr int OUT_PER_THREAD = TV * TU / NTHREADS;
constexpr int ROW_STEP = NTHREADS / TU;  // rows between a thread's outputs
constexpr int NT = 8;           // most nonzero taps a staged row/column takes
constexpr int BAND = 18432;     // staged band elements, both buffers
constexpr int HALF = BAND / 2;  // one buffer when two bands are in flight
constexpr int NP_MAX = 352;     // widest staged band (columns), resy pitch
constexpr int KCHUNK = 64;      // sources whose tile boxes are held at once

// What a (tile, source) takes: nothing (its band misses the source), the
// staged path, or the per-pixel loop.
enum Path { SKIP, STAGED, PER_PIXEL };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// Two neighbouring values; p is 2-element aligned.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round to the accumulation type of source type T.
template <typename T>
__device__ __forceinline__ float to_acc(float v);
template <>
__device__ __forceinline__ float to_acc<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_acc<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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
// contributes nothing (an empty range).  Returns false for those two, whose
// ranges are not monotone in o.
__device__ __forceinline__ bool band(int o, float s, float t, int n, int* lo,
                                     int* hi) {
  if (s == 0.0f) {
    *lo = 0;
    *hi = n - 1;
    return false;
  }
  const float a = ((float)o - 1.0f - t) / s;
  const float b = ((float)o + 1.0f - t) / s;
  if (!(isfinite(a) && isfinite(b))) {
    *lo = 0;
    *hi = -1;
    return false;
  }
  const float mn = fminf(fmaxf(fminf(a, b), -2.0f), (float)n + 1.0f);
  const float mx = fminf(fmaxf(fmaxf(a, b), -2.0f), (float)n + 1.0f);
  *lo = max((int)floorf(mn) - 1, 0);
  *hi = min((int)ceilf(mx) + 1, n - 1);
  return true;
}

// Source k's term of output (v, u), added to acc: the band loop of one
// output pixel, for (tile, source) pairs whose band is not staged.
template <typename Tin>
__device__ __noinline__ float pixel_source(float acc, const Tin* h, float syk,
                                           float tyk, float sxk, float txk,
                                           int v, int u, int hs, int ws) {
  int q_lo, q_hi, p_lo, p_hi;
  band(v, syk, tyk, hs, &q_lo, &q_hi);
  band(u, sxk, txk, ws, &p_lo, &p_hi);
  for (int p = p_lo; p <= p_hi; ++p) {
    const float cx = to_acc<Tin>(tap(p, sxk, txk, u));
    if (cx == 0.0f) continue;
    float r = 0.0f;
    for (int q = q_lo; q <= q_hi; ++q) {
      const float cy = to_acc<Tin>(tap(q, syk, tyk, v));
      if (cy != 0.0f) r += cy * load(h + (int64_t)q * ws + p);
    }
    acc += to_acc<Tin>(r) * cx;
  }
  return acc;
}

// One (tile, source): its map, the reciprocals of its scales, its path, and
// for the staged path its source band, rows [q0, q0 + nq) and columns [p0,
// p0 + pitch) with p0 and pitch multiples of V (16 bytes).
struct Box {
  float sy, ty, sx, tx, iy, ix;
  int q0, nq, p0, pitch;
  Path path;
};

// The tile's band is the union of its rows' and columns' bands, which are
// monotone in the output position for a regular map: the corners bound it.
template <int V>
__device__ Box tile_box(float syk, float tyk, float sxk, float txk, int v0,
                        int v1, int u0, int u1, int hs, int ws) {
  Box b{syk, tyk, sxk, txk, 0.0f, 0.0f, 0, 0, 0, 0, PER_PIXEL};
  int a0, a1, b0, b1, c0, c1, d0, d1;
  const bool regular = band(v0, syk, tyk, hs, &a0, &a1) &
                       band(v1, syk, tyk, hs, &b0, &b1) &
                       band(u0, sxk, txk, ws, &c0, &c1) &
                       band(u1, sxk, txk, ws, &d0, &d1);
  if (!regular) return b;
  const int q_lo = min(a0, b0), q_hi = max(a1, b1);
  const int p_lo = min(c0, d0), p_hi = max(c1, d1);
  if (q_lo > q_hi || p_lo > p_hi) {
    b.path = SKIP;
    return b;
  }
  b.q0 = q_lo;
  b.nq = q_hi - q_lo + 1;
  b.p0 = p_lo & ~(V - 1);
  b.pitch = ((p_hi + V) & ~(V - 1)) - b.p0;
  if (b.pitch <= NP_MAX && (int64_t)b.nq * b.pitch <= BAND) {
    b.path = STAGED;
    b.iy = 1.0f / syk;
    b.ix = 1.0f / sxk;
  }
  return b;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the band of `b` from source h into dst (pitch b.pitch).  Columns at
// or past ws are zero; no byte past a source row is read.  With 16-byte
// aligned rows (`vec`) ws is a multiple of V, so the band ends by ws.
template <typename Tin>
__device__ void stage(Tin* dst, const Tin* h, const Box& b, int ws, bool vec) {
  constexpr int V = 16 / sizeof(Tin);
  const int per_row = b.pitch / V;
  const int n = b.nq * per_row;
  for (int c = threadIdx.x; c < n; c += NTHREADS) {
    const int r = c / per_row;
    const int col = (c - r * per_row) * V;
    const int p = b.p0 + col;
    Tin* d = dst + r * b.pitch + col;
    const Tin* s = h + (int64_t)(b.q0 + r) * ws + p;
    if (vec) {
      cp_async16(d, s);
    } else {
      for (int i = 0; i < V; ++i)
        d[i] = p + i < ws ? s[i] : from_float<Tin>(0.0f);
    }
  }
}

// Taps of output position o under a staged map (scale s, its reciprocal
// inv, translation t) against the indices of its band: writes the taps from
// the first nonzero one on (at most NT, `stride` apart) and its index;
// returns how many lie between the first and last nonzero taps.  The scan
// covers (o - t -+ 1) / s with one index of margin, as band() does.
template <typename Tin>
__device__ int taps_of(int o, float s, float inv, float t, int n, float* out,
                       int stride, int* first) {
  const float c = ((float)o - t) * inv, w = fabsf(inv);
  const int lo = max((int)floorf(c - w) - 1, 0);
  const int hi = min((int)ceilf(c + w) + 1, n - 1);
  int f = -1, l = -1;
  for (int i = lo; i <= hi; ++i) {
    const float v = to_acc<Tin>(tap(i, s, t, o));
    if (v != 0.0f) {
      if (f < 0) f = i;
      l = i;
    }
    if (f >= 0 && i - f < NT) out[(i - f) * stride] = v;
  }
  *first = f < 0 ? 0 : f;
  return f < 0 ? 0 : l - f + 1;
}

// f(t) for every tap t < n, unrolled to the least of 2, 4 and NT taps that
// covers n_max, the largest n across the warp (which must agree on it).
template <typename F>
__device__ __forceinline__ void for_taps(int n_max, int n, F f) {
  if (n_max <= 2) {
#pragma unroll
    for (int t = 0; t < 2; ++t)
      if (t < n) f(t);
  } else if (n_max <= 4) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < n) f(t);
  } else {
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < n) f(t);
  }
}

// Dynamic shared memory of one block: the band buffers, resy, the taps and
// their offsets (the tile boxes are static shared memory).
template <typename Tin>
constexpr size_t smem_bytes() {
  return sizeof(Tin) * (BAND + TV * NP_MAX) +
         sizeof(float) * (NT * TU + TV * NT) + sizeof(int) * 2 * (TU + TV);
}

// Blocks resident on one SM, as the shared memory allows: 4 for bf16
// sources (56,752 bytes each, static included), 2 for f32 (104,880).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(NTHREADS, sizeof(Tin) == 2 ? 4 : 2)
    resample_kernel(const Tin* __restrict__ src,
                    const int* __restrict__ src_idx,
                    const float* __restrict__ sy, const float* __restrict__ ty,
                    const float* __restrict__ sx, const float* __restrict__ tx,
                    const int* __restrict__ out_idx, Tout* __restrict__ out,
                    int K, int hs, int ws, int Ho, int Wo) {
  constexpr int V = 16 / sizeof(Tin);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Box boxes[KCHUNK + 1];  // sources k0 .. k0 + KCHUNK
  Tin* band_buf = reinterpret_cast<Tin*>(smem);
  Tin* resy = band_buf + BAND;
  float* cx = reinterpret_cast<float*>(resy + TV * NP_MAX);  // [NT][TU]
  float* cy = cx + NT * TU;                                  // [TV][NT]
  int* px = reinterpret_cast<int*>(cy + TV * NT);  // first column - b.p0
  int* nx = px + TU;
  int* qy = nx + TU;                               // first row - b.q0
  int* ny = qy + TV;

  const int j = blockIdx.x;
  const int v0 = blockIdx.y * TV, u0 = blockIdx.z * TU;
  const int v1 = min(v0 + TV, Ho) - 1, u1 = min(u0 + TU, Wo) - 1;
  const int tu = threadIdx.x % TU, tv = threadIdx.x / TU;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t plane = (int64_t)hs * ws;
  const bool aligned_rows = (ws * sizeof(Tin)) % 16 == 0 &&
                            reinterpret_cast<uintptr_t>(src) % 16 == 0;

  float acc[OUT_PER_THREAD];
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) acc[r] = 0.0f;

  auto fill_boxes = [&](int k0) {
    for (int i = threadIdx.x; i <= KCHUNK && k0 + i < K; i += NTHREADS) {
      const int m = j * K + k0 + i;
      boxes[i] = tile_box<V>(sy[m], ty[m], sx[m], tx[m], v0, v1, u0, u1, hs, ws);
    }
  };
  auto source = [&](int m) { return src + (int64_t)src_idx[m] * plane; };

  // One cp.async group per source, possibly empty; band k lies at `slot`.
  fill_boxes(0);
  __syncthreads();
  int k0 = 0, slot = 0;
  if (K > 0 && boxes[0].path == STAGED)
    stage(band_buf, source(j * K), boxes[0], ws, aligned_rows);
  cp_async_commit();

  for (int k = 0; k < K; ++k) {
    if (k - k0 == KCHUNK) {
      __syncthreads();  // every thread has staged band k from boxes[KCHUNK]
      k0 = k;
      fill_boxes(k0);
      __syncthreads();
    }
    const int m = j * K + k;
    const Box& cur = boxes[k - k0];
    const Box& nxt = boxes[k + 1 - k0];
    const Path next_path = k + 1 < K ? nxt.path : SKIP;
    // Prefetch band k+1 into the other buffer while k is computed.
    const bool pre = cur.path == STAGED && next_path == STAGED &&
                     cur.nq * cur.pitch <= HALF && nxt.nq * nxt.pitch <= HALF;
    const int next_slot = pre ? HALF - slot : 0;
    if (pre) {
      stage(band_buf + next_slot, source(m + 1), nxt, ws, aligned_rows);
      cp_async_commit();
    }

    bool per_pixel = cur.path == PER_PIXEL;
    if (cur.path == STAGED) {
      int wide = 0;
      if (threadIdx.x < TU) {
        const int u = u0 + threadIdx.x;
        int first = 0, n = 0;
        if (u < Wo)
          n = taps_of<Tin>(u, cur.sx, cur.ix, cur.tx, ws, cx + threadIdx.x, TU,
                           &first);
        px[threadIdx.x] = first - cur.p0;
        nx[threadIdx.x] = n;
        wide = n > NT;
      } else if (threadIdx.x < TU + TV) {
        const int i = threadIdx.x - TU, v = v0 + i;
        int first = 0, n = 0;
        if (v < Ho)
          n = taps_of<Tin>(v, cur.sy, cur.iy, cur.ty, hs, cy + i * NT, 1, &first);
        qy[i] = first - cur.q0;
        ny[i] = n;
        wide = n > NT;
      }
      if (pre)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      per_pixel = __syncthreads_or(wide);
      if (!per_pixel) {
        // y-stage: one warp per output row, each lane on two neighbouring
        // columns of the band.
        const Tin* b = band_buf + slot;
        const int pitch = cur.pitch;
        for (int i = warp; i < TV; i += NTHREADS / 32) {
          const int n = ny[i];
          const Tin* rows = b + qy[i] * pitch;
          float c[NT];
          for_taps(n, n, [&](int t) { c[t] = cy[i * NT + t]; });
          for (int p = 2 * lane; p < pitch; p += 64) {
            float r0 = 0.0f, r1 = 0.0f;
            for_taps(n, n, [&](int t) {
              const float2 x = load2(rows + t * pitch + p);
              r0 += c[t] * x.x;
              r1 += c[t] * x.y;
            });
            store2(resy + i * NP_MAX + p, to_acc<Tin>(r0), to_acc<Tin>(r1));
          }
        }
        __syncthreads();
        // x-stage: each thread's column taps against its 8 rows.
        const int n = nx[tu];
        const int n_max = __reduce_max_sync(0xffffffffu, n);
        float c[NT];
        for_taps(n_max, n, [&](int t) { c[t] = cx[t * TU + tu]; });
#pragma unroll
        for (int r = 0; r < OUT_PER_THREAD; ++r) {
          const Tin* row = resy + (tv + r * ROW_STEP) * NP_MAX + px[tu];
          for_taps(n_max, n, [&](int t) { acc[r] += load(row + t) * c[t]; });
        }
      }
    }
    if (per_pixel) {
      const Tin* h = source(m);
      const int u = u0 + tu;
#pragma unroll
      for (int r = 0; r < OUT_PER_THREAD; ++r) {
        const int v = v0 + tv + r * ROW_STEP;
        if (v < Ho && u < Wo)
          acc[r] = pixel_source(acc[r], h, cur.sy, cur.ty, cur.sx, cur.tx, v, u,
                                hs, ws);
      }
    }
    __syncthreads();  // taps, resy and band k are free from here
    if (!pre) {
      if (next_path == STAGED)
        stage(band_buf, source(m + 1), nxt, ws, aligned_rows);
      cp_async_commit();
    }
    slot = next_slot;
  }
  cp_async_wait<0>();

  const int u = u0 + tu;
  Tout* o = out + (int64_t)out_idx[j] * Ho * Wo;
#pragma unroll
  for (int r = 0; r < OUT_PER_THREAD; ++r) {
    const int v = v0 + tv + r * ROW_STEP;
    if (v < Ho && u < Wo) o[(int64_t)v * Wo + u] = from_float<Tout>(acc[r]);
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const void* src, const int* src_idx, const float* sy,
                   const float* ty, const float* sx, const float* tx,
                   const int* out_idx, void* out, int J, int K, int hs, int ws,
                   int Ho, int Wo, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<Tin>();
  // Above 48 KB of dynamic shared memory a kernel must opt in, once; the
  // largest carveout lets the blocks that fit by shared memory be resident.
  static const cudaError_t opt_in = [] {
    const cudaError_t e = cudaFuncSetAttribute(
        resample_kernel<Tin, Tout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(resample_kernel<Tin, Tout>,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  }();
  if (opt_in != cudaSuccess) return opt_in;
  const dim3 grid((unsigned)J, (Ho + TV - 1) / TV, (Wo + TU - 1) / TU);
  resample_kernel<Tin, Tout><<<grid, NTHREADS, smem, s>>>(
      static_cast<const Tin*>(src), src_idx, sy, ty, sx, tx, out_idx,
      static_cast<Tout*>(out), K, hs, ws, Ho, Wo);
  return cudaGetLastError();
}

}  // namespace

// src: (n_src, hs, ws) f32 or bf16 (src_bf16); src_idx, sy, ty, sx, tx:
// (J, K); out_idx: (J,) distinct output planes; out: (n_out, Ho, Wo) f32 or
// bf16 (out_bf16).  J sits on grid x and J * K <= 2^31 - 1 (the maps'
// index).  Launches on `stream`; returns the launch's cudaError_t.
extern "C" int banded_resample(const void* src, int src_bf16,
                               const int* src_idx, const float* sy,
                               const float* ty, const float* sx,
                               const float* tx, const int* out_idx, void* out,
                               int out_bf16, int J, int K, int hs, int ws,
                               int Ho, int Wo, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaGetLastError();
  if (src_bf16 && out_bf16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        src, src_idx, sy, ty, sx, tx, out_idx, out, J, K, hs, ws, Ho, Wo, s);
  if (src_bf16)
    return (int)launch<__nv_bfloat16, float>(src, src_idx, sy, ty, sx, tx,
                                             out_idx, out, J, K, hs, ws, Ho,
                                             Wo, s);
  if (out_bf16)
    return (int)launch<float, __nv_bfloat16>(src, src_idx, sy, ty, sx, tx,
                                             out_idx, out, J, K, hs, ws, Ho,
                                             Wo, s);
  return (int)launch<float, float>(src, src_idx, sy, ty, sx, tx, out_idx, out,
                                   J, K, hs, ws, Ho, Wo, s);
}
