// Kernel A: bilinear event binning for the histogram voting backend.
//
// Replaces both binning kernels of dvs_mcemvs_tpu/kernels/binning_pallas.py:
//   bin_events_pallas_windowed (Pallas body _kernel_windowed) -- the row-sorted
//                               form, on grids with hs % 64 == 0;
//   bin_events_pallas          (Pallas body _kernel) -- the dense form, on any
//                               hs % 8 == 0.
// Both compute per group g
//     hist[g, q, p] = sum_e w[g, e] * hat(q - hy[g, e]) * hat(p - hx[g, e]),
// hat(d) = max(0, 1 - |d|), as one-hot matmuls on the TPU's MXU, with the
// group's whole plane summed on chip and cast once at the end.  A scatter
// touches exactly the four taps of an event whatever the row order, so one
// kernel serves both forms, on any hs.
//
// What bounds it on an H100: the event read plus one write of the output.
// At the headline shape (G = 64 groups of E = 16384 events into 64 x 576 x
// 896 bf16 bins) that is 12.6 MB in and 66.1 MB out, 78.6 MB or 0.0235 ms at
// 3.35 TB/s; the four tap products an event are a few operations a byte.
//
// What the design does about it: the sums never leave the chip.  One
// launch per call; one thread-block cluster per (group, band of rows).
// Each of the cluster's C blocks holds R rows of the group's plane, all ws
// columns, as one accumulator array in its dynamic shared memory (a group's
// plane, 2.06 MB of f32 at the headline shape, is larger than one block's
// 227 KB but fits a band of blocks).  A block zeroes its rows, the cluster
// syncs, and the C blocks take the group's 1024-event chunks in turn.  Each
// thread stages its own event of the next chunk with cp.async into a
// two-chunk ring in shared memory while it bins the current one, so the
// event loop has no block barrier and warps run free.  For each nonzero
// tap whose row falls in the band, the thread adds the product into the
// owning block's rows: its own with a shared-memory atomic, a neighbour's
// through the cluster's distributed shared memory (map_shared_rank).  Taps
// outside the band are skipped: an event on a band edge is seen by both
// clusters and each adds only its own taps, so every tap is added once.
// After a second cluster sync each block casts its rows once and writes
// them with 16-byte stores.  No accumulator in device memory, no zeroing
// pass, no cast pass.  The host (kernels/binning.py: plan) chooses R, C and
// the number of bands and passes them in.  C = 1 (no remote adds; every
// block reads all of its group's events, from L2 after the first) measured
// fastest at the headline grid (scripts/tune_binning.py): adds into another
// block's shared memory cost more than the extra event reads save.  An f32
// add to shared memory is a compare-and-swap loop on sm_90a (u32 adds are
// native), which the int8 mode's lower times show.

// Rounding, as the TPU kernels round:
//   f32/bf16 mode: bf16(hat_y * w) * bf16(hat_x), an exact f32 product,
//     accumulated in f32 (in another order than the TPU's, as any atomics
//     add); one cast of the f32 sum to bf16 when a bf16 histogram is asked
//     for.
//   int8 mode: integer taps rint(fl(hat_y * w) * 127) and rint(hat_x * 127)
//     (round half to even, as jnp.round), their product summed exactly in
//     unsigned integers, then one f32 multiply by the constant 1/(127*127)
//     and, for a bf16 histogram, one cast of that f32 value.  An event adds
//     at most 127 * 127 = 16129 to a bin, so 32-bit sums are exact up to
//     266,288 events a group; the host picks 64-bit sums above that.  The
//     TPU kernel sums int32 per 1024-event block and adds the blocks in
//     f32, exact while a bin stays below 2^24 (~1040 full-weight events),
//     so the two agree exactly on any real chunk and the integer sum stays
//     exact beyond it.
// The tap arithmetic uses __fsub_rn/__fmul_rn so nvcc contracts none of it
// into FMAs that the TPU kernels do not have.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kInt8Scale = 1.0f / (127.0f * 127.0f);
constexpr int kThreads = 1024;
// Events a chunk: one a thread.  A ring of kStages chunks of hx, hy, w
// follows the accumulator in shared memory (kernels/binning.py:
// STAGE_BYTES).
constexpr int kChunk = kThreads;
constexpr int kStages = 2;
constexpr int kStageBytes = kStages * 3 * kChunk * (int)sizeof(float);
// Dynamic shared memory a block may use on an H100, and the largest
// portable cluster.
constexpr int kMaxSmem = 232448;
constexpr int kMaxCluster = 8;
constexpr int64_t kMaxGridX = 2147483647;  // blocks on grid x

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
__device__ __forceinline__ void accumulate(unsigned* h, float ay, float ax) {
  atomicAdd(h, (unsigned)((int)ay * (int)ax));  // 0 <= product <= 16129
}
__device__ __forceinline__ void accumulate(unsigned long long* h, float ay,
                                           float ax) {
  atomicAdd(h, (unsigned long long)((int)ay * (int)ax));
}

__device__ __forceinline__ float finish(float v) { return v; }
__device__ __forceinline__ float finish(unsigned v) {
  return __fmul_rn(__uint2float_rn(v), kInt8Scale);
}
__device__ __forceinline__ float finish(unsigned long long v) {
  return __fmul_rn(__ull2float_rn(v), kInt8Scale);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy one float from device memory into shared memory, async.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most kStages - 1 of this thread's copy groups are pending.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Grid (G * C * bands, 1, 1); clusters of (C, 1, 1).  Block x belongs to
// group g = x / (C * bands), and its cluster to band b = (x mod C * bands)
// / C, so no cluster spans two groups.  The cluster of band b holds rows
// [b*C*R, (b+1)*C*R) of group g; its block of rank r holds rows
// [b*C*R + r*R, ... + R), cut at hs, in shared memory.  Groups on grid x
// take any G up to 2^31 - 1 blocks in all (grid y stops at 65,535).
template <typename Taps, typename Acc, typename Out>
__global__ void __launch_bounds__(kThreads, 1)
    bin_events_kernel(const float* __restrict__ hx,
                      const float* __restrict__ hy,
                      const float* __restrict__ w, Out* __restrict__ out,
                      int E, int hs, int ws, int rows, int bands) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int per_group = C * bands;
  const int64_t g = blockIdx.x / per_group;
  const int band_lo = (int)(blockIdx.x - g * per_group - rank) * rows;
  const int band_hi = min(band_lo + C * rows, hs);
  const int row_lo = min(band_lo + rank * rows, hs);
  const int row_hi = min(row_lo + rows, hs);
  const int t = threadIdx.x;
  Acc* acc = reinterpret_cast<Acc*>(smem);
  const int acc_bytes = round16(rows * ws * (int)sizeof(Acc));
  // The ring: kStages slots of (hx, hy, w), each kChunk floats; thread t
  // copies and reads only entry t of a slot, so no barrier guards the ring.
  float* ring = reinterpret_cast<float*>(smem + acc_bytes);

  // The C blocks take the group's chunks in turn: rank, rank + C, ...; the
  // thread's event of chunk k is k * kChunk + t.  The first kStages - 1
  // chunks' copies start before the rows are zeroed.
  const float* ex = hx + g * E;
  const float* ey = hy + g * E;
  const float* ew = w + g * E;
  auto stage = [&](int k, int slot) {
    const int64_t e = (int64_t)k * kChunk + t;
    if (e < E) {
      float* d = ring + slot * 3 * kChunk + t;
      cp_async4(d, ex + e);
      cp_async4(d + kChunk, ey + e);
      cp_async4(d + 2 * kChunk, ew + e);
    }
    cp_async_commit();  // possibly empty: the wait counts groups
  };
  const int n_chunks = (E + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) stage(rank + s * C, s);
  for (int i = t; i < acc_bytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  cluster.sync();  // every block's rows are zero before any add

  int it = 0;
  for (int k = rank; k < n_chunks; k += C, ++it) {
    stage(k + (kStages - 1) * C, (it + kStages - 1) % kStages);
    cp_async_wait_ring();  // this thread's event of chunk k has landed
    const float* cur = ring + (it % kStages) * 3 * kChunk + t;
    const float wt = (int64_t)k * kChunk + t < E ? cur[2 * kChunk] : 0.0f;
    if (wt == 0.0f) continue;  // zero-weight events add nothing
    const float x = cur[0];
    const float y = cur[kChunk];
    const int x0 = (int)floorf(x);
    const int y0 = (int)floorf(y);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int q = y0 + dy;
      if (q < band_lo || q >= band_hi) continue;  // another band's tap
      const float ay = Taps::y(y, q, wt);
      if (ay == 0.0f) continue;
      const int owner = (q - band_lo) / rows;
      const int off = (q - band_lo - owner * rows) * ws;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int p = x0 + dx;
        if (p < 0 || p >= ws) continue;
        const float ax = Taps::x(x, p);
        if (ax == 0.0f) continue;
        if (owner == rank)
          accumulate(acc + off + p, ay, ax);
        else
          accumulate(cluster.map_shared_rank(acc + off + p, owner), ay, ax);
      }
    }
  }
  cluster.sync();  // every add into this block's rows has landed

  // Cast this block's rows once and write them: a contiguous span of out,
  // laid out as the accumulator is.  16-byte stores from the first 16-byte
  // boundary of out; element stores before it and after the last.
  const int n = (row_hi - row_lo) * ws;
  Out* o = out + (g * hs + row_lo) * (int64_t)ws;
  constexpr int V = 16 / sizeof(Out);
  const int head = min(
      n, (int)(((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) /
               sizeof(Out)));
  const int n_vec = (n - head) / V;
  const bool acc_vec = ((head * sizeof(Acc)) & 15) == 0;
  constexpr int PER = 16 / sizeof(Acc);  // accumulator values a 16-byte load
  for (int i = threadIdx.x; i < head; i += kThreads)
    store(o + i, finish(acc[i]));
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const Acc* a = acc + head + v * V;
    Acc vals[V];
    if (acc_vec) {
#pragma unroll
      for (int k = 0; k < V / PER; ++k) {
        const uint4 raw = reinterpret_cast<const uint4*>(a)[k];
        memcpy(vals + k * PER, &raw, 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) vals[k] = a[k];
    }
    Out res[V];
#pragma unroll
    for (int k = 0; k < V; ++k) store(res + k, finish(vals[k]));
    uint4 packed;
    memcpy(&packed, res, 16);
    reinterpret_cast<uint4*>(o + head)[v] = packed;
  }
  for (int i = head + n_vec * V + threadIdx.x; i < n; i += kThreads)
    store(o + i, finish(acc[i]));
}

cudaLaunchConfig_t config(int G, int cluster, int bands, int smem,
                          cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)G * (unsigned)(cluster * bands), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once.
template <typename Taps, typename Acc, typename Out>
cudaError_t opt_in() {
  static const cudaError_t status = cudaFuncSetAttribute(
      bin_events_kernel<Taps, Acc, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return status;
}

// The plan's numbers, as the kernel needs them: smem covers R rows of the
// accumulator and the chunk buffers, within the block's limit.
template <typename Acc>
bool valid(int G, int E, int hs, int ws, int rows, int cluster, int bands,
           int smem) {
  if (G < 1 || E < 1 || hs < 1 || ws < 1 || rows < 1) return false;
  if (cluster < 1 || cluster > kMaxCluster || bands < 1) return false;
  if ((int64_t)G * cluster * bands > kMaxGridX) return false;
  if ((int64_t)rows * cluster * bands < hs) return false;
  const int64_t need = (((int64_t)rows * ws * sizeof(Acc) + 15) & ~15) + kStageBytes;
  return need <= smem && smem <= kMaxSmem;
}

// acc: 0 f32 sums of bf16 taps; 1 u32 and 2 u64 sums of int8 taps.
template <template <typename, typename, typename> class Fn, typename... Args>
int dispatch(int acc, int out_bf16, Args... args) {
  switch (acc * 2 + (out_bf16 ? 1 : 0)) {
    case 0: return Fn<FloatTaps, float, float>::run(args...);
    case 1: return Fn<FloatTaps, float, __nv_bfloat16>::run(args...);
    case 2: return Fn<Int8Taps, unsigned, float>::run(args...);
    case 3: return Fn<Int8Taps, unsigned, __nv_bfloat16>::run(args...);
    case 4: return Fn<Int8Taps, unsigned long long, float>::run(args...);
    case 5: return Fn<Int8Taps, unsigned long long, __nv_bfloat16>::run(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename Taps, typename Acc, typename Out>
struct Launch {
  static int run(const float* hx, const float* hy, const float* w, void* out,
                 int G, int E, int hs, int ws, int rows, int cluster,
                 int bands, int smem, cudaStream_t s) {
    if (!valid<Acc>(G, E, hs, ws, rows, cluster, bands, smem))
      return (int)cudaErrorInvalidValue;
    const cudaError_t o = opt_in<Taps, Acc, Out>();
    if (o != cudaSuccess) return (int)o;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(G, cluster, bands, smem, s, &attr);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, bin_events_kernel<Taps, Acc, Out>, hx, hy, w,
        static_cast<Out*>(out), E, hs, ws, rows, bands);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
};

template <typename Taps, typename Acc, typename Out>
struct MaxClusters {
  static int run(int cluster, int smem, int* result) {
    const cudaError_t o = opt_in<Taps, Acc, Out>();
    if (o != cudaSuccess) return (int)o;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config(1, cluster, 1, smem, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(
        result, bin_events_kernel<Taps, Acc, Out>, &cfg);
  }
};

}  // namespace

// hx, hy, w: (G, E) f32, coordinates clipped to [0, ws-1] / [0, hs-1];
// out: (G, hs, ws) f32 (out_bf16 = 0) or bf16 (out_bf16 = 1), every bin
// written.  bf16 taps summed in f32.  rows, cluster, bands, smem: the host
// plan (kernels/binning.py: plan).  Launches one kernel on `stream`;
// returns its cudaError_t (cudaErrorInvalidValue for a plan the kernel
// cannot obey).
extern "C" int bin_events(const float* hx, const float* hy, const float* w,
                          void* out, int out_bf16, int G, int E, int hs,
                          int ws, int rows, int cluster, int bands, int smem,
                          void* stream) {
  return dispatch<Launch>(0, out_bf16, hx, hy, w, out, G, E, hs, ws, rows,
                          cluster, bands, smem,
                          static_cast<cudaStream_t>(stream));
}

// The int8 mode: w in [0, 1] (checked by the caller); integer taps summed
// in 32-bit (acc64 = 0) or 64-bit (acc64 = 1) integers.  Otherwise as
// bin_events.
extern "C" int bin_events_int8(const float* hx, const float* hy,
                               const float* w, void* out, int out_bf16,
                               int acc64, int G, int E, int hs, int ws,
                               int rows, int cluster, int bands, int smem,
                               void* stream) {
  return dispatch<Launch>(acc64 ? 2 : 1, out_bf16, hx, hy, w, out, G, E, hs,
                          ws, rows, cluster, bands, smem,
                          static_cast<cudaStream_t>(stream));
}

// cudaOccupancyMaxActiveClusters for the instantiation of (acc, out_bf16)
// launched with clusters of `cluster` blocks and `smem` bytes of dynamic
// shared memory a block, into *result.  Returns its cudaError_t.
extern "C" int bin_events_max_active_clusters(int acc, int out_bf16,
                                              int cluster, int smem,
                                              int* result) {
  return dispatch<MaxClusters>(acc, out_bf16, cluster, smem, result);
}
