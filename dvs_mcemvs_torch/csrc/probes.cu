// Platform probes: the H100 counterparts of the four Pallas probes of
// scripts/probe_tpu.py, which measure the ceilings a kernel of this repo can
// be bound by.  Each probe computes a defined result, so that it can be held
// against its plain PyTorch version (kernels/probes.py); where the TPU probe
// leaves its output uninitialised, the output starts at zero here.
//
//   smem_copy  replaces run_c (probe_tpu.py:75, VMEM round trip).  Measures
//              shared-memory bandwidth: every thread stages its float4 of
//              `a`, times 1.0001, through shared memory `reps` times per pass
//              and reads it back, 16-byte vector accesses that the compiler
//              must keep: `volatile` PTX loads and stores, which ptxas may
//              neither merge nor drop (plain ld/st.shared of one address are
//              forwarded and the loop collapses, reporting more than the H100
//              SXM's peak of 132 SMs x 128 bytes a clock at 1.98 GHz,
//              33 TB/s).  out = fl(fl(a*1.0001)*1.0001).  What bounds it is
//              that peak, on the SM with the most vectors: so one persistent
//              block an SM owns an even, contiguous slice of the n / 4
//              vectors (kernels.probes.stream_plan, passed by value as
//              hbm_stream's), one vector a thread (a thread takes a second
//              one past 1,024 a slice).  Two blocks an SM were no faster
//              (PERF.md section 6).
//   block_step replaces run_e (probe_tpu.py:95, an empty grid step).
//              Measures the cost of a block: out = a + 1 on a small tile
//              (the TPU probe's 8 x 128), where block b of `n_blocks`
//              one-warp blocks loads and stores the float4 vectors
//              v = b (mod n_blocks).  Every value has one writer, so no L2
//              line takes the stores of many blocks, and blocks past the
//              tile's vectors find nothing to do and retire: the empty step
//              of the TPU probe.  What bounds it is the launch and the block
//              scheduler.  Each lane issues its loads in batches of eight
//              before it stores, so one block over the whole tile waits for
//              one round trip to memory, not eight.
//   hbm_stream replaces run_f (probe_tpu.py:115, a stream of ~1 MB blocks).
//              Measures device-memory read bandwidth: out = sum_g a[g] in
//              f32, in g order from zero, over (G, n) bf16 read once.  What
//              bounds it is HBM3 (3.35 TB/s), reached only with enough bytes
//              in flight on every SM (~25 KB an SM at ~1 us of latency, by
//              Little's law) and the same work on every SM.  So one
//              persistent block an SM owns one contiguous slice of the n8 =
//              n / 8 vectors of 16 bytes, as kernels.probes.stream_plan
//              splits them (lengths differ by at most one; the wrapper
//              passes the plan's starts), and walks it in tiles of up to 512
//              vectors.  One producer thread streams each tile's G rows
//              through a ring of kStages = 4 stages in shared memory with
//              1-D bulk copies (TMA, cp.async.bulk) that complete on an
//              mbarrier a stage, so 4 rows of the slice (7.8 KB each at the
//              probe's shape, 31 KB in all) are in flight whatever the
//              occupancy, and no thread holds a load in registers.  Eight
//              consumer warps add each stage into f32 registers, in g order,
//              release the slot, and write each tile's sums once.  The ring
//              size was chosen by scripts/tune_probes.py (PERF.md section 6).
//   dyn_slice  replaces run_d (probe_tpu.py:138, dynamic-slice traffic).
//              Measures loads at computed row offsets from on-chip memory, the
//              access pattern of the resample kernel's bands: out[r, c] for
//              r < qv sums a[q_k + r, c] over `steps` x `n_offsets` offsets
//              q_k (kernels.probes.offsets, passed by value as byte offsets:
//              the loop does no integer division), in that order; the kernel
//              writes the rows from qv on as zeros.  What bounds it is the
//              SMs' shared-memory port, 128 bytes a clock.  Items are `strip`
//              float4 columns by `band` output rows; one persistent block an
//              SM owns an even slice of them (kernels.probes.stream_plan),
//              stages for each strip its items reach the rows [first row +
//              min q, last row + max q) once, in shared memory, and each
//              thread adds its float4 of output from one volatile 16-byte
//              shared load an offset and step, none merged or hoisted, the
//              next four issued before the current four are added.  A warp
//              reads consecutive 16-byte words (offsets are multiples of 8
//              rows), so no load has a bank conflict.  Items of 2 float4 x 24
//              rows were chosen by scripts/tune_probes.py (PERF.md section
//              6): 784 at the probe's shape, 6 an SM, 288 threads (9 full
//              warps) a block, rows staged as whole 32-byte sectors.
//
// What bounds them: smem_copy and dyn_slice the SMs' shared-memory ports,
// block_step the block scheduler, hbm_stream the HBM3 bandwidth (3.35 TB/s).
// All sums are f32 additions in a fixed order and the products single
// roundings, so every probe equals its plain version exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kScale = 1.0001f;

__device__ __forceinline__ float4 scale4(float4 v) {
  return make_float4(__fmul_rn(v.x, kScale), __fmul_rn(v.y, kScale),
                     __fmul_rn(v.z, kScale), __fmul_rn(v.w, kScale));
}

__device__ __forceinline__ void sts4(unsigned addr, float4 v) {
  asm volatile("st.volatile.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 lds4(unsigned addr) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

constexpr int kMaxThreads = 1024;

// kernels.probes.stream_plan as the starts of its slices: slice i is
// [start[i], start[i + 1]).  Passed by value, as a kernel parameter.
constexpr int kMaxSlices = 256;
struct StreamPlan {
  int64_t start[kMaxSlices + 1];
};

// Block i stages slice i of `plan` (float4 vectors), one vector a thread.
__global__ void __launch_bounds__(kMaxThreads)
    smem_copy_kernel(const float4* __restrict__ a, float4* __restrict__ out,
                     int passes, int reps, const StreamPlan plan) {
  __shared__ float4 tile[kMaxThreads];
  const int end = (int)plan.start[blockIdx.x + 1];
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(&tile[threadIdx.x]));
  for (int i = (int)plan.start[blockIdx.x] + threadIdx.x; i < end;
       i += blockDim.x) {
    const float4 staged = scale4(a[i]);
    float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int pass = 0; pass < passes; ++pass) {
      for (int k = 0; k < reps; ++k) {
        sts4(addr, staged);
        r = lds4(addr);
      }
    }
    out[i] = scale4(r);
  }
}

constexpr int kStepBatch = 8;  // loads a lane has in flight

__device__ __forceinline__ float4 add_one(float4 v) {
  return make_float4(__fadd_rn(v.x, 1.0f), __fadd_rn(v.y, 1.0f),
                     __fadd_rn(v.z, 1.0f), __fadd_rn(v.w, 1.0f));
}

// Block b, lane l: the vectors b + n_blocks * (l + 32 j), j = 0, 1, ...
__global__ void block_step_kernel(const float4* __restrict__ a,
                                  float4* __restrict__ out, int n4) {
  const int64_t stride = 32 * (int64_t)gridDim.x;
  for (int64_t first = blockIdx.x + (int64_t)threadIdx.x * gridDim.x;
       first < n4; first += kStepBatch * stride) {
    float4 v[kStepBatch];
#pragma unroll
    for (int k = 0; k < kStepBatch; ++k)
      if (first + k * stride < n4) v[k] = a[first + k * stride];
#pragma unroll
    for (int k = 0; k < kStepBatch; ++k)
      if (first + k * stride < n4) out[first + k * stride] = add_one(v[k]);
  }
}

__device__ __forceinline__ void add_bf16x8(float* acc, uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    acc[2 * j] = __fadd_rn(acc[2 * j], f.x);
    acc[2 * j + 1] = __fadd_rn(acc[2 * j + 1], f.y);
  }
}

// hbm_stream's ring: kStages tiles of up to kTileVec vectors of 16 bytes
// (8 KiB each, 32 KiB in all: static shared memory, under its 48 KB), one
// producer warp (one thread of it issues the copies) and kConsumerWarps
// warps that add; each consumer thread owns kPerThread vectors of a tile.
constexpr int kStages = 4;
constexpr int kTileVec = 512;
constexpr int kConsumerWarps = 8;
constexpr int kStreamThreads = 32 * (1 + kConsumerWarps);
constexpr int kPerThread = kTileVec / (32 * kConsumerWarps);

// Vectors of the tile that starts `left` vectors before the slice's end.
__device__ __forceinline__ int tile_len(int64_t left) {
  return left < kTileVec ? (int)left : kTileVec;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(bar)
      : "memory");
}

// Arrive and expect `bytes` of asynchronous copies on the barrier.
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 1-D bulk copy (TMA) of `bytes` from global to shared memory, counted
// on the barrier `bar` when it lands.  Addresses and size: multiples of 16.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// a: (G, n8) uint4 vectors of 8 bf16; out: (n8) pairs of float4.  Block i
// sums slice i of `plan`, one block a slice.
__global__ void __launch_bounds__(kStreamThreads, 1)
    hbm_stream_kernel(const uint4* __restrict__ a, float4* __restrict__ out,
                      int G, int64_t n8, const StreamPlan plan) {
  constexpr int S = kStages;
  __shared__ __align__(128) uint4 ring[S * kTileVec];
  __shared__ __align__(8) uint64_t full[S], empty[S];
  const int64_t start = plan.start[blockIdx.x];
  const int64_t len = plan.start[blockIdx.x + 1] - start;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Both roles walk the items (tile t, row g) in the same order; item i
  // uses slot i % S in round i / S.
  if (warp == 0) {
    if (lane != 0) return;
    int slot = 0;
    unsigned round = 0;
    for (int64_t t0 = 0; t0 < len; t0 += kTileVec) {
      const unsigned bytes = 16u * (unsigned)tile_len(len - t0);
      for (int g = 0; g < G; ++g) {
        if (round > 0) mbar_wait(smem_addr(&empty[slot]), (round - 1) & 1);
        const unsigned bar = smem_addr(&full[slot]);
        mbar_arrive_tx(bar, bytes);
        bulk_load(smem_addr(ring + slot * kTileVec), a + g * n8 + start + t0,
                  bytes, bar);
        if (++slot == S) {
          slot = 0;
          ++round;
        }
      }
    }
    return;
  }
  const int c = threadIdx.x - 32;
  int slot = 0;
  unsigned round = 0;
  for (int64_t t0 = 0; t0 < len; t0 += kTileVec) {
    const int tile = tile_len(len - t0);
    float acc[kPerThread][8];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.0f;
    for (int g = 0; g < G; ++g) {
      mbar_wait(smem_addr(&full[slot]), round & 1);
      const uint4* stage = ring + slot * kTileVec;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int v = c + k * 32 * kConsumerWarps;
        if (v < tile) add_bf16x8(acc[k], stage[v]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[slot]));
      if (++slot == S) {
        slot = 0;
        ++round;
      }
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int v = c + k * 32 * kConsumerWarps;
      if (v < tile) {
        float4* o = out + 2 * (start + t0 + v);
        o[0] = make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        o[1] = make_float4(acc[k][4], acc[k][5], acc[k][6], acc[k][7]);
      }
    }
  }
}

__device__ __forceinline__ float4 add4(float4 acc, float4 v) {
  return make_float4(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y),
                     __fadd_rn(acc.z, v.z), __fadd_rn(acc.w, v.w));
}

// 16 bytes from global to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
               : "memory");
}

// dyn_slice's offsets as byte offsets into a strip's staged rows, and the
// first item of each block (kernels.probes.dyn_slice_plan).  By value.
constexpr int kMaxOffsets = 512;
constexpr int kGroup = 4;  // dyn_slice: loads a thread issues ahead of its adds
struct DynSlicePlan {
  int off[kMaxOffsets];  // (q_k - q_min) * strip * 16
  int start[kMaxSlices + 1];
};

// The outputs of a strip, `strip` float4 a row over qv rows, are numbered
// row by row; strip s's first is s * qv * strip.  Item i is band
// i % n_bands of strip i / n_bands, so a run of items is a run of outputs.
__device__ __forceinline__ int item_output(int i, int n_bands,
                                                    int band, int qv,
                                                    int strip) {
  return (i / n_bands * qv + i % n_bands * band) * strip;
}

// Block b runs items start[b] .. start[b + 1] - 1, `batch` at a time.  A
// batch is the outputs [o0, o1) over strips s0 .. s0 + n_seg - 1; for each
// strip it stages the rows [lo + q_min, hi + q_min + span) that its rows
// [lo, hi) reach, one segment after the other, so that thread t, which
// owns output o0 + t of segment s, reads its offset k at float4
// t + s * span * strip + (q_k - q_min) * strip.  kernels.probes.DynSlicePlan
// states the same rule (`staged`) to size the shared memory it passes.
__global__ void __launch_bounds__(kMaxThreads)
    dyn_slice_kernel(const float* __restrict__ a, float* __restrict__ out,
                     int H, int W, int qv, int steps, int n_off, int strip,
                     int band, int n_bands, int q_min, int span, int batch,
                     const DynSlicePlan plan) {
  extern __shared__ __align__(16) float4 slots[];
  const int W4 = (W + 3) / 4;
  const bool vec = W % 4 == 0;  // every row starts on 16 bytes
  const int per_strip = qv * strip, t = threadIdx.x;
  const int i0 = plan.start[blockIdx.x], i1 = plan.start[blockIdx.x + 1];
  // Rows from qv on are zero; every block writes its share, once.
  {
    const int64_t first = (int64_t)qv * W, n = (int64_t)(H - qv) * W;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + t;
    if (vec) {
      float4* o = reinterpret_cast<float4*>(out + first);
      for (int64_t k = i; k < n / 4; k += stride)
        o[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int64_t k = i; k < n; k += stride) out[first + k] = 0.0f;
    }
  }
  for (int b0 = i0; b0 < i1; b0 += batch) {
    const int o0 = item_output(b0, n_bands, band, qv, strip);
    const int o1 = item_output(min(b0 + batch, i1), n_bands, band, qv, strip);
    const int s0 = o0 / per_strip, n_seg = (o1 - 1) / per_strip - s0 + 1;
    // Stage: segment by segment, thread t copies float4 t % strip of every
    // (blockDim / strip)-th row.
    const int pass = blockDim.x / strip, cc = t % strip;
    int slot = 0;  // the segment's first float4 in shared memory
    for (int s = 0; s < n_seg; ++s) {
      const int lo = s == 0 ? o0 % per_strip / strip : 0;
      const int hi = s == n_seg - 1 ? (o1 - 1) % per_strip / strip + 1 : qv;
      const int c4 = (s0 + s) * strip + cc, rows = hi - lo + span;
      const float* src = a + (int64_t)(lo + q_min) * W + 4 * c4;
      float4* dst = slots + slot + cc;
      for (int row = t / strip; t < pass * strip && c4 < W4 && row < rows;
           row += pass) {
        if (vec) {
          cp_async16(smem_addr(dst + row * strip), src + (int64_t)row * W);
        } else {
          const float* g = src + (int64_t)row * W;
          float e[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) e[k] = 4 * c4 + k < W ? g[k] : 0.0f;
          dst[row * strip] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
      slot += rows * strip;
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const int o = o0 + t, s = o / per_strip - s0, c = o % strip;
    const int row = o % per_strip / strip, c4 = (s0 + s) * strip + c;
    if (o < o1 && c4 < W4) {
      const unsigned base = smem_addr(slots + t + s * span * strip);
      // The steps x n_off terms in order, offset k wrapping at n_off; the
      // loads of the next kGroup terms are issued before the adds of the
      // current ones, so a warp keeps up to 2 kGroup loads in flight.
      const int n_terms = steps * n_off;
      int k = 0;
      auto next = [&]() {
        const float4 v = lds4(base + plan.off[k]);
        k = k + 1 == n_off ? 0 : k + 1;
        return v;
      };
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f), cur[kGroup];
      int i = 0;
      if (n_terms >= kGroup) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) cur[g] = next();
        for (i = kGroup; i + kGroup <= n_terms; i += kGroup) {
          float4 nxt[kGroup];
#pragma unroll
          for (int g = 0; g < kGroup; ++g) nxt[g] = next();
#pragma unroll
          for (int g = 0; g < kGroup; ++g) {
            acc = add4(acc, cur[g]);
            cur[g] = nxt[g];
          }
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) acc = add4(acc, cur[g]);
      }
      for (; i < n_terms; ++i) acc = add4(acc, next());
      float* dst = out + (int64_t)row * W + 4 * c4;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = acc;
      } else {
        const float e[4] = {acc.x, acc.y, acc.z, acc.w};
        for (int k = 0; k < 4 && 4 * c4 + k < W; ++k) dst[k] = e[k];
      }
    }
    __syncthreads();  // the next batch overwrites the slots
  }
}

}  // namespace

// a, out: n floats, n % 4 == 0, 16-byte aligned.  passes, reps >= 1.
// starts: n_slices + 1 offsets in float4 vectors, from 0 to n / 4, increasing
// (kernels.probes.stream_plan); one block a slice, as many threads as the
// longest slice has vectors (rounded up to a warp, at most 1,024).
extern "C" int smem_copy(const float* a, float* out, int n, int passes,
                         int reps, int n_slices, const int64_t* starts,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n4 = n / 4;
  if (n4 < 1) return (int)cudaGetLastError();
  if (n_slices < 1 || n_slices > kMaxSlices || starts[0] != 0 ||
      starts[n_slices] != n4)
    return (int)cudaErrorInvalidValue;
  StreamPlan plan;
  int64_t longest = 0;
  for (int i = 0; i <= n_slices; ++i) {
    if (i > 0 && starts[i] <= starts[i - 1]) return (int)cudaErrorInvalidValue;
    if (i > 0) longest = std::max(longest, starts[i] - starts[i - 1]);
    plan.start[i] = starts[i];
  }
  const int threads =
      (int)std::min<int64_t>(kMaxThreads, (longest + 31) / 32 * 32);
  smem_copy_kernel<<<n_slices, threads, 0, s>>>(
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(out),
      passes, reps, plan);
  return (int)cudaGetLastError();
}

// a, out: n floats, n % 4 == 0, 16-byte aligned; n_blocks one-warp blocks.
extern "C" int block_step(const float* a, float* out, int n, int n_blocks,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && n_blocks > 0)
    block_step_kernel<<<n_blocks, 32, 0, s>>>(
        reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(out),
        n / 4);
  return (int)cudaGetLastError();
}

// a: (G, n) bf16, n % 8 == 0, 16-byte aligned; out: (n) f32.  starts:
// n_slices + 1 offsets in vectors of 8 values, from 0 to n / 8, increasing
// (kernels.probes.stream_plan); one block a slice.
extern "C" int hbm_stream(const void* a, float* out, int G, int64_t n,
                          int n_slices, const int64_t* starts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n8 = n / 8;
  if (G < 1 || n8 < 1) return (int)cudaGetLastError();
  if (n_slices < 1 || n_slices > kMaxSlices || starts[0] != 0 ||
      starts[n_slices] != n8)
    return (int)cudaErrorInvalidValue;
  StreamPlan plan;
  for (int i = 0; i <= n_slices; ++i) {
    if (i > 0 && starts[i] <= starts[i - 1]) return (int)cudaErrorInvalidValue;
    plan.start[i] = starts[i];
  }
  hbm_stream_kernel<<<n_slices, kStreamThreads, 0, s>>>(
      static_cast<const uint4*>(a), reinterpret_cast<float4*>(out), G, n8, plan);
  return (int)cudaGetLastError();
}

// a, out: (H, W) f32, 16-byte aligned; 0 < qv < H, W > 0, steps >= 1.
// offsets: n_offsets row offsets q in [0, H - qv].  strip, band: an item's
// float4 columns and output rows; batch: items a block stages at once;
// smem_bytes: the most a batch stages; starts: n_blocks + 1 item indices
// from 0 to the item count, increasing (kernels.probes.dyn_slice_plan,
// which sizes smem_bytes by the kernel's staging rule).  One launch writes
// every value of `out`.
extern "C" int dyn_slice(const float* a, float* out, int H, int W, int qv,
                         int steps, int n_offsets, const int* offsets,
                         int strip, int band, int batch, int smem_bytes,
                         int n_blocks, const int* starts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kMaxSmem = 232448;  // 227 KB, what a block may use
  if (W < 1 || qv < 1 || qv >= H || steps < 1 || n_offsets < 1 ||
      n_offsets > kMaxOffsets || (int64_t)steps * n_offsets > INT32_MAX ||
      strip < 1 || band < 1 || band > qv || batch < 1 || n_blocks < 1 ||
      n_blocks > kMaxSlices || smem_bytes < 16 || smem_bytes > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int q_min = H, q_max = 0;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] < 0 || offsets[k] > H - qv)
      return (int)cudaErrorInvalidValue;
    q_min = std::min(q_min, offsets[k]);
    q_max = std::max(q_max, offsets[k]);
  }
  const int span = q_max - q_min, n_bands = (qv + band - 1) / band;
  const int n_items = ((W + 3) / 4 + strip - 1) / strip * n_bands;
  const int threads = (batch * strip * band + 31) / 32 * 32;
  if (threads > kMaxThreads || starts[0] != 0 || starts[n_blocks] != n_items)
    return (int)cudaErrorInvalidValue;
  DynSlicePlan plan;
  for (int k = 0; k < n_offsets; ++k)
    plan.off[k] = (offsets[k] - q_min) * strip * 16;
  for (int i = 0; i <= n_blocks; ++i) {
    if (i > 0 && starts[i] <= starts[i - 1]) return (int)cudaErrorInvalidValue;
    plan.start[i] = starts[i];
  }
  // Above 48 KB a block's shared memory needs an opt-in, which holds for
  // the current device only: made at each such launch, so that every card
  // of the process has it (it is not a stream operation, so a CUDA graph's
  // capture may include the call).
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dyn_slice_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmem);
    if (err != cudaSuccess) return (int)err;
  }
  dyn_slice_kernel<<<n_blocks, threads, smem_bytes, s>>>(
      a, out, H, W, qv, steps, n_offsets, strip, band, n_bands, q_min, span,
      batch, plan);
  return (int)cudaGetLastError();
}
