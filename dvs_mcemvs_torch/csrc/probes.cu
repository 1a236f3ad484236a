// Platform probes: the H100 counterparts of the four Pallas probes of
// scripts/probe_tpu.py, which measure the ceilings a kernel of this repo can
// be bound by.  Each probe computes a defined result, so that it can be held
// against its plain PyTorch version (kernels/probes.py); where the TPU probe
// leaves its output uninitialised, the output starts at zero here.
//
//   smem_copy  replaces run_c (probe_tpu.py:75, VMEM round trip).  Measures
//              shared-memory bandwidth: every thread stages its four floats
//              of `a`, times 1.0001, through shared memory `reps` times per
//              pass and reads them back, 16-byte vector accesses that the
//              compiler must keep: `volatile` PTX loads and stores, which
//              ptxas may neither merge nor drop (plain ld/st.shared of one
//              address are forwarded and the loop collapses, reporting more
//              than the H100 SXM's peak of 132 SMs x 128 bytes a clock at
//              1.98 GHz, 33 TB/s).  out = fl(fl(a*1.0001)*1.0001).
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
//              Measures loads at computed row offsets, the access pattern of
//              the resample kernel's bands: out[r, c] for r < qv sums
//              a[q_k + r, c] over `steps` x `n_offsets` offsets
//              q_k = ((29 k) mod (H - qv)) / 8 * 8, in that order; rows from qv
//              on stay zero.  The loads are inline PTX inside loops whose trip
//              counts are run-time arguments, so none is merged or hoisted;
//              they are plain cacheable loads, as the resample kernel's are.
//
// What bounds them: smem_copy the SMs' shared-memory ports, block_step the
// block scheduler, hbm_stream the HBM3 bandwidth (3.35 TB/s), dyn_slice the
// L1/L2 load path (`a` is 2 MB and stays in L2).  All sums are f32 additions
// in a fixed order and the products single roundings, so every probe equals
// its plain version exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float ld_keep(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

constexpr int kSmemThreads = 256;

__global__ void smem_copy_kernel(const float4* __restrict__ a,
                                 float4* __restrict__ out, int n4, int passes,
                                 int reps) {
  __shared__ float4 tile[kSmemThreads];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float4 staged = scale4(a[i]);
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(&tile[threadIdx.x]));
  float4 r = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int pass = 0; pass < passes; ++pass) {
    for (int k = 0; k < reps; ++k) {
      sts4(addr, staged);
      r = lds4(addr);
    }
  }
  out[i] = scale4(r);
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

// kernels.probes.stream_plan as the starts of its slices: slice i is
// [start[i], start[i + 1]).  Passed by value, as a kernel parameter.
constexpr int kMaxSlices = 256;
struct StreamPlan {
  int64_t start[kMaxSlices + 1];
};

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

// grid (ceil(W / blockDim.x), qv): one thread per output element of the
// first qv rows; out is zeroed by the caller.
__global__ void dyn_slice_kernel(const float* __restrict__ a,
                                 float* __restrict__ out, int H, int W, int qv,
                                 int steps, int n_offsets) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= W) return;
  float acc = 0.0f;
  for (int step = 0; step < steps; ++step) {
    for (int k = 0; k < n_offsets; ++k) {
      const int q = ((k * 29) % (H - qv)) / 8 * 8;
      acc = __fadd_rn(acc, ld_keep(a + (int64_t)(q + r) * W + c));
    }
  }
  out[(int64_t)r * W + c] = acc;
}

}  // namespace

// a, out: n floats, n % 4 == 0, 16-byte aligned.  passes, reps >= 1.
extern "C" int smem_copy(const float* a, float* out, int n, int passes,
                         int reps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n4 = n / 4;
  if (n4 > 0)
    smem_copy_kernel<<<(n4 + kSmemThreads - 1) / kSmemThreads, kSmemThreads, 0,
                       s>>>(reinterpret_cast<const float4*>(a),
                            reinterpret_cast<float4*>(out), n4, passes, reps);
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

// a, out: (H, W) f32, out zeroed; qv < H.
extern "C" int dyn_slice(const float* a, float* out, int H, int W, int qv,
                         int steps, int n_offsets, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W > 0 && qv > 0) {
    const int threads = 128;
    const dim3 grid((W + threads - 1) / threads, qv);
    dyn_slice_kernel<<<grid, threads, 0, s>>>(a, out, H, W, qv, steps,
                                              n_offsets);
  }
  return (int)cudaGetLastError();
}
