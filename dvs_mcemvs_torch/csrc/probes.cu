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
//              Measures the cost of a block: `n_blocks` one-warp blocks each
//              compute out = a + 1 on the same small tile (the same values,
//              so the concurrent writes agree).
//   hbm_stream replaces run_f (probe_tpu.py:115, a stream of ~1 MB blocks).
//              Measures device-memory read bandwidth: out = sum_g a[g] in f32,
//              in g order, over (G, n) bf16 read once, 16 bytes per load and
//              several loads in flight per thread.
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

__global__ void block_step_kernel(const float4* __restrict__ a,
                                  float4* __restrict__ out, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float4 v = a[i];
    out[i] = make_float4(__fadd_rn(v.x, 1.0f), __fadd_rn(v.y, 1.0f),
                         __fadd_rn(v.z, 1.0f), __fadd_rn(v.w, 1.0f));
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

// a: (G, n) bf16 as (G, n8) uint4 vectors of 8; out: (n) f32.
__global__ void hbm_stream_kernel(const uint4* __restrict__ a,
                                  float4* __restrict__ out, int G,
                                  int64_t n8) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int g = 0;
  for (; g + 8 <= G; g += 8) {
    uint4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = a[(int64_t)(g + u) * n8 + i];
#pragma unroll
    for (int u = 0; u < 8; ++u) add_bf16x8(acc, v[u]);
  }
  for (; g < G; ++g) add_bf16x8(acc, a[(int64_t)g * n8 + i]);
  out[2 * i] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[2 * i + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
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

// a: (G, n) bf16, n % 8 == 0, 16-byte aligned; out: (n) f32.
extern "C" int hbm_stream(const void* a, float* out, int G, int64_t n,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n8 = n / 8;
  if (n8 > 0) {
    const int threads = 256;
    hbm_stream_kernel<<<(unsigned)((n8 + threads - 1) / threads), threads, 0,
                        s>>>(static_cast<const uint4*>(a),
                             reinterpret_cast<float4*>(out), G, n8);
  }
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
