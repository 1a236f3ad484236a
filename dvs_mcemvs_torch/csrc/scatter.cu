// The exact vote: per-event Eq. 15 transfer, bilinear taps and scatter-add
// into every depth plane, in one pass.
//
// Replaces no TPU kernel: the JAX package's splat_scatter
// (dvs_mcemvs_tpu/ops/voting.py) is an XLA scatter-add.  It was added
// because the port's plain form of the vote (kernels/scatter.py:
// scatter_vote_reference: coefficient copies, int64 corner indices and
// weights stacked per block of planes, then one index_add_ a plane) held
// 83-97 % of the benchmark cells' device time, almost all of it writing and
// reading back (planes x events x 4) tensors.
//
// For event e of packet k = e / P, z0 location (x, y), flat weight w, and
// plane z with the packet's Eq. 15 coefficients (a, bx, by, d) = coef[k, z]:
//     X = (x*a + bx) / d,   Y = (y*a + by) / d,
// and where 0 <= X < W-1 and 0 <= Y < H-1 (decided on the floats, so NaN
// and +-inf vote nowhere) the taps
//     (1-fx)(1-fy) w, fx(1-fy) w, (1-fx)fy w, fx fy w,   fx = X - floor(X),
// are added to out[z, y0, x0], [.., x0+1], [y0+1, x0], [y0+1, x0+1].  Each
// operation is rounded once in float32 in the plain version's order
// (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc contracts none of it into FMAs),
// so each tap's index and weight equal the plain version's to the bit; only
// the order of the atomic sums differs.
//
// What bounds it on an H100: the L2's atomics, not device-memory bytes.  A
// DSEC chunk's camera (E = 1 Mi events, Z = 100 planes of 640 x 480) reads
// 12 MB of events and 1.6 MB of coefficients and writes a 123 MB DSI, 0.04
// ms at 3.35 TB/s, but asks for up to E * Z * 4 = 419 M float adds, each
// performed by the L2 slice that owns its address.
//
// What the design does about it: nothing of size (planes x events) touches
// device memory, the adds stay in L2, and fewer of them go out.  A thread
// holds one event and loops over a slab of planes, reading the packet's
// coefficients as a warp-wide broadcast.  The grid runs event tiles fastest
// and slabs of planes slowest (grid x, then y), so the blocks in flight add
// into one slab of at most 12 MB (kernels/scatter.py: slab_planes), which
// stays in the 50 MB L2: at a DSEC camera of the benchmark, 27 M of the
// 30.7 M voxels take adds, and one slab of all 100 planes measured 3.2 times
// the time of slabs of 10.  A row's two taps go out as one fire-and-forget
// vector reduction where they share an aligned 8 or 16 bytes (the float2
// and float4 atomicAdd of sm_90, zeros beside the pair in 16 bytes), else
// as two scalar ones: 1.25 reductions a row on average instead of 2, 37 %
// less time than scalar reductions there.  A pair of taps of weight 0
// issues none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add_tap(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);  // result unused: a red.global.add.f32
}

// The taps a0 at p[0] and a1 at p[1]: one float2 reduction where p is on 8
// bytes, one float4 reduction of (0, a0, a1, 0) where p is 4 bytes past 16
// (the caller pads the DSI to whole 16 bytes), else two scalar ones.
// Adding 0 leaves a voxel as it is.
__device__ __forceinline__ void add_pair(float* p, float a0, float a1) {
  const unsigned slot = (unsigned)(reinterpret_cast<uintptr_t>(p) >> 2) & 3u;
  if (slot == 0u || slot == 2u) {
    if (a0 != 0.0f || a1 != 0.0f)
      atomicAdd(reinterpret_cast<float2*>(p), make_float2(a0, a1));
  } else if (slot == 1u) {
    if (a0 != 0.0f || a1 != 0.0f)
      atomicAdd(reinterpret_cast<float4*>(p - 1), make_float4(0.0f, a0, a1, 0.0f));
  } else {
    add_tap(p, a0);
    add_tap(p + 1, a1);
  }
}

__global__ void __launch_bounds__(kThreads)
    scatter_vote_kernel(const float2* __restrict__ xy,
                        const float* __restrict__ pw,
                        const float4* __restrict__ coef,
                        float* __restrict__ out, int E, int P, int Z, int H,
                        int W, int slab) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const float w = pw[e];
  if (w == 0.0f) return;  // padding and invalid packets vote nowhere
  const float2 p = xy[e];
  const float4* c = coef + (int64_t)(e / P) * Z;
  const int z_lo = blockIdx.y * slab;
  const int z_hi = min(z_lo + slab, Z);
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  const int64_t hw = (int64_t)H * W;
  for (int z = z_lo; z < z_hi; ++z) {
    const float4 q = __ldg(c + z);  // a, bx, by, d
    const float X = __fdiv_rn(__fadd_rn(__fmul_rn(p.x, q.x), q.y), q.w);
    const float Y = __fdiv_rn(__fadd_rn(__fmul_rn(p.y, q.x), q.z), q.w);
    if (!(X >= 0.0f && X < xmax && Y >= 0.0f && Y < ymax)) continue;
    const int x0 = __float2int_rd(X), y0 = __float2int_rd(Y);
    const float fx = __fsub_rn(X, __int2float_rn(x0));
    const float fy = __fsub_rn(Y, __int2float_rn(y0));
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    float* v = out + z * hw + (int64_t)y0 * W + x0;
    add_pair(v, __fmul_rn(__fmul_rn(gx, gy), w), __fmul_rn(__fmul_rn(fx, gy), w));
    add_pair(v + W, __fmul_rn(__fmul_rn(gx, fy), w), __fmul_rn(__fmul_rn(fx, fy), w));
  }
}

}  // namespace

// Add the votes of E events (xy: E float2, pw: E floats, packets of P
// events) into out, a zeroed (Z, H, W) float32 DSI on 16 bytes and padded
// to a multiple of 16 bytes, with coef the (E / P, Z) float4 table of Eq. 15
// coefficients (a, bx, by, d); `slab` planes a grid row.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int scatter_vote(const void* xy, const void* pw, const void* coef,
                            void* out, int E, int P, int Z, int H, int W,
                            int slab, void* stream) {
  const dim3 grid((E + kThreads - 1) / kThreads, (Z + slab - 1) / slab);
  scatter_vote_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(xy), static_cast<const float*>(pw),
      static_cast<const float4*>(coef), static_cast<float*>(out), E, P, Z, H,
      W, slab);
  return static_cast<int>(cudaGetLastError());
}
