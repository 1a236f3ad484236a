// The exact vote: per-event Eq. 15 transfer and bilinear taps into every
// depth plane, gathered by output tile: events binned on the card, each
// tile of a slab of planes summed in shared memory and stored once.
//
// Replaces no TPU kernel: the JAX package's splat_scatter
// (dvs_mcemvs_tpu/ops/voting.py) is an XLA scatter-add.  The port's plain
// form of the vote is kernels/scatter.py: scatter_vote_reference.
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
// the order of the sums differs.
//
// Why a gather: a thread an event that adds its taps with red.global.add
// is bound by the L2's atomic units, ~137 G non-zero taps/s on every
// cell's packets (1.3-2.5 % of the byte bound), while the taps are dense:
// a TUM-VIE camera adds ~1.1 G taps into 92 M voxels, ~12 a voxel.
//
// What the design does about it: each voxel's taps are summed on chip and
// the voxel is stored once, by the one block that owns it.  No global
// atomic touches a voxel, and the DSI needs no zeroing: every voxel is
// written.
//   1. The bin pass (bin_count, bin_scan, bin_scatter): a counting sort of
//      the events by (group of packets, cell of their z0 location), over
//      the grid of all events: counts by global atomics, a scan a group,
//      then each event to the next slot of its (group, cell), written as
//      (x, y, w, k) with CSR offsets per (group, cell).  The bucket pad,
//      zero weights, invalid packets and non-finite locations drop out.
//      The cell grid reaches past the image (kernels/scatter.py:
//      BORDER_SHARE): z0 locations there are common (a camera's
//      overscan), and past the grid they share its border cells, since
//      other planes may still map them onto the image.
//   2. The plan (plan_bounds, plan_cells; kernels/scatter.py: vote_plan is
//      its plain version, in the same float64 operations): for each (slab
//      of planes, group, tile column and row) the range of cells that holds
//      every event whose taps can land in the tile.  Within a packet the
//      map from z0 to a plane is affine, so a tile's preimage is an
//      interval per axis; the plan widens it by a margin, so the forward map
//      alone decides each tap.
//   3. vote_tiles_kernel, one block of 1024 threads an SM, a block a (tile,
//      slab): zeroes the tile's slab x tile_h x pitch floats in shared
//      memory; walks its plan's cells as (group, cell row) segments of
//      consecutive binned events, a batch of segments at a time, one event
//      a thread (a galloping search over the batch's prefix sums finds
//      it); transfers each event into each plane of the slab and adds the
//      taps that land in the tile; then stores the tile with plain
//      coalesced stores, 16 bytes wide where the rows allow.
// What bounds it now: the taps' shared-memory adds.  sm_90 has no native
// shared-memory float add: atomicAdd there compiles to a compare-and-store
// loop (ATOMS.CAST.SPIN), about one tap a clock an SM; on a TUM-VIE camera
// the taps take ~3.3 of the kernel's ~5.7 ms (against plain adds, which
// lose votes), the walk and the transfers the rest.  Hand-written CAS
// loops (32, 64 or 128 bits), red.shared and merging equal voxels in a warp
// (__match_any_sync) measured no faster, or slower.  A row pitch of 5 (mod
// 32) floats spreads a tile column over the banks (5-20 % at 128-wide
// tiles).  Tiles as large as the shared memory allows (128 x 128, 3 planes)
// and the border keep visited event-planes at ~1.4-1.5 a hit.
// Each vote block adds once into a small counter buffer: event-planes
// visited, event-planes with a tap in its tile, and groups whose plan fell
// back to every cell (a packet with a = 0 or a coefficient not finite).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinThreads = 256;
constexpr int kBinUnroll = 4;   // events a thread loads before it bins them
constexpr int kPlanThreads = 256;
constexpr int kVoteThreads = 1024;
// (group, cell row) segments a batch of the vote (kernels/scatter.py:
// SEGMENTS); each thread fills kSegments / kVoteThreads of them.
constexpr int kSegments = 1024;
constexpr int kSegPerThread = kSegments / kVoteThreads;

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32, at
// most 1024); *total gets the block's sum.  `tmp` holds 32 ints.
__device__ int block_scan(int v, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? tmp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) tmp[lane] = t;
  }
  __syncthreads();
  const int before = warp ? tmp[warp - 1] : 0;
  *total = tmp[nw - 1];
  __syncthreads();
  return before + x - v;
}

// The cell of z0 location (x, y) under weight w on a grid that starts
// `border` px before the image, or -1 for an event that votes nowhere (w =
// 0, or x or y not finite).  `inv_cell` is the inverse of a power of two.
__device__ __forceinline__ int cell_of(float x, float y, float w, float inv_cell,
                                       float border, int cw, int ch) {
  if (w == 0.0f || !isfinite(x) || !isfinite(y)) return -1;
  const float cx = fminf(fmaxf(floorf((x + border) * inv_cell), 0.0f), (float)(cw - 1));
  const float cy = fminf(fmaxf(floorf((y + border) * inv_cell), 0.0f), (float)(ch - 1));
  return (int)cy * cw + (int)cx;
}

// Bin pass, 1: each event's (group, cell) counted, the grid over all events.
__global__ void __launch_bounds__(kBinThreads)
    bin_count_kernel(const float2* __restrict__ xy, const float* __restrict__ pw,
                     int* __restrict__ count, int E, int group_events, float inv_cell,
                     float border, int cw, int ch) {
  const int cells = cw * ch;
  const int e0 = blockIdx.x * (kBinThreads * kBinUnroll) + threadIdx.x;
  float2 p[kBinUnroll];
  float w[kBinUnroll];
#pragma unroll
  for (int u = 0; u < kBinUnroll; ++u) {
    const int i = e0 + u * kBinThreads;
    w[u] = i < E ? pw[i] : 0.0f;
    if (i < E) p[u] = xy[i];
  }
#pragma unroll
  for (int u = 0; u < kBinUnroll; ++u) {
    const int c = cell_of(p[u].x, p[u].y, w[u], inv_cell, border, cw, ch);
    if (c >= 0) atomicAdd(count + (int64_t)((e0 + u * kBinThreads) / group_events) * cells + c, 1);
  }
}

// Bin pass, 2: a block a group; its counts to offsets (off, from the group's
// first index on) and to the scatter's cursors (count, in place).
__global__ void __launch_bounds__(kBinThreads)
    bin_scan_kernel(int* __restrict__ count, int* __restrict__ off, int group_events,
                    int cells) {
  __shared__ int tmp[32];
  const int e0 = blockIdx.x * group_events;
  int* n = count + (int64_t)blockIdx.x * cells;
  const int per = (cells + blockDim.x - 1) / blockDim.x;
  const int c0 = min((int)threadIdx.x * per, cells), c1 = min(c0 + per, cells);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += n[c];
  int total;
  int run = e0 + block_scan(sum, tmp, &total);
  int* o = off + (int64_t)blockIdx.x * (cells + 1);
  for (int c = c0; c < c1; ++c) {
    const int k = n[c];
    o[c] = n[c] = run;
    run += k;
  }
  if (threadIdx.x == 0) o[cells] = e0 + total;
}

// Bin pass, 3: each event to the next slot of its (group, cell).
__global__ void __launch_bounds__(kBinThreads)
    bin_scatter_kernel(const float2* __restrict__ xy, const float* __restrict__ pw,
                       int* __restrict__ cursor, float4* __restrict__ binned, int E, int P,
                       int group_events, float inv_cell, float border, int cw, int ch) {
  const int cells = cw * ch;
  const int e0 = blockIdx.x * (kBinThreads * kBinUnroll) + threadIdx.x;
  float2 p[kBinUnroll];
  float w[kBinUnroll];
#pragma unroll
  for (int u = 0; u < kBinUnroll; ++u) {
    const int i = e0 + u * kBinThreads;
    w[u] = i < E ? pw[i] : 0.0f;
    if (i < E) p[u] = xy[i];
  }
#pragma unroll
  for (int u = 0; u < kBinUnroll; ++u) {
    const int e = e0 + u * kBinThreads;
    const int c = cell_of(p[u].x, p[u].y, w[u], inv_cell, border, cw, ch);
    if (c >= 0) {
      const int at = atomicAdd(cursor + (int64_t)(e / group_events) * cells + c, 1);
      binned[at] = make_float4(p[u].x, p[u].y, w[u], __int_as_float(e / P));
    }
  }
}

// The plan (kernels/scatter.py: vote_plan, its plain version, in the same
// float64 operations, each rounded once).  Over the slab's planes and the
// group's packets, x = s * (X - c) + u with s = d / a and u = s * c - b / a
// (b = bx or by, c the image's middle) bounds the z0 locations whose
// transfer lands in a tile's reach [t0 - 1, t1], widened by 1 px and
// MARGIN_REL of the magnitudes; a = 0, d = 0 or s or u not finite (on
// either axis) falls back to every cell.
// Stage 1, a warp a (group, plane): s, u_x and u_y bounded over the
// group's packets, as (s_lo, s_hi, ux_lo, ux_hi, uy_lo, uy_hi, bad).
__global__ void __launch_bounds__(kPlanThreads)
    plan_bounds_kernel(const float4* __restrict__ coef, double* __restrict__ bounds, int K,
                       int Z, int W, int H, int group, int G) {
  const int idx = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (idx >= G * Z) return;  // whole warps
  const int g = idx / Z, z = idx - g * Z;
  const double mid_x = W / 2.0, mid_y = H / 2.0;
  double b[6] = {INFINITY, -INFINITY, INFINITY, -INFINITY, INFINITY, -INFINITY};
  bool bad = false;
  for (int k = g * group + lane; k < min((g + 1) * group, K); k += 32) {
    const float4 q = __ldg(coef + (int64_t)k * Z + z);
    const double a = q.x, d = q.w;
    const double sk = __ddiv_rn(d, a);
    const double ux = __dsub_rn(__dmul_rn(sk, mid_x), __ddiv_rn((double)q.y, a));
    const double uy = __dsub_rn(__dmul_rn(sk, mid_y), __ddiv_rn((double)q.z, a));
    bad = bad || !(isfinite(sk) && isfinite(ux) && isfinite(uy)) || a == 0.0 || d == 0.0;
    b[0] = fmin(b[0], sk); b[1] = fmax(b[1], sk);
    b[2] = fmin(b[2], ux); b[3] = fmax(b[3], ux);
    b[4] = fmin(b[4], uy); b[5] = fmax(b[5], uy);
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 6; i += 2) {
      b[i] = fmin(b[i], __shfl_xor_sync(0xffffffffu, b[i], o));
      b[i + 1] = fmax(b[i + 1], __shfl_xor_sync(0xffffffffu, b[i + 1], o));
    }
  }
  bad = __any_sync(0xffffffffu, bad);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) bounds[(int64_t)idx * 7 + i] = b[i];
    bounds[(int64_t)idx * 7 + 6] = bad ? 1.0 : 0.0;
  }
}

// Stage 2, a thread a (slab, group, axis, tile column or row): the cells.
__global__ void __launch_bounds__(kPlanThreads)
    plan_cells_kernel(const double* __restrict__ bounds, int2* __restrict__ xr,
                      int2* __restrict__ yr, int* __restrict__ fb, int Z, int W, int H,
                      int tile_w, int tile_h, int slab, double cell, double border, int cw,
                      int ch, int G, int NS, double margin_rel) {
  const int ntx = (W + tile_w - 1) / tile_w, nty = (H + tile_h - 1) / tile_h;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)NS * G * (ntx + nty)) return;
  const int jj = (int)(idx % (ntx + nty));
  const int sg = (int)(idx / (ntx + nty)), g = sg % G, s = sg / G;
  const bool ax = jj >= ntx;  // false: columns (x), true: rows (y)
  const int j = ax ? jj - ntx : jj, tile = ax ? tile_h : tile_w, size = ax ? H : W;
  const double mid = size / 2.0, top = size - 1;
  const double x_lo = __dsub_rn(fmax((double)j * tile - 1.0, 0.0), mid);
  const double x_hi = __dsub_rn(fmin((double)(j + 1) * tile, top), mid);
  const double reach = __dadd_rn(__dadd_rn(fmax(fabs(x_lo), fabs(x_hi)), 2.0 * mid), top);
  double lo = INFINITY, hi = -INFINITY;
  bool bad = false;
  for (int z = s * slab; z < min((s + 1) * slab, Z); ++z) {
    const double* b = bounds + ((int64_t)g * Z + z) * 7;
    bad = bad || b[6] != 0.0;
    const double s_lo = b[0], s_hi = b[1], u_lo = b[ax ? 4 : 2], u_hi = b[ax ? 5 : 3];
    const double e0 = __dmul_rn(s_lo, x_lo), e1 = __dmul_rn(s_lo, x_hi);
    const double e2 = __dmul_rn(s_hi, x_lo), e3 = __dmul_rn(s_hi, x_hi);
    const double mag = __dadd_rn(__dmul_rn(fmax(fabs(s_lo), fabs(s_hi)), reach),
                                 fmax(fabs(u_lo), fabs(u_hi)));
    const double margin = __dadd_rn(1.0, __dmul_rn(margin_rel, mag));
    lo = fmin(lo, __dsub_rn(__dadd_rn(fmin(fmin(e0, e1), fmin(e2, e3)), u_lo), margin));
    hi = fmax(hi, __dadd_rn(__dadd_rn(fmax(fmax(e0, e1), fmax(e2, e3)), u_hi), margin));
  }
  const int last = ax ? ch - 1 : cw - 1;
  int2 r = make_int2(0, last);
  if (!bad) {
    r.x = (int)fmin(fmax(floor(__ddiv_rn(__dadd_rn(lo, border), cell)), 0.0), (double)last);
    r.y = (int)fmin(fmax(floor(__ddiv_rn(__dadd_rn(hi, border), cell)), 0.0), (double)last);
  }
  if (ax) yr[(int64_t)sg * nty + j] = r; else xr[(int64_t)sg * ntx + j] = r;
  if (jj == 0) fb[s * G + g] = bad ? 1 : 0;
}

__device__ __forceinline__ void add_tap(float* p, float v) {
  if (v != 0.0f) atomicAdd(p, v);  // shared memory: ATOMS.CAST.SPIN on sm_90
}

__global__ void __launch_bounds__(kVoteThreads, 1)
    vote_tiles_kernel(const float4* __restrict__ ev, const int* __restrict__ off,
                      const int2* __restrict__ xr, const int2* __restrict__ yr,
                      const int* __restrict__ fb, const float4* __restrict__ coef,
                      float* __restrict__ out, unsigned long long* __restrict__ counts,
                      int K, int Z, int H, int W, int G, int cw, int ch, int tile_w,
                      int tile_h, int pitch, int slab) {
  extern __shared__ __align__(16) float acc[];  // slab x tile_h x pitch
  __shared__ int seg_start[kSegments];
  __shared__ int seg_pref[kSegments];
  __shared__ int tmp[32];
  __shared__ unsigned long long tally[3];
  const int ns = (Z + slab - 1) / slab, ntx = (W + tile_w - 1) / tile_w;
  const int nty = (H + tile_h - 1) / tile_h;
  // Slabs run fastest: the blocks in flight read one tile's events.
  const int s = blockIdx.x % ns, t = blockIdx.x / ns;
  const int ti = t / ntx, tj = t - ti * ntx;
  const int tx0 = tj * tile_w, ty0 = ti * tile_h;
  const int tw = min(tile_w, W - tx0), th = min(tile_h, H - ty0);
  const int z_lo = s * slab, nz = min(slab, Z - z_lo);
  const int plane = pitch * tile_h;
  for (int i = threadIdx.x; i < slab * plane; i += blockDim.x) acc[i] = 0.0f;
  if (threadIdx.x < 3) tally[threadIdx.x] = 0ull;
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  const int64_t cells1 = (int64_t)cw * ch + 1;
  const int gb = max(1, kSegments / ch);  // groups a batch
  unsigned long long visits = 0ull, hits = 0ull, fallbacks = 0ull;
  for (int g0 = 0; g0 < G; g0 += gb) {
    const int slots = min(gb, G - g0) * ch;
    int start[kSegPerThread], len[kSegPerThread], sum = 0;
#pragma unroll
    for (int i = 0; i < kSegPerThread; ++i) {
      const int slot = threadIdx.x * kSegPerThread + i;
      start[i] = 0;
      len[i] = 0;
      if (slot < slots) {
        const int gl = slot / ch, cy = slot - gl * ch;
        const int pg = s * G + g0 + gl;
        const int2 yy = yr[(int64_t)pg * nty + ti];
        if (cy >= yy.x && cy <= yy.y) {
          const int2 xx = xr[(int64_t)pg * ntx + tj];
          const int* o = off + (g0 + gl) * cells1 + (int64_t)cy * cw;
          start[i] = o[xx.x];
          len[i] = o[xx.y + 1] - start[i];
        }
        if (cy == 0 && fb[pg]) ++fallbacks;
      }
      sum += len[i];
    }
    int total;
    int run = block_scan(sum, tmp, &total);
#pragma unroll
    for (int i = 0; i < kSegPerThread; ++i) {
      const int slot = threadIdx.x * kSegPerThread + i;
      seg_start[slot] = start[i];
      seg_pref[slot] = run;
      run += len[i];
    }
    __syncthreads();
    int lo = 0;
    for (int f = threadIdx.x; f < total; f += blockDim.x) {
      // The segment that holds f: the last slot whose prefix is <= f, at or
      // after the thread's previous one (a galloping search).
      int step = 1;
      while (lo + step < slots && seg_pref[lo + step] <= f) {
        lo += step;
        step <<= 1;
      }
      int hi = min(lo + step, slots);
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (seg_pref[mid] <= f) lo = mid; else hi = mid;
      }
      const float4 e = __ldg(ev + seg_start[lo] + (f - seg_pref[lo]));
      const float w = e.z;
      const float4* c = coef + (int64_t)z_lo * K + __float_as_int(e.w);
      visits += nz;
      for (int zz = 0; zz < nz; ++zz) {
        const float4 q = __ldg(c + (int64_t)zz * K);  // a, bx, by, d
        const float X = __fdiv_rn(__fadd_rn(__fmul_rn(e.x, q.x), q.y), q.w);
        const float Y = __fdiv_rn(__fadd_rn(__fmul_rn(e.y, q.x), q.z), q.w);
        if (!(X >= 0.0f && X < xmax && Y >= 0.0f && Y < ymax)) continue;
        const int x0 = __float2int_rd(X), y0 = __float2int_rd(Y);
        const int lx = x0 - tx0, ly = y0 - ty0;
        if (lx < -1 || lx >= tw || ly < -1 || ly >= th) continue;  // no tap in the tile
        ++hits;
        const float fx = __fsub_rn(X, __int2float_rn(x0));
        const float fy = __fsub_rn(Y, __int2float_rn(y0));
        const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
        const int i0 = zz * plane + ly * pitch + lx;
        if (ly >= 0) {
          if (lx >= 0) add_tap(acc + i0, __fmul_rn(__fmul_rn(gx, gy), w));
          if (lx + 1 < tw) add_tap(acc + i0 + 1, __fmul_rn(__fmul_rn(fx, gy), w));
        }
        if (ly + 1 < th) {
          if (lx >= 0) add_tap(acc + i0 + pitch, __fmul_rn(__fmul_rn(gx, fy), w));
          if (lx + 1 < tw) add_tap(acc + i0 + pitch + 1, __fmul_rn(__fmul_rn(fx, fy), w));
        }
      }
    }
    __syncthreads();
  }
  for (int o = 16; o > 0; o >>= 1) {
    visits += __shfl_down_sync(0xffffffffu, visits, o);
    hits += __shfl_down_sync(0xffffffffu, hits, o);
    fallbacks += __shfl_down_sync(0xffffffffu, fallbacks, o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(tally, visits);
    atomicAdd(tally + 1, hits);
    atomicAdd(tally + 2, fallbacks);
  }
  __syncthreads();
  if (threadIdx.x == 0 && counts != nullptr) {
    atomicAdd(counts, tally[0]);
    atomicAdd(counts + 1, tally[1]);
    atomicAdd(counts + 2, tally[2]);
  }
  // The tile, once: every voxel of the DSI has one owner.
  const int64_t hw = (int64_t)H * W;
  float* dst = out + z_lo * hw + (int64_t)ty0 * W + tx0;
  if (((W | tile_w | pitch) & 3) == 0) {
    const int q = tw >> 2, per = th * q, n = nz * per;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int zz = i / per, r = i - zz * per, yy = r / q, xx = (r - yy * q) << 2;
      *reinterpret_cast<float4*>(dst + zz * hw + (int64_t)yy * W + xx) =
          *reinterpret_cast<const float4*>(acc + zz * plane + yy * pitch + xx);
    }
  } else {
    const int per = th * tw, n = nz * per;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int zz = i / per, r = i - zz * per, yy = r / tw, xx = r - yy * tw;
      dst[zz * hw + (int64_t)yy * W + xx] = acc[zz * plane + yy * pitch + xx];
    }
  }
}

}  // namespace

// Bin pass: the E events (xy: E float2, pw: E floats, packets of P events)
// of each group of `group_events` consecutive events, by the cell of their
// z0 location (cells of 1 / inv_cell px, cw x ch of them from `border` px
// before the image), into binned (E float4: x, y, w, packet index as int
// bits; each group's events from its first index on) and off (groups x (cw
// * ch + 1) ints: each (group, cell)'s first binned index, then the group's
// end); count, groups x cw * ch ints, is scratch.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int scatter_bin(const void* xy, const void* pw, void* binned, void* off,
                           void* count, int E, int P, int group_events, float inv_cell,
                           float border, int cw, int ch, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (E + group_events - 1) / group_events, cells = cw * ch;
  const int blocks = (E + kBinThreads * kBinUnroll - 1) / (kBinThreads * kBinUnroll);
  cudaMemsetAsync(count, 0, (size_t)groups * cells * sizeof(int), st);
  bin_count_kernel<<<blocks, kBinThreads, 0, st>>>(
      static_cast<const float2*>(xy), static_cast<const float*>(pw), static_cast<int*>(count),
      E, group_events, inv_cell, border, cw, ch);
  bin_scan_kernel<<<groups, kBinThreads, 0, st>>>(static_cast<int*>(count),
                                                  static_cast<int*>(off), group_events, cells);
  bin_scatter_kernel<<<blocks, kBinThreads, 0, st>>>(
      static_cast<const float2*>(xy), static_cast<const float*>(pw), static_cast<int*>(count),
      static_cast<float4*>(binned), E, P, group_events, inv_cell, border, cw, ch);
  return static_cast<int>(cudaGetLastError());
}

// Plan: xr, yr and fb as the vote pass reads them (see scatter_tiles), for
// coef, the (K, Z) float4 table of Eq. 15 coefficients; the cell grid of
// `cell` px starts `border` px before the image; bounds, (K / group rounded
// up) x Z x 7 doubles, is scratch.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int scatter_plan(const void* coef, void* xr, void* yr, void* fb, void* bounds,
                            int K, int Z, int H, int W, int tile_w, int tile_h, int slab,
                            int group, int cell, int border, int cw, int ch,
                            double margin_rel, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = (K + group - 1) / group, NS = (Z + slab - 1) / slab;
  plan_bounds_kernel<<<(G * Z * 32 + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      static_cast<const float4*>(coef), static_cast<double*>(bounds), K, Z, W, H, group, G);
  const long long n = (long long)NS * G *
                      ((W + tile_w - 1) / tile_w + (H + tile_h - 1) / tile_h);
  plan_cells_kernel<<<(unsigned)((n + kPlanThreads - 1) / kPlanThreads), kPlanThreads, 0,
                      st>>>(
      static_cast<const double*>(bounds), static_cast<int2*>(xr), static_cast<int2*>(yr),
      static_cast<int*>(fb), Z, W, H, tile_w, tile_h, slab, (double)cell, (double)border, cw,
      ch, G, NS, margin_rel);
  return static_cast<int>(cudaGetLastError());
}

// Vote pass: the binned events of G groups (off as the bin pass wrote it)
// voted with coef, the (K, Z) float4 table of Eq. 15 coefficients (a, bx,
// by, d), into out, a (Z, H, W) float32 DSI that every voxel of which is
// written; tiles of tile_w x tile_h, `slab` planes a block; xr, yr the
// plan's cell ranges ((slabs, G, tile columns) and (slabs, G, tile rows)
// int2, first and last cell), fb its fallbacks ((slabs, G) ints).  counts,
// 3 int64 or null, gains the visits, hits and fallbacks.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int scatter_tiles(const void* binned, const void* off, const void* xr,
                             const void* yr, const void* fb, const void* coef, void* out,
                             void* counts, int K, int Z, int H, int W, int G, int cw, int ch,
                             int tile_w, int tile_h, int pitch, int slab, void* stream) {
  const long long blocks = (long long)((Z + slab - 1) / slab) *
                           ((W + tile_w - 1) / tile_w) * ((H + tile_h - 1) / tile_h);
  const size_t smem = (size_t)slab * pitch * tile_h * sizeof(float);
  cudaFuncSetAttribute(vote_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  vote_tiles_kernel<<<(unsigned)blocks, kVoteThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(binned), static_cast<const int*>(off),
      static_cast<const int2*>(xr), static_cast<const int2*>(yr),
      static_cast<const int*>(fb), static_cast<const float4*>(coef),
      static_cast<float*>(out), static_cast<unsigned long long*>(counts), K, Z, H, W, G,
      cw, ch, tile_w, tile_h, pitch, slab);
  return static_cast<int>(cudaGetLastError());
}
