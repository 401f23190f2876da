// The posed tile schedule, built on the device in one launch.
//
// Replaces no Pallas kernel. The JAX package builds the schedule of a
// camera pose in XLA ops (dvren_tpu/render/posed.py: _mask_full,
// _window_lattice, _run_stats, _pack_offsets, _decode_lanes and
// _build_schedule); the port's torch twin of that build
// (dvren_tpu_torch/render/posed.py::PosedRenderer) materialises every
// intermediate in device memory: int64 keys over every sample, four
// scatter_reduce passes into per-(tile, chunk, slice, lane) bins, a
// searchsorted and dozens of elementwise passes, some 430 launches a
// frame. Here one block builds one 16x16 tile and keeps all of it on the
// chip.
//
// One thread per ray of the tile (256). For each tile:
//   1. the mask: the ray scans the lattice of K steps from the front to
//      its first in-bbox step and from the back to its last, 8 steps a
//      group; the block reduces them to k_enter and the span;
//   2. the window, chunk by chunk (8 steps from k_enter on): each thread
//      computes its ray's 8 samples (depth, cell, mask) and keeps them in
//      registers; the block reduces the chunk's lowest and highest z
//      slice, then each slice's x / y box below ez (per warp and step,
//      the lanes that share a slice reduce with redux.sync and one lane
//      takes the shared-memory integer atomicMin / atomicMax: order-free
//      and exact, so every run is the same bits); warp 0 scans the slices'
//      areas into the exclusive prefix and the run's lanes and steps the
//      host packer's offset recurrence (a run over 128 lanes starts at a
//      bank); every thread then writes its samples' depth and lane words;
//   3. the lane -> cell decode: each of the tile's nb * 128 lanes finds
//      its run (the last non-empty run starting at or before it) and its
//      slice (the last whose prefix is at or below its rank) in shared
//      memory and writes the hostmap and the cell bases.
// The diagnostics (span chunks, largest run, z-slices counted exactly,
// banks needed) reach a (4,) int32 by integer atomicMax.
//
// Bit-equality with the twin: every product and sum is rounded on its own
// (__fmul_rn / __fadd_rn / __fsub_rn: nvcc would contract a * b + c into
// an FMA), in the twin's order ((pos - lo) * inv, then * (n - 1)); the
// floor, clamp and conversion are torch's; the integer arithmetic is
// int32 as the twin's.
//
// Bound on the H100: bytes. The jitter table is read for the mask (at
// most 1024 tiles x 128 steps x 256 rays x 4 B = 134 MB at 512^2) and
// again for the window's rows, the sample words (126 MB),
// the bases, hostmap and ray planes (31 MB) written once: about 0.37 GB a
// frame, 0.11 ms at 3.35 TB/s. The arithmetic (about 55 M sample
// evaluations of a few dozen operations) stays far below the card's rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRays = 256;    // rays (and threads) of a 16x16 tile
constexpr int kChunk = 8;     // lattice steps a chunk
constexpr int kLanes = 128;   // lanes a bank
constexpr int kRows = 16;     // sample rows a chunk (16 rays x 8 steps each)
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

struct BuildConsts {
  int n_tiles, tiles_x, k_max, nc, nb, ez;
  int n[3];             // grid points along x, y, z
  float t_near, t_far, dt, nudge;
  float lo[3], inv[3];
};

// A sample's depth on the lattice: base_t = t_near + k * dt, then
// base_t + jitter * dt, moved inside t_far.
__device__ __forceinline__ float sample_depth(int k, float jt,
                                              const BuildConsts& c,
                                              float* base_t) {
  const float bt = __fadd_rn(c.t_near, __fmul_rn(__int2float_rn(k), c.dt));
  *base_t = bt;
  const float st = __fadd_rn(bt, __fmul_rn(jt, c.dt));
  return st >= c.t_far ? c.nudge : st;
}

// (pos - lo) * inv of one axis: the position in bbox units.
__device__ __forceinline__ float bbox_local(float o, float d, float st,
                                            const BuildConsts& c, int a) {
  const float pos = __fadd_rn(o, __fmul_rn(d, st));
  return __fmul_rn(__fsub_rn(pos, c.lo[a]), c.inv[a]);
}

__device__ __forceinline__ bool inside(float local) {
  return local >= 0.0f && local <= 1.0f;
}

// torch.clamp(torch.floor(local * (n - 1)), 0, n - 2).to(int32)
__device__ __forceinline__ int cell_of(float local, int n) {
  float f = floorf(__fmul_rn(local, __int2float_rn(n - 1)));
  const float hi = __int2float_rn(n - 2);
  f = f < 0.0f ? 0.0f : f;
  f = f > hi ? hi : f;
  return (int)f;
}

__device__ __forceinline__ uint4 pack8(const uint32_t* v) {
  return make_uint4(v[0] | (v[1] << 16), v[2] | (v[3] << 16),
                    v[4] | (v[5] << 16), v[6] | (v[7] << 16));
}

__global__ void __launch_bounds__(kRays, 4)
posed_build_kernel(const float* __restrict__ origins, int64_t o_s0,
                   int64_t o_s1, const float* __restrict__ dirs,
                   int64_t d_s0, int64_t d_s1,
                   const float* __restrict__ jitter,
                   uint16_t* __restrict__ samp, float* __restrict__ base,
                   float* __restrict__ rayt, int* __restrict__ bank0,
                   int* __restrict__ k_enter, int* __restrict__ hostmap,
                   int* __restrict__ diag, const BuildConsts c) {
  extern __shared__ int smem[];
  const int nc = c.nc, ez = c.ez, K = c.k_max;
  int* z0 = smem;                   // (nc) lowest z slice of the chunk
  int* z1 = z0 + nc;                // (nc) highest
  int* offs = z1 + nc;              // (nc) the run's first lane
  int* runl = offs + nc;            // (nc) the run's lanes
  int* sx = runl + nc;              // (nc, ez) x min, then x0 of the box
  int* sex = sx + nc * ez;          // (nc, ez) x max, then its width ex
  int* sy = sex + nc * ez;          // (nc, ez) y min, then y0
  int* sarea = sy + nc * ez;        // (nc, ez) y max, then the box's area
  int* spre = sarea + nc * ez;      // (nc, ez) exclusive lane prefix
  __shared__ int s_kmin, s_kmax, s_cur;

  const int t = blockIdx.x;
  const int r = threadIdx.x;
  const int lane = r & 31;
  for (int i = r; i < nc; i += kRays) {
    z0[i] = kBig;
    z1[i] = -1;
  }
  for (int i = r; i < nc * ez; i += kRays) {
    sx[i] = kBig;
    sex[i] = -1;
    sy[i] = kBig;
    sarea[i] = -1;
  }
  if (r == 0) {
    s_kmin = kBig;
    s_kmax = -1;
    s_cur = 0;
  }

  // the ray: tile t is block (t / tiles_x, t % tiles_x) of the image,
  // ray r its pixel (r / 16, r % 16)
  const int px = (t % c.tiles_x) * 16 + (r & 15);
  const int py = (t / c.tiles_x) * 16 + (r >> 4);
  const int64_t ray = (int64_t)py * (c.tiles_x * 16) + px;
  float o[3], d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    o[a] = origins[ray * o_s0 + a * o_s1];
    d[a] = dirs[ray * d_s0 + a * d_s1];
  }
  // the ray planes: rows (o_x, o_y, o_z, d_x, d_y, d_z) of 256 rays
  float* rt = rayt + (int64_t)t * 6 * kRays;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rt[a * kRays + r] = o[a];
    rt[(3 + a) * kRays + r] = d[a];
  }
  const float* jrow =
      jitter == nullptr ? nullptr : jitter + (int64_t)t * K * kRays + r;
  __syncthreads();

  // 1. the mask over the full lattice: the ray's first in-bbox step from
  // the front, its last from the back, 8 steps a group (K % 8 == 0)
  auto in_box = [&](int k, float jt) {
    float bt;
    const float st = sample_depth(k, jt, c, &bt);
    bool m = bt < c.t_far;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      m = m & inside(bbox_local(o[a], d[a], st, c, a));
    return m;
  };
  auto group_jitter = [&](int g, float* jt) {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      jt[j] = jrow == nullptr ? 0.5f : jrow[(int64_t)(g + j) * kRays];
  };
  int kmin = kBig, kmax = -1;
  for (int g = 0; g < K && kmin == kBig; g += kChunk) {
    float jt[kChunk];
    group_jitter(g, jt);
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (kmin == kBig && in_box(g + j, jt[j])) kmin = g + j;
  }
  for (int g = K - kChunk; kmin != kBig && kmax < 0; g -= kChunk) {
    float jt[kChunk];
    group_jitter(g, jt);
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j)
      if (kmax < 0 && in_box(g + j, jt[j])) kmax = g + j;
  }
  kmin = __reduce_min_sync(kFull, kmin);
  kmax = __reduce_max_sync(kFull, kmax);
  if (lane == 0) {
    atomicMin(&s_kmin, kmin);
    atomicMax(&s_kmax, kmax);
  }
  __syncthreads();
  const int tke = s_kmax >= 0 ? s_kmin : 0;
  if (r == 0) {
    const int span = max(s_kmax + 1 - tke, 0);
    k_enter[t] = tke;
    atomicMax(&diag[0], (span + kChunk - 1) / kChunk);
  }

  // 2. the window, chunk by chunk
  const int row = r >> 4;                 // the ray's sample row
  const int lane0 = (r & 15) * kChunk;    // its first lane in the row
  for (int ch = 0; ch < nc; ++ch) {
    float st[kChunk];
    int ix[kChunk], iy[kChunk], iz[kChunk];   // ix -1: masked out
    int zlo = kBig, zhi = -1;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int kw = tke + ch * kChunk + j;
      const float jt = jrow == nullptr
                           ? 0.5f
                           : (kw < K ? jrow[(int64_t)kw * kRays] : 0.0f);
      float bt;
      st[j] = sample_depth(kw, jt, c, &bt);
      bool m = bt < c.t_far && kw < K;
      int cell[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float local = bbox_local(o[a], d[a], st[j], c, a);
        m = m & inside(local);
        cell[a] = cell_of(local, c.n[a]);
      }
      ix[j] = m ? cell[0] : -1;
      iy[j] = cell[1];
      iz[j] = cell[2];
      if (m) {
        zlo = min(zlo, cell[2]);
        zhi = max(zhi, cell[2]);
      }
    }
    zlo = __reduce_min_sync(kFull, zlo);
    zhi = __reduce_max_sync(kFull, zhi);
    if (lane == 0 && zhi >= 0) {
      atomicMin(&z0[ch], zlo);
      atomicMax(&z1[ch], zhi);
    }
    __syncthreads();
    const int zb = z0[ch] == kBig ? 0 : z0[ch];
    const int box = ch * ez;
    // the slices' x / y boxes: per step, the lanes of one slice together
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int s = ix[j] >= 0 && iz[j] - zb < ez ? iz[j] - zb : -1;
      unsigned pending = __ballot_sync(kFull, s >= 0);
      while (pending) {
        const int lead = __ffs(pending) - 1;
        const int s_lead = __shfl_sync(kFull, s, lead);
        const unsigned grp = __ballot_sync(kFull, s == s_lead);
        if (s == s_lead) {
          const int x_lo = __reduce_min_sync(grp, ix[j]);
          const int x_hi = __reduce_max_sync(grp, ix[j]);
          const int y_lo = __reduce_min_sync(grp, iy[j]);
          const int y_hi = __reduce_max_sync(grp, iy[j]);
          if (lane == lead) {
            atomicMin(&sx[box + s], x_lo);
            atomicMax(&sex[box + s], x_hi);
            atomicMin(&sy[box + s], y_lo);
            atomicMax(&sarea[box + s], y_hi);
          }
        }
        pending &= ~grp;
      }
    }
    __syncthreads();
    // warp 0: the boxes, the exclusive prefix, the run and its offset
    if (r < 32) {
      int carry = 0;
      for (int b = 0; b < ez; b += 32) {
        const int s = b + lane;
        int area = 0;
        if (s < ez) {
          const int x0 = sx[box + s], y0 = sy[box + s];
          const int ex = max(sex[box + s] - x0 + 1, 0);
          const int ey = max(sarea[box + s] - y0 + 1, 0);
          area = ex * ey;
          sx[box + s] = ex > 0 ? x0 : 0;
          sy[box + s] = ey > 0 ? y0 : 0;
          sex[box + s] = ex;
          sarea[box + s] = area;
        }
        int incl = area;
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, sh);
          if (lane >= sh) incl += v;
        }
        if (s < ez) spre[box + s] = carry + incl - area;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) {
        const int n = carry;
        int cur = s_cur;
        if (n > kLanes) cur = (cur + kLanes - 1) / kLanes * kLanes;
        offs[ch] = n > 0 ? cur : 0;
        runl[ch] = n;
        s_cur = cur + n;
        atomicMax(&diag[1], n);
        if (z1[ch] >= 0) atomicMax(&diag[2], z1[ch] - zb + 1);
      }
    }
    __syncthreads();
    // the samples' words: depth hi16, depth lo16, lane | mask << 15
    const int off = offs[ch];
    uint32_t w_hi[kChunk], w_lo[kChunk], w_ln[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool m = ix[j] >= 0;
      const int zrel = iz[j] - zb;
      int rank = 0;
      if (m && zrel < ez) {
        const int q = box + zrel;
        rank = spre[q] + (iy[j] - sy[q]) * sex[q] + (ix[j] - sx[q]);
      }
      const int lidx = m ? off + rank : off;
      const uint32_t bits = __float_as_uint(st[j]);
      w_hi[j] = bits >> 16;
      w_lo[j] = bits & 0xFFFFu;
      w_ln[j] = (uint32_t)(lidx | ((int)m << 15)) & 0xFFFFu;
    }
    uint16_t* dst = samp + ((int64_t)(t * nc + ch) * 3) * kRows * kLanes +
                    row * kLanes + lane0;
    *reinterpret_cast<uint4*>(dst) = pack8(w_hi);
    *reinterpret_cast<uint4*>(dst + kRows * kLanes) = pack8(w_lo);
    *reinterpret_cast<uint4*>(dst + 2 * kRows * kLanes) = pack8(w_ln);
  }

  // 3. the lane -> cell decode
  const int lanes = c.nb * kLanes;
  if (r == 0) atomicMax(&diag[3], (s_cur + kLanes - 1) / kLanes);
  for (int i = r; i < nc; i += kRays)
    bank0[t * nc + i] = min(offs[i] / kLanes, c.nb - 1);
  for (int L = r; L < lanes; L += kRays) {
    int run = -1;
    for (int i = nc - 1; i >= 0; --i) {
      if (runl[i] > 0 && offs[i] <= L) {
        run = i;
        break;
      }
    }
    int g[3] = {0, 0, 0};
    if (run >= 0 && L < offs[run] + runl[run]) {
      const int rin = L - offs[run];
      const int b = run * ez;
      int s = 0;
      for (int i = ez - 1; i >= 0; --i) {
        if (spre[b + i] <= rin) {
          s = i;
          break;
        }
      }
      const int area = sarea[b + s], pre = spre[b + s];
      if (area > 0 && rin >= pre && rin < pre + area) {
        const int q = rin - pre;
        const int ex = max(sex[b + s], 1);
        g[0] = sx[b + s] + q % ex;
        g[1] = sy[b + s] + q / ex;
        g[2] = z0[run] + s;
      }
    }
    hostmap[(int64_t)t * lanes + L] = (g[2] * c.n[1] + g[1]) * c.n[0] + g[0];
    float* bp = base + ((int64_t)t * c.nb + L / kLanes) * 3 * kLanes +
                (L % kLanes);
#pragma unroll
    for (int a = 0; a < 3; ++a) bp[a * kLanes] = __int2float_rn(g[a]);
  }
}

}  // namespace

extern "C" int dvt_posed_build(
    const float* origins, long long o_s0, long long o_s1, const float* dirs,
    long long d_s0, long long d_s1, const float* jitter, uint16_t* samp,
    float* base, float* rayt, int* bank0, int* k_enter, int* hostmap,
    int* diag, int n_tiles, int tiles_x, int k_max, int nc, int nb, int ez,
    int nx, int ny, int nz, float t_near, float t_far, float dt, float nudge,
    float lo_x, float lo_y, float lo_z, float inv_x, float inv_y,
    float inv_z, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(diag, 0, 4 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  BuildConsts c;
  c.n_tiles = n_tiles;
  c.tiles_x = tiles_x;
  c.k_max = k_max;
  c.nc = nc;
  c.nb = nb;
  c.ez = ez;
  c.n[0] = nx; c.n[1] = ny; c.n[2] = nz;
  c.t_near = t_near;
  c.t_far = t_far;
  c.dt = dt;
  c.nudge = nudge;
  c.lo[0] = lo_x; c.lo[1] = lo_y; c.lo[2] = lo_z;
  c.inv[0] = inv_x; c.inv[1] = inv_y; c.inv[2] = inv_z;
  const size_t bytes = (size_t)(4 * nc + 5 * nc * ez) * sizeof(int);
  // the limit is a setting of each device: raised once a device, to the
  // most any launch there has asked for
  constexpr int kDevices = 64;
  static size_t smem_set[kDevices] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (bytes > 48 * 1024 && bytes > smem_set[dev]) {
    err = cudaFuncSetAttribute(posed_build_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = bytes;
  }
  posed_build_kernel<<<n_tiles, kRays, bytes, st>>>(
      origins, o_s0, o_s1, dirs, d_s0, d_s1, jitter, samp, base, rayt, bank0,
      k_enter, hostmap, diag, c);
  return (int)cudaGetLastError();
}
