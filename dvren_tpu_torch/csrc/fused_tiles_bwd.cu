// Fused tile backward (K2): the recompute adjoint of K1 for every ray of
// a tile group, with the table gradient as f32 slot rows (or, for the
// split backward, bank blocks) and, on request, the ray-plane (camera)
// adjoint.
//
// Replaces dvren_tpu/ops/fused_tiles.py::_bwd_kernel (launched by
// _tile_op.bwd_call) for both stencils ("cell", "super") and 1, 4 or 16
// sub-tiles per block, emit "rows16" in f32 form, and for the cell stencil
// emit "banks". Inputs are K1's (see csrc/fused_tiles.cu) plus
//   gs     (T, 5, 16, 16) f32  d(loss)/d(K1 output) per ray
// Outputs:
//   d_rows (T, NB, 128, C) f32   d(bank table), row (t*NB + b)*128 + lane,
//                                column ch*8 + corner (C = 32) or
//                                ch*27 + vertex (C = 108); zeroed here.
//                                With emit_banks (cell stencil only) the
//                                bank form (T, NB, 32, 128): element
//                                ((t*NB + b)*32 + col)*128 + lane, the
//                                same values transposed per bank
//   d_rayt (T, 12, 128) f32      d(rayt) in rayt's layout, or null
//   s_pre  (T, nc*8, 256) f32    scratch: each sample's optical-depth prefix
//
// What it computes, and how it differs from the TPU kernel:
// - One block per tile, one thread per ray, as K1. Pass 1 reruns K1's
//   recurrence (sigma only) and stores every sample's exclusive prefix S
//   in the scratch until the ray's transmittance falls to `stop`; from
//   there every step contributes exactly 0, so both passes stop there.
//   The TPU kernel keeps per-chunk planes and prefixes in VMEM; on the
//   card that state (40 KB per chunk) does not fit beside the staging
//   below, so pass 2 re-reads each sample's 32 stencil values instead.
// - Pass 2 walks the chunks and their steps in reverse with a running
//   suffix sum of gw*w (no cancellation, unlike a second forward walk):
//   dod = gw*p - suffix + g_odp, d sigma = dod * tie * dt with JAX's tie
//   0.5 of max(x, 0) at x == 0, d colour = g_c * w.
// - d(table) without float atomics, the same on every run: a tile's bank
//   space belongs to its block alone, so the block sums its chunks in
//   reverse chunk order itself (the cross-tile sum is the gather plan's
//   job, outside). Inside a chunk several rays hit one slot. Each sample
//   that lands in its sub-tile's 256-slot window is staged in shared
//   memory in sample order (slot, 3 fractions, 4 d-planes: 32 B; 64 KB for
//   2048 samples, compacted by a block scan), so each sub-tile's samples
//   form one range. Sub-tile by sub-tile, warp w owns the window slots s
//   with s % 8 == w and finds them with one ballot per 32 staged samples;
//   for each, in sample order, lane i adds product i (channel i / 8,
//   corner i % 8) into its column of the slot's row of a (256, C) window
//   accumulator in shared memory (32 KB for cells, 108 KB for
//   supercells: that instance runs one block per SM), so every lane works
//   on every sample. Then each touched row is added into its bank row in
//   device memory: the first half of the window into bank b0, then the
//   second into b1 = min(b0+1, nb-1), as the TPU kernel does. The ALIGNED
//   bit (30 of bank0) is ignored. tile_backward_plain sums in this order
//   (fused_tiles.ordered_sums), so the two agree to the last bit.
// - The bank form (BANKS) changes the final adds only. Its window
//   accumulator is slot-major with rows padded to 33 words, and the whole
//   block flushes a window: thread (slot = ray % 128, column parity
//   ray / 128) adds the touched rows' 16 columns into their bank's
//   (col, lane) words, one 128-byte run per warp and column, first half
//   into b0, then second into b1. Each element gets the same adds in the
//   same order as in the rows form (window by window, b0 before b1), so
//   the bank form is the rows form transposed, bit for bit; it costs two
//   block barriers per window.
// - A supercell sample's 27 hat weights have 8 nonzero values, the cell
//   corner weights of the vertices lb + (dx, dy, dz); the other 76
//   columns of its row get exact zeros, which the kernel skips (an
//   accumulator that starts at +0 never changes by adding +-0).
// - The camera adjoint needs the corner values again (differences along
//   each axis, weighted by the other two axes' weights) and chains with
//   kcam = float32(inv*ns) into d(origin) and with st*kcam into
//   d(direction). One thread per ray keeps the six sums in registers. The
//   supercell's hat derivatives reduce to the same 8-corner differences
//   (their other terms are exact zeros).
//
// Bound on the H100: the latency of the stencil reads (8 per sample in
// pass 1, 32 in pass 2, from L1/L2) and the staged scatter's shared-memory
// traffic. Two earlier versions took 12.29 and 10.8 ms over the headline's
// 14 launches on the H100 (700 W): one let thread s alone sum slot s's
// samples (one lane of 32 busy per sample), the other gave warp w the
// slots 32w .. 32w+31, so the few warps that own a chunk's run of cells
// did nearly all of its additions one sample at a time. Passes 1 and 2
// without the scatter take 1.2 ms; one list of staged samples per warp,
// in place of the ballots, was slower (6.5 ms against 5.7).
//
// Arithmetic runs in the plain twin's order with explicit _rn intrinsics
// (no FMA contraction), so per-sample values equal
// fused_tiles.tile_backward_plain's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSteps = 8;
constexpr int kNch = 32;
constexpr int kRays = 256;
constexpr int kWarps = kRays / 32;
constexpr int kChunkSamples = 2048;
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory: the staged samples (slot, 3 fractions, 4
// d-planes per sample) and the window's (256, C) accumulator
template <bool SUPER, bool BANKS>
constexpr int smem_bytes() {
  return (8 * kChunkSamples + 2 * kLanes * ((SUPER ? 108 : kNch) + BANKS)) * 4;
}

struct TileConsts {
  int nc, nb, k_max;
  float dt, t_near, t_far, t_stop, stop;
  float lo[3], inv[3], ns[3], kcam[3];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// The trilinear fractions of a sample at ray parameter st in its slot;
// `lb` the cell in its supercell (all 0 for the cell stencil), added to
// the slot's base exactly.
template <bool SUPER>
__device__ __forceinline__ void fractions(const float o[3], const float d[3],
                                          float st, const float* cbase,
                                          int slot, const int lb[3],
                                          const TileConsts& k,
                                          float frac[3]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float p = add(o[ax], mul(d[ax], st));
    const float local = mul(sub(p, k.lo[ax]), k.inv[ax]);
    float cb = cbase[ax * kLanes + slot];
    if (SUPER) cb = add(cb, (float)lb[ax]);
    frac[ax] = sub(mul(local, k.ns[ax]), cb);
  }
}

// Corner weights (wz * wy) * wx in packed-corner order dz*4 + dy*2 + dx.
__device__ __forceinline__ void corner_weights(const float frac[3],
                                               float w8[8]) {
  float w[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    w[ax][0] = sub(1.f, frac[ax]);
    w[ax][1] = frac[ax];
  }
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    w8[corner] = mul(mul(w[2][corner >> 2], w[1][(corner >> 1) & 1]),
                     w[0][corner & 1]);
  }
}

// The column within a channel of each corner: the corner itself (cells)
// or the supercell vertex lb + (dx, dy, dz).
template <bool SUPER>
__device__ __forceinline__ int corner_col(int corner, const int lb[3]) {
  if (!SUPER) return corner;
  return (lb[2] + (corner >> 2)) * 9 + (lb[1] + ((corner >> 1) & 1)) * 3
         + (lb[0] + (corner & 1));
}

// The window slot of a tile-local lane: (clipped slot, second bank?).
__device__ __forceinline__ int window_slot(int idx2, bool* second) {
  *second = idx2 >= kLanes;
  return *second ? min(max(idx2 - kLanes, 0), kLanes - 1)
                 : min(max(idx2, 0), kLanes - 1);
}

// The window accumulator's row of window slot r * 8 + warp: warp-major
// (warp, r) for the rows form, slot-major with rows padded to kCols + 1
// words for the bank form, whose flush reads it slot by slot.
template <int kCols, bool BANKS>
__device__ __forceinline__ float* acc_row(float* win_acc, int warp, int r) {
  return BANKS ? win_acc + (r * 8 + warp) * (kCols + 1)
               : win_acc + (warp * 32 + r) * kCols;
}

// The bank form's flush of one window (cell stencil): every warp has
// summed its rows; thread (slot, column parity) adds window rows slot and
// 128 + slot, where touched, into banks b0 and b1 at (col, lane) and
// zeroes them. One thread does both halves of a slot, so an element both
// reach (b1 == b0 when the window clamps) gets b0's add first, as in the
// rows form.
__device__ __forceinline__ void flush_banks(float* rows_t, float* win_acc,
                                            unsigned* hit_s, unsigned hit,
                                            int b0, int b1, int ray) {
  if ((ray & 31) == 0) hit_s[ray >> 5] = hit;
  __syncthreads();
  const int slot = ray & (kLanes - 1);
  const unsigned owner_hit = hit_s[slot & 7];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!((owner_hit >> (h * 16 + (slot >> 3))) & 1u)) continue;
    float* arow = win_acc + (h * kLanes + slot) * (kNch + 1);
    float* g = rows_t + (int64_t)(h ? b1 : b0) * kNch * kLanes + slot;
#pragma unroll
    for (int col = ray >> 7; col < kNch; col += 2) {
      g[col * kLanes] = add(g[col * kLanes], arow[col]);
      arow[col] = 0.f;
    }
  }
  __syncthreads();
}

template <int SUBS, bool SUPER, bool BANKS>
__global__ void __launch_bounds__(kRays)
tile_backward_kernel(const float* __restrict__ tabs,
                     const uint16_t* __restrict__ samp,
                     const float* __restrict__ base,
                     const float* __restrict__ rayt,
                     const int* __restrict__ ke,
                     const int* __restrict__ bank0,
                     const float* __restrict__ gs,
                     float* __restrict__ d_rows,
                     float* __restrict__ d_rayt,
                     float* __restrict__ s_pre, TileConsts k) {
  static_assert(!(SUPER && BANKS), "the bank form is cell-stencil only");
  constexpr int kCols = SUPER ? 108 : kNch;
  constexpr int kPer = SUPER ? 27 : 8;           // columns per channel
  constexpr unsigned kLaneMask = SUPER ? 0xFFFu : 0x7FFFu;
  constexpr int kSubRays = kRays / SUBS;
  extern __shared__ float stage[];
  int* st_slot = reinterpret_cast<int*>(stage);   // idx2 | lb << 16
  float* st_t = stage + kChunkSamples;        // 3 planes of fractions
  float* st_d = stage + 4 * kChunkSamples;    // 4 d-planes
  float* win_acc = stage + 8 * kChunkSamples; // (256 slots, C columns)
  __shared__ int warp_total[kWarps];
  __shared__ int sub_start[SUBS + 1];         // staged range per sub-tile
  __shared__ unsigned hit_s[kWarps];          // the bank form's touched rows

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  const int warp = ray >> 5;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  const int sub_tile = ray / kSubRays;

  // zero the tile's d(table) block (the first __syncthreads below orders
  // it before any thread adds into it)
  float* rows_t = d_rows + t * k.nb * kLanes * kCols;
  float4* rows4 = reinterpret_cast<float4*>(rows_t);
  for (int i = ray; i < k.nb * kLanes * kCols / 4; i += kRays) {
    rows4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = ray; i < 2 * kLanes * (kCols + BANKS); i += kRays) {
    win_acc[i] = 0.f;
  }

  const float* rt = rayt + t * 12 * kLanes;
  const int half = ray >> 7;
  const int rl = ray & (kLanes - 1);
  float o[3], d[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = rt[(ax * 2 + half) * kLanes + rl];
    d[ax] = rt[((3 + ax) * 2 + half) * kLanes + rl];
  }
  const float* g = gs + t * 5 * kRays + ray;
  const float g_r = g[0], g_g = g[kRays], g_b = g[2 * kRays];
  const float g_wd = g[3 * kRays], g_odp = g[4 * kRays];

  const int ket = ke[t];
  const float t_origin = add(k.t_near, mul((float)ket, k.dt));
  const float t_origin_c = fminf(t_origin, k.t_stop);
  float* spre = s_pre + t * k.nc * kSteps * kRays + ray;   // [q * kRays]
  const int n_steps = k.nc * kSteps;

  // Pass 1: K1's recurrence over sigma; k_stop = the first step whose
  // transmittance is at or below `stop` (every step from there is 0).
  int k_stop = n_steps;
  float s = 0.f;
  for (int c = 0; c < k.nc && k_stop == n_steps; ++c) {
    const int b0 = bank0[(t * k.nc + c) * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, k.nb - 1);
    const uint16_t* sc = samp + (t * k.nc + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;
    for (int j = 0; j < kSteps; ++j) {
      const int q = c * kSteps + j;
      if (!(expf(-s) > k.stop)) {
        k_stop = q;
        break;
      }
      spre[q * kRays] = s;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const bool live = (base_t < k.t_far) && (kk < k.k_max);
      const uint32_t packed = sc[2 * kChunkSamples + j];
      if (!live || !((packed >> 15) & 1u)) continue;   // od == 0
      const float dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
      const float st =
          __uint_as_float(((uint32_t)sc[j] << 16) | sc[kChunkSamples + j]);
      bool second;
      const int slot =
          window_slot((int)(packed & kLaneMask) - b0 * kLanes, &second);
      const int bank = second ? b1 : b0;
      const float* tab = tabs + (t * k.nb + bank) * kCols * kLanes + slot;
      int lb[3] = {0, 0, 0};
      if (SUPER) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) lb[ax] = (packed >> (12 + ax)) & 1u;
      }
      float frac[3], w8[8];
      fractions<SUPER>(o, d, st, base + (t * k.nb + bank) * 3 * kLanes, slot,
                       lb, k, frac);
      corner_weights(frac, w8);
      float sig = mul(w8[0], tab[corner_col<SUPER>(0, lb) * kLanes]);
#pragma unroll
      for (int corner = 1; corner < 8; ++corner) {
        sig = add(sig, mul(w8[corner],
                           tab[corner_col<SUPER>(corner, lb) * kLanes]));
      }
      s = add(s, fmaxf(mul(sig, dta), 0.f));
    }
  }

  // Pass 2: the reverse adjoint, chunk by chunk.
  float carry = 0.f;            // sum of gw * w over the later steps
  float dcam[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const bool cam = d_rayt != nullptr;
  for (int c = k.nc - 1; c >= 0; --c) {
    const int b0 = bank0[(t * k.nc + c) * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, k.nb - 1);
    const uint16_t* sc = samp + (t * k.nc + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;

    // the steps that take part (processed, live, masked in) and those
    // that land in the sub-tile's window of 256 slots
    unsigned proc = 0, scat = 0;
    for (int j = 0; j < kSteps; ++j) {
      const int q = c * kSteps + j;
      if (q >= k_stop) break;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const uint32_t packed = sc[2 * kChunkSamples + j];
      if (base_t < k.t_far && kk < k.k_max && ((packed >> 15) & 1u)) {
        proc |= 1u << j;
        const int idx2 = (int)(packed & kLaneMask) - b0 * kLanes;
        if (idx2 >= 0 && idx2 < 2 * kLanes) scat |= 1u << j;
      }
    }

    // block-wide exclusive scan of the staged counts: positions follow
    // sample order (ray-major, then step), so each sub-tile's samples
    // form one range
    const int cnt = __popc(scat);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int pos0 = incl - cnt;
    int n_stage = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int tw = warp_total[w];
      if (w < warp) pos0 += tw;
      n_stage += tw;
    }
    if (ray % kSubRays == 0) sub_start[sub_tile] = pos0;
    if (ray == 0) sub_start[SUBS] = n_stage;

    for (int j = kSteps - 1; j >= 0; --j) {
      if (!((proc >> j) & 1u)) continue;
      const int q = c * kSteps + j;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const float dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
      const float tcur =
          add(t_origin, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));
      const float mid = add(tcur, mul(0.5f, dta));
      const uint32_t packed = sc[2 * kChunkSamples + j];
      const float st =
          __uint_as_float(((uint32_t)sc[j] << 16) | sc[kChunkSamples + j]);
      const int idx2 = (int)(packed & kLaneMask) - b0 * kLanes;
      bool second;
      const int slot = window_slot(idx2, &second);
      const int bank = second ? b1 : b0;
      const float* tab = tabs + (t * k.nb + bank) * kCols * kLanes + slot;
      int lb[3] = {0, 0, 0};
      if (SUPER) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) lb[ax] = (packed >> (12 + ax)) & 1u;
      }
      float frac[3], w8[8], v[kNch];
      fractions<SUPER>(o, d, st, base + (t * k.nb + bank) * 3 * kLanes, slot,
                       lb, k, frac);
      corner_weights(frac, w8);
#pragma unroll
      for (int ch = 0; ch < 4; ++ch)
#pragma unroll
        for (int corner = 0; corner < 8; ++corner)
          v[ch * 8 + corner] =
              tab[(ch * kPer + corner_col<SUPER>(corner, lb)) * kLanes];
      float pl[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float a = mul(w8[0], v[ch * 8]);
#pragma unroll
        for (int corner = 1; corner < 8; ++corner) {
          a = add(a, mul(w8[corner], v[ch * 8 + corner]));
        }
        pl[ch] = a;
      }

      const float sp = spre[q * kRays];
      const float x = mul(pl[0], dta);
      const float od = fmaxf(x, 0.f);
      const float tb = expf(-sp);
      const float p = expf(-add(sp, od));
      const float w = sub(tb, p);
      const float gw = add(add(add(mul(g_r, pl[1]), mul(g_g, pl[2])),
                               mul(g_b, pl[3])),
                           mul(g_wd, mid));
      const float dod = add(sub(mul(gw, p), carry), g_odp);
      const float tie = x > 0.f ? 1.f : (x < 0.f ? 0.f : 0.5f);
      float dpl[4];
      dpl[0] = mul(mul(dod, tie), dta);
      dpl[1] = mul(g_r, w);
      dpl[2] = mul(g_g, w);
      dpl[3] = mul(g_b, w);
      carry = add(carry, mul(gw, w));

      if ((scat >> j) & 1u) {
        const int pos = pos0 + __popc(scat & ((1u << j) - 1u));
        st_slot[pos] =
            SUPER ? (idx2 | (int)(((packed >> 12) & 7u) << 16)) : idx2;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) st_t[ax * kChunkSamples + pos] = frac[ax];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) st_d[ch * kChunkSamples + pos] = dpl[ch];
      }

      if (cam) {
        float wa[3][2];   // axis weights (1 - frac, frac)
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          wa[ax][0] = sub(1.f, frac[ax]);
          wa[ax][1] = frac[ax];
        }
        float dtx = 0.f, dty = 0.f, dtz = 0.f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float dp = dpl[ch];
          const float* vc = v + ch * 8;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
              dtx = add(dtx, mul(dp, mul(mul(wa[2][dz], wa[1][dy]),
                                         sub(vc[dz * 4 + dy * 2 + 1],
                                             vc[dz * 4 + dy * 2]))));
#pragma unroll
          for (int dz = 0; dz < 2; ++dz)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              dty = add(dty, mul(dp, mul(mul(wa[2][dz], wa[0][dx]),
                                         sub(vc[dz * 4 + 2 + dx],
                                             vc[dz * 4 + dx]))));
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              dtz = add(dtz, mul(dp, mul(mul(wa[1][dy], wa[0][dx]),
                                         sub(vc[4 + dy * 2 + dx],
                                             vc[dy * 2 + dx]))));
        }
        const float dt3[3] = {dtx, dty, dtz};
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          dcam[ax] = add(dcam[ax], mul(dt3[ax], k.kcam[ax]));
          dcam[3 + ax] = add(dcam[3 + ax], mul(mul(dt3[ax], st), k.kcam[ax]));
        }
      }
    }
    __syncthreads();

    // Sub-tile by sub-tile, warp `warp` owns the window slots s with
    // s % 8 == warp (a chunk's run of cells is contiguous, so this spreads
    // it evenly over the warps) and adds their staged samples in sample
    // order into its rows r = s / 8 of the window accumulator. Lane i
    // adds product i = ch*8 + corner of each sample into that corner's
    // column, so each sample keeps all 32 lanes of its warp busy; a
    // supercell sample's 76 columns outside its cell's corners carry
    // exact zeros and are skipped. Then each touched row is added into
    // its bank row: the window's first half (rows 0-15 of every warp)
    // into b0, then its second half (rows 16-31) into b1, the same bank
    // when the window clamps, one coalesced read-modify-write per row,
    // and the row is zeroed for the next window. A bank lane's slots all
    // share one owner warp, so these adds need no block barrier; the
    // supercell's columns move between lanes, so it syncs the warp.
    const int col_ch = lane >> 3, col_corner = lane & 7;
    for (int sb = 0; sb < SUBS; ++sb) {
      const int sb0 = bank0[(t * k.nc + c) * SUBS + sb] & 0x3FFF;
      const int sb1 = min(sb0 + 1, k.nb - 1);
      const int q_end = sub_start[sb + 1];
      unsigned hit = 0;   // rows of this warp that received a sample
      for (int base_q = sub_start[sb]; base_q < q_end; base_q += 32) {
        const int qq = base_q + lane;
        const int sl = qq < q_end ? st_slot[qq] : -1;
        unsigned mine = __ballot_sync(kFull, sl >= 0 && (sl & 7) == warp);
        while (mine) {
          const int b = __ffs(mine) - 1;
          mine &= mine - 1u;
          const int src = base_q + b;
          const int word = __shfl_sync(kFull, sl, b);
          const int r = (word & 0xFFFF) >> 3;
          float w[3][2];
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            const float f = st_t[ax * kChunkSamples + src];
            w[ax][0] = sub(1.f, f);
            w[ax][1] = f;
          }
          const float wc = mul(mul(w[2][col_corner >> 2],
                                   w[1][(col_corner >> 1) & 1]),
                               w[0][col_corner & 1]);
          int lb[3] = {0, 0, 0};
          if (SUPER) {
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) lb[ax] = (word >> (16 + ax)) & 1;
          }
          float* a = acc_row<kCols, BANKS>(win_acc, warp, r) + col_ch * kPer
                     + corner_col<SUPER>(col_corner, lb);
          *a = add(*a, mul(wc, st_d[col_ch * kChunkSamples + src]));
          hit |= 1u << r;
          if (SUPER) __syncwarp();
        }
      }
      if constexpr (BANKS) {
        flush_banks(rows_t, win_acc, hit_s, hit, sb0, sb1, ray);
        continue;
      }
      if (SUPER) __syncwarp();
      float* wacc = acc_row<kCols, false>(win_acc, warp, 0);
      for (int h = 0; h < 2; ++h) {
        unsigned rows_left = hit & (h ? 0xFFFF0000u : 0x0000FFFFu);
        while (rows_left) {
          const int r = __ffs(rows_left) - 1;
          rows_left &= rows_left - 1u;
          const int slot = r * 8 + warp;
          float* gr = rows_t + ((int64_t)(h ? sb1 : sb0) * kLanes
                                + (slot & (kLanes - 1))) * kCols;
#pragma unroll
          for (int col = lane; col < kCols; col += 32) {
            gr[col] = add(gr[col], wacc[r * kCols + col]);
            wacc[r * kCols + col] = 0.f;
          }
        }
      }
      if (SUPER) __syncwarp();
    }
    __syncthreads();   // the staging and sub_start are refilled next chunk
  }

  if (cam) {
    float* out = d_rayt + t * 12 * kLanes;
#pragma unroll
    for (int ax = 0; ax < 6; ++ax) out[ax * kRays + ray] = dcam[ax];
  }
}

// The cell stencil at 16 px keeps its own instance: the original cell
// kernel (one window per chunk, a block barrier after each half of its
// flush); the template ran this form 2.8 % slower on the H100. It adds in
// the same order as the template, so it too equals the twin bit for bit.
template <bool BANKS>
__global__ void __launch_bounds__(kRays)
tile_backward_cell16_kernel(const float* __restrict__ tabs,
                            const uint16_t* __restrict__ samp,
                            const float* __restrict__ base,
                            const float* __restrict__ rayt,
                            const int* __restrict__ ke,
                            const int* __restrict__ bank0,
                            const float* __restrict__ gs,
                            float* __restrict__ d_rows,
                            float* __restrict__ d_rayt,
                            float* __restrict__ s_pre, TileConsts k) {
  extern __shared__ float stage[];
  int* st_slot = reinterpret_cast<int*>(stage);
  float* st_t = stage + kChunkSamples;        // 3 planes of fractions
  float* st_d = stage + 4 * kChunkSamples;    // 4 d-planes
  float* win_acc = stage + 8 * kChunkSamples; // (256 slots, 32 columns)
  __shared__ int warp_total[kWarps];
  __shared__ unsigned hit_s[kWarps];          // the bank form's touched rows
  const int kNoLb[3] = {0, 0, 0};

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  const int warp = ray >> 5;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;

  // zero the tile's d(table) block (the first __syncthreads below orders
  // it before any thread adds into it)
  float* rows_t = d_rows + t * k.nb * kLanes * kNch;
  float4* rows4 = reinterpret_cast<float4*>(rows_t);
  for (int i = ray; i < k.nb * kLanes * kNch / 4; i += kRays) {
    rows4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = ray; i < 2 * kLanes * (kNch + BANKS); i += kRays) {
    win_acc[i] = 0.f;
  }

  const float* rt = rayt + t * 12 * kLanes;
  const int half = ray >> 7;
  const int rl = ray & (kLanes - 1);
  float o[3], d[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = rt[(ax * 2 + half) * kLanes + rl];
    d[ax] = rt[((3 + ax) * 2 + half) * kLanes + rl];
  }
  const float* g = gs + t * 5 * kRays + ray;
  const float g_r = g[0], g_g = g[kRays], g_b = g[2 * kRays];
  const float g_wd = g[3 * kRays], g_odp = g[4 * kRays];

  const int ket = ke[t];
  const float t_origin = add(k.t_near, mul((float)ket, k.dt));
  const float t_origin_c = fminf(t_origin, k.t_stop);
  float* spre = s_pre + t * k.nc * kSteps * kRays + ray;   // [q * kRays]
  const int n_steps = k.nc * kSteps;

  // Pass 1: K1's recurrence over sigma; k_stop = the first step whose
  // transmittance is at or below `stop` (every step from there is 0).
  int k_stop = n_steps;
  float s = 0.f;
  for (int c = 0; c < k.nc && k_stop == n_steps; ++c) {
    const int b0 = bank0[t * k.nc + c] & 0x3FFF;
    const int b1 = min(b0 + 1, k.nb - 1);
    const uint16_t* sc = samp + (t * k.nc + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;
    for (int j = 0; j < kSteps; ++j) {
      const int q = c * kSteps + j;
      if (!(expf(-s) > k.stop)) {
        k_stop = q;
        break;
      }
      spre[q * kRays] = s;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const bool live = (base_t < k.t_far) && (kk < k.k_max);
      const uint32_t packed = sc[2 * kChunkSamples + j];
      if (!live || !((packed >> 15) & 1u)) continue;   // od == 0
      const float dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
      const float st =
          __uint_as_float(((uint32_t)sc[j] << 16) | sc[kChunkSamples + j]);
      bool second;
      const int slot =
          window_slot((int)(packed & 0x7FFFu) - b0 * kLanes, &second);
      const int bank = second ? b1 : b0;
      const float* tab = tabs + (t * k.nb + bank) * kNch * kLanes + slot;
      float frac[3], w8[8];
      fractions<false>(o, d, st, base + (t * k.nb + bank) * 3 * kLanes, slot,
                       kNoLb, k, frac);
      corner_weights(frac, w8);
      float sig = mul(w8[0], tab[0]);
#pragma unroll
      for (int corner = 1; corner < 8; ++corner) {
        sig = add(sig, mul(w8[corner], tab[corner * kLanes]));
      }
      s = add(s, fmaxf(mul(sig, dta), 0.f));
    }
  }

  // Pass 2: the reverse adjoint, chunk by chunk.
  float carry = 0.f;            // sum of gw * w over the later steps
  float dcam[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const bool cam = d_rayt != nullptr;
  for (int c = k.nc - 1; c >= 0; --c) {
    const int b0 = bank0[t * k.nc + c] & 0x3FFF;
    const int b1 = min(b0 + 1, k.nb - 1);
    const uint16_t* sc = samp + (t * k.nc + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;

    // the steps that take part (processed, live, masked in) and those
    // that land in the window's 256 slots
    unsigned proc = 0, scat = 0;
    for (int j = 0; j < kSteps; ++j) {
      const int q = c * kSteps + j;
      if (q >= k_stop) break;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const uint32_t packed = sc[2 * kChunkSamples + j];
      if (base_t < k.t_far && kk < k.k_max && ((packed >> 15) & 1u)) {
        proc |= 1u << j;
        const int idx2 = (int)(packed & 0x7FFFu) - b0 * kLanes;
        if (idx2 >= 0 && idx2 < 2 * kLanes) scat |= 1u << j;
      }
    }

    // block-wide exclusive scan of the staged counts: positions follow
    // sample order (ray-major, then step)
    const int cnt = __popc(scat);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int pos0 = incl - cnt;
    int n_stage = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int tw = warp_total[w];
      if (w < warp) pos0 += tw;
      n_stage += tw;
    }

    for (int j = kSteps - 1; j >= 0; --j) {
      if (!((proc >> j) & 1u)) continue;
      const int q = c * kSteps + j;
      const int kk = ket + q;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const float dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
      const float tcur =
          add(t_origin, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));
      const float mid = add(tcur, mul(0.5f, dta));
      const uint32_t packed = sc[2 * kChunkSamples + j];
      const float st =
          __uint_as_float(((uint32_t)sc[j] << 16) | sc[kChunkSamples + j]);
      const int idx2 = (int)(packed & 0x7FFFu) - b0 * kLanes;
      bool second;
      const int slot = window_slot(idx2, &second);
      const int bank = second ? b1 : b0;
      const float* tab = tabs + (t * k.nb + bank) * kNch * kLanes + slot;
      float frac[3], w8[8], v[kNch];
      fractions<false>(o, d, st, base + (t * k.nb + bank) * 3 * kLanes, slot,
                       kNoLb, k, frac);
      corner_weights(frac, w8);
#pragma unroll
      for (int i = 0; i < kNch; ++i) v[i] = tab[i * kLanes];
      float pl[4];
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        float a = mul(w8[0], v[ch * 8]);
#pragma unroll
        for (int corner = 1; corner < 8; ++corner) {
          a = add(a, mul(w8[corner], v[ch * 8 + corner]));
        }
        pl[ch] = a;
      }

      const float sp = spre[q * kRays];
      const float x = mul(pl[0], dta);
      const float od = fmaxf(x, 0.f);
      const float tb = expf(-sp);
      const float p = expf(-add(sp, od));
      const float w = sub(tb, p);
      const float gw = add(add(add(mul(g_r, pl[1]), mul(g_g, pl[2])),
                               mul(g_b, pl[3])),
                           mul(g_wd, mid));
      const float dod = add(sub(mul(gw, p), carry), g_odp);
      const float tie = x > 0.f ? 1.f : (x < 0.f ? 0.f : 0.5f);
      float dpl[4];
      dpl[0] = mul(mul(dod, tie), dta);
      dpl[1] = mul(g_r, w);
      dpl[2] = mul(g_g, w);
      dpl[3] = mul(g_b, w);
      carry = add(carry, mul(gw, w));

      if ((scat >> j) & 1u) {
        const int pos = pos0 + __popc(scat & ((1u << j) - 1u));
        st_slot[pos] = idx2;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) st_t[ax * kChunkSamples + pos] = frac[ax];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) st_d[ch * kChunkSamples + pos] = dpl[ch];
      }

      if (cam) {
        float wa[3][2];   // axis weights (1 - frac, frac)
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          wa[ax][0] = sub(1.f, frac[ax]);
          wa[ax][1] = frac[ax];
        }
        float dtx = 0.f, dty = 0.f, dtz = 0.f;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float dp = dpl[ch];
          const float* vc = v + ch * 8;
#pragma unroll
          for (int dz = 0; dz < 2; ++dz)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy)
              dtx = add(dtx, mul(dp, mul(mul(wa[2][dz], wa[1][dy]),
                                         sub(vc[dz * 4 + dy * 2 + 1],
                                             vc[dz * 4 + dy * 2]))));
#pragma unroll
          for (int dz = 0; dz < 2; ++dz)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              dty = add(dty, mul(dp, mul(mul(wa[2][dz], wa[0][dx]),
                                         sub(vc[dz * 4 + 2 + dx],
                                             vc[dz * 4 + dx]))));
#pragma unroll
          for (int dy = 0; dy < 2; ++dy)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
              dtz = add(dtz, mul(dp, mul(mul(wa[1][dy], wa[0][dx]),
                                         sub(vc[4 + dy * 2 + dx],
                                             vc[dy * 2 + dx]))));
        }
        const float dt3[3] = {dtx, dty, dtz};
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          dcam[ax] = add(dcam[ax], mul(dt3[ax], k.kcam[ax]));
          dcam[3 + ax] = add(dcam[3 + ax], mul(mul(dt3[ax], st), k.kcam[ax]));
        }
      }
    }
    __syncthreads();

    // Warp `warp` owns the window slots s with s % 8 == warp (a chunk's
    // run of cells is contiguous, so this spreads it evenly over the
    // warps) and adds their staged samples in sample order into its rows
    // r = s / 8 of the window accumulator; lane i owns column i
    // (ch = i / 8, corner = i % 8) of every row, so each sample keeps all
    // 32 lanes of its warp busy.
    const int col_ch = lane >> 3, col_corner = lane & 7;
    unsigned hit = 0;   // rows of this warp that received a sample
    for (int base_q = 0; base_q < n_stage; base_q += 32) {
      const int qq = base_q + lane;
      const int sl = qq < n_stage ? st_slot[qq] : -1;
      unsigned mine = __ballot_sync(kFull, sl >= 0 && (sl & 7) == warp);
      while (mine) {
        const int b = __ffs(mine) - 1;
        mine &= mine - 1u;
        const int src = base_q + b;
        const int r = __shfl_sync(kFull, sl, b) >> 3;
        float w[3][2];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float f = st_t[ax * kChunkSamples + src];
          w[ax][0] = sub(1.f, f);
          w[ax][1] = f;
        }
        const float wc = mul(mul(w[2][col_corner >> 2],
                                 w[1][(col_corner >> 1) & 1]),
                             w[0][col_corner & 1]);
        float* a = acc_row<kNch, BANKS>(win_acc, warp, r) + lane;
        *a = add(*a, mul(wc, st_d[col_ch * kChunkSamples + src]));
        hit |= 1u << r;
      }
    }

    // add into the tile's banks: the window's first half (rows 0-15 of
    // every warp) into b0, then its second half (rows 16-31) into b1, the
    // same bank when the window clamps; each row is one coalesced 128-byte
    // add, after which the accumulator row is zeroed for the next chunk
    if constexpr (BANKS) {
      flush_banks(rows_t, win_acc, hit_s, hit, b0, b1, ray);
      continue;
    }
    float* wacc = acc_row<kNch, false>(win_acc, warp, 0);
    for (int h = 0; h < 2; ++h) {
      unsigned rows_left = hit & (h ? 0xFFFF0000u : 0x0000FFFFu);
      while (rows_left) {
        const int r = __ffs(rows_left) - 1;
        rows_left &= rows_left - 1u;
        const int slot = r * 8 + warp;
        float* g = rows_t + ((int64_t)(h ? b1 : b0) * kLanes
                             + (slot & (kLanes - 1))) * kNch + lane;
        *g = add(*g, wacc[r * kNch + lane]);
        wacc[r * kNch + lane] = 0.f;
      }
      __syncthreads();
    }
  }

  if (cam) {
    float* out = d_rayt + t * 12 * kLanes;
#pragma unroll
    for (int ax = 0; ax < 6; ++ax) out[ax * kRays + ray] = dcam[ax];
  }
}


template <int SUBS, bool SUPER, bool BANKS>
int launch(int n_tiles, cudaStream_t stream, const float* tabs,
           const uint16_t* samp, const float* base, const float* rayt,
           const int* ke, const int* bank0, const float* gs, float* d_rows,
           float* d_rayt, float* s_pre, const TileConsts& k) {
  auto* kernel = tile_backward_cell16_kernel<BANKS>;
  if constexpr (SUBS != 1 || SUPER) {
    kernel = tile_backward_kernel<SUBS, SUPER, BANKS>;
  }
  static bool smem_set = false;
  constexpr int bytes = smem_bytes<SUPER, BANKS>();
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<n_tiles, kRays, bytes, stream>>>(
      tabs, samp, base, rayt, ke, bank0, gs, d_rows, d_rayt, s_pre, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dvt_tile_backward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const float* gs,
    float* d_rows, float* d_rayt, float* s_pre,
    int n_tiles, int nc, int nb, int k_max, int subs, int super_stencil,
    int emit_banks, float dt, float t_near, float t_far, float t_stop, float stop,
    float lo_x, float lo_y, float lo_z, float inv_x, float inv_y,
    float inv_z, float ns_x, float ns_y, float ns_z,
    float kcam_x, float kcam_y, float kcam_z, void* stream) {
  TileConsts k;
  k.nc = nc;
  k.nb = nb;
  k.k_max = k_max;
  k.dt = dt;
  k.t_near = t_near;
  k.t_far = t_far;
  k.t_stop = t_stop;
  k.stop = stop;
  k.lo[0] = lo_x; k.lo[1] = lo_y; k.lo[2] = lo_z;
  k.inv[0] = inv_x; k.inv[1] = inv_y; k.inv[2] = inv_z;
  k.ns[0] = ns_x; k.ns[1] = ns_y; k.ns[2] = ns_z;
  k.kcam[0] = kcam_x; k.kcam[1] = kcam_y; k.kcam[2] = kcam_z;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool sup = super_stencil != 0;
  const bool banks = emit_banks != 0;
#define DVT_BWD(S, SUP, BANKS)                                            \
  return launch<S, SUP, BANKS>(n_tiles, st, tabs, samp, base, rayt, ke,   \
                               bank0, gs, d_rows, d_rayt, s_pre, k)
  if (subs == 1 && !sup && !banks) DVT_BWD(1, false, false);
  if (subs == 4 && !sup && !banks) DVT_BWD(4, false, false);
  if (subs == 16 && !sup && !banks) DVT_BWD(16, false, false);
  if (subs == 1 && sup && !banks) DVT_BWD(1, true, false);
  if (subs == 4 && sup && !banks) DVT_BWD(4, true, false);
  if (subs == 16 && sup && !banks) DVT_BWD(16, true, false);
  if (subs == 1 && !sup && banks) DVT_BWD(1, false, true);
  if (subs == 4 && !sup && banks) DVT_BWD(4, false, true);
  if (subs == 16 && !sup && banks) DVT_BWD(16, false, true);
#undef DVT_BWD
  return (int)cudaErrorInvalidValue;
}
