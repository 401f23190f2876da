// Fused tile backward (K2): the recompute adjoint of K1 for every ray of
// a tile schedule, with the table gradient as f32 slot rows (or, for the
// split backward, bank blocks) and, on request, the ray-plane (camera)
// adjoint.
//
// Replaces dvren_tpu/ops/fused_tiles.py::_bwd_kernel (launched by
// _tile_op.bwd_call) for both stencils ("cell", "super") and 1, 4 or 16
// sub-tiles per block, emit "rows16" in f32 form, and for the cell stencil
// emit "banks": nine instances of one template. Like K1 it runs once per
// schedule over every tile group, each tile finding its chunks and banks
// through its descriptor (tile_set.cuh), the tiles in K1's order. Inputs
// are K1's (see csrc/fused_tiles.cu; S_c and S_b the chunks and banks of
// all tiles) plus
//   gs     (T, 5, 16, 16) f32  d(loss)/d(K1 output) per ray
// Outputs:
//   d_rows (S_b, 128, C) f32     d(bank table), row (bank0 + b)*128 + lane
//                                of the tile's bank b, column ch*8 + corner
//                                (C = 32) or ch*27 + vertex (C = 108);
//                                zeroed here: the one buffer the gather
//                                plan's sums read. With emit_banks (cell
//                                stencil only) the bank form (S_b, 32,
//                                128): element ((bank0 + b)*32 + col)*128
//                                + lane, the same values transposed per
//                                bank
//   d_rayt (T, 12, 128) f32      d(rayt) in rayt's layout, or null
//   s_pre  (S_c*8, 256) f32      scratch: each sample's optical-depth
//                                prefix, row (chunk0 + c)*8 + step
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
//   memory in sample order, compacted by a block scan, so each sub-tile's
//   samples form one range: its slot word (4 B) in one array, its 3
//   fractions and 4 d-planes as two float4 in another (72 KB for 2048
//   samples). Sub-tile by sub-tile, warp w owns the window slots s with
//   s % 8 == w and finds them with one ballot per 32 staged samples; for
//   each, in sample order, lane i adds product i (channel i / 8, corner
//   i % 8) into its column of the slot's row of a (256, C) window
//   accumulator in shared memory (32 KB for cells, 108 KB for
//   supercells: those instances run one block per SM), so every lane
//   works on every sample (scatter_window). Then each touched row is added
//   into its bank row in device memory: the first half of the window into
//   bank b0, then the second into b1 = min(b0+1, nb-1), as the TPU kernel
//   does (flush_rows). The ALIGNED bit (30 of bank0) is ignored.
//   tile_backward_plain sums in this order (fused_tiles.ordered_sums), so
//   the two agree to the last bit.
// - The scatter is a chain of dependent steps per sample (find the next
//   owned sample, read its operands, add into the row), so it is written
//   for latency: the next sample's slot word, fractions and d-plane are
//   read while the current one is added; a run of samples on one slot (a
//   ray's steps through one cell) is summed in a register, the row read
//   from shared memory once and written back once, in the same order of
//   additions. The flush reads up to 8 bank-row words a lane before it
//   adds and writes any, so their device-memory latencies overlap.
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
//   accumulator that starts at +0 never changes by adding +-0). Its
//   columns move between lanes from one (slot, lb) to the next, so the
//   scatter syncs the warp between them.
// - The camera adjoint needs the corner values again (differences along
//   each axis, weighted by the other two axes' weights) and chains with
//   kcam = float32(inv*ns) into d(origin) and with st*kcam into
//   d(direction). One thread per ray keeps the six sums in registers. The
//   supercell's hat derivatives reduce to the same 8-corner differences
//   (their other terms are exact zeros).
//
// Bound on the H100: the latency of the stencil reads (8 per sample in
// pass 1, 32 in pass 2, from L1/L2) and of the scatter's chain per
// sample. Two early versions took 12.29 and 10.8 ms over the headline's
// 14 launches on the H100 (700 W): one let thread s alone sum slot s's
// samples (one lane of 32 busy per sample), the other gave warp w the
// slots 32w .. 32w+31, so the few warps that own a chunk's run of cells
// did nearly all of its additions one sample at a time; one list of
// staged samples per warp, in place of the ballots, was slower (6.5 ms
// against 5.7). tools/torch_tile_bwd_ablate.py times the kernel without
// its flush, its scatter or pass 2.
//
// Arithmetic runs in the plain twin's order with explicit _rn intrinsics
// (no FMA contraction), so per-sample values equal
// fused_tiles.tile_backward_plain's.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_set.cuh"

namespace {

using dvt_tiles::tile_span;
using dvt_tiles::TileSpan;
using dvt_tiles::window_slot;

constexpr int kLanes = 128;
constexpr int kSteps = 8;
constexpr int kNch = 32;
constexpr int kRays = 256;
constexpr int kWarps = kRays / 32;
constexpr int kChunkSamples = 2048;
constexpr unsigned kFull = 0xffffffffu;

// dynamic shared memory: the staged samples (slot word; 3 fractions and
// a pad, 4 d-planes: two float4) and the window's (256, C) accumulator
template <bool SUPER, bool BANKS>
constexpr int smem_bytes() {
  return (9 * kChunkSamples + 2 * kLanes * ((SUPER ? 108 : kNch) + BANKS)) * 4;
}

// What the tiles of a launch share; each tile's chunk and bank counts
// come from its descriptor.
struct TileConsts {
  int k_max;
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

// Warp `warp` adds the staged samples [q0, q1) whose window slot s has
// s % 8 == warp (a chunk's run of cells is contiguous, so this spreads it
// evenly over the warps) into its rows r = s / 8 of the window
// accumulator, in sample order; lane i adds product i = ch*8 + corner of
// each sample into that corner's column. Returns the rows it touched
// (bit r). A sample's operands are read one sample ahead of its add, and
// each run of samples on one (slot, lb) is summed in a register between
// one read and one write of the row's words: the same additions in the
// same order as adding each sample into shared memory. Warp-uniform
// control flow throughout (the slot word comes by shuffle).
template <bool SUPER, bool BANKS, int kCols, int kPer>
__device__ __forceinline__ unsigned scatter_window(const int* st_slot,
                                                   const float4* st_v,
                                                   float* win_acc, int q0,
                                                   int q1, int warp,
                                                   int lane) {
  // the window scatter into shared memory
  const int col_ch = lane >> 3, col_corner = lane & 7;
  unsigned hit = 0;
  int base_q = q0 - 32;
  int sl = -1;
  unsigned mine = 0;
  // the next sample this warp owns, and its slot word; -1 past q1
  auto next = [&](int* word) -> int {
    while (mine == 0u) {
      base_q += 32;
      if (base_q >= q1) return -1;
      const int qq = base_q + lane;
      sl = qq < q1 ? st_slot[qq] : -1;
      mine = __ballot_sync(kFull, sl >= 0 && (sl & 7) == warp);
    }
    const int b = __ffs(mine) - 1;
    mine &= mine - 1u;
    *word = __shfl_sync(kFull, sl, b);
    return base_q + b;
  };
  auto operands = [&](int src, float4* f, float* dv) {
    *f = st_v[2 * src];
    *dv = reinterpret_cast<const float*>(st_v + 2 * src + 1)[col_ch];
  };
  int word = 0;
  int src = next(&word);
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  float dv = 0.f;
  if (src >= 0) operands(src, &f, &dv);
  int key = -1;        // the (slot, lb) word whose run is in `run`
  float* cell = win_acc;
  float run = 0.f;
  while (src >= 0) {
    int nword = 0;
    const int nsrc = next(&nword);
    float4 nf = f;
    float ndv = 0.f;
    if (nsrc >= 0) operands(nsrc, &nf, &ndv);
    if (word != key) {
      if (key >= 0) {
        *cell = run;
        if (SUPER) __syncwarp();
      }
      const int r = (word & 0xFFFF) >> 3;
      int lb[3] = {0, 0, 0};
      if (SUPER) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) lb[ax] = (word >> (16 + ax)) & 1;
      }
      cell = acc_row<kCols, BANKS>(win_acc, warp, r) + col_ch * kPer
             + corner_col<SUPER>(col_corner, lb);
      run = *cell;
      key = word;
      hit |= 1u << r;
    }
    const float wx = (col_corner & 1) ? f.x : sub(1.f, f.x);
    const float wy = ((col_corner >> 1) & 1) ? f.y : sub(1.f, f.y);
    const float wz = (col_corner >> 2) ? f.z : sub(1.f, f.z);
    run = add(run, mul(mul(mul(wz, wy), wx), dv));
    src = nsrc;
    word = nword;
    f = nf;
    dv = ndv;
  }
  if (key >= 0) *cell = run;
  if (SUPER) __syncwarp();
  return hit;
}

// The rows form's flush of one window: warp `warp` adds its touched rows
// (`hit`) of the window accumulator into their bank rows in device memory,
// the window's first half (rows 0-15) into bank b0, then its second half
// (rows 16-31) into b1, the same bank when the window clamps, and zeroes
// them for the next window. A bank lane's slots all share one owner warp
// and lane, so these adds need no barrier. Rows go in batches whose
// device-memory words (8 per lane) are all read before any is added and
// written back, so their latencies overlap.
template <int kCols>
__device__ __forceinline__ void flush_rows(float* rows_t, float* wacc,
                                           unsigned hit, int b0, int b1,
                                           int warp, int lane) {
  // the window's flush into the bank rows
  constexpr int kPerLane = (kCols + 31) / 32;
  constexpr int kBatch = 8 / kPerLane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    unsigned left = hit & (h ? 0xFFFF0000u : 0x0000FFFFu);
    float* bank_rows = rows_t + (int64_t)(h ? b1 : b0) * kLanes * kCols;
    while (left) {
      int r[kBatch];
      float v[kBatch][kPerLane];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        r[i] = left ? __ffs(left) - 1 : -1;
        left &= left - 1u;
        const float* g = bank_rows + ((r[i] & 15) * 8 + warp) * kCols;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int col = lane + 32 * k;
          v[i][k] = (r[i] >= 0 && col < kCols) ? g[col] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (r[i] < 0) continue;
        float* g = bank_rows + ((r[i] & 15) * 8 + warp) * kCols;
        float* a = wacc + r[i] * kCols;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int col = lane + 32 * k;
          if (col < kCols) {
            g[col] = add(v[i][k], a[col]);
            a[col] = 0.f;
          }
        }
      }
    }
  }
}

template <int SUBS, bool SUPER, bool BANKS>
__global__ void __launch_bounds__(kRays)
tile_backward_kernel(const float* __restrict__ tabs,
                     const uint16_t* __restrict__ samp,
                     const float* __restrict__ base,
                     const float* __restrict__ rayt,
                     const int* __restrict__ ke,
                     const int* __restrict__ bank0,
                     const int* __restrict__ desc,
                     const int* __restrict__ order,
                     const float* __restrict__ gs,
                     float* __restrict__ d_rows,
                     float* __restrict__ d_rayt,
                     float* __restrict__ s_pre, TileConsts k) {
  static_assert(!(SUPER && BANKS), "the bank form is cell-stencil only");
  constexpr int kCols = SUPER ? 108 : kNch;
  constexpr int kPer = SUPER ? 27 : 8;           // columns per channel
  constexpr unsigned kLaneMask = SUPER ? 0xFFFu : 0x7FFFu;
  constexpr int kSubRays = kRays / SUBS;
  extern __shared__ float4 stage4[];
  float4* st_v = stage4;                      // (fx, fy, fz, 0), d-planes
  int* st_slot = reinterpret_cast<int*>(stage4 + 2 * kChunkSamples);
  //                                             idx2 | lb << 16
  float* win_acc = reinterpret_cast<float*>(st_slot + kChunkSamples);
  //                                             (256 slots, C columns)
  __shared__ int warp_total[kWarps];
  __shared__ int sub_start[SUBS + 1];         // staged range per sub-tile
  __shared__ unsigned hit_s[kWarps];          // the bank form's touched rows

  const int64_t t = order[blockIdx.x];   // the longest tiles start first
  const TileSpan span = tile_span(desc, t);
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  const int warp = ray >> 5;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  const int sub_tile = ray / kSubRays;

  // zero the tile's d(table) block (the first __syncthreads below orders
  // it before any thread adds into it)
  float* rows_t = d_rows + span.bank0 * kLanes * kCols;
  float4* rows4 = reinterpret_cast<float4*>(rows_t);
  for (int i = ray; i < span.nb * kLanes * kCols / 4; i += kRays) {
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
  float* spre = s_pre + span.chunk0 * kSteps * kRays + ray;   // [q * kRays]
  const int n_steps = span.nc * kSteps;

  // Pass 1: K1's recurrence over sigma; k_stop = the first step whose
  // transmittance is at or below `stop` (every step from there is 0).
  int k_stop = n_steps;
  float s = 0.f;
  for (int c = 0; c < span.nc && k_stop == n_steps; ++c) {
    const int64_t ch = span.chunk0 + c;
    const int b0 = bank0[ch * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, span.nb - 1);
    const uint16_t* sc = samp + ch * 3 * kChunkSamples + row * kLanes + lane0;
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
      const float* tab = tabs + (span.bank0 + bank) * kCols * kLanes + slot;
      int lb[3] = {0, 0, 0};
      if (SUPER) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) lb[ax] = (packed >> (12 + ax)) & 1u;
      }
      float frac[3], w8[8];
      fractions<SUPER>(o, d, st, base + (span.bank0 + bank) * 3 * kLanes, slot,
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
  for (int c = span.nc - 1; c >= 0; --c) {
    const int64_t ch = span.chunk0 + c;
    const int b0 = bank0[ch * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, span.nb - 1);
    const uint16_t* sc = samp + ch * 3 * kChunkSamples + row * kLanes + lane0;

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
      const float* tab = tabs + (span.bank0 + bank) * kCols * kLanes + slot;
      int lb[3] = {0, 0, 0};
      if (SUPER) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) lb[ax] = (packed >> (12 + ax)) & 1u;
      }
      float frac[3], w8[8], v[kNch];
      fractions<SUPER>(o, d, st, base + (span.bank0 + bank) * 3 * kLanes, slot,
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
        st_v[2 * pos] = make_float4(frac[0], frac[1], frac[2], 0.f);
        st_v[2 * pos + 1] = make_float4(dpl[0], dpl[1], dpl[2], dpl[3]);
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

    // sub-tile by sub-tile: the window scatter, then its flush
    for (int sb = 0; sb < SUBS; ++sb) {
      const int sb0 = bank0[ch * SUBS + sb] & 0x3FFF;
      const int sb1 = min(sb0 + 1, span.nb - 1);
      const unsigned hit = scatter_window<SUPER, BANKS, kCols, kPer>(
          st_slot, st_v, win_acc, sub_start[sb], sub_start[sb + 1], warp,
          lane);
      if constexpr (BANKS) {
        flush_banks(rows_t, win_acc, hit_s, hit, sb0, sb1, ray);
      } else {
        flush_rows<kCols>(rows_t, acc_row<kCols, false>(win_acc, warp, 0),
                          hit, sb0, sb1, warp, lane);
        if (SUPER) __syncwarp();
      }
    }
    __syncthreads();   // the staging and sub_start are refilled next chunk
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
           const int* ke, const int* bank0, const int* desc,
           const int* order, const float* gs, float* d_rows, float* d_rayt,
           float* s_pre, const TileConsts& k) {
  auto* kernel = tile_backward_kernel<SUBS, SUPER, BANKS>;
  static bool smem_set = false;
  constexpr int bytes = smem_bytes<SUPER, BANKS>();
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  kernel<<<n_tiles, kRays, bytes, stream>>>(
      tabs, samp, base, rayt, ke, bank0, desc, order, gs, d_rows, d_rayt,
      s_pre, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dvt_tile_backward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const int* desc,
    const int* order, const float* gs, float* d_rows, float* d_rayt,
    float* s_pre,
    int n_tiles, int k_max, int subs, int super_stencil,
    int emit_banks, float dt, float t_near, float t_far, float t_stop, float stop,
    float lo_x, float lo_y, float lo_z, float inv_x, float inv_y,
    float inv_z, float ns_x, float ns_y, float ns_z,
    float kcam_x, float kcam_y, float kcam_z, void* stream) {
  TileConsts k;
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
                               bank0, desc, order, gs, d_rows, d_rayt,     \
                               s_pre, k)
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
