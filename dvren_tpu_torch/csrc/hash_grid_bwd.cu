// Fused hash-grid tile backward (K8b): the recompute adjoint of K8f, with
// the bank-table gradient as f32 slot rows and the MLP gradients as
// per-tile partial sums.
//
// Replaces dvren_tpu/ops/hash_grid.py::_bwd_kernel (launched by
// _hash_grid_op.bwd_call). Inputs are K8f's (csrc/hash_grid.cu: the flat
// arrays of every tile group of a schedule and the per-tile descriptor)
// plus
//   gs       (T, 5, 16, 16) f32  d(loss)/d(K8f output) per ray
// Outputs:
//   d_rows   (S_b, 128, C) f32  d(bank table), row (first bank + b)*128 +
//                               lane, column (l*8 + corner)*F + f (zeroed
//                               here): the concatenated slot rows that
//                               gather_plan.slot_rows_to_table reads
//   part_mlp (T, P) f32         each tile's d(MLP scalars), _mlp_layout order
//   s_pre    (S_c*8, 256) f32   scratch: each sample's optical-depth prefix
// The wrapper (ops/hash_grid.py) sums the partials over the tiles with one
// torch.sum, as XLA sums the TPU kernel's per-grid-step ones.
//
// One block per tile, one thread per ray, on K2's design
// (csrc/fused_tiles_bwd.cu):
// - Pass 1 reruns K8f's recurrence (sigma head only) and stores every
//   sample's exclusive prefix S until the ray's transmittance falls to
//   `stop`; every step from there contributes exactly 0, so pass 2 skips it.
// - Pass 2 walks the chunks and their steps in reverse with a running
//   suffix sum of gw*w: dod = gw*p - suffix + g_odp, d sigma = dod * tie(x)
//   * dt, d colour = g * w, then through both heads with JAX's tie values
//   (0.5 at max(x, 0) == 0 and at each end of the colour clamp) to
//   d(encoding). Masked samples contribute exactly 0 and are skipped.
// - The MLP gradients are outer products summed over samples (sum of ds1 x
//   enc, dc1 x enc, dsig2 x relu(pre_s), dc2 x relu(pre_c), and the bias
//   sums). Per step each warp stages its 32 rays' factors in shared memory,
//   one row per factor (enc, relu(pre_s), relu(pre_c), ds1, dc1, dsig2,
//   dc2, 1), and lane i owns the outputs i, i + 32, ...: it reads the two
//   factor rows of each with float4 loads and adds the step's sum over the
//   32 rays ((p0 + p1) + (p2 + p3) per 4 rays, the 8 quads in ray order)
//   into a register. So a step costs a lane P / 32 short dot products, no
//   shuffles and no block barrier. At the end the block adds its 8 warps'
//   sums in warp order. No atomics: repeat runs are equal bit for bit.
// - The bank gradient: each sample adds C products w8_l[corner] *
//   d(enc)[l*F + f] into its window slot's row. As in K2, a tile's bank
//   space belongs to its block; samples that land in the chunk's 256-slot
//   window are staged in shared memory (slot, finest coordinates, d(enc):
//   4 + enc words) in sample order, warp w owns the slots s with s % 8 == w
//   and adds their samples in order into its 32 rows of a (256, CP) window
//   accumulator, lane i taking panel columns i and i + 32, recomputing the
//   level weight of its column from the staged coordinates and the slot's
//   cell base (each lane loads those of one staged sample up front and the
//   warp passes them by shuffle); then each touched row is added into its
//   bank row in device memory (first the window's first half into b0, then
//   its second into b1), up to 8 rows' reads in flight at once. No float
//   atomics, the same bits on every run. A warp's window rows and its MLP
//   factor rows share one region: they are live at different times (the
//   steps of a staged group, then its scatter).
// - Sub-tiles (SUBS 4 or 16: 8 or 4 px tiles): ray `ray` belongs to
//   sub-tile ray / (256 / SUBS), whose chunk window starts at
//   bank0[(chunk)*SUBS + s]. Staged positions follow sample order, so each
//   sub-tile's samples form one range; the sub-tiles take turns through the
//   one window accumulator in sub-tile order, each flushed into its own
//   (b0, b1), as the TPU kernel adds them (sub-tiles of one tile may share
//   banks) and as csrc/fused_tiles_bwd.cu does for K2.
// - Shared memory: the host picks the staged group of g in {8, 4, 2, 1}
//   steps and the panel width CP <= min(C, 64) so that two blocks fit on an
//   SM where its registers allow it (g = 4, CP = 64 at the grid spec:
//   115,456 bytes), else one; every spec grid_path_ok admits fits (enc 64,
//   hidden 8: g = 1, CP = 64, 190,560 bytes in one block).
//
// Bound on the H100: latency. At the grid headline the window scatter and
// its flush take about half the time, pass 1 about 14 %, the MLP sums about
// 5 % (tools/torch_grid_bwd_ablate.py). Arithmetic runs in the plain
// twin's order with _rn
// intrinsics, so per-sample values equal
// hash_grid.hash_grid_backward_plain's; only the order of the sums over
// samples differs (the twin sums in float64).

#include "hash_grid.cuh"

namespace {

using namespace dvt_grid;

constexpr int kWarps = kRays / 32;
constexpr int kPanel = 64;       // widest window accumulator panel
constexpr int kMlpStride = 36;   // floats per staged factor row: 32 rays + 4
constexpr int kFlushRows = 8;    // window rows a warp flushes at a time
constexpr unsigned kFull = 0xffffffffu;

struct BwdLayout {
  int g;          // steps per staged group
  int cp;         // panel width
  int stride;     // staged rows: 256 * g + 1 (odd: fewer bank conflicts)
  int sc_pad;     // floats of sc, rounded up to 4
  int rows;       // MLP factor rows: enc + 4 * hidden + 5
  int region;     // floats per warp: max(32 * cp, rows * kMlpStride)
  int floats;     // dynamic shared-memory floats
};

// Shared memory (floats): sc (P, padded to 4) | per warp, its window rows
// (32, cp) or its MLP factor rows (rows, 36) | staged slots, 3 coordinates,
// enc d(enc) planes.
inline BwdLayout make_layout(int n_sc, int enc, int hidden, int g, int cp) {
  BwdLayout b;
  b.g = g;
  b.cp = cp;
  b.stride = kRays * g + 1;
  b.sc_pad = (n_sc + 3) & ~3;
  b.rows = enc + 4 * hidden + 5;
  const int win = 32 * cp, mlp = b.rows * kMlpStride;
  b.region = ((win > mlp ? win : mlp) + 3) & ~3;
  b.floats = b.sc_pad + kWarps * b.region + b.stride * (4 + enc);
  return b;
}

// The layout with the most steps per staged group, then the widest panel,
// that fits two blocks per SM (budget2 bytes each), else one (budget1);
// g == 0 if none fits.
inline BwdLayout bwd_layout(int n_sc, int enc, int hidden, int cols,
                            int budget2, int budget1) {
  for (int pass = 0; pass < 2; ++pass) {
    const int budget = pass ? budget1 : budget2;
    for (int g = kSteps; g >= 1; g >>= 1) {
      for (int cp = cols < kPanel ? cols : kPanel; cp >= 8; cp >>= 1) {
        const BwdLayout b = make_layout(n_sc, enc, hidden, g, cp);
        if (b.floats * 4 <= budget) return b;
      }
    }
  }
  BwdLayout none = make_layout(n_sc, enc, hidden, 1, 8);
  none.g = 0;
  return none;
}

// The two factor rows of MLP output o (in _mlp_layout order) packed as
// a | b << 16, or -1 past the last output. Rows: enc [0, E), relu(pre_s)
// [E, E+H), relu(pre_c) [E+H, E+2H), ds1 [E+2H, E+3H), dc1 [E+3H, E+4H),
// dsig2 E+4H, dc2 [E+4H+1, E+4H+4), ones E+4H+4.
__device__ __forceinline__ int mlp_factor_rows(int o, int E, int H) {
  const int r_s = E, r_c = E + H, r_ds = E + 2 * H, r_dc = E + 3 * H;
  const int r_sig = E + 4 * H, r_d2 = r_sig + 1, r_one = r_d2 + 3;
  const int he = H * E;
  int a = -1, b = -1;
  if (o < he) {                          // sigma_w1[j, i]
    a = r_ds + o / E;
    b = o % E;
  } else if ((o -= he) < H) {            // sigma_b1
    a = r_ds + o;
    b = r_one;
  } else if ((o -= H) < H) {             // sigma_w2
    a = r_sig;
    b = r_s + o;
  } else if ((o -= H) < 1) {             // sigma_b2
    a = r_sig;
    b = r_one;
  } else if ((o -= 1) < he) {            // color_w1[j, i]
    a = r_dc + o / E;
    b = o % E;
  } else if ((o -= he) < H) {            // color_b1
    a = r_dc + o;
    b = r_one;
  } else if ((o -= H) < 3 * H) {         // color_w2[ch, j]
    a = r_d2 + o / H;
    b = r_c + o % H;
  } else if ((o -= 3 * H) < 3) {         // color_b2
    a = r_d2 + o;
    b = r_one;
  }
  return a < 0 ? -1 : (a | (b << 16));
}

// P <= 256 (enc <= 13 at hidden 8): 8 outputs per lane; else 34 (P <= 1088,
// enc 64 at hidden 8).
constexpr int kOwnSmall = 8;
constexpr int kOwnLarge = 34;

// OWN >= ceil(P / 32): the MLP outputs each lane owns. The small form is
// held to 128 registers so that two blocks fit on an SM; the large one
// keeps its 2 * OWN running sums in registers at one block per SM
// (smem_budgets then offers it the one-block budget only).
template <int SUBS, int OWN>
__global__ void __launch_bounds__(kRays, OWN <= kOwnSmall ? 2 : 1)
hash_grid_backward_kernel(const float* __restrict__ tabs,
                          const uint16_t* __restrict__ samp,
                          const float* __restrict__ base,
                          const float* __restrict__ rayt,
                          const int* __restrict__ ke,
                          const int* __restrict__ bank0,
                          const int* __restrict__ desc,
                          const float* __restrict__ scg,
                          const float* __restrict__ gs,
                          float* __restrict__ d_rows,
                          float* __restrict__ part_mlp,
                          float* __restrict__ s_pre, GridConsts k,
                          BwdLayout bl) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const HashConsts& h = k.h;
  const int n_sc = h.n_sc, enc = h.enc, hid = h.hidden, n_f = h.n_feat;
  const int cols = k.cols, cp = bl.cp, stride = bl.stride;
  float* sc = smem;
  float* regions = sc + bl.sc_pad;                            // (8, region)
  int* st_slot = reinterpret_cast<int*>(regions + kWarps * bl.region);
  float* st_fs = reinterpret_cast<float*>(st_slot + stride);   // (3, stride)
  float* st_denc = st_fs + 3 * stride;                         // (enc, stride)
  __shared__ int warp_total[kWarps];
  __shared__ int sub_start[SUBS + 1];   // staged range per sub-tile
  constexpr int kSubRays = kRays / SUBS;

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  const int warp = ray >> 5;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  const int sub_tile = ray / kSubRays;
  const TileSpan span = tile_span(desc, t);
  const int nc = span.nc, nb = span.nb;
  float* wreg = regions + warp * bl.region;   // this warp's region
  float* wacc = wreg;                         // as window rows (32, cp)
  float* wfac = wreg + lane;                  // as factor rows: row r at
                                              // wfac[r * kMlpStride]

  block_copy(sc, scg, n_sc);
  // zero the tile's d(table) block (the first __syncthreads below orders
  // it before any thread adds into it)
  float* rows_t = d_rows + span.bank0 * kLanes * cols;
  float4* rows4 = reinterpret_cast<float4*>(rows_t);
  for (int i = ray; i < nb * kLanes * cols / 4; i += kRays) {
    rows4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);
  const float* g = gs + t * 5 * kRays + ray;
  const float g_r = g[0], g_g = g[kRays], g_b = g[2 * kRays];
  const float g_wd = g[3 * kRays], g_odp = g[4 * kRays];
  const float gch[3] = {g_r, g_g, g_b};
  const int ket = ke[t];
  const TileTime tt(ket, h);
  float* spre = s_pre + span.chunk0 * kSteps * kRays + ray;   // [q * kRays]
  const int n_steps = nc * kSteps;
  __syncthreads();
  const MlpLayout lay(h);

  // the MLP outputs this lane owns and their running sums
  int own[OWN];
  float acc[OWN];
#pragma unroll
  for (int kk = 0; kk < OWN; ++kk) {
    const int ow = lane + 32 * kk;
    own[kk] = ow < n_sc ? mlp_factor_rows(ow, enc, hid) : -1;
    acc[kk] = 0.f;
  }
  const int r_fac = enc;           // relu(pre_s), relu(pre_c), ds1, dc1 rows
  const int r_sig = enc + 4 * hid;  // dsig2, dc2 (3), ones

  // sample q's slot, bank row offset and finest coordinates
  auto locate = [&](int q, int b0, int b1, const uint16_t* sp, int* idx2,
                    int64_t* bank, int* slot, float fs[3]) {
    const int j = q & 7;
    const uint32_t packed = sp[2 * kChunkSamples + j];
    const float st =
        __uint_as_float(((uint32_t)sp[j] << 16) | sp[kChunkSamples + j]);
    *idx2 = (int)(packed & 0x7FFFu) - b0 * kLanes;
    bool second;
    *slot = window_slot(*idx2, &second);
    *bank = span.bank0 + (second ? b1 : b0);
    finest_coords(o, d, st, k, fs);
  };

  // Pass 1: K8f's recurrence over sigma; k_stop = the first step whose
  // transmittance is at or below `stop` (every step from there is 0).
  int k_stop = n_steps;
  {
    float s = 0.f;
    for (int c = 0; c < nc && k_stop == n_steps; ++c) {
      const int b0 = bank0[(span.chunk0 + c) * SUBS + sub_tile] & 0x3FFF;
      const int b1 = min(b0 + 1, nb - 1);
      const uint16_t* sp = samp + (span.chunk0 + c) * 3 * kChunkSamples
                           + row * kLanes + lane0;
      for (int j = 0; j < kSteps; ++j) {
        const int q = c * kSteps + j;
        if (!(expf(-s) > h.stop)) {
          k_stop = q;
          break;
        }
        spre[q * kRays] = s;
        float dta, mid;
        if (!tt.step(ket + q, h, &dta, &mid)) continue;            // od == 0
        if (!((sp[2 * kChunkSamples + j] >> 15) & 1u)) continue;   // masked
        int idx2, slot;
        int64_t bank;
        float fs[3], cb[3], pre_s[kMaxHidden], pre_c[kMaxHidden];
        locate(q, b0, b1, sp, &idx2, &bank, &slot, fs);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          cb[ax] = base[(bank * 3 + ax) * kLanes + slot];
        }
        grid_encode<false>(fs, cb, tabs + bank * cols * kLanes + slot, sc, k,
                           lay, pre_s, pre_c, nullptr);
        const float sig = fmaxf(sigma_pre2(pre_s, sc, h, lay), 0.f);
        s = add(s, fmaxf(mul(sig, dta), 0.f));
      }
    }
  }

  // Pass 2: the reverse adjoint, chunk by chunk, in groups of g steps.
  float carry = 0.f;   // sum of gw * w over the ray's later steps
  const int n_groups = kSteps / bl.g;
  for (int c = nc - 1; c >= 0; --c) {
    const int b0 = bank0[(span.chunk0 + c) * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, nb - 1);
    const uint16_t* sp = samp + (span.chunk0 + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;

    // the steps that take part (processed, live, masked in) and those
    // that land in the sub-tile's window of 256 slots
    unsigned proc = 0, scat = 0;
    for (int j = 0; j < kSteps; ++j) {
      const int q = c * kSteps + j;
      if (q >= k_stop) break;
      float dta, mid;
      const uint32_t packed = sp[2 * kChunkSamples + j];
      if (tt.step(ket + q, h, &dta, &mid) && ((packed >> 15) & 1u)) {
        proc |= 1u << j;
        const int idx2 = (int)(packed & 0x7FFFu) - b0 * kLanes;
        if (idx2 >= 0 && idx2 < 2 * kLanes) scat |= 1u << j;
      }
    }

    for (int grp = n_groups - 1; grp >= 0; --grp) {
      const int j_lo = grp * bl.g;
      const unsigned gmask = ((1u << bl.g) - 1u) << j_lo;
      // block-wide exclusive scan of the staged counts: positions follow
      // sample order (ray-major, then step), so each sub-tile's samples
      // form one range
      const unsigned sg = scat & gmask;
      const int cnt = __popc(sg);
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

      for (int j = j_lo + bl.g - 1; j >= j_lo; --j) {
        const bool active = (proc >> j) & 1u;
        if (!__any_sync(kFull, active)) continue;   // uniform over the warp
        const int q = c * kSteps + j;
        float pre_s[kMaxHidden], pre_c[kMaxHidden];
        float ds1[kMaxHidden], dc1[kMaxHidden], dc2[3] = {0.f, 0.f, 0.f};
        float dsig2 = 0.f;
        zero_pre(pre_s, pre_c);
#pragma unroll
        for (int jj = 0; jj < kMaxHidden; ++jj) ds1[jj] = dc1[jj] = 0.f;
        if (active) {
          float dta, mid;
          tt.step(ket + q, h, &dta, &mid);
          int idx2, slot;
          int64_t bank;
          float fs[3], cb[3], c_pre2[3];
          locate(q, b0, b1, sp, &idx2, &bank, &slot, fs);
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            cb[ax] = base[(bank * 3 + ax) * kLanes + slot];
          }
          // the encoding goes straight to its factor rows
          grid_encode<true>(fs, cb, tabs + bank * cols * kLanes + slot, sc,
                            k, lay, pre_s, pre_c, wfac, kMlpStride);
          const float s_pre2 = sigma_pre2(pre_s, sc, h, lay);
          color_pre2(pre_c, sc, h, lay, c_pre2);
          const float sig = fmaxf(s_pre2, 0.f);
          float rgb[3];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) rgb[ch] = fminf(fmaxf(c_pre2[ch], 0.f), 1.f);

          const float sp_q = spre[q * kRays];
          const float x = mul(sig, dta);
          const float od = fmaxf(x, 0.f);
          const float tb = expf(-sp_q);
          const float pn = expf(-add(sp_q, od));
          const float w = sub(tb, pn);
          const float gw = add(add(add(mul(g_r, rgb[0]), mul(g_g, rgb[1])),
                                   mul(g_b, rgb[2])),
                               mul(g_wd, mid));
          const float dod = add(sub(mul(gw, pn), carry), g_odp);
          const float dsig = mul(mul(dod, tie(x)), dta);
          carry = add(carry, mul(gw, w));

          dsig2 = mul(dsig, tie(s_pre2));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float y2 = fmaxf(c_pre2[ch], 0.f);
            const float t_hi = y2 < 1.f ? 1.f : (y2 > 1.f ? 0.f : 0.5f);
            dc2[ch] = mul(mul(mul(gch[ch], w), t_hi), tie(c_pre2[ch]));
          }
#pragma unroll
          for (int jj = 0; jj < kMaxHidden; ++jj) {
            if (jj < hid) {
              ds1[jj] = mul(mul(dsig2, sc[lay.sw2 + jj]), tie(pre_s[jj]));
              float dh = 0.f;
#pragma unroll
              for (int ch = 0; ch < 3; ++ch) {
                dh = add(dh, mul(dc2[ch], sc[lay.cw2 + ch * hid + jj]));
              }
              dc1[jj] = mul(dh, tie(pre_c[jj]));
            }
          }
          // d(encoding) feeds only the bank gradient: staged for the
          // window scatter when the sample lands in the window
          if ((scat >> j) & 1u) {
            const int pos = pos0 + __popc(sg & ((1u << j) - 1u));
            st_slot[pos] = idx2;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) st_fs[ax * stride + pos] = fs[ax];
            for (int i = 0; i < enc; ++i) {
              float a = 0.f;
#pragma unroll
              for (int jj = 0; jj < kMaxHidden; ++jj) {
                if (jj < hid) {
                  a = add(a, add(mul(ds1[jj], sc[lay.sw1 + jj * enc + i]),
                                 mul(dc1[jj], sc[lay.cw1 + jj * enc + i])));
                }
              }
              st_denc[i * stride + pos] = a;
            }
          }
        } else {
          for (int i = 0; i < enc; ++i) wfac[i * kMlpStride] = 0.f;
        }

        // the step's factor rows (an inactive ray stages zeros, and 1)
#pragma unroll
        for (int jj = 0; jj < kMaxHidden; ++jj) {
          if (jj < hid) {
            wfac[(r_fac + jj) * kMlpStride] = fmaxf(pre_s[jj], 0.f);
            wfac[(r_fac + hid + jj) * kMlpStride] = fmaxf(pre_c[jj], 0.f);
            wfac[(r_fac + 2 * hid + jj) * kMlpStride] = ds1[jj];
            wfac[(r_fac + 3 * hid + jj) * kMlpStride] = dc1[jj];
          }
        }
        wfac[r_sig * kMlpStride] = dsig2;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) wfac[(r_sig + 1 + ch) * kMlpStride] = dc2[ch];
        wfac[(r_sig + 4) * kMlpStride] = 1.f;
        __syncwarp();

        // the MLP gradients of this step: each owned output's sum over the
        // warp's 32 rays, in quads of 4 rays, the quads in ray order
        const float4* f4 = reinterpret_cast<const float4*>(wreg);
#pragma unroll
        for (int kk = 0; kk < OWN; ++kk) {
          if (own[kk] >= 0) {
            const float4* a4 = f4 + (own[kk] & 0xFFFF) * (kMlpStride / 4);
            const float4* b4 = f4 + (own[kk] >> 16) * (kMlpStride / 4);
            float step_sum = 0.f;
#pragma unroll
            for (int qd = 0; qd < 8; ++qd) {
              const float4 x = a4[qd], y = b4[qd];
              const float s4 = add(add(mul(x.x, y.x), mul(x.y, y.y)),
                                   add(mul(x.z, y.z), mul(x.w, y.w)));
              step_sum = qd ? add(step_sum, s4) : s4;
            }
            acc[kk] = add(acc[kk], step_sum);
          }
        }
        __syncwarp();   // the rows are restaged by the next step
      }
      __syncthreads();   // the group's samples are staged

      // the warp's region now holds its window rows: zero them (the flush
      // zeroes the rows it touches after each panel)
      float4* wacc4 = reinterpret_cast<float4*>(wacc);
      for (int i = lane; i < 32 * cp / 4; i += 32) {
        wacc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncwarp();

      // Sub-tile by sub-tile (the TPU kernel adds each sub-tile's window
      // into its own banks in sub-tile order; sub-tiles may share banks),
      // warp `warp` owns the window slots s with s % 8 == warp and adds
      // their staged samples in order into its rows r = s / 8 of the
      // window accumulator, one panel of cp columns at a time. A sub-tile
      // that staged nothing is skipped (sub_start is the block's, so the
      // skip is uniform and the barriers stay matched).
      for (int sb = 0; sb < SUBS; ++sb) {
        const int q_lo = sub_start[sb], q_end = sub_start[sb + 1];
        if (q_lo == q_end) continue;
        const int sb0 = bank0[(span.chunk0 + c) * SUBS + sb] & 0x3FFF;
        const int sb1 = min(sb0 + 1, nb - 1);
        for (int p0 = 0; p0 < cols; p0 += cp) {
          const int pend = min(p0 + cp, cols);
          // this lane's panel columns p0 + lane and p0 + lane + 32: corner,
          // level ratio and d(enc) plane, fixed over the panel's samples
          bool c_ok[2];
          int c_corner[2], c_denc[2];
          float c_r[2];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int col = p0 + lane + 32 * half;
            const int l = col / (8 * n_f);
            c_ok[half] = col < pend;
            c_corner[half] = (col / n_f) & 7;
            c_denc[half] = (col - (l * 8 + c_corner[half]) * n_f
                            + l * n_f) * stride;
            c_r[half] = c_ok[half] ? h.res[min(l, kMaxLevels - 1)] : 1.f;
          }
          unsigned hit = 0;   // rows of this warp that received a sample
          for (int base_q = q_lo; base_q < q_end; base_q += 32) {
            const int qq = base_q + lane;
            const int sl = qq < q_end ? st_slot[qq] : -1;
            const bool owned = sl >= 0 && (sl & 7) == warp;
            unsigned mine = __ballot_sync(kFull, owned);
            if (mine == 0u) continue;   // uniform over the warp
            // each lane loads its own staged sample's coordinates and its
            // slot's cell base up front, so the warp's serial walk below
            // takes them by shuffle instead of waiting on one load each
            float my_fs[3] = {0.f, 0.f, 0.f}, my_cb[3] = {0.f, 0.f, 0.f};
            if (owned) {
              bool second;
              const int slot = window_slot(sl, &second);
              const int64_t bank = span.bank0 + (second ? sb1 : sb0);
#pragma unroll
              for (int ax = 0; ax < 3; ++ax) {
                my_fs[ax] = st_fs[ax * stride + qq];
                my_cb[ax] = base[(bank * 3 + ax) * kLanes + slot];
              }
            }
            while (mine) {
              const int b = __ffs(mine) - 1;
              mine &= mine - 1u;
              const int src = base_q + b;
              const int s_idx = __shfl_sync(kFull, sl, b);
              const int r = s_idx >> 3;
              float fs[3], cb[3];
#pragma unroll
              for (int ax = 0; ax < 3; ++ax) {
                fs[ax] = __shfl_sync(kFull, my_fs[ax], b);
                cb[ax] = __shfl_sync(kFull, my_cb[ax], b);
              }
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                if (c_ok[half]) {
                  float tl[3];
#pragma unroll
                  for (int ax = 0; ax < 3; ++ax) {
                    tl[ax] = level_frac(fs[ax], cb[ax], c_r[half]);
                  }
                  const float v = mul(corner_weight(tl, c_corner[half]),
                                      st_denc[c_denc[half] + src]);
                  float* a = wacc + r * cp + lane + 32 * half;
                  *a = add(*a, v);
                }
              }
              hit |= 1u << r;
            }
          }

          // add into the tile's banks: the window's first half (rows 0-15 of
          // every warp) into b0, then its second half (rows 16-31) into b1,
          // the same bank when the window clamps; the accumulator rows are
          // zeroed for the next panel. The rows of one half are distinct
          // bank rows, so up to kFlushRows of them are read together before
          // any is written back (one add per element either way).
          for (int hh = 0; hh < 2; ++hh) {
            unsigned rows_left = hit & (hh ? 0xFFFF0000u : 0x0000FFFFu);
            const int64_t bank_row = (int64_t)(hh ? sb1 : sb0) * kLanes;
            while (rows_left) {
              int rr[kFlushRows];
              float gv[kFlushRows][2];
#pragma unroll
              for (int u = 0; u < kFlushRows; ++u) {
                rr[u] = -1;
                if (rows_left) {
                  rr[u] = __ffs(rows_left) - 1;
                  rows_left &= rows_left - 1u;
                }
              }
#pragma unroll
              for (int u = 0; u < kFlushRows; ++u) {
                if (rr[u] >= 0) {
                  const float* gr = rows_t + (bank_row + ((rr[u] * 8 + warp)
                                              & (kLanes - 1))) * cols + p0;
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    const int cc = lane + 32 * half;
                    if (p0 + cc < pend) gv[u][half] = gr[cc];
                  }
                }
              }
#pragma unroll
              for (int u = 0; u < kFlushRows; ++u) {
                if (rr[u] >= 0) {
                  float* gr = rows_t + (bank_row + ((rr[u] * 8 + warp)
                                        & (kLanes - 1))) * cols + p0;
#pragma unroll
                  for (int half = 0; half < 2; ++half) {
                    const int cc = lane + 32 * half;
                    if (p0 + cc < pend) {
                      gr[cc] = add(gv[u][half], wacc[rr[u] * cp + cc]);
                      wacc[rr[u] * cp + cc] = 0.f;
                    }
                  }
                }
              }
            }
            __syncthreads();
          }
        }
      }
      __syncwarp();   // the region holds factor rows again
    }
  }

  // the block's MLP partials: each warp's sums through its region, the 8
  // warps added in warp order
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < OWN; ++kk) {
    if (own[kk] >= 0) wreg[lane + 32 * kk] = acc[kk];
  }
  __syncthreads();
  for (int ow = ray; ow < n_sc; ow += kRays) {
    float v = regions[ow];
    for (int w = 1; w < kWarps; ++w) v = add(v, regions[w * bl.region + ow]);
    part_mlp[t * n_sc + ow] = v;
  }
}

// The dynamic shared-memory budgets for two blocks per SM and for one; the
// first is -1 when the kernel's registers leave room for one block only.
inline int smem_budgets(const void* fn, int* budget2, int* budget1) {
  int dev = 0, per_sm = 0, optin = 0, reserved = 0, regs_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &regs_sm, cudaDevAttrMaxRegistersPerMultiprocessor, dev);
  }
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return (int)err;
  const int regs = (fa.numRegs + 7) / 8 * 8;   // allocated in steps of 8
  *budget2 = 2 * kRays * regs <= regs_sm
                 ? per_sm / 2 - reserved - (int)fa.sharedSizeBytes
                 : -1;
  *budget1 = optin - (int)fa.sharedSizeBytes;
  return 0;
}

template <int SUBS, int OWN>
int layout_for(const GridConsts& k, BwdLayout* bl) {
  int budget2 = 0, budget1 = 0;
  const int err = smem_budgets(
      (const void*)hash_grid_backward_kernel<SUBS, OWN>, &budget2, &budget1);
  if (err != 0) return err;
  *bl = bwd_layout(k.h.n_sc, k.h.enc, k.h.hidden, k.cols, budget2, budget1);
  if (bl->g == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      hash_grid_backward_kernel<SUBS, OWN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bl->floats * 4);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(hash_grid_backward_kernel<SUBS, OWN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch is unaffected
    return (int)e;
  }
  return 0;
}

template <int SUBS, int OWN>
int launch(int n_tiles, cudaStream_t stream, const float* tabs,
           const uint16_t* samp, const float* base, const float* rayt,
           const int* ke, const int* bank0, const int* desc, const float* sc,
           const float* gs, float* d_rows, float* part_mlp, float* s_pre,
           const GridConsts& k) {
  BwdLayout bl;
  const int err = layout_for<SUBS, OWN>(k, &bl);
  if (err != 0) return err;
  if (n_tiles > 0) {
    hash_grid_backward_kernel<SUBS, OWN>
        <<<n_tiles, kRays, (size_t)bl.floats * 4, stream>>>(
            tabs, samp, base, rayt, ke, bank0, desc, sc, gs, d_rows,
            part_mlp, s_pre, k, bl);
  }
  return (int)cudaGetLastError();
}

template <int SUBS, int OWN>
int occupancy(const GridConsts& k, int* out) {
  BwdLayout bl;
  int err = layout_for<SUBS, OWN>(k, &bl);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  cudaError_t e =
      cudaFuncGetAttributes(&fa, hash_grid_backward_kernel<SUBS, OWN>);
  int blocks = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, hash_grid_backward_kernel<SUBS, OWN>, kRays,
        (size_t)bl.floats * 4);
  }
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)fa.localSizeBytes;
  out[3] = bl.floats * 4;
  out[4] = blocks;
  out[5] = bl.g;
  out[6] = bl.cp;
  return (int)e;
}

}  // namespace

extern "C" int dvt_hash_grid_backward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const int* desc,
    const float* sc, const float* gs, float* d_rows, float* part_mlp,
    float* s_pre, int n_tiles, int k_max, int subs,
    int n_levels, int n_feat, int hidden, float dt, float t_near,
    float t_far, float t_stop, float stop, float lo_x, float lo_y,
    float lo_z, float inv_x, float inv_y, float inv_z, float ns_x,
    float ns_y, float ns_z, const float* ratios, void* stream) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  const GridConsts k = make_grid_consts(
      k_max, n_levels, n_feat, hidden, dt, t_near, t_far, t_stop,
      stop, lo_x, lo_y, lo_z, inv_x, inv_y, inv_z, ns_x, ns_y, ns_z, ratios);
  if (k.h.n_sc > 32 * kOwnLarge) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool small = k.h.n_sc <= 32 * kOwnSmall;
#define DVT_GRID_BWD(S, OWN)                                               \
  return launch<S, OWN>(n_tiles, st, tabs, samp, base, rayt, ke, bank0,    \
                        desc, sc, gs, d_rows, part_mlp, s_pre, k)
  if (subs == 1 && small) DVT_GRID_BWD(1, kOwnSmall);
  if (subs == 1) DVT_GRID_BWD(1, kOwnLarge);
  if (subs == 4 && small) DVT_GRID_BWD(4, kOwnSmall);
  if (subs == 4) DVT_GRID_BWD(4, kOwnLarge);
  if (subs == 16 && small) DVT_GRID_BWD(16, kOwnSmall);
  if (subs == 16) DVT_GRID_BWD(16, kOwnLarge);
#undef DVT_GRID_BWD
  return (int)cudaErrorInvalidValue;
}

// Registers, static shared memory, local memory (stack and spills) per
// thread, dynamic shared memory, resident blocks per SM, the staged group g
// and the panel width of the K8b form `subs` at a spec: out[0..6].
extern "C" int dvt_hash_grid_backward_occupancy(int subs, int n_levels,
                                                int n_feat, int hidden,
                                                int* out) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  float ratios[kMaxLevels] = {};
  const GridConsts k = make_grid_consts(
      8, n_levels, n_feat, hidden, 0.f, 0.f, 1.f, 1.f, 0.f, 0.f, 0.f,
      0.f, 1.f, 1.f, 1.f, 1.f, 1.f, 1.f, ratios);
  if (k.h.n_sc > 32 * kOwnLarge) return (int)cudaErrorInvalidValue;
  const bool small = k.h.n_sc <= 32 * kOwnSmall;
  if (subs == 1) return small ? occupancy<1, kOwnSmall>(k, out)
                              : occupancy<1, kOwnLarge>(k, out);
  if (subs == 4) return small ? occupancy<4, kOwnSmall>(k, out)
                              : occupancy<4, kOwnLarge>(k, out);
  if (subs == 16) return small ? occupancy<16, kOwnSmall>(k, out)
                               : occupancy<16, kOwnLarge>(k, out);
  return (int)cudaErrorInvalidValue;
}
