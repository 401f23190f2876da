// Fused hash-grid tile backward (K8b): the recompute adjoint of K8f, with
// the bank-table gradient as f32 slot rows and the MLP gradients as
// per-tile partial sums.
//
// Replaces dvren_tpu/ops/hash_grid.py::_bwd_kernel (launched by
// _hash_grid_op.bwd_call). Inputs are K8f's (csrc/hash_grid.cu) plus
//   gs       (T, 5, 16, 16) f32  d(loss)/d(K8f output) per ray
// Outputs:
//   d_rows   (T, NB, 128, C) f32  d(bank table), row (t*NB + b)*128 + lane,
//                                 column (l*8 + corner)*F + f (zeroed here)
//   part_mlp (T, P) f32           each tile's d(MLP scalars), _mlp_layout order
//   s_pre    (T, nc*8, 256) f32   scratch: each sample's optical-depth prefix
// The wrapper (ops/hash_grid.py::hash_grid_backward) sums the partials over
// the tiles with torch.sum, as XLA sums the TPU kernel's per-grid-step ones.
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
// - The MLP gradients: per step, each warp sums every scalar's product over
//   its 32 rays with a fixed xor butterfly (all lanes end with the same
//   bits) and one lane adds it into the warp's row of partials in shared
//   memory; at the end the block adds its 8 rows in warp order. No atomics.
// - The bank gradient: each sample adds C products w8_l[corner] *
//   d(enc)[l*F + f] into its window slot's row. As in K2, a tile's bank
//   space belongs to its block; samples that land in the chunk's 256-slot
//   window are staged in shared memory (slot, finest coordinates, d(enc):
//   4 + enc words) in sample order, warp w owns the slots s with s % 8 == w
//   and adds their samples in order into a (256, CP) window accumulator,
//   lane i taking panel columns i and i + 32, recomputing the level weight
//   of its column from the staged coordinates and the slot's cell base; then
//   each touched row is added into its bank row in device memory (first the
//   window's first half into b0, then its second into b1). No float atomics,
//   the same bits on every run.
// - Sub-tiles (SUBS 4 or 16: 8 or 4 px tiles): ray `ray` belongs to
//   sub-tile ray / (256 / SUBS), whose chunk window starts at
//   bank0[(t*nc + c)*SUBS + s]. Staged positions follow sample order, so
//   each sub-tile's samples form one range; the sub-tiles take turns
//   through the one window accumulator in sub-tile order, each flushed
//   into its own (b0, b1), as the TPU kernel adds them (sub-tiles of one
//   tile may share banks) and as csrc/fused_tiles_bwd.cu does for K2.
// - Shared memory bounds nothing the grid path admits: the window
//   accumulator covers CP = min(C, 64) columns at a time (column panels),
//   and the host picks the largest group of g in {8, 4, 2, 1} steps whose
//   staged samples fit beside it (g = 8 at the headline's enc 8; g = 1
//   still fits enc 64, hidden 8), flushing the window after each group.
//
// Bound on the H100: latency (the C slot reads per sample, the staged
// scatter, the butterflies). Arithmetic runs in the plain twin's order
// with _rn intrinsics, so per-sample values equal
// hash_grid.hash_grid_backward_plain's; only the order of the sums over
// samples differs (the twin sums in float64).

#include "hash_grid.cuh"

namespace {

using namespace dvt_grid;

constexpr int kWarps = kRays / 32;
constexpr int kPanel = 64;       // window accumulator columns
constexpr unsigned kFull = 0xffffffffu;
// bytes of dynamic shared memory a block may use on the H100 (227 KB less
// the static warp_total array, with room to spare)
constexpr int kSmemLimit = 232448 - 256;

struct BwdLayout {
  int g;        // steps per staged group
  int cp;       // panel width
  int stride;   // staged rows: 256 * g + 1 (odd: fewer bank conflicts)
  int floats;   // shared-memory floats
};

// Shared memory (floats): sc (P) | warp MLP partials (8, P) | window
// accumulator (256, cp) | staged slots, 3 coordinates, enc d(enc) planes.
inline int bwd_floats(int n_sc, int enc, int cp, int g) {
  const int stride = kRays * g + 1;
  return n_sc * (1 + kWarps) + 2 * kLanes * cp + stride * (4 + enc);
}

inline BwdLayout bwd_layout(int n_sc, int enc, int cols) {
  BwdLayout b;
  b.cp = cols < kPanel ? cols : kPanel;
  b.g = 0;
  for (int g = kSteps; g >= 1; g >>= 1) {
    if (bwd_floats(n_sc, enc, b.cp, g) * 4 <= kSmemLimit) {
      b.g = g;
      break;
    }
  }
  b.stride = kRays * b.g + 1;
  b.floats = b.g ? bwd_floats(n_sc, enc, b.cp, b.g) : 0;
  return b;
}

// Add v's sum over the warp's 32 lanes into acc[o]; lane o % 32 writes.
__device__ __forceinline__ void warp_add(float v, int o, float* acc,
                                         int lane) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    v = add(v, __shfl_xor_sync(kFull, v, off));
  }
  if (lane == (o & 31)) acc[o] = add(acc[o], v);
}

template <int SUBS>
__global__ void __launch_bounds__(kRays)
hash_grid_backward_kernel(const float* __restrict__ tabs,
                          const uint16_t* __restrict__ samp,
                          const float* __restrict__ base,
                          const float* __restrict__ rayt,
                          const int* __restrict__ ke,
                          const int* __restrict__ bank0,
                          const float* __restrict__ scg,
                          const float* __restrict__ gs,
                          float* __restrict__ d_rows,
                          float* __restrict__ part_mlp,
                          float* __restrict__ s_pre, GridConsts k,
                          BwdLayout bl) {
  extern __shared__ float smem[];
  const HashConsts& h = k.h;
  const int n_sc = h.n_sc, enc = h.enc, hid = h.hidden, n_f = h.n_feat;
  const int cols = k.cols, cp = bl.cp, stride = bl.stride;
  float* sc = smem;
  float* mlp_acc = sc + n_sc;                   // (8, P)
  float* win_acc = mlp_acc + kWarps * n_sc;     // (256, cp)
  int* st_slot = reinterpret_cast<int*>(win_acc + 2 * kLanes * cp);
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
  const int nc = h.nc, nb = k.nb;

  block_copy(sc, scg, n_sc);
  for (int i = ray; i < kWarps * n_sc; i += kRays) mlp_acc[i] = 0.f;
  for (int i = ray; i < 2 * kLanes * cp; i += kRays) win_acc[i] = 0.f;
  // zero the tile's d(table) block (the first __syncthreads below orders
  // it before any thread adds into it)
  float* rows_t = d_rows + t * nb * kLanes * cols;
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
  float* spre = s_pre + t * nc * kSteps * kRays + ray;   // [q * kRays]
  const int n_steps = nc * kSteps;
  __syncthreads();
  const MlpLayout lay(h);

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
    *bank = t * nb + (second ? b1 : b0);
    finest_coords(o, d, st, k, fs);
  };

  // Pass 1: K8f's recurrence over sigma; k_stop = the first step whose
  // transmittance is at or below `stop` (every step from there is 0).
  int k_stop = n_steps;
  {
    float s = 0.f;
    for (int c = 0; c < nc && k_stop == n_steps; ++c) {
      const int b0 = bank0[(t * nc + c) * SUBS + sub_tile] & 0x3FFF;
      const int b1 = min(b0 + 1, nb - 1);
      const uint16_t* sp = samp + (t * nc + c) * 3 * kChunkSamples
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
  float* wmlp = mlp_acc + warp * n_sc;
  float* wacc = win_acc + warp * 32 * cp;
  const int n_groups = kSteps / bl.g;
  for (int c = nc - 1; c >= 0; --c) {
    const int b0 = bank0[(t * nc + c) * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, nb - 1);
    const uint16_t* sp = samp + (t * nc + c) * 3 * kChunkSamples
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
        float enc_v[kMaxEnc], denc[kMaxEnc];
        float pre_s[kMaxHidden], pre_c[kMaxHidden];
        float ds1[kMaxHidden], dc1[kMaxHidden], dc2[3] = {0.f, 0.f, 0.f};
        float dsig2 = 0.f;
        zero_pre(pre_s, pre_c);
#pragma unroll
        for (int jj = 0; jj < kMaxHidden; ++jj) ds1[jj] = dc1[jj] = 0.f;
        for (int i = 0; i < enc; ++i) enc_v[i] = 0.f;
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
          grid_encode<true>(fs, cb, tabs + bank * cols * kLanes + slot, sc,
                            k, lay, pre_s, pre_c, enc_v);
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
          for (int i = 0; i < enc; ++i) {
            float a = 0.f;
#pragma unroll
            for (int jj = 0; jj < kMaxHidden; ++jj) {
              if (jj < hid) {
                a = add(a, add(mul(ds1[jj], sc[lay.sw1 + jj * enc + i]),
                               mul(dc1[jj], sc[lay.cw1 + jj * enc + i])));
              }
            }
            denc[i] = a;
          }
          if ((scat >> j) & 1u) {
            const int pos = pos0 + __popc(sg & ((1u << j) - 1u));
            st_slot[pos] = idx2;
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) st_fs[ax * stride + pos] = fs[ax];
            for (int i = 0; i < enc; ++i) st_denc[i * stride + pos] = denc[i];
          }
        }

        // the MLP gradients of this step, in _mlp_layout order
        int ow = 0;
        for (int jj = 0; jj < hid; ++jj) {          // sigma_w1
          for (int i = 0; i < enc; ++i) warp_add(mul(ds1[jj], enc_v[i]), ow++, wmlp, lane);
        }
        for (int jj = 0; jj < hid; ++jj) warp_add(ds1[jj], ow++, wmlp, lane);
        for (int jj = 0; jj < hid; ++jj) {          // sigma_w2
          warp_add(mul(dsig2, fmaxf(pre_s[jj], 0.f)), ow++, wmlp, lane);
        }
        warp_add(dsig2, ow++, wmlp, lane);
        for (int jj = 0; jj < hid; ++jj) {          // color_w1
          for (int i = 0; i < enc; ++i) warp_add(mul(dc1[jj], enc_v[i]), ow++, wmlp, lane);
        }
        for (int jj = 0; jj < hid; ++jj) warp_add(dc1[jj], ow++, wmlp, lane);
        for (int ch = 0; ch < 3; ++ch) {            // color_w2
          for (int jj = 0; jj < hid; ++jj) {
            warp_add(mul(dc2[ch], fmaxf(pre_c[jj], 0.f)), ow++, wmlp, lane);
          }
        }
        for (int ch = 0; ch < 3; ++ch) warp_add(dc2[ch], ow++, wmlp, lane);
      }
      __syncthreads();   // the group's samples are staged

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
        const int sb0 = bank0[(t * nc + c) * SUBS + sb] & 0x3FFF;
        const int sb1 = min(sb0 + 1, nb - 1);
        for (int p0 = 0; p0 < cols; p0 += cp) {
          const int pend = min(p0 + cp, cols);
          unsigned hit = 0;   // rows of this warp that received a sample
          for (int base_q = q_lo; base_q < q_end; base_q += 32) {
            const int qq = base_q + lane;
            const int sl = qq < q_end ? st_slot[qq] : -1;
            unsigned mine = __ballot_sync(kFull, sl >= 0 && (sl & 7) == warp);
            while (mine) {
              const int b = __ffs(mine) - 1;
              mine &= mine - 1u;
              const int src = base_q + b;
              const int s_idx = __shfl_sync(kFull, sl, b);
              const int r = s_idx >> 3;
              bool second;
              const int slot = window_slot(s_idx, &second);
              const int64_t bank = t * nb + (second ? sb1 : sb0);
              float fs[3], cb[3];
#pragma unroll
              for (int ax = 0; ax < 3; ++ax) {
                fs[ax] = st_fs[ax * stride + src];
                cb[ax] = base[(bank * 3 + ax) * kLanes + slot];
              }
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int col = p0 + lane + 32 * half;
                if (col < pend) {
                  const int l = col / (8 * n_f);
                  const int corner = (col / n_f) & 7;
                  const int f = col - (l * 8 + corner) * n_f;
                  const float rr = h.res[l];
                  float tl[3];
#pragma unroll
                  for (int ax = 0; ax < 3; ++ax) tl[ax] = level_frac(fs[ax], cb[ax], rr);
                  const float v = mul(corner_weight(tl, corner),
                                      st_denc[(l * n_f + f) * stride + src]);
                  float* a = wacc + r * cp + (col - p0);
                  *a = add(*a, v);
                }
              }
              hit |= 1u << r;
            }
          }

          // add into the tile's banks: the window's first half (rows 0-15 of
          // every warp) into b0, then its second half (rows 16-31) into b1,
          // the same bank when the window clamps; the accumulator rows are
          // zeroed for the next panel
          for (int hh = 0; hh < 2; ++hh) {
            unsigned rows_left = hit & (hh ? 0xFFFF0000u : 0x0000FFFFu);
            while (rows_left) {
              const int r = __ffs(rows_left) - 1;
              rows_left &= rows_left - 1u;
              const int slot = r * 8 + warp;
              float* gr = rows_t + ((int64_t)(hh ? sb1 : sb0) * kLanes
                                    + (slot & (kLanes - 1))) * cols + p0;
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int cc = lane + 32 * half;
                if (p0 + cc < pend) {
                  gr[cc] = add(gr[cc], wacc[r * cp + cc]);
                  wacc[r * cp + cc] = 0.f;
                }
              }
            }
            __syncthreads();
          }
        }
      }
    }
  }

  // the block's MLP partials: the 8 warp rows added in warp order
  for (int ow = ray; ow < n_sc; ow += kRays) {
    float v = mlp_acc[ow];
    for (int w = 1; w < kWarps; ++w) v = add(v, mlp_acc[w * n_sc + ow]);
    part_mlp[t * n_sc + ow] = v;
  }
}

template <int SUBS>
int launch(int n_tiles, cudaStream_t stream, const float* tabs,
           const uint16_t* samp, const float* base, const float* rayt,
           const int* ke, const int* bank0, const float* sc, const float* gs,
           float* d_rows, float* part_mlp, float* s_pre, const GridConsts& k,
           const BwdLayout& bl) {
  const cudaError_t err = cudaFuncSetAttribute(
      hash_grid_backward_kernel<SUBS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bl.floats * 4);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it: the next launch is unaffected
    return (int)err;
  }
  if (n_tiles > 0) {
    hash_grid_backward_kernel<SUBS><<<n_tiles, kRays, (size_t)bl.floats * 4,
                                      stream>>>(
        tabs, samp, base, rayt, ke, bank0, sc, gs, d_rows, part_mlp, s_pre,
        k, bl);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dvt_hash_grid_backward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const float* sc,
    const float* gs, float* d_rows, float* part_mlp, float* s_pre,
    int n_tiles, int nc, int nb, int k_max, int subs, int n_levels,
    int n_feat, int hidden, float dt, float t_near, float t_far, float t_stop,
    float stop, float lo_x, float lo_y, float lo_z, float inv_x,
    float inv_y, float inv_z, float ns_x, float ns_y, float ns_z,
    const float* ratios, void* stream) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  const GridConsts k = make_grid_consts(
      nc, nb, k_max, n_levels, n_feat, hidden, dt, t_near, t_far, t_stop,
      stop, lo_x, lo_y, lo_z, inv_x, inv_y, inv_z, ns_x, ns_y, ns_z, ratios);
  const BwdLayout bl = bwd_layout(k.h.n_sc, k.h.enc, k.cols);
  if (bl.g == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DVT_GRID_BWD(S)                                                    \
  return launch<S>(n_tiles, st, tabs, samp, base, rayt, ke, bank0, sc, gs, \
                   d_rows, part_mlp, s_pre, k, bl)
  if (subs == 1) DVT_GRID_BWD(1);
  if (subs == 4) DVT_GRID_BWD(4);
  if (subs == 16) DVT_GRID_BWD(16);
#undef DVT_GRID_BWD
  return (int)cudaErrorInvalidValue;
}
