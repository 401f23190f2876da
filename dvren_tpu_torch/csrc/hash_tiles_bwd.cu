// Fused hash-MLP tile backward (K7b): the recompute adjoint of K7f, with
// the hash-table and MLP-weight gradients as per-tile partial sums.
//
// Replaces dvren_tpu/ops/hash_tiles.py::_bwd_kernel (launched by
// _hash_tile_op.bwd_call). Inputs are K7f's (csrc/hash_tiles.cu) plus
//   gs       (T, 5, 16, 16) f32  d(loss)/d(K7f output) per ray
// Outputs:
//   part_tab (T, L*T*F) f32   each tile's d(table), (L, T, F) order
//   part_mlp (T, P) f32       each tile's d(MLP scalars), _mlp_layout order
//   s_pre    (T, nc*8, 256) f32  scratch: each sample's optical-depth prefix
// The wrapper (ops/hash_tiles.py::hash_tile_backward) sums the partials
// over the tiles with torch.sum, as XLA sums the TPU kernel's per-grid-step
// partials.
//
// One block per tile, one thread per ray, as K7f.
// - Pass 1 reruns K7f's recurrence (sigma head only) and stores every
//   sample's exclusive prefix S until the ray's transmittance falls to
//   `stop` or its lattice ends; every step from there contributes exactly
//   0 to every gradient, so pass 2 skips it.
// - Pass 2 walks the steps in reverse, the whole block in step, with a
//   running suffix sum of gw*w: dod = gw*p - suffix + g_odp, d sigma = dod
//   * tie(x) * dt, d colour = g * w, then through the heads with JAX's
//   tie values (0.5 at max(x, 0) == 0, and at each end of the colour
//   clamp), to d(pre-activations) and d(encoding).
// - No float atomics, the same bits on every run. The MLP gradients are
//   sums of outer products: each step, every ray stages its left vectors
//   (d pre1 of both heads, d pre2 of both) and right vectors (encoding,
//   hidden activations, 1) in shared memory, and one owner thread per MLP
//   scalar adds its products over the 256 rays in ray order into a
//   register (four interleaved chains per step, then added in a fixed
//   order). The table gradient is a scatter of 8*L*F terms per sample
//   into L*T*F entries; each warp owns a private copy of it in shared
//   memory. The 32 rays of a warp are neighbours and sample the same
//   depth, so at each step and level they mostly share one cell, hence
//   all eight corner entries. Per level the lanes are grouped by cell
//   (the lowest pending lane's cell, and a ballot of the lanes in it);
//   for each group and feature the warp reduces the members' eight corner
//   terms with a fixed butterfly (non-members add 0) that leaves corner
//   c's sum in lane 4c, and lane 4c adds it into its entry: eight adds in
//   parallel, or one corner after another when two corners hash to one
//   entry. Groups run one after another. At the end the block adds its
//   copies in copy order.
// - Where 8 copies of d(table) do not fit in shared memory (L*F > 33 at
//   T=128, hidden 8), `share` warps hold one copy together: warps
//   c*share .. c*share + share - 1 add into copy c in turn, warp by warp,
//   each level's turns separated by block barriers, so the order of the
//   adds is still fixed. The launcher takes the most copies that fit (8,
//   4, 2 or 1): 8 for every spec up to L*F = 33, through an instance
//   compiled without the turns (kShared false: the code of one copy per
//   warp); 2 at L*F = 64, the widest spec fast_path_ok admits.
//
// Bound on the H100: latency. One block per SM (about 127 KB of shared
// memory at L=8, T=128, F=2, hidden 8, 8 copies) leaves 8 warps to hide the
// shuffles of the scatter and the owners' shared-memory reads. A first
// version in which the lowest lane of each (level, corner, entry) group
// added the group's terms one by one took 176.7 ms at the 512^2 hash
// headline on the H100 (700 W): neighbouring rays made every group 32
// lanes long. In the present design (33 ms there, 31.5 ms once
// __match_any_sync gave way to the ballot) timing-only variants put
// about 12.7 ms in the table scatter, 4 ms in the MLP owners and 3.3 ms
// in pass 1.

#include "hash_tiles.cuh"

namespace {

using namespace dvt_hash;

constexpr int kWarps = kRays / 32;
constexpr int kMaxOwners = 5;             // ceil(max P / 256), P <= 1076
constexpr unsigned kFull = 0xffffffffu;

struct StageDims {
  int ltf, ls, rs, one;
};

__host__ __device__ inline StageDims stage_dims(int n_levels, int n_feat,
                                                int t_size, int hidden) {
  StageDims s;
  const int enc = n_levels * n_feat;
  s.ltf = n_levels * t_size * n_feat;
  s.ls = 2 * hidden + 5;                  // odd row strides: fewer bank
  s.rs = (enc + 2 * hidden + 1) | 1;      // conflicts on the row writes
  s.one = enc + 2 * hidden;               // the right vectors' constant 1
  return s;
}

// Shared-memory floats: table, MLP scalars, `copies` copies of d(table),
// left and right stage rows. At T=128 and hidden 8, 8 copies fit the
// H100's 227 KB up to L*F = 33, 2 copies up to L*F = 64.
inline int smem_floats(int n_levels, int n_feat, int t_size, int hidden,
                       int copies) {
  const StageDims s = stage_dims(n_levels, n_feat, t_size, hidden);
  const int enc = n_levels * n_feat;
  const int n_sc = 2 * hidden * enc + 6 * hidden + 4;
  return s.ltf * (1 + copies) + n_sc + kRays * (s.ls + s.rs);
}

// Warp sum of eight per-lane values: returns, in every lane, the sum of
// value lane >> 2 over the 32 lanes. Each stage halves the values a lane
// keeps and adds its xor partner's copy of them; the pairing is fixed, so
// the bits do not depend on anything but the inputs.
__device__ __forceinline__ float reduce8(float v[8], int lane) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float send = h16 ? v[k] : v[k + 4];
    const float keep = h16 ? v[k + 4] : v[k];
    v[k] = add(keep, __shfl_xor_sync(kFull, send, 16));
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float send = h8 ? v[k] : v[k + 2];
    const float keep = h8 ? v[k + 2] : v[k];
    v[k] = add(keep, __shfl_xor_sync(kFull, send, 8));
  }
  {
    const float send = h4 ? v[0] : v[1];
    const float keep = h4 ? v[1] : v[0];
    v[0] = add(keep, __shfl_xor_sync(kFull, send, 4));
  }
  v[0] = add(v[0], __shfl_xor_sync(kFull, v[0], 2));
  return add(v[0], __shfl_xor_sync(kFull, v[0], 1));
}

// (left, right) stage columns whose products MLP scalar o sums.
__device__ inline void owner_columns(int o, const HashConsts& k,
                                     const MlpLayout& lay,
                                     const StageDims& sd, int* a, int* b) {
  const int hid = k.hidden, enc = k.enc;
  if (o < lay.sb1) {                 // sigma_w1[j, i]
    *a = o / enc;
    *b = o % enc;
  } else if (o < lay.sw2) {          // sigma_b1[j]
    *a = o - lay.sb1;
    *b = sd.one;
  } else if (o < lay.sb2) {          // sigma_w2[j]: d pre2 * relu(pre1)
    *a = 2 * hid;
    *b = enc + (o - lay.sw2);
  } else if (o < lay.cw1) {          // sigma_b2
    *a = 2 * hid;
    *b = sd.one;
  } else if (o < lay.cb1) {          // color_w1[j, i]
    *a = hid + (o - lay.cw1) / enc;
    *b = (o - lay.cw1) % enc;
  } else if (o < lay.cw2) {          // color_b1[j]
    *a = hid + (o - lay.cb1);
    *b = sd.one;
  } else if (o < lay.cb2) {          // color_w2[ch, j]
    *a = 2 * hid + 1 + (o - lay.cw2) / hid;
    *b = enc + hid + (o - lay.cw2) % hid;
  } else {                           // color_b2[ch]
    *a = 2 * hid + 1 + (o - lay.cb2);
    *b = sd.one;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kRays, 1)
hash_backward_kernel(const float* __restrict__ samp,
                     const float* __restrict__ rayt,
                     const float* __restrict__ table,
                     const float* __restrict__ scg,
                     const float* __restrict__ gs,
                     float* __restrict__ part_tab,
                     float* __restrict__ part_mlp,
                     float* __restrict__ s_pre, HashConsts k,
                     int share_arg) {
  extern __shared__ float smem[];
  const int share = kShared ? share_arg : 1;   // warps per d(table) copy
  const StageDims sd = stage_dims(k.n_levels, k.n_feat, k.t_size, k.hidden);
  const int n_f = k.n_feat;
  const int copies = kWarps / share;
  float* tab = smem;
  float* sc = tab + sd.ltf;
  float* acc_tab = sc + k.n_sc;                    // (copies, L*T*F)
  float* stage_l = acc_tab + copies * sd.ltf;      // (256, ls)
  float* stage_r = stage_l + kRays * sd.ls;        // (256, rs)

  block_copy(tab, table, sd.ltf);
  block_copy(sc, scg, k.n_sc);
  for (int i = threadIdx.x; i < copies * sd.ltf; i += kRays) acc_tab[i] = 0.f;

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int lane = ray & 31;
  const int warp = ray >> 5;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);
  const float* g = gs + t * 5 * kRays + ray;
  const float g_r = g[0], g_g = g[kRays], g_b = g[2 * kRays];
  const float g_wd = g[3 * kRays], g_odp = g[4 * kRays];
  const int n_steps = k.nc * kSteps;
  float* spre = s_pre + t * n_steps * kRays + ray;   // [q * kRays]
  __syncthreads();
  const MlpLayout lay(k);

  auto sample_t = [&](int q) {
    return samp[((t * k.nc + (q >> 3)) * kRows + row) * kLanes + lane0
                + (q & 7)];
  };
  auto position = [&](int q, float p[3]) {
    const float st = sample_t(q);
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p[ax] = add(o[ax], mul(d[ax], st));
  };

  // Pass 1: K7f's recurrence over sigma; k_stop = the first step that
  // adds nothing (T <= stop, or past the live lattice).
  int k_stop = n_steps;
  {
    float s = 0.f;
    for (int q = 0; q < n_steps; ++q) {
      float dta, mid;
      if (!(expf(-s) > k.stop) || !step_geometry(q, k, &dta, &mid)) {
        k_stop = q;
        break;
      }
      spre[q * kRays] = s;
      float p[3], pre_s[kMaxHidden], pre_c[kMaxHidden];
      position(q, p);
      encode_dense<false>(p, tab, sc, k, lay, pre_s, pre_c, nullptr);
      const float sig = fmaxf(sigma_pre2(pre_s, sc, k, lay), 0.f);
      s = add(s, fmaxf(mul(sig, dta), 0.f));
    }
  }

  // the MLP scalars this thread owns, and their stage columns
  int own_a[kMaxOwners], own_b[kMaxOwners];
  float own_acc[kMaxOwners];
#pragma unroll
  for (int m = 0; m < kMaxOwners; ++m) {
    own_acc[m] = 0.f;
    own_a[m] = own_b[m] = 0;
    const int ow = ray + m * kRays;
    if (ow < k.n_sc) owner_columns(ow, k, lay, sd, &own_a[m], &own_b[m]);
  }

  // Pass 2: the reverse adjoint, one step of every ray at a time.
  float carry = 0.f;   // sum of gw * w over the ray's later steps
  float* left = stage_l + ray * sd.ls;
  float* right = stage_r + ray * sd.rs;
  for (int q = n_steps - 1; q >= 0; --q) {
    const bool active = q < k_stop;
    if (!__syncthreads_or(active)) continue;
    float p[3];
    float ds1[kMaxHidden], dc1[kMaxHidden];
    if (active) {
      float dta, mid;
      step_geometry(q, k, &dta, &mid);
      position(q, p);
      float pre_s[kMaxHidden], pre_c[kMaxHidden], c_pre2[3];
      encode_dense<true>(p, tab, sc, k, lay, pre_s, pre_c, right);
      const float s_pre2 = sigma_pre2(pre_s, sc, k, lay);
      color_pre2(pre_c, sc, k, lay, c_pre2);
      const float sig = fmaxf(s_pre2, 0.f);
      float rgb[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[ch] = fminf(fmaxf(c_pre2[ch], 0.f), 1.f);

      const float sp = spre[q * kRays];
      const float x = mul(sig, dta);
      const float od = fmaxf(x, 0.f);
      const float tb = expf(-sp);
      const float pn = expf(-add(sp, od));
      const float w = sub(tb, pn);
      const float gw = add(add(add(mul(g_r, rgb[0]), mul(g_g, rgb[1])),
                               mul(g_b, rgb[2])),
                           mul(g_wd, mid));
      const float dod = add(sub(mul(gw, pn), carry), g_odp);
      const float dsig = mul(mul(dod, tie(x)), dta);
      carry = add(carry, mul(gw, w));

      const float dsig2 = mul(dsig, tie(s_pre2));
      const float gch[3] = {g_r, g_g, g_b};
      float dc2[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float y2 = fmaxf(c_pre2[ch], 0.f);
        const float t_hi = y2 < 1.f ? 1.f : (y2 > 1.f ? 0.f : 0.5f);
        dc2[ch] = mul(mul(mul(gch[ch], w), t_hi), tie(c_pre2[ch]));
      }
#pragma unroll
      for (int j = 0; j < kMaxHidden; ++j) {
        ds1[j] = dc1[j] = 0.f;
        if (j < k.hidden) {
          ds1[j] = mul(mul(dsig2, sc[lay.sw2 + j]), tie(pre_s[j]));
          float dh = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            dh = add(dh, mul(dc2[ch], sc[lay.cw2 + ch * k.hidden + j]));
          }
          dc1[j] = mul(dh, tie(pre_c[j]));
          left[j] = ds1[j];
          left[k.hidden + j] = dc1[j];
          right[k.enc + j] = fmaxf(pre_s[j], 0.f);
          right[k.enc + k.hidden + j] = fmaxf(pre_c[j], 0.f);
        }
      }
      left[2 * k.hidden] = dsig2;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) left[2 * k.hidden + 1 + ch] = dc2[ch];
      right[sd.one] = 1.f;
    } else {
      for (int i = 0; i < sd.ls; ++i) left[i] = 0.f;
      for (int i = 0; i < sd.rs; ++i) right[i] = 0.f;
    }

    // d(table): per level, d(encoding), then the cell groups' sums
    const unsigned act = __ballot_sync(kFull, active);
    for (int l = 0; l < k.n_levels; ++l) {
      float w[8], denc[kMaxLevels];
      int ic[3] = {0, 0, 0};
      if (active) {
        level_cell(p, k.res[l], w, ic);
        for (int f = 0; f < n_f; ++f) {
          const int i = l * n_f + f;
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxHidden; ++j) {
            if (j < k.hidden) {
              acc = add(acc, add(mul(ds1[j], sc[lay.sw1 + j * k.enc + i]),
                                 mul(dc1[j], sc[lay.cw1 + j * k.enc + i])));
            }
          }
          denc[f] = acc;
        }
      }
      float* acc_l = acc_tab + (warp / share) * sd.ltf + l * k.t_size * n_f;
      // lane 4c writes corner c of the group's cell
      const int c_own = lane >> 2;
      const bool writer = (lane & 3) == 0;
      // the warps sharing a copy take their turns in warp order
      for (int turn = 0; turn < share; ++turn) {
      if (warp % share == turn) {
      for (unsigned pending = act; pending;) {    // uniform over the warp
        // the group: the active lanes in the lowest pending lane's cell
        const int leader = __ffs(pending) - 1;
        const int cell[3] = {__shfl_sync(kFull, ic[0], leader),
                             __shfl_sync(kFull, ic[1], leader),
                             __shfl_sync(kFull, ic[2], leader)};
        const bool member = active && ic[0] == cell[0] && ic[1] == cell[1]
                            && ic[2] == cell[2];
        pending &= ~__ballot_sync(kFull, member);
        // serial when two of the cell's corners hash to one entry (every
        // lane finds the same answer)
        int keys[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) keys[c] = corner_entry(cell, c, k.t_size);
        bool serial = false;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = a + 1; b < 8; ++b) serial |= keys[a] == keys[b];
        }
        const int key = corner_entry(cell, c_own, k.t_size);
        for (int f = 0; f < n_f; ++f) {
          const float dv = member ? denc[f] : 0.f;
          float v[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) v[c] = member ? mul(w[c], dv) : 0.f;
          const float sum = reduce8(v, lane);
          float* a = acc_l + key * n_f + f;
          if (!serial) {
            if (writer) *a = add(*a, sum);
          } else {            // two corners share an entry: in corner order
            for (int c = 0; c < 8; ++c) {
              if (lane == 4 * c) *a = add(*a, sum);
              __syncwarp();
            }
          }
        }
        __syncwarp();         // the next group may share entries
      }
      }
      if (kShared) __syncthreads();   // the turn's adds are done
      }
    }
    __syncthreads();   // every ray's stage rows are written

#pragma unroll
    for (int m = 0; m < kMaxOwners; ++m) {
      if (ray + m * kRays < k.n_sc) {
        const float* lc = stage_l + own_a[m];
        const float* rc = stage_r + own_b[m];
        float part[4] = {0.f, 0.f, 0.f, 0.f};   // rays r = 4i + q
        for (int r = 0; r < kRays; r += 4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            part[q] = add(part[q],
                          mul(lc[(r + q) * sd.ls], rc[(r + q) * sd.rs]));
          }
        }
        own_acc[m] = add(own_acc[m],
                         add(add(part[0], part[1]), add(part[2], part[3])));
      }
    }
    // the next step's __syncthreads_or orders these reads before its writes
  }
  __syncthreads();

#pragma unroll
  for (int m = 0; m < kMaxOwners; ++m) {
    const int ow = ray + m * kRays;
    if (ow < k.n_sc) part_mlp[t * k.n_sc + ow] = own_acc[m];
  }
  for (int e = ray; e < sd.ltf; e += kRays) {
    float v = acc_tab[e];
    for (int c = 1; c < copies; ++c) v = add(v, acc_tab[c * sd.ltf + e]);
    part_tab[t * sd.ltf + e] = v;
  }
}

}  // namespace

extern "C" int dvt_hash_backward(
    const float* samp, const float* rayt, const float* table,
    const float* sc, const float* gs, float* part_tab, float* part_mlp,
    float* s_pre, int n_tiles, int nc, int k_max, int n_levels, int n_feat,
    int t_size, int hidden, float dt, float t_near, float t_far,
    float t_stop, float stop, const float* res, void* stream) {
  if (n_levels < 1 || n_levels * n_feat > kMaxLevels || hidden < 1
      || hidden > kMaxHidden) {
    return (int)cudaErrorInvalidValue;
  }
  const HashConsts k = make_consts(nc, k_max, n_levels, n_feat, t_size,
                                   hidden, dt, t_near, t_far, t_stop, stop,
                                   res);
  if (k.n_sc > kMaxOwners * kRays) return (int)cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // the most d(table) copies that fit: 8, 4, 2 or 1
  int copies = kWarps;
  while (copies > 1
         && smem_floats(n_levels, n_feat, t_size, hidden, copies) * 4
                > limit) {
    copies /= 2;
  }
  const int smem = smem_floats(n_levels, n_feat, t_size, hidden, copies) * 4;
  const auto kernel = copies == kWarps ? hash_backward_kernel<false>
                                       : hash_backward_kernel<true>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {   // even one copy does not fit
    cudaGetLastError();       // clear it: the next launch is unaffected
    return (int)err;
  }
  if (n_tiles > 0) {
    kernel<<<n_tiles, kRays, smem, (cudaStream_t)stream>>>(
        samp, rayt, table, sc, gs, part_tab, part_mlp, s_pre, k,
        kWarps / copies);
  }
  return (int)cudaGetLastError();
}
