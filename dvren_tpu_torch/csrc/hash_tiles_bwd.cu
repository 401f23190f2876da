// Fused hash-MLP tile backward (K7b): the recompute adjoint of K7f, with
// the hash-table and MLP-weight gradients as partial sums.
//
// Replaces dvren_tpu/ops/hash_tiles.py::_bwd_kernel (launched by
// _hash_tile_op.bwd_call). Inputs are K7f's (csrc/hash_tiles.cu) plus
//   gs       (T, 5, 16, 16) f32  d(loss)/d(K7f output) per ray
// Outputs:
//   part_tab (T*split, L*T*F) f32  each block's d(table), (L, T, F) order
//   part_mlp (T*8, P) f32       each warp's d(MLP scalars), _mlp_layout order
//   s_pre    (T, nc*8, 256) f32  scratch: each sample's optical-depth prefix
// The wrapper (ops/hash_tiles.py::hash_tile_backward) sums the partials
// over their first axis with torch.sum, as XLA sums the TPU kernel's
// per-grid-step partials.
//
// A tile's 256 rays are split over `split` blocks of 32*warps threads
// (warps 4, 2 or 1, split = 8 / warps; the launcher takes the choice that
// keeps the most warps resident on an SM), one thread per ray; a warp's
// rays are a 4x8 pixel block of the tile. The block keeps the table and
// the MLP scalars (as K7f's feature-major rows) in shared memory, and per
// warp a copy of d(table) and 32 stage rows.
// - Pass 1 reruns K7f's recurrence (sigma head only) and stores every
//   sample's exclusive prefix S until the ray's transmittance falls to
//   `stop` or its lattice ends; every step from there contributes exactly
//   0 to every gradient, so pass 2 skips it.
// - Pass 2: each warp walks its rays' steps in reverse on its own (no
//   block barrier), with a running suffix sum of gw*w: dod = gw*p -
//   suffix + g_odp, d sigma = dod * tie(x) * dt, d colour = g * w, then
//   through the heads with JAX's tie values (0.5 at max(x, 0) == 0, and
//   at each end of the colour clamp), to d(pre-activations) and
//   d(encoding). The recompute and d(encoding) read the rows as float4
//   broadcasts; the transmittance after a step is the next step's before
//   it (one expf a step).
// - No float atomics, the same bits on every run.
//   The table gradient is a scatter of 8*L*F terms per sample into the
//   warp's d(table) copy. Neighbouring rays at one step mostly share a
//   level's cell, hence all eight corner entries. Per level and pair of
//   features the lanes are grouped by cell (the lowest pending lane's
//   cell, and a ballot of the lanes in it); one fixed butterfly reduces
//   the members' 16 corner terms of both features (non-members add 0),
//   leaving each term's sum in two lanes, and 16 lanes add them into the
//   copy. Corners that share an entry (known from the hash's structure,
//   corner_collisions) leave their sums to the first of them, which adds
//   them in corner order. Groups go two at a time, their butterflies
//   overlapped and the second's adds after the first's (the order of one
//   at a time, the same bits); at the end the block adds its warps'
//   copies in warp order.
//   The MLP gradients are sums over rays and steps of outer products:
//   left (d pre1 of both heads, d pre2 of both) x right (encoding, hidden
//   activations, 1). Each step the warp's rays write their rows to shared
//   memory and each lane keeps a 4x4 tile of the product in registers
//   (25 tiles at hidden 8, enc 16; one float4 of each side per ray and 16
//   FMAs), summing over the warp's active rays in lane order; each warp
//   writes its own row of part_mlp.
//
// Bound on the H100: the instructions and latency of the scatter's groups (about
// 14 a step at the 512^2 hash headline, 30 at the fit's 96^2 views, most
// at the finest levels), then the recompute's float work. At L=8, T=128,
// F=2, hidden 8 a 4-warp block takes 70,864 B of shared memory, three
// blocks (12 warps) per SM. Timing-only variants
// (tools/torch_hash_bwd_ablate.py, H100 at 700 W), in full / without the
// scatter / without the MLP products / pass 1 alone: 11.67 / 6.57 /
// 9.99 / 1.81 ms at the hash headline, 1.47 / 0.62 / 1.32 / 0.18 at the
// fit's four-view stack. Warps as 2x16 row pairs: 12.00 and 1.57; groups
// one at a time: 11.68 and 1.52.

#include "hash_tiles.cuh"

namespace {

using namespace dvt_hash;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileWarps = kRays / 32;   // 8 warps per tile
constexpr int kMaxBlockWarps = 4;
constexpr int kLeft = 20;   // left row: ds1 (8), dc1 (8), dsig2, dc2 (3)

// The stage rows and the product's 4x4 tiles. Right row: the encoding
// (4*ncb floats), relu(pre_s) (8), relu(pre_c) (8), then (1, 0, 0, 0).
struct BwdDims {
  int ltf;       // L*T*F
  int ncb;       // float4 groups of the encoding
  int rs;        // right row stride: an odd number of float4s
  int nag;       // left row groups per head: 2, or 1 at hidden <= 4
  int n_tiles;   // product tiles
  int rows;      // MlpRows floats
};

__host__ __device__ inline BwdDims bwd_dims(int n_levels, int n_feat,
                                            int t_size, int hidden) {
  BwdDims b;
  const int enc = n_levels * n_feat;
  b.ltf = n_levels * t_size * n_feat;
  b.ncb = (enc + 3) / 4;
  b.rs = 4 * b.ncb + 20;
  if (((b.rs / 4) & 1) == 0) b.rs += 4;
  b.nag = hidden > 4 ? 2 : 1;
  // w1 of both heads, w2 of both, the biases
  b.n_tiles = 2 * b.nag * b.ncb + 2 * b.nag + 2 * b.nag + 1;
  b.rows = MlpRows(enc).floats();
  return b;
}

// Shared memory of a block of `warps` warps: the rows, the stage rows,
// the table and the d(table) copies.
inline size_t bwd_smem(const BwdDims& b, int warps) {
  return (size_t)(b.rows + warps * 32 * (kLeft + b.rs)
                  + b.ltf * (1 + warps)) * 4;
}

// Product tile t: left float4 group a (0-1 ds1, 2-3 dc1, 4 the second
// layers' d pre2) times right float4 group b.
struct Tile {
  int a, b;
  bool ok;
};

__device__ inline Tile tile_of(int t, const BwdDims& bd) {
  const int nag = bd.nag, ncb = bd.ncb;
  auto group = [&](int x) { return nag == 2 ? x : 2 * x; };
  Tile r{0, 0, false};
  const int core = 2 * nag * ncb;
  if (t < core) {                      // w1: d pre1 x encoding
    r = Tile{group(t / ncb), t % ncb, true};
  } else if (t - core < 2 * nag) {     // w2: d pre2 x relu(pre1)
    r = Tile{4, ncb + group(t - core), true};
  } else if (t - core - 2 * nag <= 2 * nag) {   // biases: left x 1
    const int x = t - core - 2 * nag;
    r = Tile{x < 2 * nag ? group(x) : 4, ncb + 4, true};
  }
  return r;
}

// The packed-scalar index of output (u, v) of a tile, or -1 if unused.
__device__ inline int mlp_index(const Tile& tl, int u, int v,
                                const HashConsts& k, const MlpLayout& lay,
                                int ncb) {
  const int hid = k.hidden, enc = k.enc;
  if (tl.b < ncb) {
    const int j = 4 * (tl.a & 1) + u, i = 4 * tl.b + v;
    if (j >= hid || i >= enc) return -1;
    return (tl.a < 2 ? lay.sw1 : lay.cw1) + j * enc + i;
  }
  const int g = tl.b - ncb;
  if (g < 4) {
    const int j = 4 * (g & 1) + v;
    if (j >= hid) return -1;
    if (g < 2) return u == 0 ? lay.sw2 + j : -1;
    return u > 0 ? lay.cw2 + (u - 1) * hid + j : -1;
  }
  if (v != 0) return -1;
  if (tl.a < 4) {
    const int j = 4 * (tl.a & 1) + u;
    if (j >= hid) return -1;
    return (tl.a < 2 ? lay.sb1 : lay.cb1) + j;
  }
  return u == 0 ? lay.sb2 : lay.cb2 + u - 1;
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

// The same for sixteen values: the sum of value lane >> 1 in every lane
// (16 shuffles where two reduce8 take 18), for G independent sets at
// once, stage by stage, so that their shuffle chains overlap.
template <int G>
__device__ __forceinline__ void reduce16(float (&v)[G][16], int lane,
                                         float (&out)[G]) {
  const bool h16 = lane & 16, h8 = lane & 8, h4 = lane & 4, h2 = lane & 2;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float send = h16 ? v[g][k] : v[g][k + 8];
      const float keep = h16 ? v[g][k + 8] : v[g][k];
      v[g][k] = add(keep, __shfl_xor_sync(kFull, send, 16));
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float send = h8 ? v[g][k] : v[g][k + 4];
      const float keep = h8 ? v[g][k + 4] : v[g][k];
      v[g][k] = add(keep, __shfl_xor_sync(kFull, send, 8));
    }
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float send = h4 ? v[g][k] : v[g][k + 2];
      const float keep = h4 ? v[g][k + 2] : v[g][k];
      v[g][k] = add(keep, __shfl_xor_sync(kFull, send, 4));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float send = h2 ? v[g][0] : v[g][1];
    const float keep = h2 ? v[g][1] : v[g][0];
    v[g][0] = add(keep, __shfl_xor_sync(kFull, send, 2));
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    out[g] = add(v[g][0], __shfl_xor_sync(kFull, v[g][0], 1));
  }
}

// Which corners of a cell share a table entry: bit d (1..7) is set when
// corners c and c ^ d do, for every c. The entry of corner c is
// hx[c & 1] ^ hy[(c >> 1) & 1] ^ hz[c >> 2] mod T (hash3), so corners c
// and c ^ d collide exactly when the xor of the axes' differences hx[0] ^
// hx[1], ... over the axes set in d is 0 mod T.
__device__ __forceinline__ unsigned corner_collisions(const int cell[3],
                                                      int t_size) {
  const uint32_t m = (uint32_t)(t_size - 1);
  const uint32_t a = ((uint32_t)cell[0] ^ (uint32_t)(cell[0] + 1)) & m;
  const uint32_t b = (((uint32_t)cell[1] * kPrimeY)
                      ^ ((uint32_t)(cell[1] + 1) * kPrimeY)) & m;
  const uint32_t g = (((uint32_t)cell[2] * kPrimeZ)
                      ^ ((uint32_t)(cell[2] + 1) * kPrimeZ)) & m;
  return ((a == 0u) << 1) | ((b == 0u) << 2) | (((a ^ b) == 0u) << 3)
         | ((g == 0u) << 4) | (((a ^ g) == 0u) << 5)
         | (((b ^ g) == 0u) << 6) | (((a ^ b ^ g) == 0u) << 7);
}

// The differences d for which corner c ^ d comes before corner c: those
// whose highest bit is set in c.
__device__ __forceinline__ unsigned earlier_mask(int c) {
  return ((c & 1) ? 0x02u : 0u) | ((c & 2) ? 0x0cu : 0u)
         | ((c & 4) ? 0xf0u : 0u);
}

// d(encoding) of feature i: sum over j of ds1[j] * sigma_w1[j, i] +
// dc1[j] * color_w1[j, i], from row i of the rows.
__device__ __forceinline__ float denc_of(const float* row, int hidden,
                                         const float ds1[kMaxHidden],
                                         const float dc1[kMaxHidden]) {
  float ws[kMaxHidden], wc[kMaxHidden];
  row8(row, hidden, ws);
  row8(row + kMaxHidden, hidden, wc);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < hidden) acc = add(acc, add(mul(ds1[j], ws[j]), mul(dc1[j], wc[j])));
  }
  return acc;
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

template <int kTiles>   // product tiles per lane
__global__ void __launch_bounds__(32 * kMaxBlockWarps, 3)
hash_backward_kernel(const float* __restrict__ samp,
                     const float* __restrict__ rayt,
                     const float* __restrict__ table,
                     const float* __restrict__ scg,
                     const float* __restrict__ gs,
                     float* __restrict__ part_tab,
                     float* __restrict__ part_mlp,
                     float* __restrict__ s_pre, HashConsts k, int split) {
  extern __shared__ __align__(16) float smem[];
  const BwdDims bd = bwd_dims(k.n_levels, k.n_feat, k.t_size, k.hidden);
  const int warps = blockDim.x >> 5;
  const int n_f = k.n_feat, hid = k.hidden;
  const int stage_floats = 32 * (kLeft + bd.rs);
  float* rows = smem;
  float* stage = rows + bd.rows;                 // per warp: left, right rows
  float* tab = stage + warps * stage_floats;
  float* copies = tab + bd.ltf;                  // (warps, L*T*F)

  load_mlp_rows(rows, scg, k);
  block_copy(tab, table, bd.ltf);
  for (int i = threadIdx.x; i < warps * bd.ltf; i += blockDim.x) copies[i] = 0.f;
  for (int i = threadIdx.x; i < warps * stage_floats; i += blockDim.x) {
    stage[i] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* left_w = stage + warp * stage_floats;   // (32, kLeft)
  float* right_w = left_w + 32 * kLeft;          // (32, rs)
  float* left = left_w + lane * kLeft;
  float* right = right_w + lane * bd.rs;
  const int relu0 = 4 * bd.ncb;
  right[relu0 + 16] = 1.f;
  float* acc_tab = copies + warp * bd.ltf;

  const int64_t t = blockIdx.x / split;
  // the warp's rays: a 4x8 pixel block of the tile, which meets fewer
  // cells per level than a 2x16 row pair (fewer scatter groups)
  const int wt = (blockIdx.x % split) * warps + warp;   // warp of the tile
  const int ray = ((wt >> 1) * 4 + (lane >> 3)) * 16 + (wt & 1) * 8
                  + (lane & 7);
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);
  const float* g = gs + t * 5 * kRays + ray;
  const float g_r = g[0], g_g = g[kRays], g_b = g[2 * kRays];
  const float g_wd = g[3 * kRays], g_odp = g[4 * kRays];
  const int n_steps = k.nc * kSteps;
  float* spre = s_pre + t * n_steps * kRays + ray;   // [q * kRays]
  const MlpRows mr(k.enc);

  auto position = [&](int q, float p[3]) {
    const float st = samp[((t * k.nc + (q >> 3)) * kRows + row) * kLanes
                          + lane0 + (q & 7)];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p[ax] = add(o[ax], mul(d[ax], st));
  };

  // Pass 1: K7f's recurrence over sigma; k_stop = the first step that
  // adds nothing (T <= stop, or past the live lattice). Two steps at a
  // time, as K7f: both samples' sigma heads, then the recurrence.
  int k_stop = n_steps;
  {
    float s = 0.f, tb = 1.f;
    for (int q = 0; q < n_steps && k_stop == n_steps; q += 2) {
      float p[2][3], pre_s[2][kMaxHidden], pre_c[2][kMaxHidden], s2[2];
      position(q, p[0]);
      position(q + 1, p[1]);
      encode_rows_n<false, 2>(p, tab, rows, k, pre_s, pre_c, nullptr);
      sigma_pre2_rows_n<2>(pre_s, rows, k, s2);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float dta, mid;
        if (!(tb > k.stop) || !step_geometry(q + n, k, &dta, &mid)) {
          k_stop = q + n;
          break;
        }
        spre[(q + n) * kRays] = s;
        s = add(s, fmaxf(mul(fmaxf(s2[n], 0.f), dta), 0.f));
        tb = expf(-s);
      }
    }
  }

  Tile tiles[kTiles];
  float acc[kTiles][16];
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    tiles[m] = tile_of(lane + 32 * m, bd);
#pragma unroll
    for (int x = 0; x < 16; ++x) acc[m][x] = 0.f;
  }

  // Pass 2: the reverse adjoint, each warp on its own.
  const int q_hi = __reduce_max_sync(kFull, k_stop);
  float carry = 0.f;   // sum of gw * w over the ray's later steps
  float tb_next = 0.f;   // expf(-S) of the ray's next step
  for (int q = q_hi - 1; q >= 0; --q) {
    const bool active = q < k_stop;
    const unsigned act = __ballot_sync(kFull, active);
    float pp[1][3] = {{0.f, 0.f, 0.f}};
    float (&p)[3] = pp[0];
    float ds1[kMaxHidden], dc1[kMaxHidden];
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) ds1[j] = dc1[j] = 0.f;
    if (active) {
      float dta, mid;
      step_geometry(q, k, &dta, &mid);
      position(q, p);
      float ps[1][kMaxHidden], pc[1][kMaxHidden], sp2[1], cp2[1][3];
      encode_rows_n<true, 1>(pp, tab, rows, k, ps, pc, right);
      sigma_pre2_rows_n<1>(ps, rows, k, sp2);
      color_pre2_rows_n<1>(pc, rows, k, cp2);
      const float(&pre_s)[kMaxHidden] = ps[0];
      const float(&pre_c)[kMaxHidden] = pc[0];
      const float s_pre2 = sp2[0];
      const float(&c_pre2)[3] = cp2[0];
      const float sig = fmaxf(s_pre2, 0.f);
      float rgb[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) rgb[ch] = fminf(fmaxf(c_pre2[ch], 0.f), 1.f);

      const float sp = spre[q * kRays];
      const float x = mul(sig, dta);
      const float od = fmaxf(x, 0.f);
      const float tb = expf(-sp);
      // the prefix after this step is the next step's (pass 1's add)
      const float pn = q == k_stop - 1 ? expf(-add(sp, od)) : tb_next;
      tb_next = tb;
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
      float w2[kMaxHidden], cw2[3][kMaxHidden];
      row8(rows + mr.w2(), hid, w2);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) row8(rows + mr.cw2() + ch * kMaxHidden, hid, cw2[ch]);
#pragma unroll
      for (int j = 0; j < kMaxHidden; ++j) {
        if (j < hid) {
          ds1[j] = mul(mul(dsig2, w2[j]), tie(pre_s[j]));
          float dh = 0.f;
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) dh = add(dh, mul(dc2[ch], cw2[ch][j]));
          dc1[j] = mul(dh, tie(pre_c[j]));
        }
      }
      store4(left, ds1[0], ds1[1], ds1[2], ds1[3]);
      store4(left + 4, ds1[4], ds1[5], ds1[6], ds1[7]);
      store4(left + 8, dc1[0], dc1[1], dc1[2], dc1[3]);
      store4(left + 12, dc1[4], dc1[5], dc1[6], dc1[7]);
      store4(left + 16, dsig2, dc2[0], dc2[1], dc2[2]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* pre = h ? pre_c : pre_s;
        store4(right + relu0 + 8 * h, fmaxf(pre[0], 0.f), fmaxf(pre[1], 0.f),
               fmaxf(pre[2], 0.f), fmaxf(pre[3], 0.f));
        store4(right + relu0 + 8 * h + 4, fmaxf(pre[4], 0.f),
               fmaxf(pre[5], 0.f), fmaxf(pre[6], 0.f), fmaxf(pre[7], 0.f));
      }
    }

    // d(table): per level and feature pair, d(encoding), then the cell
    // groups' sums into the warp's copy
    for (int l = 0; l < k.n_levels; ++l) {
      float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int ic[3] = {0, 0, 0};
      if (active) level_cell(p, k.res[l], w, ic);
      float* acc_l = acc_tab + l * k.t_size * n_f;
      for (int f = 0; f < n_f; f += 2) {
        const bool two = f + 1 < n_f;
        const int i = l * n_f + f;
        float d0 = 0.f, d1 = 0.f;
        if (active) {
          d0 = denc_of(rows + i * MlpRows::kRow, hid, ds1, dc1);
          if (two) d1 = denc_of(rows + (i + 1) * MlpRows::kRow, hid, ds1, dc1);
        }
        // the next group: the active lanes in the lowest pending lane's
        // cell (the cell is the same in every lane)
        auto take = [&](unsigned& pending, int cell[3]) {
          const int leader = __ffs(pending) - 1;
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            cell[ax] = __shfl_sync(kFull, ic[ax], leader);
          }
          const bool member = active && ic[0] == cell[0]
                              && ic[1] == cell[1] && ic[2] == cell[2];
          pending &= ~__ballot_sync(kFull, member);
          return member;
        };
        // a member's 16 corner terms of both features; non-members add
        // 0 (w is finite in every lane)
        auto terms = [&](bool member, float (&v)[16]) {
          const float m0 = member ? d0 : 0.f, m1 = member ? d1 : 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            v[2 * c] = mul(w[c], m0);
            v[2 * c + 1] = mul(w[c], m1);
          }
        };
        // add a group's sums into the copy: lanes 4c and 4c + 2 hold
        // corner c's sums (features 0, 1); corners that hash to one entry
        // add in corner order, in the lane of the first of them
        auto put = [&](const int cell[3], float sum) {
          const int c_own = lane >> 2;
          const int key = corner_entry(cell, c_own, k.t_size);
          const unsigned z = corner_collisions(cell, k.t_size);
          const bool own_first = (z & earlier_mask(c_own)) == 0;
          float total = sum;
          if (z != 0) {   // uniform over the warp
            total = 0.f;
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float o = __shfl_sync(kFull, sum, (c << 2) | (lane & 2));
              if (((z | 1u) >> (c ^ c_own)) & 1u) total = add(total, o);
            }
          }
          const bool writer = two ? (lane & 1) == 0 : (lane & 3) == 0;
          if (writer && own_first) {
            float* a = acc_l + key * n_f + f + ((lane >> 1) & 1);
            *a = add(*a, total);
          }
        };
        for (unsigned pending = act; pending;) {    // uniform over the warp
          int ca[3];
          const bool ma = take(pending, ca);
          if (two && pending != 0) {   // two groups, butterflies overlapped
            int cb[3];
            const bool mb = take(pending, cb);
            float v[2][16], sums[2];
            terms(ma, v[0]);
            terms(mb, v[1]);
            reduce16<2>(v, lane, sums);
            put(ca, sums[0]);
            __syncwarp();   // the second group may share entries
            put(cb, sums[1]);
          } else if (two) {
            float v[1][16], sums[1];
            terms(ma, v[0]);
            reduce16<1>(v, lane, sums);
            put(ca, sums[0]);
          } else {
            const float m0 = ma ? d0 : 0.f;
            float v[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) v[c] = mul(w[c], m0);
            put(ca, reduce8(v, lane));
          }
          __syncwarp();   // the next group may share entries
        }
      }
    }

    // the MLP gradient: this step's outer products over the warp's
    // active rays, in lane order
    __syncwarp();
    for (unsigned m = act; m; m &= m - 1) {
      const int r = __ffs(m) - 1;
      const float* lr = left_w + r * kLeft;
      const float* rr = right_w + r * bd.rs;
#pragma unroll
      for (int mm = 0; mm < kTiles; ++mm) {
        const float4 a = *reinterpret_cast<const float4*>(lr + 4 * tiles[mm].a);
        const float4 b = *reinterpret_cast<const float4*>(rr + 4 * tiles[mm].b);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            acc[mm][4 * u + v] = fmaf(av[u], bv[v], acc[mm][4 * u + v]);
          }
        }
      }
    }
    __syncwarp();   // read before the next step's rows are written
  }

  // this warp's MLP partials: each scalar from exactly one tile
  const MlpLayout lay(k);
  float* pm = part_mlp + (t * kTileWarps + wt) * k.n_sc;
#pragma unroll
  for (int mm = 0; mm < kTiles; ++mm) {
    if (tiles[mm].ok) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int idx = mlp_index(tiles[mm], u, v, k, lay, bd.ncb);
          if (idx >= 0) pm[idx] = acc[mm][4 * u + v];
        }
      }
    }
  }
  __syncthreads();   // every warp's d(table) adds are done
  for (int e = threadIdx.x; e < bd.ltf; e += blockDim.x) {
    float v = copies[e];
    for (int c = 1; c < warps; ++c) v = add(v, copies[c * bd.ltf + e]);
    part_tab[(int64_t)blockIdx.x * bd.ltf + e] = v;
  }
}

using BwdKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*,
                           float*, HashConsts, int);

BwdKernel bwd_kernel(int tiles_per_lane) {
  switch (tiles_per_lane) {
    case 1: return hash_backward_kernel<1>;
    case 2: return hash_backward_kernel<2>;
    case 3: return hash_backward_kernel<3>;
    default: return nullptr;
  }
}

// The launch configuration of a spec: the instance, warps per block and
// resident blocks per SM, taking the warps per block (4, 2 or 1) that
// keep the most warps resident on an SM (the larger block on a tie).
struct BwdConfig {
  BwdKernel kernel;
  int warps, blocks;
  size_t smem;
};

cudaError_t bwd_config(const BwdDims& bd, BwdConfig* cfg) {
  cfg->kernel = bwd_kernel((bd.n_tiles + 31) / 32);
  if (cfg->kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        cfg->kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  }
  if (err != cudaSuccess) return err;
  cfg->warps = 0;
  int best = 0;
  for (int warps = kMaxBlockWarps; warps >= 1; warps /= 2) {
    const size_t smem = bwd_smem(bd, warps);
    if (smem > (size_t)limit) continue;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, cfg->kernel, 32 * warps, smem);
    if (err != cudaSuccess) return err;
    if (blocks * warps > best) {
      best = blocks * warps;
      cfg->warps = warps;
      cfg->blocks = blocks;
      cfg->smem = smem;
    }
  }
  return cfg->warps == 0 ? cudaErrorInvalidValue : cudaSuccess;
}

bool spec_ok(int n_levels, int n_feat, int hidden) {
  return n_levels >= 1 && n_feat >= 1 && n_levels * n_feat <= kMaxLevels
         && hidden >= 1 && hidden <= kMaxHidden;
}

}  // namespace

extern "C" int dvt_hash_backward(
    const float* samp, const float* rayt, const float* table,
    const float* sc, const float* gs, float* part_tab, float* part_mlp,
    float* s_pre, int n_tiles, int nc, int k_max, int n_levels, int n_feat,
    int t_size, int hidden, float dt, float t_near, float t_far,
    float t_stop, float stop, const float* res, void* stream) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  const HashConsts k = make_consts(nc, k_max, n_levels, n_feat, t_size,
                                   hidden, dt, t_near, t_far, t_stop, stop,
                                   res);
  BwdConfig cfg;
  const cudaError_t err =
      bwd_config(bwd_dims(n_levels, n_feat, t_size, hidden), &cfg);
  if (err != cudaSuccess) {   // the spec does not fit
    cudaGetLastError();       // clear it: the next launch is unaffected
    return (int)err;
  }
  const int split = kTileWarps / cfg.warps;
  if (n_tiles > 0) {
    cfg.kernel<<<n_tiles * split, 32 * cfg.warps, cfg.smem,
                 (cudaStream_t)stream>>>(samp, rayt, table, sc, gs, part_tab,
                                         part_mlp, s_pre, k, split);
  }
  return (int)cudaGetLastError();
}

// K7b's registers, static and dynamic shared memory (bytes per block),
// local memory (bytes per thread), resident blocks per SM, warps per
// block and product tiles per lane at a spec.
extern "C" int dvt_hash_backward_occupancy(int n_levels, int n_feat,
                                           int t_size, int hidden, int* out) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  const BwdDims bd = bwd_dims(n_levels, n_feat, t_size, hidden);
  BwdConfig cfg;
  cudaError_t err = bwd_config(bd, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, cfg.kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)fa.localSizeBytes;
  out[3] = (int)cfg.smem;
  out[4] = cfg.blocks;
  out[5] = cfg.warps;
  out[6] = (bd.n_tiles + 31) / 32;
  return (int)cudaSuccess;
}
