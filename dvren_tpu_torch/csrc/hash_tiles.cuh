// Shared device code of the fused hash-MLP kernels (K7f hash_tiles.cu,
// K7b hash_tiles_bwd.cu, and through hash_grid.cuh K8f / K8b): constants,
// the sample lattice, the hash, the MLP scalars in the packed order (K8)
// and in K7's feature-major rows, the per-sample encoding folded into both
// heads' pre-activations, and the heads' second layers.
//
// Every float operation uses the _rn intrinsics (no FMA contraction) in
// the order of dvren_tpu_torch/ops/hash_tiles.py's plain twins, which is
// the order of dvren_tpu/ops/hash_tiles.py's _encode_chunk / _mlp_heads:
//   position p = o + d * st; per level s = p * res, x0 = floor(s),
//   f = s - x0; corners dz, dy, dx (outer to inner) with weight
//   (wx * wy) * wz; enc[l*F + f] = sum over corners of w * table value;
//   pre[j] = (sum over i of w1[j, i] * enc[i]) + b1[j].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt_hash {

constexpr int kLanes = 128;
constexpr int kRows = 16;
constexpr int kSteps = 8;
constexpr int kRays = 256;
constexpr int kChunkSamples = kRows * kLanes;   // 2048
constexpr int kMaxLevels = 64;                  // encoding_dim <= 64
constexpr int kMaxHidden = 8;                   // hidden_dim <= 8
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

struct HashConsts {
  int nc, k_max, n_levels, n_feat, t_size, hidden, enc, n_sc;
  float dt, t_near, t_far, t_stop, stop;
  float res[kMaxLevels];
};

// Offsets into the packed MLP scalar vector (ops/hash_tiles.py::_mlp_layout).
struct MlpLayout {
  int sw1, sb1, sw2, sb2, cw1, cb1, cw2, cb2;
  __device__ __forceinline__ explicit MlpLayout(const HashConsts& k) {
    const int he = k.hidden * k.enc;
    sw1 = 0;
    sb1 = he;
    sw2 = sb1 + k.hidden;
    sb2 = sw2 + k.hidden;
    cw1 = sb2 + 1;
    cb1 = cw1 + he;
    cw2 = cb1 + k.hidden;
    cb2 = cw2 + 3 * k.hidden;
  }
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// d max(x, 0) / dx with JAX's tie value 0.5 at x == 0.
__device__ __forceinline__ float tie(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? 0.f : 0.5f);
}

// Wrapping uint32 3-prime XOR hash; t_size is a power of two.
__device__ __forceinline__ int hash3(int x, int y, int z, int t_size) {
  const uint32_t h = (uint32_t)x ^ ((uint32_t)y * kPrimeY)
                     ^ ((uint32_t)z * kPrimeZ);
  return (int)(h & (uint32_t)(t_size - 1));
}

// The cell of position p at resolution res (integer corner ic) and the
// eight corner weights (wx*wy)*wz in corner order dz*4 + dy*2 + dx.
__device__ __forceinline__ void level_cell(const float p[3], float res,
                                           float w[8], int ic[3]) {
  float fr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float s = mul(p[ax], res);
    const float fl = floorf(s);
    fr[ax] = sub(s, fl);
    ic[ax] = (int)fl;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 1) ? fr[0] : sub(1.f, fr[0]);
    const float wy = ((c >> 1) & 1) ? fr[1] : sub(1.f, fr[1]);
    const float wz = (c >> 2) ? fr[2] : sub(1.f, fr[2]);
    w[c] = mul(mul(wx, wy), wz);
  }
}

// Table entry of corner c of the cell at ic.
__device__ __forceinline__ int corner_entry(const int ic[3], int c,
                                            int t_size) {
  return hash3(ic[0] + (c & 1), ic[1] + ((c >> 1) & 1), ic[2] + (c >> 2),
               t_size);
}

// The eight corners of level `l` around position p: weights w and table
// entries id, in corner order.
__device__ __forceinline__ void level_corners(const float p[3], float res,
                                              int t_size, float w[8],
                                              int id[8]) {
  int ic[3];
  level_cell(p, res, w, ic);
#pragma unroll
  for (int c = 0; c < 8; ++c) id[c] = corner_entry(ic, c, t_size);
}

// The first layers' pre-activations are folded feature by feature, in
// the i-order of the sums: zero_pre, then fold_feature for i = 0, 1, ...
// as each feature is final, then add_biases; pre_s (and pre_c when
// kColor) end as w1 . enc + b1.
__device__ __forceinline__ void zero_pre(float pre_s[kMaxHidden],
                                         float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    pre_s[j] = 0.f;
    pre_c[j] = 0.f;
  }
}

template <bool kColor>
__device__ __forceinline__ void fold_feature(int i, float e, const float* sc,
                                             const HashConsts& k,
                                             const MlpLayout& lay,
                                             float pre_s[kMaxHidden],
                                             float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) {
      pre_s[j] = add(pre_s[j], mul(sc[lay.sw1 + j * k.enc + i], e));
      if (kColor) pre_c[j] = add(pre_c[j], mul(sc[lay.cw1 + j * k.enc + i], e));
    }
  }
}

template <bool kColor>
__device__ __forceinline__ void add_biases(const float* sc,
                                           const HashConsts& k,
                                           const MlpLayout& lay,
                                           float pre_s[kMaxHidden],
                                           float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) {
      pre_s[j] = add(pre_s[j], sc[lay.sb1 + j]);
      if (kColor) pre_c[j] = add(pre_c[j], sc[lay.cb1 + j]);
    }
  }
}

// Second layer of the sigma head: s_pre2 = sum_j w2[j] * relu(pre_s[j]) + b2.
__device__ __forceinline__ float sigma_pre2(const float pre_s[kMaxHidden],
                                            const float* sc,
                                            const HashConsts& k,
                                            const MlpLayout& lay) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) acc = add(acc, mul(sc[lay.sw2 + j], fmaxf(pre_s[j], 0.f)));
  }
  return add(acc, sc[lay.sb2]);
}

// Second layer of the colour head, before the clamp.
__device__ __forceinline__ void color_pre2(const float pre_c[kMaxHidden],
                                           const float* sc,
                                           const HashConsts& k,
                                           const MlpLayout& lay,
                                           float out[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) {
      if (j < k.hidden) {
        acc = add(acc, mul(sc[lay.cw2 + ch * k.hidden + j],
                           fmaxf(pre_c[j], 0.f)));
      }
    }
    out[ch] = add(acc, sc[lay.cb2 + ch]);
  }
}

// K7's copy of the MLP scalars in shared memory, feature-major rows of 16
// floats, each 16-byte aligned, so that a warp reads a row with float4
// broadcasts (4 loads where the packed order takes 16 scalar loads):
//   w1  (enc, 16) at 0:   row i = sigma_w1[0..7, i], color_w1[0..7, i]
//   b1  (16)  at b1():    sigma_b1[0..7], color_b1[0..7]
//   w2  (8)   at w2():    sigma_w2[0..7]
//   cw2 (3, 8) at cw2():  color_w2[ch, 0..7]
//   b2  (4)   at b2():    sigma_b2, color_b2[0..2]
// Entries past `hidden` are 0 and never enter a sum.
struct MlpRows {
  static constexpr int kRow = 2 * kMaxHidden;
  int enc;
  __host__ __device__ explicit MlpRows(int enc_) : enc(enc_) {}
  __host__ __device__ int b1() const { return enc * kRow; }
  __host__ __device__ int w2() const { return b1() + kRow; }
  __host__ __device__ int cw2() const { return w2() + kMaxHidden; }
  __host__ __device__ int b2() const { return cw2() + 3 * kMaxHidden; }
  __host__ __device__ int floats() const { return b2() + 4; }
};

// Build the rows from the packed vector, the whole block.
__device__ __forceinline__ void load_mlp_rows(float* rows, const float* sc,
                                              const HashConsts& k) {
  const MlpLayout lay(k);
  const MlpRows mr(k.enc);
  const int hid = k.hidden;
  for (int x = threadIdx.x; x < mr.floats(); x += blockDim.x) {
    float v = 0.f;
    if (x < mr.b1()) {
      const int i = x / MlpRows::kRow, r = x % MlpRows::kRow;
      const int j = r % kMaxHidden;
      if (j < hid) v = sc[(r < kMaxHidden ? lay.sw1 : lay.cw1) + j * k.enc + i];
    } else if (x < mr.w2()) {
      const int r = x - mr.b1(), j = r % kMaxHidden;
      if (j < hid) v = sc[(r < kMaxHidden ? lay.sb1 : lay.cb1) + j];
    } else if (x < mr.cw2()) {
      const int j = x - mr.w2();
      if (j < hid) v = sc[lay.sw2 + j];
    } else if (x < mr.b2()) {
      const int r = x - mr.cw2(), j = r % kMaxHidden;
      if (j < hid) v = sc[lay.cw2 + (r / kMaxHidden) * hid + j];
    } else {
      const int r = x - mr.b2();
      v = r == 0 ? sc[lay.sb2] : sc[lay.cb2 + r - 1];
    }
    rows[x] = v;
  }
}

// Eight weights of a row: two float4 broadcasts, one where hidden <= 4.
__device__ __forceinline__ void row8(const float* src, int hidden,
                                     float out[kMaxHidden]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  if (hidden > 4) b = *reinterpret_cast<const float4*>(src + 4);
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// fold_feature from row i of the rows, for N samples: each weight is
// read once for all of them.
template <bool kColor, int N>
__device__ __forceinline__ void fold_row(const float* row, const float (&e)[N],
                                         int hidden,
                                         float (&pre_s)[N][kMaxHidden],
                                         float (&pre_c)[N][kMaxHidden]) {
  float ws[kMaxHidden], wc[kMaxHidden];
  row8(row, hidden, ws);
  if (kColor) row8(row + kMaxHidden, hidden, wc);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) {
      if (j < hidden) {
        pre_s[n][j] = add(pre_s[n][j], mul(ws[j], e[n]));
        if (kColor) pre_c[n][j] = add(pre_c[n][j], mul(wc[j], e[n]));
      }
    }
  }
}

// Encode N samples at p[n] from the (L, T, F) table and fold each feature
// into the first layers' pre-activations as soon as it is final (then the
// biases), each sample in the order of arithmetic of one. A corner's
// features are read together: F = 2 as one float2, any even F in float2
// pairs; an odd F feature by feature. Each corner's entry is hashed once
// per level. With enc_out (N = 1), feature i is also written to
// enc_out[i].
template <bool kColor, int N>
__device__ __forceinline__ void encode_rows_n(const float (&p)[N][3],
                                              const float* tab,
                                              const float* rows,
                                              const HashConsts& k,
                                              float (&pre_s)[N][kMaxHidden],
                                              float (&pre_c)[N][kMaxHidden],
                                              float* enc_out) {
  const int n_f = k.n_feat, hid = k.hidden;
#pragma unroll
  for (int n = 0; n < N; ++n) zero_pre(pre_s[n], pre_c[n]);
  for (int l = 0; l < k.n_levels; ++l) {
    float w[N][8];
    int id[N][8];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      level_corners(p[n], k.res[l], k.t_size, w[n], id[n]);
    }
    const float* lt = tab + l * k.t_size * n_f;
    auto emit = [&](int f, const float (&e)[N]) {
      const int i = l * n_f + f;
      if (enc_out != nullptr) enc_out[i] = e[0];
      fold_row<kColor, N>(rows + i * MlpRows::kRow, e, hid, pre_s, pre_c);
    };
    if ((n_f & 1) == 0) {
      for (int f = 0; f < n_f; f += 2) {
        float e0[N], e1[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float2 v[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            v[c] = *reinterpret_cast<const float2*>(lt + id[n][c] * n_f + f);
          }
          e0[n] = 0.f;
          e1[n] = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            e0[n] = add(e0[n], mul(w[n][c], v[c].x));
            e1[n] = add(e1[n], mul(w[n][c], v[c].y));
          }
        }
        emit(f, e0);
        emit(f + 1, e1);
      }
    } else {
      for (int f = 0; f < n_f; ++f) {
        float e[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          e[n] = 0.f;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            e[n] = add(e[n], mul(w[n][c], lt[id[n][c] * n_f + f]));
          }
        }
        emit(f, e);
      }
    }
  }
  const float* b1 = rows + MlpRows(k.enc).b1();
  float bs[kMaxHidden], bc[kMaxHidden];
  row8(b1, hid, bs);
  if (kColor) row8(b1 + kMaxHidden, hid, bc);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) {
      if (j < hid) {
        pre_s[n][j] = add(pre_s[n][j], bs[j]);
        if (kColor) pre_c[n][j] = add(pre_c[n][j], bc[j]);
      }
    }
  }
}

// sigma_pre2 of N samples from the rows.
template <int N>
__device__ __forceinline__ void sigma_pre2_rows_n(
    const float (&pre_s)[N][kMaxHidden], const float* rows,
    const HashConsts& k, float (&out)[N]) {
  const MlpRows mr(k.enc);
  float w2[kMaxHidden];
  row8(rows + mr.w2(), k.hidden, w2);
  const float b2 = rows[mr.b2()];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) {
      if (j < k.hidden) acc = add(acc, mul(w2[j], fmaxf(pre_s[n][j], 0.f)));
    }
    out[n] = add(acc, b2);
  }
}

// color_pre2 of N samples from the rows.
template <int N>
__device__ __forceinline__ void color_pre2_rows_n(
    const float (&pre_c)[N][kMaxHidden], const float* rows,
    const HashConsts& k, float (&out)[N][3]) {
  const MlpRows mr(k.enc);
  const float4 b2 = *reinterpret_cast<const float4*>(rows + mr.b2());
  const float cb[3] = {b2.y, b2.z, b2.w};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float w[kMaxHidden];
    row8(rows + mr.cw2() + ch * kMaxHidden, k.hidden, w);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxHidden; ++j) {
        if (j < k.hidden) acc = add(acc, mul(w[j], fmaxf(pre_c[n][j], 0.f)));
      }
      out[n][ch] = add(acc, cb[ch]);
    }
  }
}

// Lattice step kk of every ray (tiles start at step 0): live flag, the
// segment length dt_actual and the depth cursor (closed form, as
// fused_tiles._chunk_geometry with k_enter 0).
__device__ __forceinline__ bool step_geometry(int kk, const HashConsts& k,
                                              float* dta, float* mid) {
  const float base_t = add(k.t_near, mul((float)kk, k.dt));
  if (!(base_t < k.t_far && kk < k.k_max)) return false;
  *dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
  const float t_origin_c = fminf(k.t_near, k.t_stop);
  const float tcur =
      add(k.t_near, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));
  *mid = add(tcur, mul(0.5f, *dta));
  return true;
}

// The ray's origin and direction from the compact ray planes.
__device__ __forceinline__ void load_ray(const float* rayt, int64_t t,
                                         int ray, float o[3], float d[3]) {
  const float* rt = rayt + t * 12 * kLanes;
  const int half = ray >> 7;
  const int rl = ray & (kLanes - 1);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = rt[(ax * 2 + half) * kLanes + rl];
    d[ax] = rt[((3 + ax) * 2 + half) * kLanes + rl];
  }
}

// Copy n floats from global to shared memory, the whole block.
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

inline HashConsts make_consts(int nc, int k_max, int n_levels, int n_feat,
                              int t_size, int hidden, float dt, float t_near,
                              float t_far, float t_stop, float stop,
                              const float* res) {
  HashConsts k;
  k.nc = nc;
  k.k_max = k_max;
  k.n_levels = n_levels;
  k.n_feat = n_feat;
  k.t_size = t_size;
  k.hidden = hidden;
  k.enc = n_levels * n_feat;
  k.n_sc = 2 * hidden * k.enc + 6 * hidden + 4;
  k.dt = dt;
  k.t_near = t_near;
  k.t_far = t_far;
  k.t_stop = t_stop;
  k.stop = stop;
  for (int l = 0; l < kMaxLevels; ++l) k.res[l] = l < n_levels ? res[l] : 0.f;
  return k;
}

}  // namespace dvt_hash
