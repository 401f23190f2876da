// Shared device code of the fused hash-grid kernels (K8f hash_grid.cu, K8b
// hash_grid_bwd.cu): the constants, the tile lattice with its window start
// step, and a sample's multi-level encoding read from its bank slot.
//
// Every float operation uses the _rn intrinsics (no FMA contraction) in
// the order of dvren_tpu_torch/ops/hash_grid.py's plain twins, which is
// the order of dvren_tpu/ops/hash_grid.py's _sample_geometry_hash /
// _encode_from_banks / _mlp_heads:
//   finest coordinate fs = ((o + d * st - lo) * inv) * ns per axis;
//   level fraction t = fs - base at ratio 1, else fs * r - floor(base * r);
//   corner weight (wz * wy) * wx in corner order dz*4 + dy*2 + dx;
//   enc[l*F + f] = sum over corners in order of w * bank column
//   (l*8 + corner)*F + f; pre[j] = (sum over i of w1[j, i] * enc[i]) + b1[j].
#pragma once

#include "hash_tiles.cuh"

namespace dvt_grid {

using namespace dvt_hash;

constexpr int kMaxEnc = 64;   // encoding_dim <= 64 (ops/hash_grid.py::grid_path_ok)

struct GridConsts {
  HashConsts h;   // lattice, spec sizes; h.res[l] = res_l / res_finest
  int nb, cols;   // banks per tile, C = L*8*F bank columns
  float lo[3], inv[3], ns[3];
};

inline GridConsts make_grid_consts(int nc, int nb, int k_max, int n_levels,
                                   int n_feat, int hidden, float dt,
                                   float t_near, float t_far, float t_stop,
                                   float stop, float lo_x, float lo_y,
                                   float lo_z, float inv_x, float inv_y,
                                   float inv_z, float ns_x, float ns_y,
                                   float ns_z, const float* ratios) {
  GridConsts k;
  k.h = make_consts(nc, k_max, n_levels, n_feat, 0, hidden, dt, t_near,
                    t_far, t_stop, stop, ratios);
  k.nb = nb;
  k.cols = n_levels * 8 * n_feat;
  k.lo[0] = lo_x; k.lo[1] = lo_y; k.lo[2] = lo_z;
  k.inv[0] = inv_x; k.inv[1] = inv_y; k.inv[2] = inv_z;
  k.ns[0] = ns_x; k.ns[1] = ns_y; k.ns[2] = ns_z;
  return k;
}

// Host check of the spec limits the kernels' register arrays assume.
inline bool spec_ok(int n_levels, int n_feat, int hidden) {
  return n_levels >= 1 && n_feat >= 1 && n_levels * n_feat <= kMaxEnc
         && n_levels <= kMaxLevels && hidden >= 1 && hidden <= kMaxHidden;
}

// Step kk of a tile whose window starts at step ket: live flag, segment
// length dt_actual and mid-segment depth (fused_tiles._chunk_geometry).
struct TileTime {
  float t_origin, t_origin_c;
  __device__ __forceinline__ TileTime(int ket, const HashConsts& k) {
    t_origin = add(k.t_near, mul((float)ket, k.dt));
    t_origin_c = fminf(t_origin, k.t_stop);
  }
  __device__ __forceinline__ bool step(int kk, const HashConsts& k,
                                       float* dta, float* mid) const {
    const float base_t = add(k.t_near, mul((float)kk, k.dt));
    if (!(base_t < k.t_far && kk < k.k_max)) return false;
    *dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
    const float tcur =
        add(t_origin, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));
    *mid = add(tcur, mul(0.5f, *dta));
    return true;
  }
};

// The sample's coordinates on the finest cell grid.
__device__ __forceinline__ void finest_coords(const float o[3],
                                              const float d[3], float st,
                                              const GridConsts& k,
                                              float fs[3]) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float p = add(o[ax], mul(d[ax], st));
    fs[ax] = mul(mul(sub(p, k.lo[ax]), k.inv[ax]), k.ns[ax]);
  }
}

// The fraction of coordinate f in its level cell, at ratio r, for the
// finest cell base cb.
__device__ __forceinline__ float level_frac(float f, float cb, float r) {
  return r == 1.f ? sub(f, cb) : sub(mul(f, r), floorf(mul(cb, r)));
}

// Corner weight (wz * wy) * wx of corner c from the three fractions.
__device__ __forceinline__ float corner_weight(const float t[3], int c) {
  const float wx = (c & 1) ? t[0] : sub(1.f, t[0]);
  const float wy = ((c >> 1) & 1) ? t[1] : sub(1.f, t[1]);
  const float wz = (c >> 2) ? t[2] : sub(1.f, t[2]);
  return mul(mul(wz, wy), wx);
}

// The sample's encoding from its bank slot (col points at column 0 of the
// slot; column stride kLanes), folded into the first layers'
// pre-activations; with enc_out the features are written there too.
template <bool kColor>
__device__ __forceinline__ void grid_encode(const float fs[3],
                                            const float cb[3],
                                            const float* col,
                                            const float* sc,
                                            const GridConsts& k,
                                            const MlpLayout& lay,
                                            float pre_s[kMaxHidden],
                                            float pre_c[kMaxHidden],
                                            float* enc_out) {
  const int n_f = k.h.n_feat;
  zero_pre(pre_s, pre_c);
  for (int l = 0; l < k.h.n_levels; ++l) {
    const float r = k.h.res[l];
    float t[3], w8[8];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) t[ax] = level_frac(fs[ax], cb[ax], r);
#pragma unroll
    for (int c = 0; c < 8; ++c) w8[c] = corner_weight(t, c);
    for (int f = 0; f < n_f; ++f) {
      const float* v = col + (l * 8 * n_f + f) * kLanes;
      float e = mul(w8[0], v[0]);
#pragma unroll
      for (int c = 1; c < 8; ++c) e = add(e, mul(w8[c], v[c * n_f * kLanes]));
      const int i = l * n_f + f;
      if (enc_out != nullptr) enc_out[i] = e;
      fold_feature<kColor>(i, e, sc, k.h, lay, pre_s, pre_c);
    }
  }
  add_biases<kColor>(sc, k.h, lay, pre_s, pre_c);
}

// The window slot of a tile-local lane: (clipped slot, second bank?).
__device__ __forceinline__ int window_slot(int idx2, bool* second) {
  *second = idx2 >= kLanes;
  return *second ? min(max(idx2 - kLanes, 0), kLanes - 1)
                 : min(max(idx2, 0), kLanes - 1);
}

}  // namespace dvt_grid
