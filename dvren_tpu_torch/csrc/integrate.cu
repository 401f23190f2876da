// Per-ray emission-absorption integration, forward (K9f).
//
// Replaces dvren_tpu/ops/integrate_pallas.py::_fwd_call (_fwd_kernel): the
// radiance, transmittance, opacity and depth of each ray of an (N, K)
// lattice of sigma, three colour planes and dt (mask: (N, K) bool). With
// od_k = max(sigma_k * dt_k, 0) on live steps and P_k = exp(-sum_{j<=k}
// od_j), step k is processed iff it is live and no step up to k has
// P_{j-1} <= stop (a scan's prefixes may rise by an ulp after falling to
// stop; the processed steps stay a prefix); its weight is P_{k-1} - P_k
// (dvren_tpu/ops/integrate.py::integrate). T is P at the last processed
// step, opacity 1 - T, depth the weighted segment midpoint
// (cursor from t_origin[ray], or t_near) over opacity, t_far where opacity
// <= eps. Output row (N, 8): r, g, b, T, opacity, depth, 0, 0.
//
// The TPU kernel takes both prefix sums (optical depth, dt) as matmuls with
// a triangular ones matrix on the MXU. Here one warp owns a ray and walks
// its steps in chunks of 32: each lane loads one step (neighbouring lanes
// read neighbouring addresses), a warp inclusive scan (__shfl_up_sync)
// gives the chunk's prefixes, and the sums carry from chunk to chunk. The
// warp leaves the loop at the chunk where T_before first falls to stop: no
// later step is processed. Colours are read only for processed steps. The
// per-lane sums are reduced with a fixed butterfly, so repeats are
// bit-identical; the prefix sums and expf are those of the plain twin
// (ops/integrate.py::scan_prefix, torch.exp), so both stop at one step.
//
// Bound on the H100: bytes. Each processed step reads sigma, dt, three
// colours (20 bytes) and a mask byte for about 18 float operations; one
// row of 32 bytes per ray is written. expf, no fast math.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void integrate_forward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ cr,
    const float* __restrict__ cg, const float* __restrict__ cb,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ t_origin, float* __restrict__ out, int n, int k,
    float t_near, float t_far, float stop, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;  // the whole warp leaves together
  const int64_t base = ray * (int64_t)k;
  const float origin = t_origin != nullptr ? t_origin[ray] : t_near;

  float s_carry = 0.0f;  // sum of od before this chunk
  float p_carry = 1.0f;  // P at the step before this chunk
  float d_carry = 0.0f;  // sum of live dt before this chunk
  float r = 0.0f, g = 0.0f, b = 0.0f, wd = 0.0f, t = 1.0f;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int kk = c0 + lane;
    const bool in = kk < k;
    float sg = 0.0f, dtv = 0.0f;
    bool live = false;
    if (in) {
      sg = sigma[base + kk];
      dtv = dt[base + kk];
      live = mask[base + kk] != 0;
    }
    const float od = live ? fmaxf(sg * dtv, 0.0f) : 0.0f;
    const float s = s_carry + warp_incl_scan(od, lane);
    const float p = expf(-s);
    float tb = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) tb = p_carry;
    const unsigned dead = __ballot_sync(kFull, in && !(tb > stop));
    const int first_dead = dead ? __ffs(dead) - 1 : 32;
    const bool proc = live && lane < first_dead;
    const float dtm = live ? dtv : 0.0f;
    const float dsum = d_carry + warp_incl_scan(dtm, lane);
    if (proc) {
      const float w = tb - p;
      const float mid = ((origin + dsum) - dtm) + 0.5f * dtv;
      r += w * cr[base + kk];
      g += w * cg[base + kk];
      b += w * cb[base + kk];
      wd += w * mid;
    }
    // T: P at the last processed step (the processed steps are a prefix)
    const unsigned done = __ballot_sync(kFull, proc);
    if (done) t = __shfl_sync(kFull, p, 31 - __clz(done));
    s_carry = __shfl_sync(kFull, s, 31);
    p_carry = __shfl_sync(kFull, p, 31);
    d_carry = __shfl_sync(kFull, dsum, 31);
    // uniform: no later step is processed
    if (dead || p_carry <= stop) break;
  }
  r = warp_sum(r);
  g = warp_sum(g);
  b = warp_sum(b);
  wd = warp_sum(wd);
  if (lane == 0) {
    const float op = 1.0f - t;
    const float depth = op > eps ? wd / fmaxf(op, eps) : t_far;
    float* row = out + ray * 8;
    row[0] = r;
    row[1] = g;
    row[2] = b;
    row[3] = t;
    row[4] = op;
    row[5] = depth;
    row[6] = 0.0f;
    row[7] = 0.0f;
  }
}

}  // namespace

extern "C" int dvt_integrate_forward(const float* sigma, const float* cr,
                                     const float* cg, const float* cb,
                                     const float* dt, const uint8_t* mask,
                                     const float* t_origin, float* out, int n,
                                     int k, float t_near, float t_far,
                                     float stop, float eps, void* stream) {
  if (n > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    integrate_forward_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
        sigma, cr, cg, cb, dt, mask, t_origin, out, n, k, t_near, t_far, stop,
        eps);
  }
  return (int)cudaGetLastError();
}
