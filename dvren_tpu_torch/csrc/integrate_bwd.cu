// Per-ray emission-absorption integration, radiance adjoint (K9b).
//
// Replaces dvren_tpu/ops/integrate_pallas.py::_bwd_call (_bwd_kernel): for
// the radiance cotangent g (N, 3) of each ray, with w_k = (P_{k-1} - P_k)
// on processed steps (see integrate.cu) and dot_k = sum_c g_c * c_k,
//
//   dL/dod_j   = proc_j * dot_j * P_j - sum_{k>j} dot_k * w_k
//   d_sigma_j  = dL/dod_j * dt_j * tie(sigma_j * dt_j)   on live steps
//   d_colour_j = w_j * g_c
//
// where tie is d max(x, 0) / dx with 0.5 at x == 0: JAX's autodiff of
// dvren_tpu/ops/integrate.py::integrate and the port's K2 take that value
// (the TPU kernel multiplies by sigma*dt >= 0, i.e. 1 there).
//
// The TPU kernel recomputes P with one triangular matmul and takes the
// suffix sum with another. Here one warp owns a ray and makes two sweeps
// over 32-step chunks: forward, a warp inclusive scan of od recomputes P_k
// and parks it in the d_sigma row (stopping at the chunk where the carried
// P falls to stop: every later output is zero); backward, chunk by chunk
// from the last live one, a reversed warp scan (__shfl_down_sync) of
// dot*w gives each step the sum over the later steps of its chunk, and a
// carry adds the later chunks'. The suffix is never a total minus a prefix
// (that cancels), and the order is fixed: repeats are bit-identical.
//
// Bound on the H100: bytes. Each processed step reads sigma, dt, three
// colours and a mask byte and writes four floats; the P row it parks is a
// round trip the design adds. expf, no fast math.

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

// lane j gets the sum of v over lanes j..31
__device__ __forceinline__ float warp_suffix_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

__global__ void integrate_backward_kernel(
    const float* __restrict__ sigma, const float* __restrict__ cr,
    const float* __restrict__ cg, const float* __restrict__ cb,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ gin, float* __restrict__ dsig,
    float* __restrict__ dcr, float* __restrict__ dcg, float* __restrict__ dcb,
    int n, int k, float stop) {
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;  // the whole warp leaves together
  const int64_t base = ray * (int64_t)k;
  const float gr = gin[ray * 3 + 0];
  const float gg = gin[ray * 3 + 1];
  const float gb = gin[ray * 3 + 2];

  // sweep 1: P_k into the d_sigma row; k_dead = the first step whose
  // T_before is <= stop (no step from it on is processed), c_end = the end
  // of its chunk
  float s_carry = 0.0f, p_carry = 1.0f;
  int c_end = k, k_dead = k;
  for (int c0 = 0; c0 < k; c0 += 32) {
    const int kk = c0 + lane;
    const bool in = kk < k;
    float od = 0.0f;
    if (in && mask[base + kk] != 0)
      od = fmaxf(sigma[base + kk] * dt[base + kk], 0.0f);
    const float s = s_carry + warp_incl_scan(od, lane);
    const float p = expf(-s);
    if (in) dsig[base + kk] = p;
    float tb = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) tb = p_carry;
    const unsigned dead = __ballot_sync(kFull, in && !(tb > stop));
    s_carry = __shfl_sync(kFull, s, 31);
    p_carry = __shfl_sync(kFull, p, 31);
    if (dead || p_carry <= stop) {
      k_dead = dead ? c0 + __ffs(dead) - 1 : c0 + 32;
      c_end = c0 + 32 < k ? c0 + 32 : k;
      break;
    }
  }
  for (int kk = c_end + lane; kk < k; kk += 32) {
    dsig[base + kk] = 0.0f;
    dcr[base + kk] = 0.0f;
    dcg[base + kk] = 0.0f;
    dcb[base + kk] = 0.0f;
  }
  __syncwarp();

  // sweep 2: chunks from the last live one down to the first
  float suffix_carry = 0.0f;  // sum of dot*w over the later chunks
  for (int c0 = ((c_end - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
    const int kk = c0 + lane;
    const bool in = kk < c_end;
    float p = 0.0f, sg = 0.0f, dtv = 0.0f, vr = 0.0f, vg = 0.0f, vb = 0.0f;
    bool live = false;
    if (in) {
      p = dsig[base + kk];
      sg = sigma[base + kk];
      dtv = dt[base + kk];
      live = mask[base + kk] != 0;
    }
    float tb = __shfl_up_sync(kFull, p, 1);
    if (lane == 0) tb = c0 == 0 ? 1.0f : dsig[base + c0 - 1];
    const bool proc = live && kk < k_dead;
    const float w = proc ? tb - p : 0.0f;
    float dot = 0.0f;
    if (proc) {
      vr = cr[base + kk];
      vg = cg[base + kk];
      vb = cb[base + kk];
      dot = vr * gr + vg * gg + vb * gb;
    }
    const float incl = warp_suffix_scan(dot * w, lane);
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) excl = 0.0f;
    const float suffix = suffix_carry + excl;
    suffix_carry += __shfl_sync(kFull, incl, 0);
    const float dl = (proc ? dot * p : 0.0f) - suffix;
    const float sdt = sg * dtv;
    const float tie = sdt > 0.0f ? 1.0f : (sdt == 0.0f ? 0.5f : 0.0f);
    __syncwarp();  // every lane has read its P (lane 0 its neighbour's)
    if (in) {
      dsig[base + kk] = live ? (dl * dtv) * tie : 0.0f;
      dcr[base + kk] = w * gr;
      dcg[base + kk] = w * gg;
      dcb[base + kk] = w * gb;
    }
  }
}

}  // namespace

extern "C" int dvt_integrate_backward(const float* sigma, const float* cr,
                                      const float* cg, const float* cb,
                                      const float* dt, const uint8_t* mask,
                                      const float* g, float* dsig, float* dcr,
                                      float* dcg, float* dcb, int n, int k,
                                      float stop, void* stream) {
  if (n > 0 && k > 0) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    integrate_backward_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                                (cudaStream_t)stream>>>(
        sigma, cr, cg, cb, dt, mask, g, dsig, dcr, dcg, dcb, n, k, stop);
  }
  return (int)cudaGetLastError();
}
