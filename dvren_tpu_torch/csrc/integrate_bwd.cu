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
// suffix sum with another. Here one warp owns a ray and holds its row in
// registers (integrate.cuh): up to 128 steps, lane j steps j, j+32, j+64,
// j+96. Sigma, dt, the mask and the colours are read once, all before the
// first scan; the forward scans (a warp inclusive scan of od per chunk, in
// order, carried) give P, T_before and each processed step's weight and
// dot; then, from the chunk where T_before first falls to stop down to the
// first, a reversed warp scan (__shfl_down_sync) of dot*w gives each step
// the sum over the later steps of its chunk and a carry adds the later
// chunks'. The suffix is never a total minus a prefix (that cancels), and
// the order is fixed: repeats are bit-identical. Each of d_sigma, d_r, d_g,
// d_b is written once, the dead steps' zeros in the same stores.
//
// A row longer than 128 steps (the fine grid's 256) is walked in groups of
// four chunks. Pass 1 scans every group but the last (the next group's
// sigma / dt / mask loads in flight) to find the group where the ray stops,
// and parks the optical-depth carry at each group's start in that group's
// first d_sigma entry; pass 2 runs the register form above on each group
// from that one down to the first, starting its scans from the parked
// carry (the same sums, so the same P). The parking costs 8 bytes a group;
// pass 1 reads 9 bytes a step again for every group but the last.
//
// Bound on the H100: bytes. Each processed step reads sigma, dt, three
// colours and a mask byte (21 bytes) and writes four floats: 37 bytes.
// expf, no fast math.

#include "integrate.cuh"

namespace {

using namespace dvt_integrate;

// Pass 2 on the group of C chunks from step g0: its outputs, and the sum
// of dot*w over it added to suffix_carry. s_carry: the sum of od before
// g0 (0 at g0 == 0).
template <int C>
__device__ __forceinline__ void group_adjoint(
    const Row<C>& row, float s_carry, float& suffix_carry, float gr,
    float gg, float gb, float* __restrict__ dsig, float* __restrict__ dcr,
    float* __restrict__ dcg, float* __restrict__ dcb, int64_t base, int g0,
    int k, float stop, int lane) {
  float p_carry = g0 == 0 ? 1.0f : expf(-s_carry);  // P at step g0 - 1
  float p[C], w[C], dot[C];
  bool proc[C];
  int last = C - 1;  // the chunk where T_before falls to stop
  bool stopped = false;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    p[c] = 0.0f;
    w[c] = 0.0f;
    dot[c] = 0.0f;
    proc[c] = false;
    const int c0 = g0 + 32 * c;
    if (stopped || c0 >= k) continue;  // uniform
    const bool in = c0 + lane < k;
    const bool live = row.lv[c];
    const float od = live ? fmaxf(row.sg[c] * row.dv[c], 0.0f) : 0.0f;
    const float s = s_carry + warp_incl_scan(od, lane);
    p[c] = expf(-s);
    float tb = __shfl_up_sync(kFull, p[c], 1);
    if (lane == 0) tb = p_carry;
    const unsigned dead = __ballot_sync(kFull, in && !(tb > stop));
    const int first_dead = dead ? __ffs(dead) - 1 : 32;
    proc[c] = live && lane < first_dead;
    if (proc[c]) {
      w[c] = tb - p[c];
      dot[c] = row.cr[c] * gr + row.cg[c] * gg + row.cb[c] * gb;
    }
    s_carry = __shfl_sync(kFull, s, 31);
    p_carry = __shfl_sync(kFull, p[c], 31);
    if (dead || p_carry <= stop) {
      stopped = true;
      last = c;
    }
  }
#pragma unroll
  for (int c = C - 1; c >= 0; --c) {
    const int c0 = g0 + 32 * c;
    if (c0 >= k) continue;  // uniform
    const int64_t at = base + c0 + lane;
    const bool in = c0 + lane < k;
    if (c > last) {  // uniform: past the stop, nothing is processed
      if (in) {
        dsig[at] = 0.0f;
        dcr[at] = 0.0f;
        dcg[at] = 0.0f;
        dcb[at] = 0.0f;
      }
      continue;
    }
    const float incl = warp_suffix_scan(dot[c] * w[c], lane);
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) excl = 0.0f;
    const float suffix = suffix_carry + excl;
    suffix_carry += __shfl_sync(kFull, incl, 0);
    const float dl = (proc[c] ? dot[c] * p[c] : 0.0f) - suffix;
    const float dtv = row.dv[c];
    const float sdt = row.sg[c] * dtv;
    const float tie = sdt > 0.0f ? 1.0f : (sdt == 0.0f ? 0.5f : 0.0f);
    if (in) {
      dsig[at] = row.lv[c] ? (dl * dtv) * tie : 0.0f;
      dcr[at] = w[c] * gr;
      dcg[at] = w[c] * gg;
      dcb[at] = w[c] * gb;
    }
  }
}

template <int C, bool kGrouped>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    integrate_backward_kernel(
        const float* __restrict__ sigma, const float* __restrict__ cr,
        const float* __restrict__ cg, const float* __restrict__ cb,
        const float* __restrict__ dt, const uint8_t* __restrict__ mask,
        const float* __restrict__ gin, float* __restrict__ dsig,
        float* __restrict__ dcr, float* __restrict__ dcg,
        float* __restrict__ dcb, int n, int k, float stop) {
  constexpr int kSpan = 32 * C;
  const int lane = threadIdx.x & 31;
  const int64_t ray =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n) return;  // the whole warp leaves together
  const int64_t base = ray * (int64_t)k;
  const float gr = gin[ray * 3 + 0];
  const float gg = gin[ray * 3 + 1];
  const float gb = gin[ray * 3 + 2];

  if constexpr (!kGrouped) {
    Row<C> row;
    load_row<C, true>(row, sigma, dt, mask, cr, cg, cb, base, 0, k, lane);
    float suffix_carry = 0.0f;
    group_adjoint<C>(row, 0.0f, suffix_carry, gr, gg, gb, dsig, dcr, dcg,
                     dcb, base, 0, k, stop, lane);
  } else {
    // pass 1: the groups before the last (all of their steps in the row)
    const int g_last = ((k - 1) / kSpan) * kSpan;
    int g_stop = g_last;  // the group where the ray stops
    float s_carry = 0.0f, p_carry = 1.0f;
    Row<C> row;
    load_row<C, false>(row, sigma, dt, mask, cr, cg, cb, base, 0, g_last,
                       lane);
    for (int g0 = 0; g0 < g_last; g0 += kSpan) {
      Row<C> next;
      load_row<C, false>(next, sigma, dt, mask, cr, cg, cb, base, g0 + kSpan,
                         g_last, lane);
      if (g0 > 0 && lane == 0) dsig[base + g0] = s_carry;
      bool stopped = false;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (stopped) continue;  // uniform
        const float od =
            row.lv[c] ? fmaxf(row.sg[c] * row.dv[c], 0.0f) : 0.0f;
        const float s = s_carry + warp_incl_scan(od, lane);
        const float p = expf(-s);
        float tb = __shfl_up_sync(kFull, p, 1);
        if (lane == 0) tb = p_carry;
        const unsigned dead = __ballot_sync(kFull, !(tb > stop));
        s_carry = __shfl_sync(kFull, s, 31);
        p_carry = __shfl_sync(kFull, p, 31);
        if (dead || p_carry <= stop) stopped = true;
      }
      if (stopped) {
        g_stop = g0;
        break;
      }
      row = next;
    }
    if (g_stop == g_last && g_last > 0 && lane == 0)
      dsig[base + g_last] = s_carry;
    for (int kk = g_stop + kSpan + lane; kk < k; kk += 32) {
      dsig[base + kk] = 0.0f;
      dcr[base + kk] = 0.0f;
      dcg[base + kk] = 0.0f;
      dcb[base + kk] = 0.0f;
    }
    // pass 2: from the stop group down to the first
    float suffix_carry = 0.0f;
    for (int g0 = g_stop; g0 >= 0; g0 -= kSpan) {
      float parked = 0.0f;  // lane 0 wrote it, lane 0 reads it
      if (g0 > 0 && lane == 0) parked = dsig[base + g0];
      parked = __shfl_sync(kFull, parked, 0);
      load_row<C, true>(row, sigma, dt, mask, cr, cg, cb, base, g0, k, lane);
      group_adjoint<C>(row, parked, suffix_carry, gr, gg, gb, dsig, dcr, dcg,
                       dcb, base, g0, k, stop, lane);
    }
  }
}

// the kernel instance of a geometry (integrate.cu's dispatch)
template <typename Fn>
int dispatch(int chunks, bool grouped, Fn fn) {
  switch (chunks) {
    case 1: return fn(integrate_backward_kernel<1, false>);
    case 2: return fn(integrate_backward_kernel<2, false>);
    case 3: return fn(integrate_backward_kernel<3, false>);
    case 4:
      return grouped ? fn(integrate_backward_kernel<4, true>)
                     : fn(integrate_backward_kernel<4, false>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dvt_integrate_backward(const float* sigma, const float* cr,
                                      const float* cg, const float* cb,
                                      const float* dt, const uint8_t* mask,
                                      const float* g, float* dsig, float* dcr,
                                      float* dcg, float* dcb, int n, int k,
                                      int chunks, int blocks, float stop,
                                      void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  if (!geometry_ok(n, k, chunks, blocks)) return (int)cudaErrorInvalidValue;
  dispatch(chunks, k > 32 * chunks, [&](auto kernel) {
    kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        sigma, cr, cg, cb, dt, mask, g, dsig, dcr, dcg, dcb, n, k, stop);
    return 0;
  });
  return (int)cudaGetLastError();
}

// Registers, local memory and resident blocks per SM of the K9b instance
// for rows of k steps at `chunks` (launch_geometry): out[0..2].
extern "C" int dvt_integrate_backward_occupancy(int k, int chunks,
                                                int* out) {
  if (!geometry_ok(1, k, chunks, 1)) return (int)cudaErrorInvalidValue;
  return dispatch(chunks, k > 32 * chunks,
                  [&](auto kernel) { return occupancy(kernel, out); });
}
