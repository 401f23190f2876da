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
// a triangular ones matrix on the MXU. Here one warp owns a ray and holds
// its row in registers (integrate.cuh): up to 128 steps, lane j steps j,
// j+32, j+64, j+96, with every sigma / dt / mask load issued before the
// first scan, so a ray waits for one memory round trip, not one per chunk.
// A longer row (the fine grid's 256 steps) is walked in groups of four
// chunks, the next group's loads in flight while the current one is
// scanned. Per chunk, in order, a warp inclusive scan (__shfl_up_sync)
// gives the prefixes and the sums carry from chunk to chunk; the walk ends
// at the chunk where T_before first falls to stop. Then the group's colours
// are loaded for its processed steps only, all at once (one more round
// trip per group; loading them with the row took more registers and read
// the colours of steps a stopped ray never reaches: it was slower at every
// shape timed, the fused lattice where every step is processed included,
// PERF.md). Each lane sums
// its steps in chunk order and a fixed butterfly reduces the lanes, so
// repeats are bit-identical; the prefix sums and expf are those of the
// plain twin (ops/integrate.py::scan_prefix, torch.exp), so both stop at
// one step.
//
// Bound on the H100: bytes. Each processed step reads sigma, dt, three
// colours (20 bytes) and a mask byte for about 18 float operations; one
// row of 32 bytes per ray is written. A launch of few rays (a 96^2 view:
// 9,216 rays, 2,304 blocks, about two waves at 8-9 resident blocks an SM)
// is paced by latency instead: each wave waits for its rows' loads, scans
// and colour loads once. expf, no fast math.

#include "integrate.cuh"

namespace {

using namespace dvt_integrate;

template <int C, bool kGrouped>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    integrate_forward_kernel(
        const float* __restrict__ sigma, const float* __restrict__ cr,
        const float* __restrict__ cg, const float* __restrict__ cb,
        const float* __restrict__ dt, const uint8_t* __restrict__ mask,
        const float* __restrict__ t_origin, float* __restrict__ out, int n,
        int k, float t_near, float t_far, float stop, float eps) {
  constexpr int kSpan = 32 * C;
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
  bool stopped = false;  // uniform: no later step is processed
  Row<C> row;
  load_row<C, false>(row, sigma, dt, mask, cr, cg, cb, base, 0, k, lane);
  for (int g0 = 0; g0 < k && !stopped; g0 += kSpan) {
    Row<C> next;
    if constexpr (kGrouped)
      load_row<C, false>(next, sigma, dt, mask, cr, cg, cb, base,
                         g0 + kSpan, k, lane);
    float w[C], mid[C];
    bool proc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      w[c] = 0.0f;
      mid[c] = 0.0f;
      proc[c] = false;
      const int c0 = g0 + 32 * c;
      if (stopped || c0 >= k) continue;  // uniform
      const bool in = c0 + lane < k;
      const bool live = row.lv[c];
      const float dtv = row.dv[c];
      const float od = live ? fmaxf(row.sg[c] * dtv, 0.0f) : 0.0f;
      const float s = s_carry + warp_incl_scan(od, lane);
      const float p = expf(-s);
      float tb = __shfl_up_sync(kFull, p, 1);
      if (lane == 0) tb = p_carry;
      const unsigned dead = __ballot_sync(kFull, in && !(tb > stop));
      const int first_dead = dead ? __ffs(dead) - 1 : 32;
      proc[c] = live && lane < first_dead;
      const float dtm = live ? dtv : 0.0f;
      const float dsum = d_carry + warp_incl_scan(dtm, lane);
      w[c] = tb - p;
      mid[c] = ((origin + dsum) - dtm) + 0.5f * dtv;
      // T: P at the last processed step (the processed steps are a prefix)
      const unsigned done = __ballot_sync(kFull, proc[c]);
      if (done) t = __shfl_sync(kFull, p, 31 - __clz(done));
      s_carry = __shfl_sync(kFull, s, 31);
      p_carry = __shfl_sync(kFull, p, 31);
      d_carry = __shfl_sync(kFull, dsum, 31);
      if (dead || p_carry <= stop) stopped = true;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (proc[c]) {
        const int64_t at = base + g0 + 32 * c + lane;
        row.cr[c] = cr[at];
        row.cg[c] = cg[at];
        row.cb[c] = cb[at];
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (proc[c]) {
        r += w[c] * row.cr[c];
        g += w[c] * row.cg[c];
        b += w[c] * row.cb[c];
        wd += w[c] * mid[c];
      }
    }
    if constexpr (kGrouped) row = next;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r += __shfl_xor_sync(kFull, r, off);
    g += __shfl_xor_sync(kFull, g, off);
    b += __shfl_xor_sync(kFull, b, off);
    wd += __shfl_xor_sync(kFull, wd, off);
  }
  if (lane == 0) {
    const float op = 1.0f - t;
    const float depth = op > eps ? wd / fmaxf(op, eps) : t_far;
    float* o = out + ray * 8;
    o[0] = r;
    o[1] = g;
    o[2] = b;
    o[3] = t;
    o[4] = op;
    o[5] = depth;
    o[6] = 0.0f;
    o[7] = 0.0f;
  }
}

// the kernel instance of a geometry: C chunks, grouped past 32 * C steps
// (only at kMaxChunks: geometry_ok)
template <typename Fn>
int dispatch(int chunks, bool grouped, Fn fn) {
  switch (chunks) {
    case 1: return fn(integrate_forward_kernel<1, false>);
    case 2: return fn(integrate_forward_kernel<2, false>);
    case 3: return fn(integrate_forward_kernel<3, false>);
    case 4:
      return grouped ? fn(integrate_forward_kernel<4, true>)
                     : fn(integrate_forward_kernel<4, false>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dvt_integrate_forward(const float* sigma, const float* cr,
                                     const float* cg, const float* cb,
                                     const float* dt, const uint8_t* mask,
                                     const float* t_origin, float* out, int n,
                                     int k, int chunks, int blocks,
                                     float t_near, float t_far, float stop,
                                     float eps, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (!geometry_ok(n, k, chunks, blocks)) return (int)cudaErrorInvalidValue;
  dispatch(chunks, k > 32 * chunks, [&](auto kernel) {
    kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
        sigma, cr, cg, cb, dt, mask, t_origin, out, n, k, t_near, t_far, stop,
        eps);
    return 0;
  });
  return (int)cudaGetLastError();
}

// Registers, local memory and resident blocks per SM of the K9f instance
// for rows of k steps at `chunks` (launch_geometry): out[0..2].
extern "C" int dvt_integrate_forward_occupancy(int k, int chunks, int* out) {
  if (!geometry_ok(1, k, chunks, 1)) return (int)cudaErrorInvalidValue;
  return dispatch(chunks, k > 32 * chunks,
                  [&](auto kernel) { return occupancy(kernel, out); });
}
