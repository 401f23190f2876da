// The port's native core (C ABI, loaded with ctypes by
// dvren_tpu_torch/native/__init__.py), its copy of dvren_tpu's.
//
// The CPU oracles: scalar double-precision ray generation
// (dvn_generate_rays), trilinear / nearest grid evaluation
// (dvn_eval_grid) and transmittance integration with early termination
// (dvn_integrate), the independent referee the pipeline is held to; the
// packed-ragged views between the dense (N, K) lattice and the packed
// sample stream (dvn_ray_offsets, dvn_pack_samples, dvn_unpack_samples);
// binary PPM encoding (dvn_write_ppm).
//
// The host hot loop of the tile-table scheduler
// (dvren_tpu_torch/render/tiled.py::build_tiled_schedule), kept
// byte-identical to its numpy form there and to dvren_tpu's native core:
//   - dvn_pack_runs: per (tile, chunk, sub-tile) row of sample cell ids,
//     the run-pack scan (stable sort, lanes in sorted-unique order);
//   - dvn_build_runs: the sample lattice (march, jitter, cell index and
//     mask in numpy-exact float32 arithmetic) fused with that scan;
//   - dvn_tighten_occupancy: each ray's step window trimmed to its first
//     and last sample in a non-empty cell.
//
// Build with -ffp-contract=off: numpy never fuses a multiply and an add,
// and a contracted FMA here would change float bits.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr double kStopThreshold = 1e-4;
constexpr double kOpacityEps = 1e-6;

inline double alpha_from(double sigma, double dt) {
    const double od = sigma * dt;
    if (od <= 0.0) return 0.0;
    if (od < 1e-4) return od * (1.0 - 0.5 * od);
    const double a = -std::expm1(-od);
    return std::min(1.0, std::max(a, 0.0));
}

struct GridView {
    const float* data;
    int nx, ny, nz, channels;   // channels == 0 -> scalar grid
};

inline float fetch(const GridView& g, int ix, int iy, int iz, int c) {
    const long idx = ((static_cast<long>(iz) * g.ny + iy) * g.nx + ix);
    return g.channels > 0 ? g.data[idx * g.channels + c] : g.data[idx];
}

// world -> [0,1] local; returns false when outside under OOB_ZERO.
inline bool to_local(const float p[3], const float* bmin, const float* bmax,
                     int oob, double local[3]) {
    bool outside = false;
    for (int i = 0; i < 3; ++i) {
        const double ext = static_cast<double>(bmax[i]) - bmin[i];
        double c = ext != 0.0 ? (p[i] - bmin[i]) / ext : 0.0;
        if (c < 0.0 || c > 1.0) outside = true;
        local[i] = c;
    }
    if (oob == 1) {  // clamp
        for (int i = 0; i < 3; ++i)
            local[i] = std::min(1.0, std::max(0.0, local[i]));
        return true;
    }
    return !outside;
}

inline double sample_channel(const GridView& g, const double local[3],
                             int interp, int c) {
    const double fx = local[0] * (g.nx - 1);
    const double fy = local[1] * (g.ny - 1);
    const double fz = local[2] * (g.nz - 1);
    if (interp == 0) {  // nearest, round half away from zero (coords >= 0)
        const int ix = std::min(g.nx - 1, std::max(0, (int)std::floor(fx + 0.5)));
        const int iy = std::min(g.ny - 1, std::max(0, (int)std::floor(fy + 0.5)));
        const int iz = std::min(g.nz - 1, std::max(0, (int)std::floor(fz + 0.5)));
        return fetch(g, ix, iy, iz, c);
    }
    const int x0 = std::min(g.nx - 1, std::max(0, (int)std::floor(fx)));
    const int y0 = std::min(g.ny - 1, std::max(0, (int)std::floor(fy)));
    const int z0 = std::min(g.nz - 1, std::max(0, (int)std::floor(fz)));
    const int x1 = std::min(x0 + 1, g.nx - 1);
    const int y1 = std::min(y0 + 1, g.ny - 1);
    const int z1 = std::min(z0 + 1, g.nz - 1);
    const double tx = fx - x0, ty = fy - y0, tz = fz - z0;

    auto lerp = [](double a, double b, double t) { return a + (b - a) * t; };
    const double c00 = lerp(fetch(g, x0, y0, z0, c), fetch(g, x1, y0, z0, c), tx);
    const double c10 = lerp(fetch(g, x0, y1, z0, c), fetch(g, x1, y1, z0, c), tx);
    const double c01 = lerp(fetch(g, x0, y0, z1, c), fetch(g, x1, y0, z1, c), tx);
    const double c11 = lerp(fetch(g, x0, y1, z1, c), fetch(g, x1, y1, z1, c), tx);
    return lerp(lerp(c00, c10, ty), lerp(c01, c11, ty), tz);
}

}  // namespace

extern "C" {

int dvn_abi_version(void) { return 4; }

// ---------------------------------------------------------------- ray gen

// model: 0 = pinhole (+0.5 pixel centers), 1 = orthographic (plane-offset
// origins, no +0.5 - the reference's CUDA convention, ray_cuda.cu:57-84).
int dvn_generate_rays(int model, const float* K, const float* c2w,
                      float ortho_scale, int width, int /*height*/,
                      int roi_x, int roi_y, int roi_w, int roi_h,
                      float t_near, float t_far,
                      float* origins, float* dirs, float* tn, float* tf,
                      uint32_t* pixel_ids) {
    if (!K || !c2w || !origins || !dirs || !tn || !tf || !pixel_ids)
        return 1;
    const double fx = K[0], fy = K[4], cx = K[2], cy = K[5];
    const double r[9] = {c2w[0], c2w[1], c2w[2], c2w[4], c2w[5], c2w[6],
                         c2w[8], c2w[9], c2w[10]};
    const double t[3] = {c2w[3], c2w[7], c2w[11]};

    long idx = 0;
    for (int ly = 0; ly < roi_h; ++ly) {
        for (int lx = 0; lx < roi_w; ++lx, ++idx) {
            const int px = roi_x + lx, py = roi_y + ly;
            double d[3], o[3] = {t[0], t[1], t[2]};
            if (model == 0) {
                const double a = ((px + 0.5) - cx) / fx;
                const double b = ((py + 0.5) - cy) / fy;
                d[0] = r[0] * a + r[1] * b + r[2];
                d[1] = r[3] * a + r[4] * b + r[5];
                d[2] = r[6] * a + r[7] * b + r[8];
            } else {
                d[0] = r[2]; d[1] = r[5]; d[2] = r[8];
                const double u = (px - cx) / fx * ortho_scale;
                const double v = (py - cy) / fy * ortho_scale;
                o[0] += r[0] * u + r[1] * v;
                o[1] += r[3] * u + r[4] * v;
                o[2] += r[6] * u + r[7] * v;
            }
            const double len = std::sqrt(
                std::max(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], 1e-300));
            for (int i = 0; i < 3; ++i) {
                dirs[idx * 3 + i] = static_cast<float>(d[i] / len);
                origins[idx * 3 + i] = static_cast<float>(o[i]);
            }
            tn[idx] = t_near;
            tf[idx] = t_far;
            pixel_ids[idx] = static_cast<uint32_t>(py) * width + px;
        }
    }
    return 0;
}

// ------------------------------------------------------------- field eval

int dvn_eval_grid(const float* grid, int nx, int ny, int nz, int channels,
                  const float* bbox_min, const float* bbox_max,
                  int interp, int oob,
                  const float* positions, long n_points, float* out) {
    if (!grid || !positions || !out || nx <= 0 || ny <= 0 || nz <= 0)
        return 1;
    const GridView g{grid, nx, ny, nz, channels};
    const int nc = channels > 0 ? channels : 1;
    for (long i = 0; i < n_points; ++i) {
        double local[3];
        const bool inside = to_local(positions + i * 3, bbox_min, bbox_max,
                                     oob, local);
        for (int c = 0; c < nc; ++c) {
            out[i * nc + c] = inside
                ? static_cast<float>(sample_channel(g, local, interp, c))
                : 0.0f;
        }
    }
    return 0;
}

// ------------------------------------------------------------ integration

// Dense-lattice integration, double accumulation, sequential recurrence
// with early termination. aux (optional, may be null): (alpha, weight,
// T_before, logT_before) per slot, zero for unprocessed slots.
int dvn_integrate(long n_rays, int max_steps,
                  const float* sigma, const float* color, const float* dt,
                  const uint8_t* mask, float t_near, float t_far,
                  float* radiance, float* trans, float* opacity,
                  float* depth, float* aux) {
    if (!sigma || !color || !dt || !mask) return 1;
    for (long ray = 0; ray < n_rays; ++ray) {
        double T = 1.0, acc[3] = {0, 0, 0}, depth_w = 0.0;
        double t_cursor = t_near;
        const long base = ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            const long s = base + k;
            if (!mask[s]) continue;
            const double dts = dt[s];
            const double a = alpha_from(sigma[s], dts);
            const double T_before = T;
            const double w = T_before * a;
            for (int c = 0; c < 3; ++c) acc[c] += w * color[s * 3 + c];
            depth_w += w * (t_cursor + 0.5 * dts);
            if (aux) {
                aux[s * 4 + 0] = static_cast<float>(a);
                aux[s * 4 + 1] = static_cast<float>(w);
                aux[s * 4 + 2] = static_cast<float>(T_before);
                aux[s * 4 + 3] = static_cast<float>(
                    std::log(std::max(T_before, 1e-30)));
            }
            T *= std::max(1.0 - a, 0.0);
            t_cursor += dts;
            if (T <= kStopThreshold) break;
        }
        for (int c = 0; c < 3; ++c)
            radiance[ray * 3 + c] = static_cast<float>(acc[c]);
        trans[ray] = static_cast<float>(T);
        const double op = 1.0 - T;
        opacity[ray] = static_cast<float>(op);
        depth[ray] = static_cast<float>(
            op > kOpacityEps ? depth_w / op : t_far);
    }
    return 0;
}

// --------------------------------------------------- packed-ragged views

// Count live samples and fill (n_rays + 1) prefix offsets.
long dvn_ray_offsets(long n_rays, int max_steps, const uint8_t* mask,
                     uint32_t* offsets) {
    long total = 0;
    for (long ray = 0; ray < n_rays; ++ray) {
        offsets[ray] = static_cast<uint32_t>(total);
        const long base = ray * max_steps;
        for (int k = 0; k < max_steps; ++k)
            total += mask[base + k] ? 1 : 0;
    }
    offsets[n_rays] = static_cast<uint32_t>(total);
    return total;
}

// Compact dense (n_rays, max_steps, channels) values into the packed
// stream (row-major over live slots). Returns packed count.
long dvn_pack_samples(long n_rays, int max_steps, int channels,
                      const uint8_t* mask, const float* dense,
                      float* packed) {
    long out = 0;
    const long stride = static_cast<long>(max_steps) * channels;
    for (long ray = 0; ray < n_rays; ++ray) {
        const float* row = dense + ray * stride;
        const uint8_t* mrow = mask + ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            if (!mrow[k]) continue;
            std::memcpy(packed + out * channels, row + (long)k * channels,
                        sizeof(float) * channels);
            ++out;
        }
    }
    return out;
}

// Scatter packed per-sample values back onto the dense lattice (inverse of
// dvn_pack_samples); unmasked slots are zero-filled.
long dvn_unpack_samples(long n_rays, int max_steps, int channels,
                        const uint8_t* mask, const float* packed,
                        float* dense) {
    long in = 0;
    const long stride = static_cast<long>(max_steps) * channels;
    for (long ray = 0; ray < n_rays; ++ray) {
        float* row = dense + ray * stride;
        const uint8_t* mrow = mask + ray * max_steps;
        for (int k = 0; k < max_steps; ++k) {
            if (mrow[k]) {
                std::memcpy(row + (long)k * channels, packed + in * channels,
                            sizeof(float) * channels);
                ++in;
            } else {
                std::memset(row + (long)k * channels, 0,
                            sizeof(float) * channels);
            }
        }
    }
    return in;
}

// ---------------------------------------------------------------- PPM IO

int dvn_write_ppm(const char* path, const float* image, int width,
                  int height) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::fprintf(f, "P6\n%d %d\n255\n", width, height);
    const long n = static_cast<long>(width) * height * 3;
    for (long i = 0; i < n; ++i) {
        const float v = std::min(1.0f, std::max(0.0f, image[i]));
        const unsigned char b =
            static_cast<unsigned char>(std::lround(v * 255.0f));
        std::fputc(b, f);
    }
    std::fclose(f);
    return 0;
}

//
// The hot phase of the host tile-table SCHEDULER
// (render/tiled.py::build_tiled_schedule): per (tile, chunk,
// sub-tile) row of sample cell ids, stable-sort, assign window-relative
// lanes in sorted-unique order (pitch 1: lane = unique rank; pitch 2:
// lane = 2*pair_rank + (cell & 1)), and emit the COMPACT unique
// (cell, lane) list the hostmap/gathermap assembly scatters from.
// Exactly mirrors the numpy reference implementation
// (tiled.py::_pack_runs_numpy) - schedules must stay byte-identical
// (tests/test_torch_native.py holds them so).
//
// flat:      (rows, cols) int64 cell ids; masked samples carry
//            ``sentinel`` (sorts after every real cell).
// lidx:      (rows, cols) int32 per-SAMPLE window-relative lane.
// lanes_run: (rows,) int32 lanes used by the run (0 when all masked).
// ucell/ulane: (rows, umax) compact unique cells + their lanes,
//            ucell -1-padded; counts in n_u. Rows whose lanes_run
//            exceeds 2*128 overflow the bank space and are discarded by
//            the caller, so umax = min(cols, 257) always suffices for
//            rows that get consumed.
// upair:     (rows, pmax) pitch-2 compact unique PAIR ids (cell >> 1),
//            -1-padded, counts in n_p; the j-th pair's rank IS j.

namespace {

// one row of the run-pack scan (see dvn_pack_runs docs)
inline void pack_row(const long long* v, long long cols, int pitch,
                     long long sentinel, long long umax, long long pmax,
                     int* idx, int* lx, long long* uc, int* ul,
                     long long* up, int* lanes_run, int* n_u, int* n_p) {
    for (long long j = 0; j < cols; ++j) idx[j] = (int)j;
    std::stable_sort(idx, idx + cols,
                     [v](int a, int b) { return v[a] < v[b]; });
    int rank = -1, prank = -1;
    long long prev = 0, prevp = 0;
    long long nu = 0, np_ = 0;
    bool any_sent = false;
    for (long long j = 0; j < cols; ++j) {
        const long long val = v[idx[j]];
        const bool is_new = (j == 0) || (val != prev);
        if (is_new) ++rank;
        int lane;
        if (pitch == 2) {
            const long long pv = (val == sentinel) ? sentinel : (val >> 1);
            const bool new_p = (j == 0) || (pv != prevp);
            if (new_p) ++prank;
            lane = 2 * prank + (int)(val & 1);
            if (new_p && val != sentinel && np_ < pmax) up[np_++] = pv;
            prevp = pv;
        } else {
            lane = rank;
        }
        if (is_new && val != sentinel && nu < umax) {
            uc[nu] = val;
            ul[nu] = lane;
            ++nu;
        }
        if (val == sentinel) any_sent = true;
        lx[idx[j]] = lane;
        prev = val;
    }
    const int sent = any_sent ? 1 : 0;
    *lanes_run = (pitch == 2) ? 2 * (prank + 1 - sent)
                              : (rank + 1 - sent);
    *n_u = (int)nu;
    *n_p = (int)np_;
    for (long long j = nu; j < umax; ++j) { uc[j] = -1; ul[j] = 0; }
    for (long long j = np_; j < pmax; ++j) up[j] = -1;
}

}  // namespace

int dvn_pack_runs(const long long* flat, long long rows, long long cols,
                  int pitch, long long sentinel, long long umax,
                  long long pmax, int* lidx, int* lanes_run,
                  long long* ucell, int* ulane, int* n_u,
                  long long* upair, int* n_p) {
    if (rows < 0 || cols <= 0 || (pitch != 1 && pitch != 2)) return 1;
    std::vector<int> idx(cols);
    for (long long r = 0; r < rows; ++r) {
        pack_row(flat + r * cols, cols, pitch, sentinel, umax, pmax,
                 idx.data(), lidx + r * cols, ucell + r * umax,
                 ulane + r * umax, upair + r * pmax, lanes_run + r,
                 n_u + r, n_p + r);
    }
    return 0;
}

// ------------------------------------------- occupancy window tightening
//
// Shrink each ray's [ke, ke+cnt) step window to its first..last lattice
// step whose (jittered, f32-exact) sample lands in a NON-empty cell -
// the native form of render/tiled.py::_tighten_windows_by_occupancy
// (byte-identical semantics; same -ffp-contract=off requirement). The
// scan runs FORWARD to the first live step and BACKWARD to the last,
// skipping the interior entirely (the numpy reference must evaluate
// every step; shells/sparse media make the interior the common case).

namespace {

struct OccGeom {
    const float* o;
    const float* d;
    const float* jitter;
    long long jk;
    float t_near, t_far, dt, nudge;
    int k_max, nx, ny, nz;
    const float* lo;
    const float* inv;
    const unsigned char* empty;
};

inline bool occ_live_at(const OccGeom& g, long long ray, long long k) {
    const float base_t = g.t_near + (float)k * g.dt;
    if (!(base_t < g.t_far) || k >= (long long)g.k_max) return false;
    float jit = 0.5f;
    if (g.jitter) {
        const long long jc = k < g.jk - 1 ? k : g.jk - 1;
        jit = g.jitter[ray * g.jk + jc];
    }
    float t = base_t + jit * g.dt;
    if (t >= g.t_far) t = g.nudge;
    const int nq[3] = {g.nx, g.ny, g.nz};
    long long ix[3];
    for (int ax = 0; ax < 3; ++ax) {
        const float p = g.o[ray * 3 + ax] + g.d[ray * 3 + ax] * t;
        const float local = (p - g.lo[ax]) * g.inv[ax];
        if (!(local >= 0.0f && local <= 1.0f)) return false;
        float f = std::floor(local * (float)(nq[ax] - 1));
        const float hi = (float)(nq[ax] - 2);
        if (!(f >= 0.0f)) f = 0.0f;
        if (f > hi) f = hi;
        ix[ax] = (long long)f;
    }
    const long long cell = (ix[2] * g.ny + ix[1]) * g.nx + ix[0];
    return g.empty[cell] == 0;
}

}  // namespace

int dvn_tighten_occupancy(
    const float* o, const float* d, const long long* ke_in,
    const long long* cnt_in, const float* jitter, long long jk,
    float t_near, float t_far, float dt, float nudge, int k_max,
    const float* lo, const float* inv_ext, int nx, int ny, int nz,
    const unsigned char* cell_empty, long long n,
    int* ke_out, int* cnt_out) {
    OccGeom g{o, d, jitter, jk, t_near, t_far, dt, nudge,
              k_max, nx, ny, nz, lo, inv_ext, cell_empty};
    for (long long r = 0; r < n; ++r) {
        const long long ke = ke_in[r];
        const long long cnt = cnt_in[r];
        long long first = -1, last = -1;
        for (long long k = ke; k < ke + cnt; ++k) {
            if (occ_live_at(g, r, k)) { first = k; break; }
        }
        if (first >= 0) {
            for (long long k = ke + cnt - 1; k >= first; --k) {
                if (occ_live_at(g, r, k)) { last = k; break; }
            }
            ke_out[r] = (int)first;
            cnt_out[r] = (int)(last - first + 1);
        } else {
            ke_out[r] = 0;
            cnt_out[r] = 0;
        }
    }
    return 0;
}

// --------------------------------------------- fused lattice + pack
//
// The full per-(tile, chunk) scheduler hot loop: per sample, march
// t = t_near + k*dt (+ stratified jitter), evaluate the grid cell index
// and inside/live mask with numpy-exact f32 arithmetic, lay the results
// out in the kernel's (tile, chunk, block row, lane) order, and run the
// run-pack scan per (chunk, sub-tile) row - one pass, no full-array
// temporaries. Mirrors build_tiled_schedule's numpy block
// (render/tiled.py; tests/test_torch_native.py holds them byte-equal).
// NOTE: compile with -ffp-contract=off - numpy never fuses mul+add, a
// contracted FMA here would change float bits.

// cell_scale 1: packed ids are FULL-pitch cell ids. cell_scale 2:
// packed ids are SUPERCELL ids ((iz>>1)*SY + (iy>>1))*SX + (ix>>1) over
// the (nz//2, ny//2, nx//2) supergrid, and each sample's
// cell-within-supercell bits (lx | ly<<1 | lz<<2) are OR'd into lidx at
// bit 16 (the lane itself stays in the low 16 bits).
int dvn_build_runs(
    const float* ot, const float* dtn,          // (T, 256, 3)
    const long long* safe_ids,                  // (T, 256)
    const unsigned char* live_r,                // (T, 256)
    const long long* ke,                        // (T,)
    long long t_cnt, int nc, int n_sub,
    float t_near, float t_far, float dt, float nudge, int k_max,
    const float* jitter, long long jn, long long jk,  // NULL -> 0.5
    const float* bbox_lo, const float* inv_ext,       // [3]
    int nx, int ny, int nz,
    int pitch, long long sentinel, long long umax, long long pmax,
    int cell_scale,
    float* st_l, float* m_l,                    // (T, nc, 16, 128)
    int* lidx, int* lanes_run,
    long long* ucell, int* ulane, int* n_u,
    long long* upair, int* n_p) {
    if (t_cnt < 0 || nc <= 0 || n_sub <= 0 || 16 % n_sub != 0) return 1;
    if (cell_scale != 1 && cell_scale != 2) return 1;
    const int rps = 16 / n_sub;           // block rows per sub-tile
    const long long sub_cols = (long long)rps * 128;
    const int kq[3] = {nx - 1, ny - 1, nz - 1};
    const long long snx = nx / 2, sny = ny / 2;
    std::vector<long long> cells(sub_cols);
    std::vector<int> lbits(sub_cols);
    std::vector<int> idx(sub_cols);
    for (long long t = 0; t < t_cnt; ++t) {
        const long long ket = ke[t];
        for (int c = 0; c < nc; ++c) {
            for (int s = 0; s < n_sub; ++s) {
                const long long row = (t * nc + c) * (long long)n_sub + s;
                long long* cv = cells.data();
                float* st_row =
                    st_l + ((t * nc + c) * 16LL + s * rps) * 128;
                float* m_row =
                    m_l + ((t * nc + c) * 16LL + s * rps) * 128;
                for (int rr = 0; rr < rps; ++rr) {       // block row
                    const int brow = s * rps + rr;
                    for (int rl = 0; rl < 16; ++rl) {    // ray in row
                        const long long ray = (long long)brow * 16 + rl;
                        const float ox = ot[(t * 256 + ray) * 3 + 0];
                        const float oy = ot[(t * 256 + ray) * 3 + 1];
                        const float oz = ot[(t * 256 + ray) * 3 + 2];
                        const float dx = dtn[(t * 256 + ray) * 3 + 0];
                        const float dy = dtn[(t * 256 + ray) * 3 + 1];
                        const float dz = dtn[(t * 256 + ray) * 3 + 2];
                        const bool lv_r = live_r[t * 256 + ray] != 0;
                        const long long sid = safe_ids[t * 256 + ray];
                        for (int jj = 0; jj < 8; ++jj) { // step in chunk
                            const long long kg = ket + (long long)c * 8 + jj;
                            const float base_t =
                                t_near + (float)kg * dt;
                            const bool live = (base_t < t_far)
                                && (kg < (long long)k_max) && lv_r;
                            float jit = 0.5f;
                            if (jitter) {
                                const long long jr =
                                    sid < jn - 1 ? sid : jn - 1;
                                const long long jc =
                                    kg < jk - 1 ? kg : jk - 1;
                                jit = jitter[jr * jk + jc];
                            }
                            float stv = base_t + jit * dt;
                            if (stv >= t_far) stv = nudge;
                            const float px = ox + dx * stv;
                            const float py = oy + dy * stv;
                            const float pz = oz + dz * stv;
                            bool inside = true;
                            long long cell = 0;
                            const float ps[3] = {px, py, pz};
                            long long ix[3];
                            for (int ax = 0; ax < 3; ++ax) {
                                const float local =
                                    (ps[ax] - bbox_lo[ax]) * inv_ext[ax];
                                inside = inside && (local >= 0.0f)
                                       && (local <= 1.0f);
                                float f = std::floor(local
                                                     * (float)kq[ax]);
                                const float hi = (float)(kq[ax] - 1);
                                if (!(f >= 0.0f)) f = 0.0f;  // NaN -> 0
                                if (f > hi) f = hi;
                                ix[ax] = (long long)f;
                            }
                            const bool m = inside && live;
                            const long long col =
                                ((long long)rr * 16 + rl) * 8 + jj;
                            if (cell_scale == 2) {
                                cell = ((ix[2] >> 1) * sny
                                        + (ix[1] >> 1)) * snx
                                       + (ix[0] >> 1);
                                lbits[col] = m
                                    ? (int)((ix[0] & 1) | ((ix[1] & 1) << 1)
                                            | ((ix[2] & 1) << 2))
                                    : 0;
                            } else {
                                cell = (ix[2] * ny + ix[1]) * nx + ix[0];
                            }
                            cv[col] = m ? cell : sentinel;
                            st_row[rr * 128 + rl * 8 + jj - 0] = stv;
                            m_row[rr * 128 + rl * 8 + jj] = m ? 1.f : 0.f;
                        }
                    }
                }
                pack_row(cv, sub_cols, pitch, sentinel, umax, pmax,
                         idx.data(), lidx + row * sub_cols,
                         ucell + row * umax, ulane + row * umax,
                         upair + row * pmax, lanes_run + row,
                         n_u + row, n_p + row);
                if (cell_scale == 2) {
                    int* lr = lidx + row * sub_cols;
                    for (long long col = 0; col < sub_cols; ++col)
                        lr[col] |= lbits[col] << 16;
                }
            }
        }
    }
    return 0;
}


}  // extern "C"
