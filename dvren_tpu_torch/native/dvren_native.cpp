// The port's native scheduler core (C ABI, loaded with ctypes by
// dvren_tpu_torch/native/__init__.py).
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
#include <algorithm>
#include <vector>

extern "C" {

int dvn_abi_version(void) { return 3; }

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
