"""Instant-NGP-style multiresolution hash encoding and its two MLP heads.

Counterpart of ``dvren_tpu/ops/hashmlp.py``: the plain per-sample
reference of the hash-MLP field, which the tests and the plain twins of
the fused kernels (:mod:`dvren_tpu_torch.ops.hash_tiles`) use.

Parity notes (hash_mlp_cpu.cpp of the original):
- hash: ``(x*1 ^ y*2654435761 ^ z*805459861) mod table_size`` on
  wrapping uint32. torch has no wrapping uint32 multiply on every
  backend, so it runs in int64, masked to 32 bits; each product is split
  into 16-bit halves so no int64 product overflows. Negative cell
  indices wrap to uint32 modularly, as ``astype(uint32)`` does;
- per-level resolution ``base * exp(l * ln(finest/base)/(L-1))`` in
  float32 (:func:`level_resolutions`), or the spec's explicit ladder;
- feature layout ``[level][entry][feature]``;
- sigma head: 2-layer ReLU MLP with a ReLU output; colour head: 2-layer
  ReLU MLP clamped to [0, 1];
- the flat parameter blob: hash_table | sigma_w1 (hidden x enc) row-major,
  sigma_w2 (hidden,) | sigma_b1 (hidden,), sigma_b2 | color_w1
  (hidden x enc), color_w2 (3 x hidden) | color_b1 (hidden,), color_b2 (3,).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_PRIME_Y = 2654435761
_PRIME_Z = 805459861
_MASK32 = 0xFFFFFFFF

# the params-dict keys, in the order of the flat blob's sections
PARAM_KEYS = ("hash_table", "sigma_w1", "sigma_w2", "sigma_b1", "sigma_b2",
              "color_w1", "color_w2", "color_b1", "color_b2")


@dataclass(frozen=True)
class HashMLPSpec:
    """Static hyperparameters (hash_mlp_cpu.cpp:170-177 defaults)."""

    n_levels: int = 4
    features_per_level: int = 2
    table_size: int = 16
    hidden_dim: int = 8
    base_resolution: float = 2.0
    finest_resolution: float = 16.0
    # explicit per-level resolutions (length n_levels), or None for the
    # geometric ladder between base and finest
    resolutions: tuple | None = None

    @property
    def encoding_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def hash_table_size(self) -> int:
        return self.n_levels * self.table_size * self.features_per_level

    @property
    def sigma_weights_size(self) -> int:
        return self.hidden_dim * self.encoding_dim + self.hidden_dim

    @property
    def sigma_biases_size(self) -> int:
        return self.hidden_dim + 1

    @property
    def color_weights_size(self) -> int:
        return self.hidden_dim * self.encoding_dim + 3 * self.hidden_dim

    @property
    def color_biases_size(self) -> int:
        return self.hidden_dim + 3

    @property
    def param_count(self) -> int:
        return (self.hash_table_size + self.sigma_weights_size
                + self.sigma_biases_size + self.color_weights_size
                + self.color_biases_size)


def level_resolutions(spec: HashMLPSpec) -> tuple:
    """Per-level resolutions in float32 arithmetic (base * exp(l *
    ln(finest/base)/(L-1))), or the spec's explicit ``resolutions``, as
    Python floats holding float32 values."""
    if spec.resolutions is not None:
        return tuple(float(np.float32(r)) for r in spec.resolutions)
    n = spec.n_levels
    denom = np.float32(n - 1) if n > 1 else np.float32(1)
    log_scale = np.float32(
        np.log(np.float32(spec.finest_resolution)
               / np.float32(spec.base_resolution),
               dtype=np.float32)) / denom
    return tuple(
        float(np.float32(spec.base_resolution)
              * np.exp(np.float32(l) * log_scale, dtype=np.float32))
        for l in range(n))


def _mul32(x: torch.Tensor, prime: int) -> torch.Tensor:
    """(x * prime) mod 2**32 for 0 <= x < 2**32 in int64, without any
    int64 product above 2**49."""
    lo = x * (prime & 0xFFFF)
    hi = ((x * (prime >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash_coords(ix, iy, iz, table_size: int) -> torch.Tensor:
    """3-prime XOR hash on wrapping uint32 (hash_mlp_cpu.cpp:9-18) of
    integer cell coordinates; int64 entry ids in [0, table_size)."""
    x = ix.to(torch.int64) & _MASK32
    y = _mul32(iy.to(torch.int64) & _MASK32, _PRIME_Y)
    z = _mul32(iz.to(torch.int64) & _MASK32, _PRIME_Z)
    return (x ^ y ^ z) % int(table_size)


def _level_cells(px, py, pz, res: float):
    """floor cell (int64 x0, y0, z0) and fractions (fx, fy, fz) of the
    positions scaled by ``res`` (float32)."""
    r = torch.tensor(res, dtype=torch.float32, device=px.device)
    sx, sy, sz = px * r, py * r, pz * r
    x0, y0, z0 = torch.floor(sx), torch.floor(sy), torch.floor(sz)
    return ((x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)),
            (sx - x0, sy - y0, sz - z0))


def encode(positions: torch.Tensor, hash_table: torch.Tensor,
           spec: HashMLPSpec) -> torch.Tensor:
    """Multiresolution hash encoding with the reference's lerp chain.

    positions (..., 3) float32; hash_table (L, T, F) float32.
    Returns (..., L*F) in the layout [level*F + feature]."""
    px, py, pz = positions[..., 0], positions[..., 1], positions[..., 2]
    feats = []
    for level, res in enumerate(level_resolutions(spec)):
        (x0, y0, z0), (fx, fy, fz) = _level_cells(px, py, pz, res)
        fx, fy, fz = fx[..., None], fy[..., None], fz[..., None]
        table = hash_table[level]

        def corner(dx, dy, dz):
            return table[hash_coords(x0 + dx, y0 + dy, z0 + dz,
                                     spec.table_size)]

        v00 = corner(0, 0, 0) * (1.0 - fx) + corner(1, 0, 0) * fx
        v01 = corner(0, 0, 1) * (1.0 - fx) + corner(1, 0, 1) * fx
        v10 = corner(0, 1, 0) * (1.0 - fx) + corner(1, 1, 0) * fx
        v11 = corner(0, 1, 1) * (1.0 - fx) + corner(1, 1, 1) * fx
        v0 = v00 * (1.0 - fy) + v10 * fy
        v1 = v01 * (1.0 - fy) + v11 * fy
        feats.append(v0 * (1.0 - fz) + v1 * fz)
    return torch.cat(feats, dim=-1)


def unpack_params(flat, spec: HashMLPSpec) -> dict:
    """Split the reference's flat float32 blob into the params dict."""
    if not isinstance(flat, torch.Tensor):
        flat = torch.from_numpy(np.array(flat, np.float32))
    flat = flat.to(torch.float32).reshape(-1)
    enc, hid = spec.encoding_dim, spec.hidden_dim
    sizes = (spec.hash_table_size, spec.sigma_weights_size,
             spec.sigma_biases_size, spec.color_weights_size,
             spec.color_biases_size)
    table, sw, sb, cw, cb = torch.split(flat, sizes)
    return dict(
        hash_table=table.reshape(spec.n_levels, spec.table_size,
                                 spec.features_per_level),
        sigma_w1=sw[:hid * enc].reshape(hid, enc), sigma_w2=sw[hid * enc:],
        sigma_b1=sb[:hid], sigma_b2=sb[hid],
        color_w1=cw[:hid * enc].reshape(hid, enc),
        color_w2=cw[hid * enc:].reshape(3, hid),
        color_b1=cb[:hid], color_b2=cb[hid:])


def pack_params(params: dict, spec: HashMLPSpec) -> torch.Tensor:
    """Inverse of :func:`unpack_params` (the reference blob layout)."""
    return torch.cat([params[k].reshape(-1) for k in PARAM_KEYS]).to(
        torch.float32)


def encode_planes(px, py, pz, hash_table, spec: HashMLPSpec):
    """The encoding as L*F planes of the positions' shape, summed over the
    corners in the fused kernels' order: dz, dy, dx outermost to
    innermost, corner weight (wx * wy) * wz."""
    t_size, n_f = spec.table_size, spec.features_per_level
    enc = []
    for level, res in enumerate(level_resolutions(spec)):
        (x0, y0, z0), (fx, fy, fz) = _level_cells(px, py, pz, res)
        table = hash_table[level]
        acc = [None] * n_f
        for dz in (0, 1):
            wz = fz if dz else 1.0 - fz
            for dy in (0, 1):
                wy = fy if dy else 1.0 - fy
                for dx in (0, 1):
                    wx = fx if dx else 1.0 - fx
                    w = (wx * wy) * wz
                    vals = table[hash_coords(x0 + dx, y0 + dy, z0 + dz,
                                             t_size)]
                    for f in range(n_f):
                        term = w * vals[..., f]
                        acc[f] = term if acc[f] is None else acc[f] + term
        enc.extend(acc)
    return enc


def _dense(enc, w1, b1):
    """Pre-activations of one hidden layer from planes: sum over inputs in
    order, then the bias (the fused kernels' order)."""
    pre = []
    for j in range(w1.shape[0]):
        acc = w1[j, 0] * enc[0]
        for i in range(1, len(enc)):
            acc = acc + w1[j, i] * enc[i]
        pre.append(acc + b1[j])
    return pre


def heads_from_planes(enc, params: dict):
    """(sigma, r, g, b) planes and the pre-activations the adjoint needs,
    from encoding planes; every sum in the fused kernels' order."""
    s_pre1 = _dense(enc, params["sigma_w1"], params["sigma_b1"])
    s_h = [torch.clamp_min(p, 0.0) for p in s_pre1]
    w2 = params["sigma_w2"]
    s_pre2 = w2[0] * s_h[0]
    for j in range(1, len(s_h)):
        s_pre2 = s_pre2 + w2[j] * s_h[j]
    s_pre2 = s_pre2 + params["sigma_b2"]
    sigma = torch.clamp_min(s_pre2, 0.0)

    c_pre1 = _dense(enc, params["color_w1"], params["color_b1"])
    c_h = [torch.clamp_min(p, 0.0) for p in c_pre1]
    cw2, cb2 = params["color_w2"], params["color_b2"]
    c_pre2 = []
    for ch in range(3):
        acc = cw2[ch, 0] * c_h[0]
        for j in range(1, len(c_h)):
            acc = acc + cw2[ch, j] * c_h[j]
        c_pre2.append(acc + cb2[ch])
    rgb = [torch.clamp(p, 0.0, 1.0) for p in c_pre2]
    return (sigma, rgb[0], rgb[1], rgb[2]), (s_pre1, s_pre2, c_pre1,
                                             c_pre2, s_h, c_h)


def eval_planes(px, py, pz, params: dict, spec: HashMLPSpec):
    """(sigma, r, g, b) planes of the positions' shape: the encoding is
    computed once for both heads."""
    enc = encode_planes(px, py, pz, params["hash_table"], spec)
    return heads_from_planes(enc, params)[0]


def eval_sigma(positions: torch.Tensor, params: dict,
               spec: HashMLPSpec) -> torch.Tensor:
    """Sigma head (hash_mlp_cpu.cpp:95-119): ReLU MLP, non-negative."""
    enc = encode(positions, params["hash_table"], spec)
    hidden = torch.clamp_min(enc @ params["sigma_w1"].T
                             + params["sigma_b1"], 0.0)
    return torch.clamp_min(hidden @ params["sigma_w2"]
                           + params["sigma_b2"], 0.0)


def eval_color(positions: torch.Tensor, params: dict,
               spec: HashMLPSpec) -> torch.Tensor:
    """Colour head (hash_mlp_cpu.cpp:121-148): ReLU MLP clamped to [0, 1]."""
    enc = encode(positions, params["hash_table"], spec)
    hidden = torch.clamp_min(enc @ params["color_w1"].T
                             + params["color_b1"], 0.0)
    return torch.clamp(hidden @ params["color_w2"].T + params["color_b2"],
                       0.0, 1.0)
