"""Plain reference of a dense-grid emission-absorption render, its MSE
gradient and Adam: straightforward PyTorch, no kernels, no schedules.

It follows the renderer's published semantics (the original's
``hotpath`` CPU path): pinhole rays through pixel centres, a fixed-dt march
from ``t_near`` with stratified splitmix64 jitter, trilinear interpolation
of sigma and colour at the sample points (zero outside the bbox), and the
emission-absorption sum ``w_k = T_k * (1 - exp(-sigma_k * dt_k))``, which
stops once the transmittance before a step is at most 1e-4. It imports
nothing of the program and takes nothing the program made: the grid, the
views, the seed and the target images are handed to it.

``dtype`` is the precision the field's values, the interpolation, the
integration, the loss, the gradients and Adam run in: float32 for the
reference, bfloat16 for the control. The geometry (rays, sample depths and
points) stays float32 in both: it is the camera's, not the field's.
Everything runs in blocks of rays, so that a 512^2 view at 256 steps fits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

STOP_T = 1e-4            # a step is taken while T before it is above this
_MASK32 = 0xFFFFFFFF
_M1 = 0xBF58476D1CE4E5B9
_M2 = 0x94D049BB133111EB
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _signed(v: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >> 63 else v


def _lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def jitter(seed: int, ray: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """Stratified jitter in [0, 1): splitmix64 of ``seed ^ (ray << 32) ^
    step`` (each index as uint32), its low 52 bits over 2^52, rounded to
    float32. ``ray`` and ``step`` are broadcastable int64 tensors."""
    s = (_signed(seed) ^ ((ray & _MASK32) << 32)) ^ (step & _MASK32)
    s = (s ^ _lsr(s, 30)) * _signed(_M1)
    s = (s ^ _lsr(s, 27)) * _signed(_M2)
    s = s ^ _lsr(s, 31)
    frac = (s & ((1 << 52) - 1)).to(torch.float64)
    return (frac * 2.0 ** -52).to(torch.float32)


@dataclass(frozen=True)
class Scene:
    """What the march needs besides the grid: the image size, the pinhole
    intrinsics, the depth range, the step and the jitter seed."""

    width: int
    height: int
    focal: float            # fx = fy, in pixels
    t_near: float
    t_far: float
    n_steps: int
    seed: int
    bbox_min: tuple = (0.0, 0.0, 0.0)
    bbox_max: tuple = (1.0, 1.0, 1.0)

    @property
    def dt(self) -> float:
        return (self.t_far - self.t_near) / self.n_steps

    @property
    def rays(self) -> int:
        return self.width * self.height


def blob_grid(n: int, peak: float, width: float, centre, device):
    """(sigma (n, n, n), colour (n, n, n, 3)) float32 in [z][y][x] order:
    sigma = peak * exp(-r^2 / width) about ``centre`` (x, y, z), colour
    (x, y, 1 - z), on vertices spaced evenly over [0, 1]."""
    ax = torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device)
    zs, ys, xs = torch.meshgrid(ax, ax, ax, indexing="ij")
    r2 = ((xs - centre[0]) ** 2 + (ys - centre[1]) ** 2
          + (zs - centre[2]) ** 2)
    sigma = (peak * torch.exp(-r2 / width)).to(torch.float32)
    color = torch.stack([xs, ys, 1.0 - zs], dim=-1).to(torch.float32)
    return sigma, color


def _rays(scene: Scene, c2w, start: int, count: int, device):
    """Origins (3,) and unit directions (count, 3) of pixels ``start`` ..
    ``start + count`` (row-major), through pixel centres."""
    idx = torch.arange(start, start + count, device=device)
    px = (idx % scene.width).to(torch.float32) + 0.5
    py = (idx // scene.width).to(torch.float32) + 0.5
    a = (px - scene.width / 2) / scene.focal
    b = (py - scene.height / 2) / scene.focal
    r = torch.tensor(c2w, dtype=torch.float32, device=device).reshape(3, 4)
    d = torch.stack([r[i, 0] * a + r[i, 1] * b + r[i, 2] for i in range(3)],
                    dim=-1)
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    return r[:, 3], d


def _samples(scene: Scene, origin, dirs, start: int):
    """Sample points (B, K, 3), step lengths (B, K) and the live mask of
    a block of rays: base t = t_near + k dt, jittered within its step."""
    dev = dirs.device
    n = dirs.shape[0]
    k = torch.arange(scene.n_steps, device=dev)
    dt = torch.tensor(scene.dt, dtype=torch.float32, device=dev)
    t_near = torch.tensor(scene.t_near, dtype=torch.float32, device=dev)
    t_far = torch.tensor(scene.t_far, dtype=torch.float32, device=dev)
    base = t_near + k.to(torch.float32) * dt                     # (K,)
    live = (base < t_far).expand(n, -1)
    ray = torch.arange(start, start + n, device=dev)[:, None]
    j = torch.clamp(jitter(scene.seed, ray, k[None, :]), 0.0, 1.0)
    t = base + j * dt
    t = torch.where(t >= t_far, torch.nextafter(t_far, t_near), t)
    step = torch.where(live, torch.minimum(base + dt, t_far) - base,
                       torch.zeros_like(t))
    pts = origin + dirs[:, None, :] * t[..., None]
    return pts, step, live


def _trilinear(table: torch.Tensor, shape, scene: Scene, pts: torch.Tensor):
    """(S, C) values of a (Z*Y*X, C) vertex table at (S, 3) points: the
    eight surrounding vertices blended along x, then y, then z; zero
    outside the bbox."""
    nz, ny, nx = shape
    lo = torch.tensor(scene.bbox_min, dtype=torch.float32, device=pts.device)
    hi = torch.tensor(scene.bbox_max, dtype=torch.float32, device=pts.device)
    loc = (pts - lo) * (1.0 / (hi - lo))
    outside = ((loc < 0.0) | (loc > 1.0)).any(dim=-1)
    n = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.float32,
                     device=pts.device)
    f = loc * n
    i0 = torch.minimum(torch.clamp(torch.floor(f), min=0.0), n)
    frac = (f - i0).to(table.dtype)
    i0 = i0.to(torch.int64)
    i1 = torch.minimum(i0 + 1, n.to(torch.int64))
    x = (i0[:, 0], i1[:, 0])
    y = (i0[:, 1], i1[:, 1])
    z = (i0[:, 2], i1[:, 2])

    def at(iz, iy, ix):
        return table.index_select(0, (z[iz] * ny + y[iy]) * nx + x[ix])

    tx, ty, tz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    c00 = at(0, 0, 0) + (at(0, 0, 1) - at(0, 0, 0)) * tx
    c10 = at(0, 1, 0) + (at(0, 1, 1) - at(0, 1, 0)) * tx
    c01 = at(1, 0, 0) + (at(1, 0, 1) - at(1, 0, 0)) * tx
    c11 = at(1, 1, 0) + (at(1, 1, 1) - at(1, 1, 0)) * tx
    c0 = c00 + (c10 - c00) * ty
    c1 = c01 + (c11 - c01) * ty
    vals = c0 + (c1 - c0) * tz
    return torch.where(outside[:, None], torch.zeros_like(vals), vals)


def _integrate(sigma, rgb, step, live):
    """Per-ray (radiance (B, 3), opacity (B,)) of (B, K) sigma and step
    lengths and (B, K, 3) colour: weights T_k (1 - exp(-sigma_k dt_k)),
    taken while T before the step is above :data:`STOP_T`."""
    dtype = sigma.dtype
    od = torch.clamp_min(sigma * step.to(dtype), 0.0) * live.to(dtype)
    before = torch.cumsum(od, dim=1) - od
    t_before = torch.exp(-before)
    taken = torch.cummin((t_before.detach() > STOP_T).to(torch.int32),
                         dim=1).values.to(dtype) * live.to(dtype)
    w = t_before * -torch.expm1(-od) * taken
    return (w[..., None] * rgb).sum(dim=1), w.sum(dim=1)


def render_block(table, shape, scene: Scene, c2w, start: int, count: int):
    """(radiance (B, 3), opacity (B,)) of rays ``start`` .. ``start +
    count`` of one view, in the table's dtype."""
    origin, dirs = _rays(scene, c2w, start, count, table.device)
    pts, step, live = _samples(scene, origin, dirs, start)
    b, k = step.shape
    vals = _trilinear(table, shape, scene, pts.reshape(-1, 3)).reshape(
        b, k, -1)
    return _integrate(vals[..., 0], vals[..., 1:], step, live)


def grid_table(sigma: torch.Tensor, color: torch.Tensor, dtype):
    """The (Z*Y*X, 4) vertex table (sigma, r, g, b) in ``dtype``."""
    return torch.cat([sigma.reshape(-1, 1), color.reshape(-1, 3)],
                     dim=1).to(dtype)


def block_rays(scene: Scene) -> int:
    """Rays a block: about 4M samples."""
    return max(1024, min(scene.rays, (1 << 22) // scene.n_steps))


@torch.no_grad()
def render_view(sigma, color, scene: Scene, c2w, dtype=torch.float32):
    """(image (H, W, 3), opacity (H, W)) float32 of one view."""
    table = grid_table(sigma, color, dtype)
    shape = tuple(sigma.shape)
    rgb, op = [], []
    blk = block_rays(scene)
    for s in range(0, scene.rays, blk):
        c, o = render_block(table, shape, scene, c2w, s,
                            min(blk, scene.rays - s))
        rgb.append(c.float())
        op.append(o.float())
    hw = (scene.height, scene.width)
    return torch.cat(rgb).reshape(hw + (3,)), torch.cat(op).reshape(hw)


def loss_and_grad(sigma, color, scene: Scene, views, targets,
                  dtype=torch.float32, alter=None):
    """(MSE over every view's image, d loss / d sigma, d loss / d colour):
    the mean over (V, H, W, 3) of the squared error against ``targets``
    (V, H, W, 3), summed block by block with autograd on the vertex
    table. ``alter(view, start, rgb) -> rgb`` may change a block's
    radiance where it is produced (a planted fault)."""
    shape = tuple(sigma.shape)
    table = grid_table(sigma, color, dtype).detach().requires_grad_(True)
    n = len(views) * scene.rays * 3
    flat = targets.reshape(len(views), -1, 3)
    total = torch.zeros((), dtype=torch.float64, device=sigma.device)
    blk = block_rays(scene)
    for v, c2w in enumerate(views):
        for s in range(0, scene.rays, blk):
            cnt = min(blk, scene.rays - s)
            rgb, _ = render_block(table, shape, scene, c2w, s, cnt)
            if alter is not None:
                rgb = alter(v, s, rgb)
            err = rgb - flat[v, s:s + cnt].to(dtype)
            part = (err * err).sum() / n
            part.backward()
            total += part.detach().double()
    g = table.grad
    return (total.float(), g[:, 0].reshape(shape),
            g[:, 1:].reshape(shape + (3,)))


def adam_fit(sigma0, color0, scene: Scene, views, targets, lr: float,
             steps: int, dtype=torch.float32, alter=None):
    """``steps`` steps of Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected)
    from (sigma0, color0), each followed by the projection sigma >= 0,
    colour in [0, 1]. Returns the losses, the first step's gradients and
    the parameters after the last step, float32."""
    params = [sigma0.to(dtype).clone(), color0.to(dtype).clone()]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first = [], None
    for t in range(1, steps + 1):
        loss, gs, gc = loss_and_grad(params[0], params[1], scene, views,
                                     targets, dtype, alter)
        losses.append(float(loss))
        grads = [gs.to(dtype), gc.to(dtype)]
        if first is None:
            first = [g.float() for g in grads]
        for p, g, mi, vi in zip(params, grads, m, v):
            mi.mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
            vi.mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
            m_hat = mi / (1 - ADAM_B1 ** t)
            v_hat = vi / (1 - ADAM_B2 ** t)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + ADAM_EPS))
        params[0].clamp_(min=0.0)
        params[1].clamp_(0.0, 1.0)
    return {"losses": losses, "grads": first,
            "params": [p.float() for p in params]}


def orbit_c2w(i: int, n: int, amp_x: float, amp_y: float, tz: float = -1.0):
    """Pose ``i`` of ``n`` on a translation orbit: identity rotation, the
    camera at (0.5 + amp_x sin a, 0.5 + amp_y cos a, tz), a = 2 pi i / n."""
    ang = 2.0 * math.pi * i / n
    return (1.0, 0.0, 0.0, 0.5 + amp_x * math.sin(ang),
            0.0, 1.0, 0.0, 0.5 + amp_y * math.cos(ang),
            0.0, 0.0, 1.0, tz)
