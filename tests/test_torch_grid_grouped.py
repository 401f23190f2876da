"""The hash grid path's one-launch route: every tile group of a schedule
through one K8f and one K8b call, from the schedule's flat arrays and
per-tile descriptor (``fused_tiles.TileSet``, the schedule's ``tiles``), on
the CPU.

Three port scenes (no JAX): 16 px tiles over a 64^2 frame with 48 steps
(groups of 3 and 4 chunks), 8 px sub-tiles over a 48^2 frame with 40
steps seen from a close camera (seven groups of 3 or 4 chunks and 2 to 6
banks) and 4 px sub-tiles over 24^2 with 24 steps (tests/test_torch_grid_
subtiles.py's 4 px scene). Held:

- the descriptor and the flat arrays index exactly the slices of the
  per-group route (samp, base, rayt, ke, bank0 and the gathered bank
  tables), and the groups' arrays are views of the flat ones, on the host
  and after ``.to``; the groups equal those of the scheduler without them;
- ``render_hash_grid_tiled``'s frame and every parameter's gradient equal
  bit for bit to the per-group route it replaced (K8f's and K8b's twins
  called group by group, the slot rows concatenated, the groups' MLP
  gradients summed with ``torch.sum``); a schedule without the flat
  arrays, and the dense scheduler's own schedule of the finest lattice,
  render the same frame and gradients;
- an emulation of K8b's MLP-gradient order (per warp and step, the 32
  rays in quads ((p0 + p1) + (p2 + p3)) added in ray order, the steps in
  the kernel's reverse order, the warps and then the tiles in order),
  rounded in float32 as the kernel rounds and in float64, within 2e-5 x
  scale of the float64 twin.

The comparisons of these frames and gradients with JAX stay in
tests/test_torch_hash_grid.py and tests/test_torch_grid_subtiles*.py;
tests/test_torch_cuda.py holds the one-launch kernels to these twins on
the card.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import dvren_tpu_torch as P
from dvren_tpu_torch.ops import fused_tiles, gather_plan, hash_grid, hash_tiles
from dvren_tpu_torch.render import hash_tiled, tiled

torch.set_num_threads(1)

TWIN_TOL = 2e-5   # x max |reference|

SPEC3 = dict(n_levels=3, features_per_level=2, table_size=4096,
             resolutions=(2, 4, 8))
SPEC4 = dict(n_levels=4, features_per_level=2, table_size=4096,
             base_resolution=2.0, finest_resolution=16.0,
             resolutions=(2, 4, 8, 16))
# scene -> (width, steps, spec, camera position, tile_px)
SCENES = {
    "16px": (64, 48, SPEC3, (0.3, 0.6, -0.6), 16),
    "8px": (48, 40, SPEC4, (0.3, 0.6, -0.6), 8),
    "4px": (24, 24, SPEC4, (0.5, 0.65, -1.0), 4),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(plan, field with seeded biases, schedule on CPU tensors)."""
    w, steps, spec, (x, y, z), px = SCENES[name]
    plan = P.Plan.create(P.PlanConfig(
        width=w, height=w, t_near=0.2, t_far=2.2, seed=5,
        camera=P.CameraConfig(
            k=(w * 1.2, 0, w / 2, 0, w * 1.2, w / 2, 0, 0, 1),
            c2w=(1, 0, 0, x, 0, 1, 0, y, 0, 0, 1, z)),
        sampling=P.SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    field = P.HashMLPField.init_random(torch.Generator().manual_seed(0),
                                       spec=P.HashMLPSpec(**spec),
                                       table_std=0.5, device="cpu")
    rng = np.random.default_rng(1)
    field = field.with_params({
        k: v.detach() + (torch.from_numpy(rng.normal(
            0.0, 0.3, tuple(v.shape)).astype(np.float32))
            if k.endswith(("_b1", "_b2")) else 0.0)
        for k, v in field.params.items()})
    sched = hash_tiled.build_hash_grid_schedule(plan, field, tile_px=px,
                                                device="cpu")
    assert sched.tile_px == px and sched.fallback_rays == 0
    return plan, field, sched


def shapes(sched):
    return [(g.n_tiles, g.n_chunks, g.banks) for g in sched.groups]


def test_a_schedule_has_ragged_groups():
    """The 8 px scene's groups differ in both chunk and bank counts."""
    got = shapes(case("8px")[2])
    assert len({nc for _, nc, _ in got}) > 1
    assert len({nb for _, _, nb in got}) > 1
    assert len({nc for _, nc, _ in shapes(case("16px")[2])}) > 1


@pytest.mark.parametrize("name", sorted(SCENES))
def test_descriptor_indexes_the_group_slices(name):
    plan, field, sched = case(name)
    tiles = sched.tiles
    subs = (16 // sched.tile_px) ** 2
    assert tiles.shapes == tuple(shapes(sched)) and tiles.subs == subs
    desc = tiles.desc.numpy()
    assert desc.dtype == np.int32 and desc.shape == (tiles.n_tiles, 4)
    table = hash_grid.build_hash_grid_table(dict(field.params), field.spec)
    flat_tabs = tiled._gather_banks_flat(table, sched.gathermap_all)
    group_tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    t0 = c0 = b0 = 0
    for gi, g in enumerate(sched.groups):
        n, nc, nb = g.n_tiles, g.n_chunks, g.banks
        d = desc[t0:t0 + n]
        np.testing.assert_array_equal(d[:, :2], [[nc, nb]] * n)
        np.testing.assert_array_equal(d[:, 2], c0 + nc * np.arange(n))
        np.testing.assert_array_equal(d[:, 3], b0 + nb * np.arange(n))
        for j in range(n):
            ch, bk = int(d[j, 2]), int(d[j, 3])
            assert torch.equal(tiles.samp[ch:ch + nc], g.samp[j])
            assert torch.equal(tiles.base[bk:bk + nb], g.base[j])
            assert torch.equal(tiles.bank0[ch * subs:(ch + nc) * subs],
                               g.bank0[j].reshape(-1))
            assert torch.equal(tiles.rayt[t0 + j], g.rayt[j])
            assert int(tiles.ke[t0 + j]) == int(g.k_enter[j])
            assert torch.equal(flat_tabs[bk:bk + nb], group_tabs[gi][j])
        t0, c0, b0 = t0 + n, c0 + n * nc, b0 + n * nb
    assert (t0, c0, b0) == (tiles.n_tiles, tiles.samp.shape[0],
                            flat_tabs.shape[0])
    assert c0 * subs == tiles.bank0.shape[0] and b0 == tiles.base.shape[0]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_groups_are_views_of_the_flat_arrays(name):
    """The groups' arrays share the flat arrays' memory (the schedule
    holds them once) and equal the scheduler's own groups."""
    plan, field, sched = case(name)
    tiles = sched.tiles
    for g in sched.groups:
        for key, flat in (("samp", tiles.samp), ("base", tiles.base),
                          ("rayt", tiles.rayt), ("k_enter", tiles.ke),
                          ("bank0", tiles.bank0)):
            assert (getattr(g, key).untyped_storage().data_ptr()
                    == flat.untyped_storage().data_ptr()), key
    proxy = hash_tiled._HashSchedProxy(
        schedule_grid_shape=hash_grid.grid_shape(field.spec))
    own = tiled.build_tiled_schedule(plan, proxy, tile_px=sched.tile_px)
    assert own.tiles is not None and sched.tiles is not None
    for g, h in zip(sched.groups, own.groups):
        for f in dataclasses.fields(g):
            a, b = getattr(g, f.name), getattr(h, f.name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), b, err_msg=f.name)
            else:
                assert a == b, f.name


def test_host_schedule_views_and_move():
    """Built in numpy, the groups are views of the numpy flat arrays;
    ``.to`` moves the flat arrays once and cuts the groups from them."""
    plan, field, _ = case("8px")
    host = hash_tiled.build_hash_grid_schedule(plan, field, tile_px=8)
    assert isinstance(host.tiles.samp, np.ndarray)
    for g in host.groups:
        assert np.shares_memory(g.samp, host.tiles.samp)
        assert np.shares_memory(g.bank0, host.tiles.bank0)
    moved = host.to("cpu")
    assert moved.tiles.device == torch.device("cpu")
    assert torch.equal(moved.tiles.desc,
                       torch.from_numpy(host.tiles.desc))
    for g, h in zip(moved.groups, host.groups):
        np.testing.assert_array_equal(g.samp.numpy(), h.samp)
        assert (g.samp.untyped_storage().data_ptr()
                == moved.tiles.samp.untyped_storage().data_ptr())


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tiles_from_tensors_equal_tiles_from_numpy(name):
    """``tile_set`` over tensor groups (u16 samples included) builds the
    same arrays and descriptor as over the numpy groups."""
    _, _, sched = case(name)
    again = fused_tiles.tile_set(sched.groups, sched.tiles.subs)
    for key in ("samp", "base", "rayt", "ke", "bank0", "desc", "order"):
        a, b = getattr(again, key), getattr(sched.tiles, key)
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert again.shapes == sched.tiles.shapes


def per_group_route(plan, field, sched, loss_fn):
    """The route before one launch per schedule: K8f's twin per group,
    the compose, the loss's cotangent per group, K8b's twin per group, the
    slot rows concatenated and reduced, the groups' MLP gradients summed
    with ``torch.sum``. Returns (planes, gradients by name)."""
    spec = field.spec
    subs = (16 // sched.tile_px) ** 2
    named = {k: v.detach() for k, v in field.params.items()}
    table = hash_grid.build_hash_grid_table(named, spec)
    sc = hash_tiles.pack_mlp_scalars(named, spec)
    tabs = tiled._gather_bank_tables(
        table, sched.gathermap_all,
        [(g.n_tiles, g.banks) for g in sched.groups])
    args = [(tabs[i], g.samp, g.base, g.rayt, g.k_enter, g.bank0.reshape(-1),
             sc, hash_grid.grid_op_params(plan, spec, g.banks, g.n_chunks,
                                          subs))
            for i, g in enumerate(sched.groups)]
    raws = [hash_grid.hash_grid_forward_plain(*a).requires_grad_(True)
            for a in args]
    planes = tiled._compose_tiles(plan, raws,
                                  [g.tile_ids for g in sched.groups],
                                  tile_px=sched.tile_px)
    g_raws = torch.autograd.grad(loss_fn(planes), raws)
    rows, d_scs = [], []
    for a, gr in zip(args, g_raws):
        d_rows, d_sc = hash_grid.hash_grid_backward_plain(
            *a[:7], gr.contiguous(), a[7])
        rows.append(d_rows.reshape(-1, d_rows.shape[-1]))
        d_scs.append(d_sc)
    table_grad = gather_plan.slot_rows_to_table(
        torch.cat(rows), sched.gather_plan, int(table.shape[0]))
    grads = hash_tiles.grads_from_blocks(
        hash_grid.hash_grid_table_grad(table_grad, spec),
        torch.sum(torch.stack(d_scs), dim=0), spec)
    return planes, grads


def loss_of(planes):
    return (torch.mean(planes.image ** 2) + 0.25 * torch.mean(planes.opacity)
            + 0.01 * torch.mean(planes.depth))


def one_launch_route(plan, field, sched):
    leaf = field.with_params({k: v.detach().clone().requires_grad_(True)
                              for k, v in field.params.items()})
    planes = hash_tiled.render_hash_grid_tiled(plan, leaf, sched)
    keys = sorted(leaf.params)
    grads = torch.autograd.grad(loss_of(planes),
                                [leaf.params[k] for k in keys])
    return planes, dict(zip(keys, grads))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_and_gradients_equal_the_per_group_route(name):
    plan, field, sched = case(name)
    launches = (hash_grid.hash_grid_forward_tiles.launches,
                hash_grid.hash_grid_backward_tiles.launches)
    got, g_got = one_launch_route(plan, field, sched)
    want, g_want = per_group_route(plan, field, sched, loss_of)
    for key in ("image", "transmittance", "opacity", "depth", "hitmask"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    assert float(got.opacity.detach().max()) > 0.0
    for k in g_want:
        assert torch.equal(g_got[k], g_want[k]), k
        assert float(g_got[k].abs().max()) > 0.0, k
    # the CPU runs the twins: no kernel launch is counted
    assert (hash_grid.hash_grid_forward_tiles.launches,
            hash_grid.hash_grid_backward_tiles.launches) == launches


def test_schedule_without_flat_arrays_is_refused():
    """A schedule whose flat arrays were taken away, and the dense
    scheduler's own schedule of the finest lattice (not built by
    ``build_hash_grid_schedule``), are no longer refused: each renders
    the frame and gradients of the grid schedule bit for bit, as JAX's
    ``render_hash_grid_tiled`` takes any zero-overflow tile schedule of
    that lattice."""
    plan, field, sched = case("8px")
    want, g_want = one_launch_route(plan, field, sched)
    proxy = hash_tiled._HashSchedProxy(
        schedule_grid_shape=hash_grid.grid_shape(field.spec))
    own = tiled.build_tiled_schedule(plan, proxy, tile_px=8).to("cpu")
    for other in (dataclasses.replace(sched, tiles=None), own):
        got, g_got = one_launch_route(plan, field, other)
        for key in ("image", "transmittance", "opacity", "depth"):
            assert torch.equal(getattr(got, key), getattr(want, key)), key
        for k in g_want:
            assert torch.equal(g_got[k], g_want[k]), k


def tiles_args(name, seed=3):
    plan, field, sched = case(name)
    named = {k: v.detach() for k, v in field.params.items()}
    table = hash_grid.build_hash_grid_table(named, field.spec)
    tabs = tiled._gather_banks_flat(table, sched.gathermap_all)
    sc = hash_tiles.pack_mlp_scalars(named, field.spec)
    prm = hash_grid.tiles_op_params(plan, field.spec, sched.tiles)
    gs = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(sched.tiles.n_tiles, 5, 16, 16)).astype(np.float32))
    return tabs, sched.tiles, sc, gs, prm


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tile_wrappers_on_cpu_loop_the_twins(name):
    tabs, tiles, sc, gs, prm = tiles_args(name)
    assert prm.n_chunks == tiles.max_chunks and prm.banks == tiles.max_banks
    out = hash_grid.hash_grid_forward_tiles(tabs, tiles, sc, prm)
    rows, d_sc = hash_grid.hash_grid_backward_tiles(tabs, tiles, sc, gs, prm)
    assert out.shape == (tiles.n_tiles, 5, 16, 16)
    assert rows.shape == (tabs.shape[0] * 128, prm.cols)
    t0 = b0 = 0
    d_scs = []
    for a, (n, nc, nb) in zip(hash_grid._group_args(tabs, tiles, sc, prm),
                              tiles.shapes):
        assert (a[7].n_chunks, a[7].banks) == (nc, nb)
        assert torch.equal(out[t0:t0 + n],
                           hash_grid.hash_grid_forward_plain(*a))
        p_rows, p_sc = hash_grid.hash_grid_backward_plain(
            *a[:7], gs[t0:t0 + n].contiguous(), a[7])
        assert torch.equal(rows[b0 * 128:(b0 + n * nb) * 128],
                           p_rows.reshape(-1, prm.cols))
        d_scs.append(p_sc)
        t0, b0 = t0 + n, b0 + n * nb
    assert torch.equal(d_sc, torch.sum(torch.stack(d_scs), dim=0))


def test_tile_wrappers_refuse_bad_inputs():
    tabs, tiles, sc, gs, prm = tiles_args("4px")
    with pytest.raises(ValueError, match="subs"):
        hash_grid.hash_grid_forward_tiles(
            tabs, tiles, sc, dataclasses.replace(prm, subs=4))
    with pytest.raises(ValueError, match="tabs"):
        hash_grid.hash_grid_forward_tiles(tabs[1:], tiles, sc, prm)
    with pytest.raises(ValueError, match="gs"):
        hash_grid.hash_grid_backward_tiles(tabs, tiles, sc, gs[1:], prm)
    with pytest.raises(TypeError, match="desc"):
        hash_grid.hash_grid_forward_tiles(
            tabs, dataclasses.replace(tiles, desc=tiles.desc.long()), sc,
            prm)
    plan, field, _ = case("4px")
    host = hash_tiled.build_hash_grid_schedule(plan, field, tile_px=4)
    with pytest.raises(TypeError, match="tensor"):
        hash_grid.hash_grid_forward_tiles(tabs, host.tiles, sc, prm)


def mlp_factor_pairs(f, spec):
    """K8b's (a, b) factor planes of every MLP output, in _mlp_layout
    order (csrc/hash_grid_bwd.cu::mlp_factor_rows); None is the row of
    ones."""
    hid, enc = spec.hidden_dim, spec.encoding_dim
    pairs = [(f["ds1"][j], f["enc"][i]) for j in range(hid)
             for i in range(enc)]
    pairs += [(f["ds1"][j], None) for j in range(hid)]
    pairs += [(f["dsig2"], f["s_h"][j]) for j in range(hid)]
    pairs += [(f["dsig2"], None)]
    pairs += [(f["dc1"][j], f["enc"][i]) for j in range(hid)
              for i in range(enc)]
    pairs += [(f["dc1"][j], None) for j in range(hid)]
    pairs += [(f["dc2"][ch], f["c_h"][j]) for ch in range(3)
              for j in range(hid)]
    pairs += [(f["dc2"][ch], None) for ch in range(3)]
    return pairs


def kernel_order_mlp(tabs, tiles, sc, gs, prm, dtype):
    """d(MLP scalars) summed in K8b's order from the twin's per-sample
    factors, rounding in ``dtype``: per (tile, warp) and step, the 32 rays'
    products in quads ((p0 + p1) + (p2 + p3)), the 8 quads in ray order;
    the steps added into a running sum from the last chunk's last step
    back; the 8 warps in order, then the tiles in order."""
    spec = prm.spec
    mlp = hash_tiles._mlp_from_scalars(sc, spec)
    parts, t0 = [], 0
    for a in hash_grid._group_args(tabs, tiles, sc, prm):
        n = int(a[0].shape[0])
        lat = hash_grid._GridLattice(*a[:6], a[7])
        acc = None
        for f in hash_grid._adjoint_chunks(lat, mlp, gs[t0:t0 + n], spec):
            prods = torch.stack([
                (x.to(dtype) * y.to(dtype)) if y is not None else x.to(dtype)
                for x, y in mlp_factor_pairs(f, spec)])      # (P, T, 2048)
            # sample = ray * 8 + step; ray = warp * 32 + quad * 4 + k
            p = prods.reshape(-1, n, 8, 8, 4, 8)
            s4 = (p[:, :, :, :, 0] + p[:, :, :, :, 1]) + (
                p[:, :, :, :, 2] + p[:, :, :, :, 3])        # (P, T, w, q, j)
            step = s4[:, :, :, 0]
            for qd in range(1, 8):
                step = step + s4[:, :, :, qd]              # (P, T, w, j)
            for j in reversed(range(8)):
                acc = step[..., j] if acc is None else acc + step[..., j]
        tile = acc[:, :, 0]
        for w in range(1, 8):
            tile = tile + acc[:, :, w]                     # (P, T)
        parts.append(tile)
        t0 += n
    parts = torch.cat(parts, dim=1)
    total = parts[:, 0]
    for t in range(1, parts.shape[1]):
        total = total + parts[:, t]
    return total


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_mlp_sum_order_within_bound(name, dtype):
    tabs, tiles, sc, gs, prm = tiles_args(name)
    got = kernel_order_mlp(tabs, tiles, sc, gs, prm, dtype)
    want = torch.stack([
        hash_grid.hash_grid_backward_plain(
            *a[:7], gs[t0:t0 + int(a[0].shape[0])].contiguous(), a[7])[1]
        for a, t0 in zip(hash_grid._group_args(tabs, tiles, sc, prm),
                         [o[0] for o in tiles.offsets()])]).double().sum(0)
    scale = float(want.abs().max())
    assert scale > 0.0
    err = float((got.double() - want).abs().max())
    assert err <= TWIN_TOL * scale, (err, scale)
