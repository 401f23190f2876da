"""Name for name: every public top-level name of dvren_tpu has its port.

Both packages are read with ``ast`` (nothing is imported). A public
top-level name (a ``def``, a ``class`` or an assignment not starting with
an underscore) of a ``dvren_tpu`` module must exist at the same module
path of ``dvren_tpu_torch``, or be mapped below to the port name that
does its work (``"module:name"``, which must exist), or to a one-line
reason it is not ported. A new JAX name without a counterpart fails the
test, and so does a stale entry of the map.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "dvren_tpu"
PORT_PKG = ROOT / "dvren_tpu_torch"

_MXU_REDUCE = ("not ported: the reduce= TPU variants (mxu, roll) compute "
               "the default's sums with the TPU's matrix unit; K1 and K2 "
               "have one reduction")
_STARTS = ("not ported: a TPU gather-start rate; on the card a row gather "
           "is priced by its bytes (utils/roofline.py)")

# JAX module:name -> port "module:name", or a reason (a sentence).
COUNTERPARTS = {
    "ops.fused_tiles:DEFAULT_REDUCE": _MXU_REDUCE,
    "ops.fused_tiles:SUP_NCH": "ops.grid:SUPER_NCH",
    "ops.fused_tiles:render_tile_group": "ops.fused_tiles:finalize_heads",
    "ops.fused_tiles:render_tile_group_raw": "ops.fused_tiles:tile_forward",
    "ops.fused_tiles:stencil_rows": "ops.fused_tiles:check_tiles",
    "ops.grid:build_packed_stencil_chmajor":
        "ops.grid:build_packed_stencil",
    "ops.grid:build_packed_stencil_fullpitch":
        "ops.packed_transpose:build_rows",
    "ops.grid:build_packed_table16": "ops.packed_transpose:build_rows16",
    "ops.grid:take_rows_exact": "ops.grid:take_rows",
    "ops.hash_grid:hash_grid_group_op":
        "ops.hash_grid:hash_grid_forward_tiles",
    "ops.hash_grid:mlp_vec_from_blocks": "ops.hash_tiles:grads_from_blocks",
    "ops.hash_grid:render_hash_grid_group_raw":
        "ops.hash_grid:hash_grid_forward_tiles",
    "ops.hash_tiles:table_block": (
        "not ported: the TPU's (8, 128) VMEM block of the hash table; K7 "
        "reads the table as the field holds it"),
    "ops.integrate_pallas:DEFAULT_TILE_N": (
        "not ported: the Pallas kernel's ray block; K9 gives each ray a "
        "warp"),
    "ops.integrate_pallas:LANE": (
        "not ported: the TPU's 128-lane vector width"),
    "ops.integrate_pallas:integrate_pallas":
        "ops.integrate_fused:integrate_fused",
    "ops.packed_transpose:banks_to_u16_rows":
        "ops.packed_transpose:banks_to_rows",
    "ops.packed_transpose:rows_to_stack":
        "ops.packed_transpose:table16_grad_to_params",
    "ops.packed_transpose:stack_to_rows": "ops.packed_transpose:build_rows16",
    "ops.packed_transpose:stack_to_u16_rows":
        "ops.packed_transpose:build_rows",
    "ops.packed_transpose:u16_rows_to_stack":
        "ops.packed_transpose:table_grad_to_params",
    "ops.raygen:jax_rsqrt": (
        "not ported: an alias of 1 / sqrt that the port's raygen writes "
        "out"),
    "render.tiled:GatherPlan": "ops.gather_plan:GatherPlan",
    "render.tiled:bank_tables_from_params": "render.tiled:_gather_bank_tables",
    "render.tiled:ct16_rows_to_table": "ops.gather_plan:slot_rows_to_table",
    "render.tiled:ct16_rows_to_table16": "render.tiled:slot_rows_to_table_as",
    "render.tiled:render_tiled_phases": (
        "not ported: the Renderer times the frame render_tiled renders by "
        "its stage clock (utils/trace.py::timed_clock), not a second path"),
    "utils.pytree:pytree_dataclass": (
        "not ported: a JAX pytree registration; the port walks dataclasses "
        "itself (utils/pytree.py::tree_map)"),
    "utils.roofline:HBM_GBPS": "utils.roofline:HBM_BYTES_S",
    "utils.roofline:F32_STARTS_PER_S": _STARTS,
    "utils.roofline:U16_STARTS_PER_S": _STARTS,
}

# Private names whose absence the ROADMAP explains, held here as well.
PRIVATE_REASONS = {
    "parallel.shard:_PLAN_META_MEMO": (
        "not ported: a memo against jax.jit retraces; the port traces "
        "nothing"),
    "ops.fused_tiles:_gather_planes_mxu": _MXU_REDUCE,
    "ops.fused_tiles:_MxuReduce": _MXU_REDUCE,
    "ops.fused_tiles:_RollReduce": _MXU_REDUCE,
}


def _module_names(root: Path, imports: bool) -> dict:
    """{dotted module path: its top-level names}; with ``imports`` the
    names its imports bind too."""
    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = ".".join(path.relative_to(root).with_suffix("").parts)
        if mod.endswith("__init__"):
            mod = mod[: -len("__init__")].rstrip(".")
        names = set()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                names.update(t.id for t in node.targets
                             if isinstance(t, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(
                    node.target, ast.Name):
                names.add(node.target.id)
            elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
                names.update((a.asname or a.name).split(".")[0]
                             for a in node.names)
        out[mod] = names
    return out


PORT = _module_names(PORT_PKG, imports=True)
JAX_DEFINED = _module_names(JAX_PKG, imports=False)
PUBLIC = sorted(f"{mod}:{name}" for mod, names in JAX_DEFINED.items()
                for name in names if not name.startswith("_"))


def _port_has(target: str) -> bool:
    mod, name = target.split(":")
    return name in PORT.get(mod, set())


def test_the_walk_finds_both_packages():
    assert len(PUBLIC) > 200
    assert "render.renderer:Renderer" in PUBLIC
    assert _port_has("render.renderer:Renderer")


@pytest.mark.parametrize("module", sorted(
    {p.split(":")[0] for p in PUBLIC}))
def test_every_public_name_has_a_counterpart(module):
    missing = []
    for entry in (p for p in PUBLIC if p.split(":")[0] == module):
        if _port_has(entry):
            continue
        target = COUNTERPARTS.get(entry)
        if target is None:
            missing.append(f"{entry}: no port name and no reason")
        elif not target.startswith("not ported: ") and not _port_has(target):
            missing.append(f"{entry}: mapped to missing {target}")
    assert not missing, "\n".join(missing)


def test_map_has_no_stale_entries():
    """Each mapped name is a JAX name the port lacks under its own
    module path, and each reason is one line."""
    for entry, target in {**COUNTERPARTS, **PRIVATE_REASONS}.items():
        mod, name = entry.split(":")
        assert name in JAX_DEFINED.get(mod, set()), entry
        assert not _port_has(entry), f"{entry} is ported under its name"
        assert "\n" not in target
        if not target.startswith("not ported: "):
            assert _port_has(target), target


def test_top_level_all_matches():
    """``dvren_tpu.__all__``'s names all exist in ``dvren_tpu_torch``'s."""
    def all_of(path):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets):
                return {ast.literal_eval(e) for e in node.value.elts}
        return set()

    jax_all = all_of(JAX_PKG / "__init__.py")
    port_all = all_of(PORT_PKG / "__init__.py")
    assert "render_windowed_traced" in jax_all
    assert jax_all <= port_all, sorted(jax_all - port_all)
