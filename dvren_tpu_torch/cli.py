"""dvren_render CLI: a JSON config in, a PPM image out.

Counterpart of ``dvren_tpu/cli.py`` (the reference CLI,
``apps/dvren_render/main.cpp:314-370``):

    python -m dvren_tpu_torch.cli <config.json> [output.ppm]

It renders on the card (a CUDA context and field), prints the same two
summary lines (forward stats, workspace accounting) so that tooling can
read either package's output, and exits 0 on success, 1 on a config or
render error (also when torch has no CUDA: it never falls back to the
CPU) and 2 on a usage error. ``main(argv, device="cpu")`` renders on the
CPU instead; the command line has no such flag.
"""

from __future__ import annotations

import sys

from dvren_tpu_torch.core.context import Context
from dvren_tpu_torch.core.plan import Plan
from dvren_tpu_torch.core.status import DvrenError
from dvren_tpu_torch.fields.dense_grid import DenseGridField
from dvren_tpu_torch.io.config import parse_config_file
from dvren_tpu_torch.io.ppm import write_ppm
from dvren_tpu_torch.render.renderer import Renderer


def render_to_file(ctx: Context, plan: Plan, field: DenseGridField,
                   options, output_path: str) -> int:
    """Render one frame of ``field``, write it to ``output_path`` and print
    the summary lines; returns the exit code (0)."""
    renderer = Renderer(ctx, plan, options)
    result = renderer.forward(field)
    workspace = renderer.workspace_info()
    write_ppm(output_path, result.image.reshape(plan.height, plan.width, 3))
    print(f"Forward stats: rays={result.ray_count} "
          f"samples={result.sample_count} "
          f"total_ms={result.stats.total_ms:.4g}")
    print(f"Workspace bytes total={workspace.total_bytes()} "
          f"sample={workspace.sample_buffer_bytes} "
          f"integration={workspace.integration_buffer_bytes} "
          f"gradient={workspace.gradient_buffer_bytes} "
          f"scratch={workspace.workspace_buffer_bytes}")
    return 0


def main(argv: list[str] | None = None, device: str | None = None) -> int:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); ``device``
    (default: the card) names the torch device."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1 or len(argv) > 2:
        print("usage: python -m dvren_tpu_torch.cli <config.json> "
              "[output.ppm]", file=sys.stderr)
        return 2
    try:
        config = parse_config_file(argv[0])
        output_path = argv[1] if len(argv) == 2 else config.output_path
        ctx = Context.create(device=device)
        plan = Plan.create(config.plan)
        field = DenseGridField.create(config.grid, device=ctx.device)
        if config.table_precision != "float32":
            field = field.with_packed_dtype(config.table_precision)
        return render_to_file(ctx, plan, field, config.options, output_path)
    except DvrenError as exc:
        print(f"error: {exc.status.to_string()}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
