"""The kernel-name table the readers key on: a substring of each tile
kernel's symbol (``dvren_tpu_torch/csrc``), and the H100's published peaks
(NVIDIA's data sheet, SXM part, at its 700 W limit)."""

K1 = "tile_forward_kernel"          # csrc/fused_tiles.cu
K2 = "tile_backward_kernel"         # csrc/fused_tiles_bwd.cu
K3 = "packed_table_kernel"          # csrc/packed_table.cu (float32 rows)
K4 = "packed_table_grad_kernel"     # csrc/packed_table_bwd.cu

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
