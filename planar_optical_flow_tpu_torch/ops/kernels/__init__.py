"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version: K1 ``cutout_kernel.cutout``; in ``conv_stack`` K2
``backbone_bf16`` (and ``backbone_tail``, its JAX interface), K4 ``head``,
K5 ``backbone_int8``, K7 ``head_int8``, K8 ``backbone_int8_cut``, K9
``backbone_int8_pm``, K10 ``backbone_int8_tail`` and K16 ``row_shift``;
K13 ``serve_cell.serve_cell_int8``; K14 ``fused_drow.fused_backbone`` and
``fused_head`` (K3, K6 and K12, the gates, and K15, the standalone mix, are
``infer.fast_gate.gate``, ``gate_int8``, ``gate_head_int8`` and
``banded_mix_update``). Sources are in ``csrc/``; ``_build`` compiles them
at first use. ``fold`` folds BatchNorm, ``quant`` quantizes for the int8
kernels."""
