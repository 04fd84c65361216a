"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version: K1 ``cutout_kernel.cutout``; in ``conv_stack`` K2
``backbone_tail``, K4 ``head``, K5 ``backbone_int8``, K7 ``head_int8``, K8
``backbone_int8_cut``, K9 ``backbone_int8_pm``, K10 ``backbone_int8_tail``
and K16 ``row_shift``; K13 ``serve_cell.serve_cell_int8`` (K3, K6 and K12,
the gates, are ``infer.fast_gate.gate``, ``gate_int8`` and
``gate_head_int8``). Sources are in ``csrc/``; ``_build`` compiles them at
first use. ``fold`` folds BatchNorm, ``quant`` quantizes for the int8
kernels."""
