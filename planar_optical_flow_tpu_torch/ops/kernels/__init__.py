"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version: K1 ``cutout_kernel.cutout``, K2 ``conv_stack.backbone_tail``,
K4 ``conv_stack.head``, K5 ``conv_stack.backbone_int8``, K7
``conv_stack.head_int8`` (K3 and K6, the gates, are ``infer.fast_gate.gate``
and ``gate_int8``). Sources are in ``csrc/``; ``_build`` compiles them at
first use. ``fold`` folds BatchNorm, ``quant`` quantizes for K5/K7."""
