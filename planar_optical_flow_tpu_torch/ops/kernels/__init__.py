"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version: K1 ``cutout_kernel.cutout``, K2 ``conv_stack.backbone_tail``,
K4 ``conv_stack.head`` (K3, the gate, is ``infer.fast_gate.gate``). Sources
are in ``csrc/``; ``_build`` compiles them at first use."""
