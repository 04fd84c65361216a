"""The benchmark of the PyTorch/CUDA port (``planar_optical_flow_tpu_torch``):
streaming person detection and flow on one H100. ``run.py`` runs a cell;
``BENCHMARK.json`` at the checkout's root lists the cells. It imports the
port only for the code under test, and neither JAX nor the JAX package."""

import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def use_checkout_caches():
    """Point the caches of compilers the process may start at fixed paths
    in the checkout, so that only a checkout's first run builds."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)
