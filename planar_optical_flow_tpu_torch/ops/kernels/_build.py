"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on its own with ``nvcc`` for Hopper into a shared
library with a plain C interface, loaded with ``ctypes``. Every pointer and
the stream are passed as ``c_void_p``; every entry returns
``cudaGetLastError()`` and :func:`check` raises if it is not 0.

* The build runs at first use, into ``build/torch_kernels/`` beside the
  package (listed in ``.gitignore``). Only the sources in the checkout are
  used.
* A library is named after the hash of its source, every header in
  ``csrc/`` (``*.cuh``, which the sources include) and the flags, so a
  changed source or header is rebuilt and an unchanged one is not.
* :func:`build_all` starts one ``nvcc`` per source, all at once, and waits
  for every one of them.
* ``-Xptxas -v`` is always on; its report (registers, shared memory,
  spills) is kept beside each library as ``<lib>.log``.
* Each ``nvcc`` run is a ``kernels.build`` span (its source in the span's
  args) and adds to the counter ``kernels.built``; each library loaded is a
  ``kernels.load`` span (``utils.tracing``; both recorded whether tracing
  is on or not).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from planar_optical_flow_tpu_torch.utils import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
SOURCES = ("cutout", "backbone_bf16", "head_bf16", "conv_stack_int8", "gate",
           "serve_cell", "serve_cell_wg", "fused_f32", "banded_mix")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# loaded libraries, one per source for the life of the process (a CDLL
# cannot be unloaded safely while kernels may still reference it)
_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc"
        if Path("/usr/local/cuda/bin/nvcc").exists() else None)
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built at first use on a machine with a card")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` is built: named after the hash of the
    source, of every ``csrc/*.cuh`` header (name and bytes) and of the
    flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc(compiler: str, name: str):
    """Compile ``csrc/<name>.cu`` into a temporary library beside its
    :func:`library_path`, as one ``kernels.build`` span: (return code,
    compiler output, the temporary library)."""
    out = library_path(name)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    with tracing.span("kernels.build", always=True, args={"source": name}):
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, tmp


def build_all(names=SOURCES) -> dict:
    """Compile every source in ``names`` that is not built yet, one
    ``nvcc`` process per source (each waited for on a thread of its own),
    all started together.

    Returns ``{name: {"log": ptxas report}}``; raises ``RuntimeError``
    with the compiler output if any build fails. How long each build took
    is its ``kernels.build`` span.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, todo = {}, []
    for name in names:
        out = library_path(name)
        if out.exists():
            log = out.with_suffix(".log")
            report[name] = {"log": log.read_text() if log.exists() else ""}
        else:
            todo.append(name)
    if not todo:
        return report
    compiler = nvcc()
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        runs = list(pool.map(lambda n: _nvcc(compiler, n), todo))
    failed = []
    for name, (rc, log, tmp) in zip(todo, runs):
        if rc != 0:
            failed.append(f"--- nvcc {name}.cu (rc {rc})\n{log}")
            continue
        tracing.count("kernels.built", always=True)
        out = library_path(name)
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders race safely
        report[name] = {"log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build_all((name,))
            with tracing.span("kernels.load", always=True,
                              args={"source": name}):
                lib = ctypes.CDLL(str(library_path(name)))
            _LOADED[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
