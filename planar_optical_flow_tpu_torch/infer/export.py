"""Export the serving step and the stateless models as deployment artifacts
(``torch.export``), and load them.

Counterpart of ``planar_optical_flow_tpu/infer/export.py``. A serving
artifact is a directory with two programs for each batch size, each
``torch.export.export`` of a small ``nn.Module`` around the step's body
(``step.raw_step`` of ``make_serve_step_v3``) and written by
``torch.export.save``:

* ``boot.pt2``: ``scan (B, P) f32 -> (carry, outputs)``, a stream's first
  scan;
* ``step.pt2``: ``(carry, scan) -> (carry, outputs)``, the carry a dict of
  tensors;

and ``engine.json``: the batch list, ``num_pts``, the program files, the
generation, ``platforms`` (``["cuda"]`` or ``["cpu"]``, the device the step
was built on), ``torch_version``, ``precision`` and the caller's extras. One
batch size keeps the names ``boot.pt2``/``step.pt2``; a list of sizes
writes ``boot_b{B}.pt2``/``step_b{B}.pt2`` and the loaded engine routes on
the scan's batch. :func:`export_model` writes ``model_b{B}.pt2`` and
``model.json`` for a stateless ``fn(*inputs)`` (the flow U-Net, the box
regressor, the ``drow`` and fc detectors).

The programs hold the weights as constants and every kernel as its
``pof_torch::`` op node (``ops/kernels/library.py``): the loaded engine
launches the same hand-written kernels as the live step, the same number
of times, and gives its carries and outputs to the bit. Loading needs this
package installed, since importing it registers the ops; it does not need
the model code, the checkpoint or the calibration. Shapes are static.

Writes are crash-safe as in JAX: every program is serialized before the
directory is touched, program files carry a generation suffix (``.g{N}``
for N > 0) so a re-export never writes a name the current meta refers to,
the meta is replaced atomically last, and only then are the programs it no
longer lists removed. The loaders refuse, with a readable error, a newer
or unreadable schema, an artifact of the JAX package (``jax_version``, or
``.bin`` programs) and a CUDA artifact on a host without a card.
"""

from __future__ import annotations

import io
import json
import os
import re

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from planar_optical_flow_tpu_torch.ops.kernels import library  # noqa: F401

_META = "engine.json"
_BOOT = "boot.pt2"
_STEP = "step.pt2"
_MODEL_META = "model.json"
_EXT = ".pt2"

# On-disk layout version. Loaders refuse a NEWER (or unreadable) stamp with
# a readable error; an artifact without a stamp reads as version 1.
SCHEMA_VERSION = 1


def _check_schema(path: str, meta: dict):
    ver = meta.get("schema_version", 1)
    if not isinstance(ver, int) or isinstance(ver, bool) or ver < 1:
        raise ValueError(
            f"artifact {path} has an unreadable schema_version {ver!r} "
            "(expected a positive integer) — the meta file is corrupt "
            "or hand-edited; re-export the artifact")
    if ver > SCHEMA_VERSION:
        raise ValueError(
            f"artifact {path} uses schema version {ver} but this "
            f"runtime understands up to {SCHEMA_VERSION} — upgrade "
            "planar_optical_flow_tpu_torch on the serving host, or "
            "re-export the artifact with this version")


def _read_meta(out_dir: str, meta_name: str):
    try:
        with open(os.path.join(out_dir, meta_name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _next_generation(out_dir: str, meta_name: str) -> int:
    """Generation of a re-export into ``out_dir``: one past the current
    meta's; where the meta exists but is unreadable, one past the highest
    ``.g{N}`` suffix among the program files (a backup of the lost meta may
    refer to them); 0 for a fresh directory."""
    meta = _read_meta(out_dir, meta_name)
    if meta is not None:
        return int(meta.get("generation", 0)) + 1
    if not os.path.exists(os.path.join(out_dir, meta_name)):
        return 0
    max_gen = 0
    for name in os.listdir(out_dir):
        m = re.search(r"\.g(\d+)\.pt2(\.tmp)?$", name)
        if m:
            max_gen = max(max_gen, int(m.group(1)))
    return max_gen + 1


def _write_atomic(path: str, blob: bytes):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _write_meta_atomic(path: str, info: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(info, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def _prune_programs(out_dir: str, prefixes, keep):
    """Remove the program files (and write residue) of earlier exports that
    the meta just written does not list: they may hold other weights."""
    for name in os.listdir(out_dir):
        if name in keep:
            continue
        if (any(name.startswith(p) for p in prefixes)
                and (name.endswith(_EXT) or name.endswith(_EXT + ".tmp"))):
            os.remove(os.path.join(out_dir, name))


def _serialize(program) -> bytes:
    # the example inputs are not needed to run the program, and would be
    # saved with it: the zero carry alone is 0.67 GB (int8c) to 1.3 GB
    # (bf16) at B=384
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def _output_values(program):
    """The fake values of an exported program's outputs, in its output
    pytree (shapes and dtypes, without running it)."""
    out = next(n for n in program.graph.nodes if n.op == "output")
    vals = [n.meta["val"] for n in out.args[0]]
    return pytree.tree_unflatten(vals, program.call_spec.out_spec)


def _spec(t) -> dict:
    return {"shape": list(t.shape), "dtype": str(t.dtype).split(".")[-1]}


class _Boot(nn.Module):
    def __init__(self, raw):
        super().__init__()
        self.raw = raw

    def forward(self, scan):
        return self.raw(None, scan)


class _Step(nn.Module):
    def __init__(self, raw):
        super().__init__()
        self.raw = raw

    def forward(self, carry, scan):
        return self.raw(carry, scan)


class _Fn(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(*inputs)


def _shape_of(spec) -> tuple:
    return tuple(spec.shape) if hasattr(spec, "shape") else tuple(spec)


def export_serving_engine(out_dir: str, step, example_scan,
                          meta: dict | None = None) -> str:
    """Write a built serving step (``make_serve_step_v3``) as an artifact
    for the scan batch shape(s) of ``example_scan``. Returns ``out_dir``.

    ``example_scan``: a ``(B, num_pts)`` tensor or shape (only the shape is
    read), or a LIST of them for one boot/step pair per batch size. The
    programs are traced on ``step.device`` under ``torch.no_grad``: no
    kernel runs and no launch is counted (the carry's shapes come from the
    traced boot program).
    """
    raw, device = step.raw_step, torch.device(step.device)
    specs = (list(example_scan) if isinstance(example_scan, list)
             else [example_scan])
    shapes = [_shape_of(s) for s in specs]
    if any(len(s) != 2 for s in shapes):
        raise ValueError(f"scan shapes must be (B, num_pts), got {shapes}")
    batches = [int(s[0]) for s in shapes]
    if len(set(batches)) != len(batches):
        raise ValueError(f"duplicate batch sizes in export: {batches}")
    if len({s[1] for s in shapes}) != 1:
        raise ValueError("all exported batches must share num_pts")

    single = len(shapes) == 1
    # serialize every program BEFORE touching the output directory, so a
    # failed re-export leaves an earlier artifact as it was
    blobs = {}
    with torch.no_grad():
        for shape, b in zip(shapes, batches):
            scan = torch.zeros(shape, dtype=torch.float32, device=device)
            boot = torch.export.export(_Boot(raw), (scan,))
            carry = pytree.tree_map(
                lambda v: torch.zeros(v.shape, dtype=v.dtype, device=device),
                _output_values(boot)[0])
            stepped = torch.export.export(_Step(raw), (carry, scan))
            blobs[b] = (_serialize(boot), _serialize(stepped))

    os.makedirs(out_dir, exist_ok=True)
    gen = _next_generation(out_dir, _META)
    suffix = f".g{gen}" if gen else ""

    def names(b):
        if single and not gen:
            return _BOOT, _STEP
        if single:
            return f"boot{suffix}{_EXT}", f"step{suffix}{_EXT}"
        return f"boot_b{b}{suffix}{_EXT}", f"step_b{b}{suffix}{_EXT}"

    files = {}
    for b, (boot_blob, step_blob) in blobs.items():
        boot_name, step_name = names(b)
        _write_atomic(os.path.join(out_dir, boot_name), boot_blob)
        _write_atomic(os.path.join(out_dir, step_name), step_blob)
        files[str(b)] = [boot_name, step_name]

    # the caller's extras first, the computed facts last: the load-time
    # checks key on these
    info = dict(meta or {})
    info.update({
        "batch": batches[0] if single else None,
        "batches": sorted(batches),
        "files": files,
        "generation": gen,
        "num_pts": int(shapes[0][1]),
        "platforms": [device.type],
        "precision": step.precision,
        "torch_version": torch.__version__,
        "schema_version": SCHEMA_VERSION,
    })
    _write_meta_atomic(os.path.join(out_dir, _META), info)
    _prune_programs(out_dir, ("boot", "step"),
                    {n for pair in files.values() for n in pair})
    return out_dir


def export_model(out_dir: str, fn, example_inputs, meta: dict | None = None
                 ) -> str:
    """Write a stateless ``fn(*inputs) -> outputs`` (an ``nn.Module`` in
    eval mode, or a function closing over its weights) as an artifact, the
    batch-inference counterpart of :func:`export_serving_engine` for the
    stateless models (the flow U-Net, the box regressor, the ``drow`` and
    fc detectors). Returns ``out_dir``.

    ``example_inputs``: a tuple of tensors (one program) or a LIST of such
    tuples (one ``model_b{B}.pt2`` each, routed at load on the first
    input's batch); the programs run on the inputs' device. Writes
    ``model.json`` with each program's input and output shapes.
    """
    sigs = (list(example_inputs) if isinstance(example_inputs, list)
            else [tuple(example_inputs)])
    batches = [int(sig[0].shape[0]) for sig in sigs]
    if len(set(batches)) != len(batches):
        raise ValueError(f"duplicate batch sizes in export: {batches}")
    module = fn if isinstance(fn, nn.Module) else _Fn(fn)
    device = sigs[0][0].device

    blobs, input_shapes, output_shapes = {}, {}, {}
    with torch.no_grad():
        for sig, b in zip(sigs, batches):
            program = torch.export.export(module, tuple(sig))
            blobs[b] = _serialize(program)
            input_shapes[str(b)] = [_spec(t) for t in sig]
            output_shapes[str(b)] = [
                _spec(v) for v in pytree.tree_leaves(_output_values(program))]

    os.makedirs(out_dir, exist_ok=True)
    gen = _next_generation(out_dir, _MODEL_META)
    suffix = f".g{gen}" if gen else ""
    files = {}
    for b, blob in blobs.items():
        name = f"model_b{b}{suffix}{_EXT}"
        _write_atomic(os.path.join(out_dir, name), blob)
        files[str(b)] = name

    info = dict(meta or {})
    info.update({
        "batches": sorted(batches),
        "files": files,
        "generation": gen,
        "input_shapes": input_shapes,
        "output_shapes": output_shapes,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "schema_version": SCHEMA_VERSION,
    })
    _write_meta_atomic(os.path.join(out_dir, _MODEL_META), info)
    _prune_programs(out_dir, ("model_b",), set(files.values()))
    return out_dir


def _load_meta(path: str, meta_name: str, program_names) -> tuple:
    """Read and check an artifact's meta -> (meta, the device its programs
    run on)."""
    with open(os.path.join(path, meta_name)) as f:
        meta = json.load(f)
    _check_schema(path, meta)
    if "jax_version" in meta or any(
            n.endswith(".bin") for n in program_names(meta)):
        raise ValueError(
            f"artifact {path} was written by the JAX package "
            f"(jax_version {meta.get('jax_version')!r}, .bin programs); "
            "this package loads torch.export artifacts — re-export it with "
            "planar_optical_flow_tpu_torch.cli.export_serving or "
            "cli.export_model")
    platforms = [p.lower() for p in meta.get("platforms") or ["cpu"]]
    if "cuda" in platforms:
        if not torch.cuda.is_available():
            raise ValueError(
                f"artifact {path} was exported for platform(s) {platforms} "
                "but this host has no CUDA card "
                "(torch.cuda.is_available() is False); it does not run on "
                "the CPU — re-export it with --cpu for a CPU host")
        return meta, torch.device("cuda")
    if platforms != ["cpu"]:
        raise ValueError(
            f"artifact {path} was exported for platform(s) {platforms}; "
            "this package runs 'cuda' and 'cpu' artifacts")
    return meta, torch.device("cpu")


def _load_program(path: str, name: str):
    return torch.export.load(os.path.join(path, name)).module()


class ModelEngine:
    """A loaded stateless-model artifact, called like the exported
    function: ``engine(*inputs)``, routed on the first input's batch.
    Inputs may be tensors or arrays; they are moved to ``engine.device``.
    ``engine.meta`` holds the metadata."""

    def __init__(self, programs: dict, meta: dict, device):
        self._programs = programs
        self.meta = meta
        self.device = torch.device(device)

    def __call__(self, *inputs):
        b = int(np.shape(inputs[0])[0])
        if b not in self._programs:
            raise ValueError(
                f"no exported program for batch {b}; this artifact holds "
                f"batches {sorted(self._programs)} (re-export with the "
                "batch you need, see cli.export_model --batch)")
        sig = self.meta.get("input_shapes", {}).get(str(b))
        if sig is not None:
            if len(inputs) != len(sig):
                raise ValueError(
                    f"this artifact's program takes {len(sig)} input(s), "
                    f"got {len(inputs)}")
            for i, (x, s) in enumerate(zip(inputs, sig)):
                if list(np.shape(x)) != list(s["shape"]):
                    raise ValueError(
                        f"input {i} has shape {list(np.shape(x))} but the "
                        f"artifact was exported for {s['shape']} "
                        "(re-export with the shapes you need, see "
                        "cli.export_model)")
                got = (str(x.dtype).split(".")[-1] if torch.is_tensor(x)
                       else str(np.asarray(x).dtype))
                if got != s["dtype"]:
                    raise ValueError(
                        f"input {i} has dtype {got} but the artifact was "
                        f"exported for {s['dtype']}")
        inputs = [torch.as_tensor(x, device=self.device) for x in inputs]
        with torch.inference_mode():
            return self._programs[b](*inputs)


def load_model(path: str) -> ModelEngine:
    """Load a directory written by :func:`export_model`."""
    meta, device = _load_meta(
        path, _MODEL_META, lambda m: (m.get("files") or {}).values())
    files = meta.get("files") or {}
    programs = {int(b): _load_program(path, files.get(str(b),
                                                      f"model_b{b}{_EXT}"))
                for b in meta["batches"]}
    return ModelEngine(programs, meta, device)


class ServingEngine:
    """A loaded serving artifact, with the live step's contract:
    ``engine(carry, scan) -> (carry', outputs)``, ``carry=None`` to
    bootstrap a stream; routed on the scan's batch. ``engine.meta`` holds
    the metadata, ``engine.device`` the device its programs run on."""

    def __init__(self, programs: dict, meta: dict, device):
        self._programs = programs
        self.meta = meta
        self.device = torch.device(device)

    @property
    def batches(self) -> list:
        """The batch sizes this artifact holds programs for."""
        return sorted(self._programs)

    def __call__(self, carry, scan):
        scan = torch.as_tensor(scan, dtype=torch.float32, device=self.device)
        b = scan.shape[0]
        if b not in self._programs:
            raise ValueError(
                f"no exported program for batch {b}; this artifact holds "
                f"batches {self.batches} (re-export with the "
                "batch you need, see cli.export_serving --batch)")
        boot, step = self._programs[b]
        with torch.inference_mode():
            return boot(scan) if carry is None else step(carry, scan)


def _serving_files(meta) -> list:
    return [n for pair in (meta.get("files") or {}).values() for n in pair]


def load_serving_engine(path: str) -> ServingEngine:
    """Load an engine directory written by :func:`export_serving_engine`.

    An int8 artifact first runs the known-answer check of the int8 kernels'
    tap rows (K16, ``conv_stack.check_row_shift``) on its device, once per
    device and process, as the step builder does."""
    meta, device = _load_meta(path, _META, _serving_files)
    if meta.get("precision") in ("int8", "int8c"):
        from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
            check_row_shift,
        )

        check_row_shift(device)
    batches = meta.get("batches") or [meta["batch"]]
    files = meta.get("files") or {}

    def names(b):
        if str(b) in files:
            return files[str(b)]
        if len(batches) == 1:
            return _BOOT, _STEP
        return f"boot_b{b}{_EXT}", f"step_b{b}{_EXT}"

    programs = {int(b): tuple(_load_program(path, n) for n in names(b))
                for b in batches}
    return ServingEngine(programs, meta, device)
