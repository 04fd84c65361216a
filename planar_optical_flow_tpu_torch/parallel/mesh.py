"""Meshes, partition rules and multi-process initialization.

Counterpart of ``planar_optical_flow_tpu/parallel/mesh.py``. JAX drives
every device from one process; PyTorch's collective training runs one
process per device. A :class:`Mesh` covers both:

* across processes (``torch.distributed`` initialized; training): the
  mesh's positions are ranks, one device each. Every rank knows its
  coordinates on the named axes (``dcn``, ``data``, ``model``, ``pipe``)
  and holds a process group for each axis and one for (``dcn``, ``data``)
  jointly, over which a batch's rows and the gradient sum span;
* in one process (serving): the positions are local devices; the shards
  of independent streams need no collective.

The mesh's shape is a pure function of the config and a device count
(:func:`mesh_shape`), with JAX's rules: ``dcn`` outermost, one ``-1`` /
``"auto"`` axis absorbing the remaining devices, a ``ValueError`` when the
mesh needs more devices than there are.

:func:`default_partition_rule` gives the leaves JAX's rule splits over a
``model`` axis, matched on the flax names of the port's parameters
(``interop/flax_bridge.py``): the gate ``embed`` dense column-split,
``block3``'s third conv column-split with its bias and BatchNorm vectors,
``block4``'s first conv row-split. A spec is a tuple with one entry a
dimension of the port's tensor (``"model"`` where it is split, else None);
``()`` is replicated.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dcn", "data", "model", "pipe")
REPLICATED = ()


def initialize_distributed(coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device="cuda") -> torch.device:
    """Join the process group of a multi-process run; returns this
    process's device.

    Without arguments it reads ``torch.distributed.run``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) and
    joins even a world of one there. With arguments, as JAX's: a
    ``coordinator`` (``host:port``, or an init URL such as
    ``file:///path``), ``num_processes`` and ``process_id``; one process
    is a no-op. On the card the backend is NCCL and the device
    ``cuda:LOCAL_RANK`` (made current); Gloo and the CPU only when
    ``device`` is ``"cpu"``."""
    launched = "WORLD_SIZE" in os.environ and num_processes is None
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        from planar_optical_flow_tpu_torch import resolve_device

        resolve_device(dev)
        local = int(os.environ.get(
            "LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if dist.is_initialized() or (num_processes <= 1 and not launched):
        return dev
    if coordinator is None:
        init = "env://"
    elif "://" in coordinator:
        init = coordinator
    else:
        init = f"tcp://{coordinator}"
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=num_processes,
                            rank=process_id, **kwargs)
    return dev


def default_devices() -> list:
    """The mesh's positions when none are given: the ranks of the
    initialized process group, else this process's CUDA devices (the
    CPU where there is no card)."""
    if dist.is_available() and dist.is_initialized():
        return list(range(dist.get_world_size()))
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(n)]


def mesh_shape(mesh_cfg, n_devices: int) -> dict:
    """Axis name -> size of ``make_mesh_from_config(mesh_cfg)`` over
    ``n_devices`` devices: ``None``/empty is all ``data``; one axis of -1,
    ``"auto"`` or None takes the remaining devices; ``dcn`` goes first."""
    if not mesh_cfg:
        return {"data": int(n_devices)}
    names, sizes, auto_idx = [], [], None
    for k, v in mesh_cfg.items():
        names.append(str(k))
        if v in (-1, "auto", None):
            if auto_idx is not None:
                raise ValueError("only one mesh axis may be auto")
            auto_idx = len(sizes)
            sizes.append(-1)
        else:
            sizes.append(int(v))
    fixed = int(np.prod([s for s in sizes if s > 0]))
    if auto_idx is not None:
        sizes[auto_idx] = n_devices // max(fixed, 1)
    total = int(np.prod(sizes))
    if total > n_devices or total < 1 or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {n_devices}")
    shape = dict(zip(names, sizes))
    if "dcn" in shape:
        shape = {"dcn": shape.pop("dcn"), **shape}
    return shape


class Mesh:
    """A named grid of positions: ranks across processes, else local
    devices.

    ``shape`` (axis -> size, ordered), ``axis_names``, ``devices`` (the
    positions as an array of that shape), ``size``. Across processes also
    ``rank``, ``coords`` (axis -> this rank's index), ``device`` (this
    rank's device) and :meth:`group`."""

    def __init__(self, positions: np.ndarray, axis_names):
        self.devices = np.asarray(positions, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d positions for axes "
                             f"{self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        flat = list(self.devices.ravel())
        self.multi_process = bool(
            dist.is_available() and dist.is_initialized()
            and all(isinstance(p, (int, np.integer)) for p in flat))
        self._groups = {}
        if not self.multi_process:
            self.rank, self.coords = 0, {a: 0 for a in self.axis_names}
            self.device = (flat[0] if flat and isinstance(flat[0],
                                                          torch.device)
                           else None)
            return
        world = dist.get_world_size()
        if self.size != world or sorted(flat) != list(range(world)):
            raise ValueError(
                f"mesh {self.shape} covers {self.size} of the {world} "
                "ranks: a multi-process mesh spans every rank once")
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)[0]
        self.coords = dict(zip(self.axis_names, (int(i) for i in where)))
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        # every rank makes every group, in the same order
        specs = [(a,) for a in self.axis_names]
        joint = tuple(a for a in ("dcn", "data") if a in self.shape)
        if len(joint) == 2:
            specs.append(joint)
        for axes in specs:
            self._groups[axes] = self._make_groups(axes)

    def _make_groups(self, axes):
        """New groups over ``axes`` jointly, one for each coordinate of the
        other axes; returns this rank's."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(self.devices.ndim) if d not in dims]
        arr = np.transpose(self.devices, rest + dims)
        arr = arr.reshape(-1, int(np.prod([self.devices.shape[d]
                                           for d in dims])))
        mine = None
        for row in arr:
            ranks = [int(r) for r in row]
            g = dist.new_group(ranks)
            if self.rank in ranks:
                mine = g
        return mine

    def __repr__(self):
        kind = "ranks" if self.multi_process else "devices"
        return f"Mesh({self.shape}, {kind})"

    def axis_size(self, axis: str) -> int:
        return int(self.shape.get(axis, 1))

    def axis_index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))

    def group(self, *axes):
        """The process group of this rank over ``axes`` jointly (one axis,
        or ``("dcn", "data")``); None for axes the mesh lacks."""
        axes = tuple(a for a in axes if a in self.shape)
        if not axes or not self.multi_process:
            return None
        return self._groups[axes]

    @property
    def data_axes(self) -> tuple:
        """The axes a batch's rows span: (``dcn``, ``data``) where present."""
        return tuple(a for a in ("dcn", "data") if a in self.shape)

    @property
    def data_extent(self) -> int:
        return int(np.prod([self.shape[a] for a in self.data_axes] or [1]))

    @property
    def data_index(self) -> int:
        """This rank's block of a batch's rows: dcn-major over the data
        axes."""
        idx = 0
        for a in self.data_axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    @property
    def data_group(self):
        return self.group(*self.data_axes)

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(axis_names=("data",), axis_sizes=None, devices=None) -> Mesh:
    """A mesh over ``devices`` (default :func:`default_devices`); with the
    default sizes every position lands on the last axis."""
    devices = list(devices) if devices is not None else default_devices()
    if axis_sizes is None:
        axis_sizes = [1] * (len(axis_names) - 1) + [len(devices)]
        axis_sizes = tuple(axis_sizes[-len(axis_names):])
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(tuple(int(s) for s in axis_sizes)), axis_names)


def _process_of(position) -> int:
    """A position's process: a rank is its own, a local device is this
    process's."""
    if isinstance(position, (int, np.integer)):
        return int(position)
    return dist.get_rank() if dist.is_initialized() else 0


def make_hybrid_mesh(dcn_size: int, ici_axes: dict, devices=None) -> Mesh:
    """A mesh with a ``dcn`` axis outermost and ``ici_axes`` within each
    dcn group (JAX's multi-slice layout). The gradient sum over
    (``dcn``, ``data``) then runs over one joint group. Positions are
    ordered by process; a dcn group holds whole processes, and a mesh
    smaller than the positions takes each group's from its own block."""
    devices = list(devices) if devices is not None else default_devices()
    devices.sort(key=_process_of)
    names = ("dcn",) + tuple(str(k) for k in ici_axes)
    sizes = (int(dcn_size),) + tuple(int(v) for v in ici_axes.values())
    total = int(np.prod(sizes))
    if total > len(devices) or total < 1 or min(sizes) < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} "
                         f"devices, have {len(devices)}")
    per = total // int(dcn_size)
    if total < len(devices) and len(devices) % int(dcn_size) == 0:
        span = len(devices) // int(dcn_size)
        devices = [d for i in range(int(dcn_size))
                   for d in devices[i * span:i * span + per]]
    else:
        devices = devices[:total]
    groups = [{_process_of(d) for d in devices[i * per:(i + 1) * per]}
              for i in range(int(dcn_size))]
    for i in range(len(groups)):
        for j in range(i + 1, len(groups)):
            if groups[i] & groups[j]:
                raise ValueError(
                    f"dcn axis of {dcn_size} splits a process across "
                    f"slices (groups {groups}) — dcn must divide along "
                    "process boundaries")
    arr = np.empty(total, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(sizes), names)


def make_mesh_from_config(mesh_cfg, devices=None) -> Mesh:
    """The mesh of a config mapping such as ``{"data": 4, "model": 2}``
    (:func:`mesh_shape`); a ``dcn`` axis selects :func:`make_hybrid_mesh`."""
    devices = list(devices) if devices is not None else default_devices()
    shape = mesh_shape(mesh_cfg, len(devices))
    if not mesh_cfg:
        return make_mesh(devices=devices)
    if "dcn" in shape:
        ici = {n: s for n, s in shape.items() if n != "dcn"}
        return make_hybrid_mesh(shape["dcn"], ici, devices=devices)
    total = int(np.prod(list(shape.values())))
    return make_mesh(tuple(shape), tuple(shape.values()),
                     devices=devices[:total])


def default_partition_rule(mesh: Mesh):
    """JAX's Megatron-style rule on a ``model`` axis, as ``rule(name,
    tensor) -> spec`` over the port's parameter and statistic names:

    * ``embed`` dense: column-parallel (its output split over ``model``),
    * ``block3`` ``ConvBlock_2`` (256 -> 512): column-parallel, with its
      conv bias and BatchNorm vectors,
    * ``block4`` ``ConvBlock_0`` (512 -> 256): its kernel row-parallel.

    Everything else, and every leaf on a mesh without a ``model`` axis
    larger than 1, is replicated (``()``)."""
    from planar_optical_flow_tpu_torch.interop.flax_bridge import flax_path

    has_model = mesh.axis_size("model") > 1

    def rule(name: str, leaf) -> tuple:
        if not has_model or not hasattr(leaf, "ndim"):
            return REPLICATED
        nset = set(flax_path(name))
        if "embed" in nset:
            if leaf.ndim == 2:   # (out, in) of flax's (in, out)
                return ("model", None)
            if leaf.ndim == 1:
                return ("model",)
        if "block3" in nset and "ConvBlock_2" in nset:
            if leaf.ndim == 3:   # (Cout, Cin, K) of flax's (K, Cin, Cout)
                return ("model", None, None)
            if leaf.ndim == 1:
                return ("model",)
        if "block4" in nset and "ConvBlock_0" in nset and leaf.ndim == 3:
            return (None, "model", None)
        return REPLICATED

    return rule


def state_shardings(mesh: Mesh, state, rule=None) -> dict:
    """Name -> spec for every parameter and running statistic of
    ``state.model`` (the optimizer's moments follow their parameter's)."""
    from planar_optical_flow_tpu_torch.train.state import (
        named_params,
        named_stats,
    )

    rule = rule or default_partition_rule(mesh)
    leaves = {**named_params(state.model), **named_stats(state.model)}
    return {n: rule(n, t) for n, t in leaves.items()}


def split_dim(spec) -> int | None:
    """The dimension a spec splits over ``model``, or None."""
    for d, a in enumerate(spec):
        if a == "model":
            return d
    return None


class BatchSharding:
    """Which rows of a global batch a rank holds: the block ``index`` of
    ``count`` equal blocks, over the mesh's ``axes``."""

    def __init__(self, axes: tuple, index: int, count: int):
        self.axes, self.index, self.count = axes, index, count

    def rows(self, batch_size: int) -> slice:
        if batch_size % self.count:
            raise ValueError(f"batch {batch_size} not divisible by the "
                             f"data-parallel extent {self.count}")
        per = batch_size // self.count
        return slice(self.index * per, (self.index + 1) * per)

    def __repr__(self):
        return (f"BatchSharding(axes={self.axes}, index={self.index}, "
                f"count={self.count})")


def batch_sharding(mesh: Mesh, axis: str = "data") -> BatchSharding:
    """The batch's leading dimension split over ``axis``; on a hybrid mesh
    over (``dcn``, ``axis``) jointly, dcn-major."""
    axes = tuple(a for a in ("dcn", axis) if a in mesh.shape)
    idx, count = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
        count *= mesh.shape[a]
    return BatchSharding(axes, idx, count)


def replicated_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding((), 0, 1)


def _put(batch, device):
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device) for k, v in batch.items()}


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """A global batch dict -> this rank's rows of it on its device (across
    processes), or the list of every position's rows on its device (in one
    process)."""
    if mesh.multi_process:
        rows = batch_sharding(mesh, axis).rows(len(next(iter(
            batch.values()))))
        return _put({k: v[rows] for k, v in batch.items()}, mesh.device)
    n = len(next(iter(batch.values())))
    out = []
    devs = list(mesh.devices.ravel())
    count = mesh.size
    if n % count:
        raise ValueError(f"batch {n} not divisible by the data-parallel "
                         f"extent {count}")
    per = n // count
    for i, d in enumerate(devs):
        out.append(_put({k: v[i * per:(i + 1) * per]
                         for k, v in batch.items()}, d))
    return out


def replicate_batch(batch, mesh: Mesh):
    """The whole batch on this rank's device (across processes), or on
    every position's device (in one process)."""
    if mesh.multi_process:
        return _put(batch, mesh.device)
    return [_put(batch, d) for d in mesh.devices.ravel()]
