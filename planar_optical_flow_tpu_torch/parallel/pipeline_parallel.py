"""Pipeline parallelism: a GPipe wavefront over a mesh's ``pipe`` group.

Counterpart of ``planar_optical_flow_tpu/parallel/pipeline_parallel.py``.
:func:`pipeline_apply` runs a chain of stage functions, one for each rank
of the ``pipe`` group: microbatches enter stage 0 and travel rank to rank
by ``send``/``recv``, every rank computing its own stage; the schedule is
``M + n - 1`` ticks, rank ``d`` working on microbatch ``t - d`` at tick
``t`` and idle on its bubble ticks.

JAX differentiates its scan of ``ppermute``s; the port writes the backward
wavefront itself (:class:`_Pipeline`, a ``torch.autograd.Function``): each
rank keeps the autograd graph of each of its microbatches, the last stage
starts from the output's gradient, and the activation gradients travel
back rank to rank in reverse tick order. The parameter gradients are
summed over ``pipe`` (and over ``data``, see below), so every rank ends
with the whole gradient, as JAX's replicated parameters get it.

* Activations: the leaves of a stage's output (any pytree, one dtype) are
  packed into one ``(rows, width)`` buffer a microbatch; the first
  microbatch's message is preceded by its structure (one object message a
  call), so stages need not agree on shapes beforehand.
* Output: the last stage's microbatches, broadcast over ``pipe`` (JAX's
  ``psum`` of a one-hot output); under a ``data`` axis gathered over it,
  so every rank returns the whole batch in JAX's row order.
* Stage state (BatchNorm statistics, counters) threads through a stage's
  microbatches in order; bubble ticks do not advance it. The final state
  of stage ``i`` is broadcast from its rank over ``pipe``; over ``data``
  float leaves are averaged and integer leaves take data shard 0's value.
* ``data`` axis: every rank passes the whole batch; the rows of each
  microbatch split over ``data`` (shard ``k`` takes rows ``k * mb/n_data``
  onwards of every microbatch, as JAX's ``shard_map`` does), each data
  shard running its own wavefront. Under this split a train-mode
  BatchNorm's ghost batch is a microbatch's per-shard rows.

The bubble fraction is ``(n - 1) / (M + n - 1)``.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from planar_optical_flow_tpu_torch.parallel import comm

_CTX = threading.local()


def current_shard() -> int:
    """The data shard a pipeline stage runs on (0 outside a pipeline)."""
    return getattr(_CTX, "shard", 0)


@contextlib.contextmanager
def _on_shard(k: int):
    prev = getattr(_CTX, "shard", 0)
    _CTX.shard = k
    try:
        yield
    finally:
        _CTX.shard = prev


def _neighbor(mesh, axis: str, index: int) -> int:
    """The global rank at this rank's coordinates with ``axis`` at
    ``index``."""
    idx = tuple(index if a == axis else mesh.coords[a]
                for a in mesh.axis_names)
    return int(mesh.devices[idx])


def _pack(leaves, rows: int) -> torch.Tensor:
    return torch.cat([l.reshape(rows, -1) for l in leaves], dim=1)


def _unpack(buf: torch.Tensor, rows: int, shapes) -> list:
    out, off = [], 0
    for s in shapes:
        n = math.prod(s)
        out.append(buf[:, off:off + n].reshape((rows,) + tuple(s)))
        off += n
    return out


def _one_dtype(leaves, what: str):
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"pipeline stages must exchange a single dtype, "
                         f"got {dtypes} ({what})")
    return dtypes.pop()


class _Schedule:
    """One call's wavefront on this rank: the forward, then (from
    :class:`_Pipeline`'s backward) the reverse wavefront."""

    def __init__(self, fns, stage_params, stage_state, mesh, axis, data_axis,
                 m, mb_local, n_data):
        self.fns, self.mesh, self.m = fns, mesh, m
        self.n = mesh.axis_size(axis)
        self.d = mesh.axis_index(axis)
        self.mb_local, self.n_data = mb_local, n_data
        self.k = mesh.axis_index(data_axis) if n_data > 1 else 0
        self.multi = mesh.multi_process
        self.pipe_group = mesh.group(axis) if self.multi else None
        self.data_group = (mesh.group(data_axis) if self.multi and n_data > 1
                           else None)
        if self.multi:
            self.prev = _neighbor(mesh, axis, self.d - 1) if self.d else None
            self.next = (_neighbor(mesh, axis, self.d + 1)
                         if self.d < self.n - 1 else None)
            self.stage_rank = [_neighbor(mesh, axis, i)
                               for i in range(self.n)]
            self.shard_rank0 = (_neighbor(mesh, data_axis, 0)
                                if n_data > 1 else None)
        self.stage_params = stage_params
        self.states = list(stage_state)
        # the parameters of every stage, once each, in the same order on
        # every rank
        seen, self.params = set(), []
        for p in stage_params:
            for leaf in pytree.tree_leaves(p):
                if torch.is_tensor(leaf) and leaf.requires_grad \
                        and id(leaf) not in seen:
                    seen.add(id(leaf))
                    self.params.append(leaf)

    # ------------------------------------------------------------ forward

    def forward(self, x_leaves, x_spec):
        m, mbl, k, d, n = self.m, self.mb_local, self.k, self.d, self.n
        xs = [l.reshape((m, self.n_data, mbl) + tuple(l.shape[1:]))[:, k]
              for l in x_leaves]
        self.x_spec, self.x_shapes = x_spec, [tuple(l.shape[1:])
                                              for l in x_leaves]
        self.x_grad = any(l.requires_grad for l in x_leaves)
        self.saved = [None] * m
        outs = []
        state = self.states[d]
        fn, params = self.fns[d], self.stage_params[d]
        in_meta = out_meta = None
        with _on_shard(k):
            for t in range(m + n - 1):
                i = t - d
                if not 0 <= i < m:
                    continue  # a bubble tick: the state does not advance
                if d == 0:
                    ins = [x[i].detach().requires_grad_(x.requires_grad)
                           for x in xs]
                    spec = x_spec
                else:
                    if in_meta is None:
                        got = [None]
                        dist.recv_object_list(got, src=self.prev,
                                              group=self.pipe_group)
                        in_meta = got[0]
                    spec, shapes, dtype = in_meta
                    buf = torch.empty((mbl, sum(math.prod(s) for s in shapes)),
                                      dtype=dtype, device=xs[0].device)
                    dist.recv(buf, src=self.prev, group=self.pipe_group)
                    ins = [l.detach().requires_grad_(l.is_floating_point())
                           for l in _unpack(buf, mbl, shapes)]
                with torch.enable_grad():
                    y, state = fn(params, state,
                                  pytree.tree_unflatten(ins, spec))
                y_leaves, y_spec = pytree.tree_flatten(y)
                dtype = _one_dtype(y_leaves, f"stage {d} output")
                self.saved[i] = (ins, y_leaves)
                if out_meta is None:
                    out_meta = (y_spec, [tuple(l.shape[1:])
                                         for l in y_leaves], dtype)
                packed = _pack([l.detach() for l in y_leaves], mbl)
                if d < n - 1:
                    if i == 0:
                        dist.send_object_list([out_meta], dst=self.next,
                                              group=self.pipe_group)
                    dist.send(packed.contiguous(), dst=self.next,
                              group=self.pipe_group)
                else:
                    outs.append(packed)
        self.out_meta = out_meta
        self.states[d] = state
        return self._assemble_output(outs)

    def _assemble_output(self, outs):
        """The last stage's microbatches -> the whole batch's output leaves
        on every rank (broadcast over pipe, gathered over data)."""
        m, mbl, n = self.m, self.mb_local, self.n
        if self.multi and n > 1:
            meta = [self.out_meta if self.d == n - 1 else None]
            dist.broadcast_object_list(meta, src=self.stage_rank[-1],
                                       group=self.pipe_group)
            self.out_meta = meta[0]
        spec, shapes, dtype = self.out_meta
        width = sum(math.prod(s) for s in shapes)
        if self.d == n - 1:
            buf = torch.stack(outs)                  # (m, mbl, width)
        else:
            buf = torch.empty((m, mbl, width), dtype=dtype,
                              device=self.out_device)
        if self.multi and n > 1:
            dist.broadcast(buf, src=self.stage_rank[-1],
                           group=self.pipe_group)
        if self.data_group is not None:
            parts = [torch.empty_like(buf) for _ in range(self.n_data)]
            dist.all_gather(parts, buf.contiguous(), group=self.data_group)
            buf = torch.stack(parts, dim=1)          # (m, n_data, mbl, w)
        rows = m * self.n_data * mbl
        return spec, _unpack(buf.reshape(rows, width), rows, shapes)

    # ----------------------------------------------------------- backward

    def backward(self, grads):
        """Gradients of the whole-batch output leaves -> (gradients of the
        input leaves or None, of ``self.params``), summed over pipe and
        data."""
        m, mbl, k, d, n = self.m, self.mb_local, self.k, self.d, self.n
        _, out_shapes, dtype = self.out_meta
        acc = [torch.zeros_like(p) for p in self.params]
        index = {id(p): j for j, p in enumerate(self.params)}
        mine = [p for p in self.params if id(p) in {
            id(leaf) for leaf in pytree.tree_leaves(self.stage_params[d])}]
        x_grads = [None] * m
        if d == n - 1:
            gs_all = [g.reshape((m, self.n_data, mbl) + tuple(s))[:, k]
                      for g, s in zip(grads, out_shapes)]
        for t in reversed(range(m + n - 1)):
            i = t - d
            if not 0 <= i < m:
                continue
            ins, y_leaves = self.saved[i]
            self.saved[i] = None
            if d == n - 1:
                g_out = [g[i] for g in gs_all]
            else:
                width = sum(l[0].numel() for l in y_leaves)
                buf = torch.empty((mbl, width), dtype=dtype,
                                  device=y_leaves[0].device)
                dist.recv(buf, src=self.next, group=self.pipe_group)
                g_out = _unpack(buf, mbl, [tuple(l.shape[1:])
                                           for l in y_leaves])
            pairs = [(y, g) for y, g in zip(y_leaves, g_out)
                     if y.requires_grad]
            want = [x for x in ins if x.requires_grad] + mine
            got = (torch.autograd.grad([y for y, _ in pairs],
                                       want, [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and want else [None] * len(want))
            n_in = len(want) - len(mine)
            for p, g in zip(mine, got[n_in:]):
                if g is not None:
                    acc[index[id(p)]] += g
            in_grads = [torch.zeros_like(x) if g is None else g
                        for x, g in zip([x for x in ins if x.requires_grad],
                                        got[:n_in])]
            if d > 0:
                dist.send(_pack(in_grads, mbl).contiguous(), dst=self.prev,
                          group=self.pipe_group)
            elif self.x_grad:
                x_grads[i] = in_grads
        if self.multi:
            comm.all_reduce_(acc, self.pipe_group)
            comm.all_reduce_(acc, self.data_group)
        return self._assemble_x_grads(x_grads), acc

    def _assemble_x_grads(self, x_grads):
        if not self.x_grad:
            return None
        m, mbl = self.m, self.mb_local
        width = sum(math.prod(s) for s in self.x_shapes)
        if self.d == 0:
            buf = torch.stack([_pack(g, mbl) for g in x_grads])
        else:
            buf = torch.empty((m, mbl, width), device=self.out_device)
        if self.multi and self.n > 1:
            dist.broadcast(buf, src=self.stage_rank[0],
                           group=self.pipe_group)
        if self.data_group is not None:
            parts = [torch.empty_like(buf) for _ in range(self.n_data)]
            dist.all_gather(parts, buf.contiguous(), group=self.data_group)
            buf = torch.stack(parts, dim=1)
        rows = m * self.n_data * mbl
        return _unpack(buf.reshape(rows, width), rows, self.x_shapes)

    # ------------------------------------------------------------- states

    def final_states(self):
        """Each stage's final state on every rank: broadcast from the
        stage's rank over pipe, then averaged (floats) or taken from data
        shard 0 (integers) over data."""
        out = []
        for i, state in enumerate(self.states):
            leaves, spec = pytree.tree_flatten(state)
            leaves = [l.detach().clone() if torch.is_tensor(l)
                      else torch.as_tensor(l) for l in leaves]
            if self.multi and self.n > 1:
                for l in leaves:
                    dist.broadcast(l, src=self.stage_rank[i],
                                   group=self.pipe_group)
            if self.data_group is not None:
                floats = [l for l in leaves if l.is_floating_point()]
                ints = [l for l in leaves if not l.is_floating_point()]
                comm.all_reduce_(floats, self.data_group)
                for l in floats:
                    l.div_(self.n_data)
                for l in ints:
                    dist.broadcast(l, src=self.shard_rank0,
                                   group=self.data_group)
            out.append(pytree.tree_unflatten(leaves, spec))
        return tuple(out)


class _Pipeline(torch.autograd.Function):
    """The wavefront as one differentiable call: inputs the input leaves
    and the parameters, outputs the whole batch's output leaves."""

    @staticmethod
    def forward(ctx, sched, x_spec, n_x, *tensors):
        x_leaves = list(tensors[:n_x])
        sched.out_device = x_leaves[0].device
        spec, outs = sched.forward(x_leaves, x_spec)
        ctx.sched, ctx.n_x = sched, n_x
        sched.result_spec = spec
        return tuple(o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        sched = ctx.sched
        grads = [torch.zeros_like(g) if g is None else g for g in grads]
        x_grads, p_grads = sched.backward(grads)
        if x_grads is None:
            x_grads = [None] * ctx.n_x
        return (None, None, None, *x_grads, *p_grads)


def pipeline_apply(stage_fns, stage_params, x, mesh, axis: str = "pipe",
                   n_microbatches: int | None = None, stage_state=None,
                   data_axis: str = "data"):
    """``stage_fns[n-1](p[n-1], ... stage_fns[0](p[0], x))`` as a GPipe
    wavefront over the ``mesh.shape[axis]`` ranks of a multi-process mesh
    (a mesh of one position runs the chain in this process).

    ``stage_fns``: one callable a stage, ``(stage_params[i], activations)
    -> activations`` on pytrees of tensors with a leading microbatch
    dimension. ``stage_params``: one pytree of tensors a stage; the
    tensors that require a gradient get it, summed over the stages that
    use them (both DROW stages take the model's whole parameter dict).
    ``x``: a pytree with leading batch ``B`` (the whole batch, on every
    rank), split into ``n_microbatches`` (default: the pipe size) equal
    microbatches. ``stage_state``: one state pytree a stage; then stage
    ``i`` is ``(params, state, x) -> (y, new_state)`` and the state threads
    through that stage's microbatches in order. Under a ``data_axis`` of
    the mesh the microbatch rows split over it (see the module notes).

    Returns the last stage's output with leading ``B`` on every rank, or
    ``(output, final_states)`` with ``stage_state``."""
    n = mesh.axis_size(axis)
    stage_fns = tuple(stage_fns)
    stage_params = tuple(stage_params)
    if len(stage_fns) != n:
        raise ValueError(
            f"{len(stage_fns)} stages but mesh axis {axis!r} has {n} devices")
    if len(stage_params) != n:
        raise ValueError(f"{len(stage_params)} param trees for {n} stages")
    with_state = stage_state is not None
    if with_state:
        stage_state = tuple(stage_state)
        if len(stage_state) != n:
            raise ValueError(f"{len(stage_state)} state trees for {n} stages")
        fns = stage_fns
    else:
        stage_state = ({},) * n
        fns = tuple((lambda f: lambda p, s, xx: (f(p, xx), s))(f)
                    for f in stage_fns)
    x_leaves, x_spec = pytree.tree_flatten(x)
    batch = x_leaves[0].shape[0]
    m = n if n_microbatches is None else int(n_microbatches)
    if batch % m:
        raise ValueError(f"batch {batch} not divisible by {m} microbatches")
    mb = batch // m
    n_data = mesh.axis_size(data_axis)
    if mb % n_data:
        raise ValueError(
            f"microbatch rows {mb} (batch {batch} / {m} microbatches) not "
            f"divisible by the {data_axis} axis size {n_data}")
    _one_dtype(x_leaves, "the input")
    if mesh.size > 1 and not mesh.multi_process:
        raise ValueError(
            "pipeline_apply across devices runs one process a device: "
            "build the mesh under torch.distributed (see "
            "parallel.initialize_distributed)")
    sched = _Schedule(fns, stage_params, stage_state, mesh, axis, data_axis,
                      m, mb // n_data, n_data)
    outs = _Pipeline.apply(sched, x_spec, len(x_leaves), *x_leaves,
                           *sched.params)
    out = pytree.tree_unflatten(list(outs), sched.result_spec)
    if with_state:
        return out, sched.final_states()
    return out


# ------------------------------------------------------------ the models


def _seed_of(rng) -> int | None:
    if rng is None:
        return None
    if isinstance(rng, int):
        return rng
    from planar_optical_flow_tpu_torch.models.blocks import child_seed

    return child_seed(rng)


def _stage_generator(seed, stage: int, tick, device):
    """Dropout's generator of (stage, microbatch tick, data shard): a
    stage-only key would give every microbatch and shard the same masks."""
    if seed is None:
        return None
    t = int(tick)
    key = ((seed * 1_000_003 + stage) * 1_000_003 + t) * 1_000_003 \
        + current_shard()
    return torch.Generator(device=device).manual_seed(key % (2 ** 63))


def _dropout_of(model) -> float:
    return float(getattr(getattr(model, "backbone", None), "dropout", 0.0))


def drow_pipeline_stages(model, train: bool = False, dropout_rng=None):
    """The DROW detector's forward as two stages, backbone with the sum over
    scans | head, each ``(params, x) -> y`` for :func:`pipeline_apply`;
    returns ``(stage_fns, (params, params))`` with ``params`` the model's
    parameter dict. In train mode BatchNorm normalizes on each
    microbatch's statistics and the running statistics are left as they
    are (JAX discards their update); a dropout model then needs
    ``dropout_rng`` (a ``torch.Generator`` or a seed)."""
    from planar_optical_flow_tpu_torch.models.blocks import (
        frozen_running_stats,
    )

    if train and _dropout_of(model) > 0 and dropout_rng is None:
        raise ValueError(
            "drow_pipeline_stages(train=True) on a dropout-enabled model "
            "requires dropout_rng")
    seed = _seed_of(dropout_rng) if train else None

    def run(fn, i):
        def stage(p, x):
            with frozen_running_stats():
                return fn(x, _stage_generator(seed, i, 0, x.device))
        return stage

    stage_backbone = run(lambda x, g: model.encode_cutouts(x, train, g)
                         .sum(dim=2), 0)
    stage_head = run(lambda f, g: model.fused_head(f, train, g), 1)
    params = dict(model.named_parameters())
    return (stage_backbone, stage_head), (params, params)


def drow_pipeline_train_stages(model, dropout_rng=None):
    """Training stages of the DROW detector with BatchNorm state threaded
    through :func:`pipeline_apply`'s ``stage_state``: ghost-batch BN
    (each microbatch normalizes on its own statistics, the running
    statistics advance once a microbatch in order, as a sequential loop
    over microbatches does). A stage's state is (its statistics, its
    microbatch tick), the tick keying dropout.

    Returns ``(stage_fns, split_params, split_stats, combine)``:
    ``split_params(params) -> (params, params)``, ``split_stats(stats)``
    (the model's name -> statistic dict) -> one state a stage, and
    ``combine(states)`` -> the model's statistics dict."""
    from planar_optical_flow_tpu_torch.train.state import (
        named_stats,
        set_stats,
    )

    if _dropout_of(model) > 0 and dropout_rng is None:
        raise ValueError("drow_pipeline_train_stages on a dropout-enabled "
                         "model requires dropout_rng")
    seed = _seed_of(dropout_rng)

    def stage_backbone(p, state, x):
        stats, t = state
        set_stats(model.backbone, stats)
        g = _stage_generator(seed, 0, t, x.device)
        out = model.encode_cutouts(x, True, g).sum(dim=2)
        return out, (dict(named_stats(model.backbone)), t + 1)

    def stage_head(p, state, fused):
        stats, t = state
        set_stats(model.head, stats)
        g = _stage_generator(seed, 1, t, fused.device)
        out = model.fused_head(fused, True, g)
        return out, (dict(named_stats(model.head)), t + 1)

    def split_params(params):
        return (params, params)

    def split_stats(batch_stats):
        t0 = torch.zeros((), dtype=torch.int32)
        sub = [{n[len(pre):]: v for n, v in batch_stats.items()
                if n.startswith(pre)} for pre in ("backbone.", "head.")]
        return ((sub[0], t0), (sub[1], t0.clone()))

    def combine(states):
        out = {f"backbone.{n}": v for n, v in states[0][0].items()}
        out.update({f"head.{n}": v for n, v in states[1][0].items()})
        return out

    return (stage_backbone, stage_head), split_params, split_stats, combine


def flow_unet_pipeline_stages(model, train: bool = False):
    """The flow U-Net as encoder + correlation | decoder + head for
    :func:`pipeline_apply`; the skip connections cross the stage boundary
    as a pytree activation. Input is the ``(scan1, scan2)`` pair. In train
    mode BatchNorm uses each microbatch's statistics and leaves the
    running statistics as they are."""
    from planar_optical_flow_tpu_torch.models.blocks import (
        frozen_running_stats,
    )

    def stage_encode(p, scans):
        with frozen_running_stats():
            return model.encode(scans[0], scans[1], train)

    def stage_decode(p, enc):
        with frozen_running_stats():
            return model.decode(*enc, train)

    params = dict(model.named_parameters())
    return (stage_encode, stage_decode), (params, params)
