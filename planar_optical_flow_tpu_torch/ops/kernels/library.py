"""The serving kernels as ``torch.library`` custom ops (namespace
``pof_torch``), so that ``torch.export`` records each launch as one opaque
node of the graph and a saved program runs the same hand-written kernels
after loading.

Every kernel that ``infer.streaming.make_serve_step_v3`` can launch is one
op: K1 ``cutout``, K2 ``backbone_bf16`` (and ``backbone_tail``, its JAX
interface on act1), K3 ``gate``, K4 ``head``, K5 ``backbone_int8``, K6
``gate_int8``, K7 ``head_int8``, K8 ``backbone_int8_cut``, K9
``backbone_int8_pm``, K10 ``backbone_int8_tail``, K12 ``gate_head_int8``,
K13 ``serve_cell_int8``, and K16 ``row_shift`` (run at the build and at
loading, never in a graph). So are the kernels of no exported step: K14
``fused_backbone`` and ``fused_head`` (``make_fused_stream_step``) and K15
``banded_mix_update``. Each op has

* a CUDA kernel: the module's ``_cuda_*`` function, which checks its
  tensors, builds the ``ctypes`` arguments (the weight pointer arrays
  included, on every call: no device address lives in a graph or an
  artifact), launches and adds one to the public wrapper's ``launches``;
  it launches or raises, never runs the plain version;
* a CPU kernel: the plain version, as the wrappers chose it for a CPU
  tensor;
* a fake kernel: the exact output shapes and dtypes, for tracing.

The public wrappers (``cutout_kernel.cutout``, ``conv_stack.*``,
``fast_gate.gate*``, ``serve_cell.serve_cell_int8``) keep their signatures
and call ``torch.ops.pof_torch.*`` on both devices. The schemas take only
tensors, tensor lists, ints, floats, bools and optionals: the laid-out
weights (``conv_stack.Int8Laid``, ``Bf16Laid``, ``serve_cell.CellEmbed``)
cross as flat tensor lists (:func:`int8_stack`, :func:`bf16_stack`) that the
kernels rebuild; an empty ``laid`` list means the caller passed the plain
triples or pairs, which the CUDA kernel lays out in the call. Every op
allocates its outputs; none writes into an input.

Importing this module registers the ops; every wrapper module imports it,
and so does ``infer.export`` before it loads a program.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor

NAMESPACE = "pof_torch"
# the ops, by the wrapper that calls each
OPS = ("cutout", "backbone_bf16", "backbone_tail", "gate", "head",
       "backbone_int8", "backbone_int8_pm", "backbone_int8_cut",
       "backbone_int8_tail", "gate_int8", "head_int8", "gate_head_int8",
       "serve_cell_int8", "row_shift", "fused_backbone", "fused_head",
       "banded_mix_update")
EMBED_DIM = 128
FEAT_CHANNELS = 256


def _cs():
    from planar_optical_flow_tpu_torch.ops.kernels import conv_stack
    return conv_stack


def _ck():
    from planar_optical_flow_tpu_torch.ops.kernels import cutout_kernel
    return cutout_kernel


def _fg():
    from planar_optical_flow_tpu_torch.infer import fast_gate
    return fast_gate


def _sc():
    from planar_optical_flow_tpu_torch.ops.kernels import serve_cell
    return serve_cell


def _fd():
    from planar_optical_flow_tpu_torch.ops.kernels import fused_drow
    return fused_drow


# ------------------------------------------------- flat lists and back


def flat(groups) -> list:
    """``((a, b, ...), ...)`` -> ``[a, b, ..., ...]``."""
    return [t for group in groups for t in group]


def groups(tensors, size: int) -> tuple:
    """:func:`flat`'s inverse for groups of ``size``."""
    return tuple(tuple(tensors[i:i + size])
                 for i in range(0, len(tensors), size))


def int8_stack(weights):
    """An int8 stack (``conv_stack.Int8Laid`` or the ``(w, s_eff, b_eff)``
    triples) -> (the triples flat, the laid-out triples flat or ``[]``)."""
    laid = getattr(weights, "laid", None)
    convs = weights.convs if laid is not None else weights
    return flat(convs), flat(laid) if laid is not None else []


def bf16_stack(weights):
    """A bf16 stack (``conv_stack.Bf16Laid`` or the ``(w, b)`` pairs) ->
    (the pairs flat, the laid-out ``w`` list or ``[]``)."""
    laid = getattr(weights, "laid", None)
    convs = weights.convs if laid is not None else weights
    return flat(convs), list(laid) if laid is not None else []


def _int8_weights(convs, laid):
    """The CUDA kernels' form of an int8 stack: the ``Int8Laid`` rebuilt,
    or the triples (laid out in the call)."""
    triples = groups(convs, 3)
    if not laid:
        return triples
    return _cs().Int8Laid(triples, groups(laid, 3))


def _bf16_weights(convs, laid):
    pairs = groups(convs, 2)
    if not laid:
        return pairs
    return _cs().Bf16Laid(pairs, tuple(laid))


def _op(name, fake):
    """Register ``pof_torch::<name>`` with the decorated function as its
    CUDA kernel and ``fake`` as its fake kernel; the CPU kernel is
    registered by the caller."""
    def wrap(fn):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", fn,
                                     mutates_args=(), device_types="cuda")
        op.register_fake(fake)
        return op
    return wrap


def _empty(like, *shape, dtype):
    return like.new_empty(shape, dtype=dtype)


def _feats_fake(inp, rows, l, dtype=torch.int8):
    return (_empty(inp, rows * (l // 4), FEAT_CHANNELS, dtype=dtype),
            _empty(inp, rows, EMBED_DIM, dtype=torch.bfloat16))


def _gate_fake(zx, template, window):
    n = template.shape[0]
    return (torch.empty_like(template, memory_format=torch.contiguous_format),
            _empty(zx, n, EMBED_DIM, dtype=zx.dtype),
            _empty(zx, n, window, dtype=torch.float32))


def _head_fake(inp, rows, num_classes):
    return (_empty(inp, rows, num_classes, dtype=torch.float32),
            _empty(inp, rows, 2, dtype=torch.float32))


# ------------------------------------------------------------------ K1


def _cutout_kw(num_cutout_pts, window_width, window_depth, padding_val,
               centered, area_mode, angle_inc, p_valid):
    return dict(num_cutout_pts=num_cutout_pts, window_width=window_width,
                window_depth=window_depth, padding_val=padding_val,
                centered=centered, area_mode=area_mode, angle_inc=angle_inc,
                p_valid=p_valid)


def _cutout_fake(scans, num_cutout_pts, *args):
    return _empty(scans, scans.shape[0] * scans.shape[1], num_cutout_pts,
                  dtype=torch.float32)


@_op("cutout", _cutout_fake)
def cutout(scans: Tensor, num_cutout_pts: int, window_width: float,
           window_depth: float, padding_val: float, centered: bool,
           area_mode: bool, angle_inc: float,
           p_valid: Optional[int]) -> Tensor:
    return _ck()._cuda_cutout(scans, **_cutout_kw(
        num_cutout_pts, window_width, window_depth, padding_val, centered,
        area_mode, angle_inc, p_valid))


@cutout.register_kernel("cpu")
def _(scans, num_cutout_pts, window_width, window_depth, padding_val,
      centered, area_mode, angle_inc, p_valid):
    return _ck().cutout_plain(scans, **_cutout_kw(
        num_cutout_pts, window_width, window_depth, padding_val, centered,
        area_mode, angle_inc, p_valid))


# ------------------------------------------------------------- K2, K4


def _backbone_bf16_fake(cutouts, layer1, convs, laid, embed, l):
    return _feats_fake(cutouts, cutouts.shape[0], l, torch.bfloat16)


@_op("backbone_bf16", _backbone_bf16_fake)
def backbone_bf16(cutouts: Tensor, layer1: list[Tensor], convs: list[Tensor],
                  laid: list[Tensor], embed: list[Tensor],
                  l: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_bf16(cutouts, tuple(layer1),
                                     _bf16_weights(convs, laid), tuple(embed),
                                     l=l)


@backbone_bf16.register_kernel("cpu")
def _(cutouts, layer1, convs, laid, embed, l):
    return _cs().backbone_bf16_plain(cutouts, tuple(layer1), groups(convs, 2),
                                     tuple(embed), l=l)


def _backbone_tail_fake(act1, convs, laid, embed, l):
    return _feats_fake(act1, act1.shape[0] // l, l, torch.bfloat16)


@_op("backbone_tail", _backbone_tail_fake)
def backbone_tail(act1: Tensor, convs: list[Tensor], laid: list[Tensor],
                  embed: list[Tensor], l: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_tail(act1, _bf16_weights(convs, laid),
                                     tuple(embed), l=l)


@backbone_tail.register_kernel("cpu")
def _(act1, convs, laid, embed, l):
    return _cs().backbone_tail_plain(act1, groups(convs, 2), tuple(embed),
                                     l=l)


def _head_bf16_fake(feats, convs, laid, head_weights, num_classes, l4):
    return _head_fake(feats, feats.shape[0] // l4, num_classes)


@_op("head", _head_bf16_fake)
def head(feats: Tensor, convs: list[Tensor], laid: list[Tensor],
         head_weights: list[Tensor], num_classes: int,
         l4: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_head(feats, _bf16_weights(convs, laid),
                            tuple(head_weights), num_classes=num_classes,
                            l4=l4)


@head.register_kernel("cpu")
def _(feats, convs, laid, head_weights, num_classes, l4):
    return _cs().head_plain(feats, groups(convs, 2), tuple(head_weights),
                            l4=l4)


# ------------------------------------------------- K5, K8, K9, K10


def _backbone_int8_fake(cutouts, layer1, convs, laid, embed, l, *args):
    return _feats_fake(cutouts, cutouts.shape[0], l)


@_op("backbone_int8", _backbone_int8_fake)
def backbone_int8(cutouts: Tensor, layer1: list[Tensor], convs: list[Tensor],
                  laid: list[Tensor], embed: list[Tensor],
                  l: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_int8(cutouts, tuple(layer1),
                                     _int8_weights(convs, laid), tuple(embed),
                                     l=l)


@backbone_int8.register_kernel("cpu")
def _(cutouts, layer1, convs, laid, embed, l):
    return _cs().backbone_int8_plain(cutouts, tuple(layer1), groups(convs, 3),
                                     tuple(embed), l=l)


@_op("backbone_int8_pm", _backbone_int8_fake)
def backbone_int8_pm(cutouts: Tensor, layer1: list[Tensor],
                     convs: list[Tensor], laid: list[Tensor],
                     embed: list[Tensor], l: int,
                     in_scale: float) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_int8_pm(
        cutouts, tuple(layer1), _int8_weights(convs, laid), tuple(embed),
        l=l, in_scale=in_scale)


@backbone_int8_pm.register_kernel("cpu")
def _(cutouts, layer1, convs, laid, embed, l, in_scale):
    return _cs().backbone_int8_pm_plain(cutouts, tuple(layer1),
                                        groups(convs, 3), tuple(embed), l=l,
                                        in_scale=in_scale)


def _backbone_int8_cut_fake(scans, layer1, convs, laid, embed,
                            num_cutout_pts, *args):
    return _feats_fake(scans, scans.shape[0] * scans.shape[1],
                       num_cutout_pts)


@_op("backbone_int8_cut", _backbone_int8_cut_fake)
def backbone_int8_cut(scans: Tensor, layer1: list[Tensor],
                      convs: list[Tensor], laid: list[Tensor],
                      embed: list[Tensor], num_cutout_pts: int,
                      window_width: float, window_depth: float,
                      padding_val: float, centered: bool, area_mode: bool,
                      angle_inc: float,
                      p_valid: Optional[int]) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_int8_cut(
        scans, tuple(layer1), _int8_weights(convs, laid), tuple(embed),
        **_cutout_kw(num_cutout_pts, window_width, window_depth, padding_val,
                     centered, area_mode, angle_inc, p_valid))


@backbone_int8_cut.register_kernel("cpu")
def _(scans, layer1, convs, laid, embed, num_cutout_pts, window_width,
      window_depth, padding_val, centered, area_mode, angle_inc, p_valid):
    return _cs().backbone_int8_cut_plain(
        scans, tuple(layer1), groups(convs, 3), tuple(embed),
        **_cutout_kw(num_cutout_pts, window_width, window_depth, padding_val,
                     centered, area_mode, angle_inc, p_valid))


def _feats_dtype(bf16_feats):
    return torch.bfloat16 if bf16_feats else torch.int8


def _backbone_int8_tail_fake(act1, convs, laid, embed, l, bf16_feats):
    return _feats_fake(act1, act1.shape[0] // l, l, _feats_dtype(bf16_feats))


@_op("backbone_int8_tail", _backbone_int8_tail_fake)
def backbone_int8_tail(act1: Tensor, convs: list[Tensor],
                       laid: list[Tensor], embed: list[Tensor], l: int,
                       bf16_feats: bool) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_backbone_int8_tail(
        act1, _int8_weights(convs, laid), tuple(embed), l=l,
        out_dtype=_feats_dtype(bf16_feats))


@backbone_int8_tail.register_kernel("cpu")
def _(act1, convs, laid, embed, l, bf16_feats):
    return _cs().backbone_int8_tail_plain(act1, groups(convs, 3),
                                          tuple(embed), l=l,
                                          out_dtype=_feats_dtype(bf16_feats))


# ------------------------------------------------------------ K3, K6


def _gate_op_fake(zx, zt, x, template, ct, alpha, window_size, *args):
    return _gate_fake(zx, template, window_size)


@_op("gate", _gate_op_fake)
def gate(zx: Tensor, zt: Tensor, x: Tensor, template: Tensor, ct: int,
         alpha: float, window_size: int,
         ct_valid: Optional[int]) -> tuple[Tensor, Tensor, Tensor]:
    return _fg()._cuda_gate(zx, zt, x, template, ct=ct, alpha=alpha,
                            window_size=window_size, ct_valid=ct_valid)


@gate.register_kernel("cpu")
def _(zx, zt, x, template, ct, alpha, window_size, ct_valid):
    return _fg().gate_plain(zx, zt, x, template, ct=ct, alpha=alpha,
                            window_size=window_size, ct_valid=ct_valid)


def _int8_gate_kw(ct, alpha, window_size, s_x, s_t, s_out, ct_valid):
    return dict(ct=ct, alpha=alpha, window_size=window_size, s_x=s_x,
                s_t=s_t, s_out=s_out, ct_valid=ct_valid)


@_op("gate_int8", _gate_op_fake)
def gate_int8(zx: Tensor, zt: Tensor, x: Tensor, template: Tensor, ct: int,
              alpha: float, window_size: int, s_x: float, s_t: float,
              s_out: float,
              ct_valid: Optional[int]) -> tuple[Tensor, Tensor, Tensor]:
    return _fg()._cuda_gate_int8(zx, zt, x, template, **_int8_gate_kw(
        ct, alpha, window_size, s_x, s_t, s_out, ct_valid))


@gate_int8.register_kernel("cpu")
def _(zx, zt, x, template, ct, alpha, window_size, s_x, s_t, s_out,
      ct_valid):
    return _fg().gate_int8_plain(zx, zt, x, template, **_int8_gate_kw(
        ct, alpha, window_size, s_x, s_t, s_out, ct_valid))


# ---------------------------------------------------------- K7, K12


def _head_int8_fake(template, convs, laid, head_weights, num_classes, l4):
    return _head_fake(template, template.shape[0] // l4, num_classes)


@_op("head_int8", _head_int8_fake)
def head_int8(template: Tensor, convs: list[Tensor], laid: list[Tensor],
              head_weights: list[Tensor], num_classes: int,
              l4: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_head_int8(template, _int8_weights(convs, laid),
                                 tuple(head_weights),
                                 num_classes=num_classes, l4=l4)


@head_int8.register_kernel("cpu")
def _(template, convs, laid, head_weights, num_classes, l4):
    return _cs().head_int8_plain(template, groups(convs, 3),
                                 tuple(head_weights), l4=l4)


def _gate_head_int8_fake(zx, zt, x, template, head_convs, head_laid,
                         head_weights, ct, alpha, window_size, s_x, s_t,
                         s_out, num_classes, l4, ct_valid):
    return (*_gate_fake(zx, template, window_size),
            *_head_fake(zx, template.shape[0], num_classes))


@_op("gate_head_int8", _gate_head_int8_fake)
def gate_head_int8(zx: Tensor, zt: Tensor, x: Tensor, template: Tensor,
                   head_convs: list[Tensor], head_laid: list[Tensor],
                   head_weights: list[Tensor], ct: int, alpha: float,
                   window_size: int, s_x: float, s_t: float, s_out: float,
                   num_classes: int, l4: int, ct_valid: Optional[int]
                   ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return _fg()._cuda_gate_head_int8(
        zx, zt, x, template, _int8_weights(head_convs, head_laid),
        tuple(head_weights), num_classes=num_classes, l4=l4,
        **_int8_gate_kw(ct, alpha, window_size, s_x, s_t, s_out, ct_valid))


@gate_head_int8.register_kernel("cpu")
def _(zx, zt, x, template, head_convs, head_laid, head_weights, ct, alpha,
      window_size, s_x, s_t, s_out, num_classes, l4, ct_valid):
    return _fg().gate_head_int8_plain(
        zx, zt, x, template, groups(head_convs, 3), tuple(head_weights),
        num_classes=num_classes, l4=l4,
        **_int8_gate_kw(ct, alpha, window_size, s_x, s_t, s_out, ct_valid))


# ------------------------------------------------------------------ K13


def _cell_kw(l, ct, alpha, window_size, in_scale, s_x, s_t, s_out,
             num_classes, ct_valid):
    return dict(l=l, ct=ct, alpha=alpha, window_size=window_size,
                in_scale=in_scale, s_x=s_x, s_t=s_t, s_out=s_out,
                num_classes=num_classes, ct_valid=ct_valid)


def _serve_cell_fake(cutouts, zt, template, layer1, convs, laid, embed,
                     embed_laid, head_convs, head_laid, head_weights, l, ct,
                     alpha, window_size, in_scale, s_x, s_t, s_out,
                     num_classes, ct_valid):
    n = cutouts.shape[0]
    return (torch.empty_like(template,
                             memory_format=torch.contiguous_format),
            _empty(cutouts, n, EMBED_DIM, dtype=torch.bfloat16),
            _empty(cutouts, n, window_size, dtype=torch.float32),
            *_head_fake(cutouts, n, num_classes))


@_op("serve_cell_int8", _serve_cell_fake)
def serve_cell_int8(cutouts: Tensor, zt: Tensor, template: Tensor,
                    layer1: list[Tensor], convs: list[Tensor],
                    laid: list[Tensor], embed: list[Tensor],
                    embed_laid: list[Tensor], head_convs: list[Tensor],
                    head_laid: list[Tensor], head_weights: list[Tensor],
                    l: int, ct: int, alpha: float, window_size: int,
                    in_scale: float, s_x: float, s_t: float, s_out: float,
                    num_classes: int, ct_valid: Optional[int]
                    ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    sc = _sc()
    embed_w = (sc.CellEmbed(tuple(embed), embed_laid[0]) if embed_laid
               else tuple(embed))
    return sc._cuda_serve_cell_int8(
        cutouts, zt, template, tuple(layer1), _int8_weights(convs, laid),
        embed_w, _int8_weights(head_convs, head_laid), tuple(head_weights),
        **_cell_kw(l, ct, alpha, window_size, in_scale, s_x, s_t, s_out,
                   num_classes, ct_valid))


@serve_cell_int8.register_kernel("cpu")
def _(cutouts, zt, template, layer1, convs, laid, embed, embed_laid,
      head_convs, head_laid, head_weights, l, ct, alpha, window_size,
      in_scale, s_x, s_t, s_out, num_classes, ct_valid):
    return _sc().serve_cell_int8_plain(
        cutouts, zt, template, tuple(layer1), groups(convs, 3), tuple(embed),
        groups(head_convs, 3), tuple(head_weights),
        **_cell_kw(l, ct, alpha, window_size, in_scale, s_x, s_t, s_out,
                   num_classes, ct_valid))


# ------------------------------------------------------------------ K16


def _row_shift_fake(x, l):
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(x, memory_format=torch.contiguous_format))


@_op("row_shift", _row_shift_fake)
def row_shift(x: Tensor, l: int) -> tuple[Tensor, Tensor]:
    return _cs()._cuda_row_shift(x, l=l)


@row_shift.register_kernel("cpu")
def _(x, l):
    return _cs().row_shift_plain(x, l=l)


# ------------------------------------------------------------- K14, K15


def _compute_dtype(bf16):
    return torch.bfloat16 if bf16 else torch.float32


def _fused_weights(pairs, laid, bf16):
    """K14's weights: ``fused_drow.LaidWeights`` rebuilt, or the pairs
    (laid out in the call)."""
    pairs = groups(pairs, 2)
    if not laid:
        return pairs
    return _fd().LaidWeights(pairs, tuple(laid), _compute_dtype(bf16))


def _fused_backbone_fake(cutouts, pairs, laid, bf16):
    n, l = cutouts.shape
    return cutouts.new_empty((n, l // 4, FEAT_CHANNELS))


@_op("fused_backbone", _fused_backbone_fake)
def fused_backbone(cutouts: Tensor, pairs: list[Tensor], laid: list[Tensor],
                   bf16: bool) -> Tensor:
    return _fd()._cuda_fused_backbone(cutouts,
                                      _fused_weights(pairs, laid, bf16),
                                      compute_dtype=_compute_dtype(bf16))


@fused_backbone.register_kernel("cpu")
def _(cutouts, pairs, laid, bf16):
    return _fd().fused_backbone_plain(cutouts, groups(pairs, 2),
                                      compute_dtype=_compute_dtype(bf16))


def _fused_head_fake(feats, pairs, laid, num_classes, bf16):
    return _head_fake(feats, feats.shape[0], num_classes)


@_op("fused_head", _fused_head_fake)
def fused_head(feats: Tensor, pairs: list[Tensor], laid: list[Tensor],
               num_classes: int, bf16: bool) -> tuple[Tensor, Tensor]:
    return _fd()._cuda_fused_head(feats, _fused_weights(pairs, laid, bf16),
                                  num_classes=num_classes,
                                  compute_dtype=_compute_dtype(bf16))


@fused_head.register_kernel("cpu")
def _(feats, pairs, laid, num_classes, bf16):
    return _fd().fused_head_plain(feats, groups(pairs, 2), num_classes,
                                  compute_dtype=_compute_dtype(bf16))


def _banded_mix_fake(attn, x, template, alpha, window_size):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@_op("banded_mix_update", _banded_mix_fake)
def banded_mix_update(attn: Tensor, x: Tensor, template: Tensor,
                      alpha: float, window_size: int) -> Tensor:
    return _fg()._cuda_banded_mix_update(attn, x, template, alpha=alpha,
                                         window_size=window_size)


@banded_mix_update.register_kernel("cpu")
def _(attn, x, template, alpha, window_size):
    return _fg().banded_mix_update_plain(attn, x, template, alpha,
                                         window_size)
