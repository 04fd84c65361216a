"""K13: the whole int8 serving cell in one kernel (``csrc/serve_cell_wg.cu``).

Replaces ``planar_optical_flow_tpu/ops/pallas/serve_cell.py``
``serve_cell_int8`` (kernel ``_cell_kernel``): on a carried step, the
backbone of ``conv_stack.backbone_int8_pm`` (K9: layer 1 divided after the
leaky, the int8 tail, the gate embed with zx rounded to bf16), the int8
gate of ``fast_gate.gate_int8`` (K6) and the int8 head of
``conv_stack.head_int8`` (K7), equal to that chain to the bit. The TPU
program holds a whole stream in VMEM; the kernel runs blocks of 16 cutouts
of one stream on the wgmma convs of K9 and K7 and K6's row mix, each block
reading its neighbours' carried embedding and template rows, and keeps the
feats, zx and the new template in shared memory between the stages. Rows
stay cutout-major (the JAX kernel's position-major rows at ``tile == ct``
are a TPU layout device).

The conv weights come as the triples of ``quant.kernel_stack_weights`` or,
laid out once for the kernel's weight ring, as
``conv_stack.backbone_weights_int8``/``head_weights_int8``; the embed as
its ``(W^T, b)`` pair or laid out once by :func:`cell_embed` (a caller
passing the pair and the triples has them laid out on every call).

Bound on the H100: int8 tensor-core operations, K9's ~15.1 M and K7's
~28.9 M per cutout.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from planar_optical_flow_tpu_torch.infer.fast_gate import (
    EMBED_DIM,
    _check_gate_args,
    gate_int8_plain,
)
from planar_optical_flow_tpu_torch.ops.kernels import _build, int8_tiles
from planar_optical_flow_tpu_torch.ops.kernels import library
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    _check_backbone_int8_args,
    backbone_int8_pm_plain,
    check_head_int8_weights,
    check_int8_plans,
    head_int8_plain,
    head_ptrs,
    int8_ptr_array,
    wg_laid,
)

__all__ = ["CellEmbed", "cell_embed", "serve_cell_int8",
           "serve_cell_int8_plain"]


class CellEmbed(NamedTuple):
    """K13's gate embed laid out once (:func:`cell_embed`): the ``(W^T (128,
    D) bf16, b (128,) bf16)`` pair and ``W^T`` in the chunk order the
    kernel reads (``int8_tiles.embed_weights``)."""
    pair: tuple
    laid: torch.Tensor


def cell_embed(embed_weights) -> CellEmbed:
    """Lay K13's gate embed out for the kernel, once per set of weights:
    the step builder holds the result."""
    return CellEmbed(tuple(embed_weights),
                     int8_tiles.embed_weights(embed_weights[0]))


def _embed_pair(embed_weights):
    return (embed_weights.pair if isinstance(embed_weights, CellEmbed)
            else embed_weights)


def serve_cell_int8_plain(cutouts, zt, template, layer1, weights,
                          embed_weights, head_conv_weights, head_weights, *,
                          l: int, ct: int, alpha: float, window_size: int,
                          in_scale: float, s_x: float, s_t: float,
                          s_out: float, num_classes: int,
                          ct_valid: int | None = None):
    """Plain PyTorch version of :func:`serve_cell_int8` (same arguments):
    ``backbone_int8_pm_plain``, ``gate_int8_plain``, ``head_int8_plain``."""
    del num_classes  # the head's weights carry it
    feats, zx = backbone_int8_pm_plain(cutouts, layer1, weights,
                                       _embed_pair(embed_weights), l=l,
                                       in_scale=in_scale)
    new_t, new_z, sim = gate_int8_plain(
        zx, zt, feats.reshape(zx.shape[0], -1), template, ct=ct, alpha=alpha,
        window_size=window_size, s_x=s_x, s_t=s_t, s_out=s_out,
        ct_valid=ct_valid)
    cls, reg = head_int8_plain(new_t.reshape(-1, 256), head_conv_weights,
                               head_weights, l4=l // 4)
    return new_t, new_z, sim, cls, reg


def serve_cell_int8(cutouts, zt, template, layer1, weights, embed_weights,
                    head_conv_weights, head_weights, *, l: int, ct: int,
                    alpha: float, window_size: int, in_scale: float,
                    s_x: float, s_t: float, s_out: float, num_classes: int,
                    ct_valid: int | None = None):
    """One carried step of the int8 cell for the ``N = streams * ct`` rows.

    ``cutouts``: ``(N, l)`` f32 in (stream, cutout) order; ``zt``: ``(N,
    128)`` bf16 and ``template``: ``(N, l/4 * 256)`` int8 at ``s_t``, the
    carry. ``layer1``, ``weights``, ``embed_weights`` and ``in_scale`` as
    for ``conv_stack.backbone_int8_pm`` (feats at ``s_x``; the embed also
    as :func:`cell_embed`); ``head_conv_weights``/``head_weights`` as for
    ``conv_stack.head_int8``;
    the gate's arguments as for ``fast_gate.gate_int8`` (``s_out`` the
    head's input scale). Returns (new_template ``(N, l/4 * 256)`` int8,
    new_z ``(N, 128)`` bf16, sim ``(N, window)`` f32, cls ``(N,
    num_classes)`` f32, reg ``(N, 2)`` f32), in fresh buffers. Runs
    ``pof_torch::serve_cell_int8``: K13 on a CUDA tensor,
    :func:`serve_cell_int8_plain` on a CPU tensor.
    """
    convs, laid = library.int8_stack(weights)
    head_convs, head_laid = library.int8_stack(head_conv_weights)
    embed_laid = ([embed_weights.laid] if isinstance(embed_weights, CellEmbed)
                  else [])
    return torch.ops.pof_torch.serve_cell_int8(
        cutouts, zt, template, list(layer1), convs, laid,
        list(_embed_pair(embed_weights)), embed_laid, head_convs, head_laid,
        list(head_weights), l, ct, float(alpha), window_size,
        float(in_scale), float(s_x), float(s_t), float(s_out), num_classes,
        ct_valid)


def _cuda_serve_cell_int8(cutouts, zt, template, layer1, weights,
                          embed_weights, head_conv_weights, head_weights, *,
                          l, ct, alpha, window_size, in_scale, s_x, s_t,
                          s_out, num_classes, ct_valid):
    """K13's launch: the CUDA kernel of ``pof_torch::serve_cell_int8``."""
    ct_valid = ct_valid or ct
    cutouts, w1, b1, we_t, be = _check_backbone_int8_args(
        "serve_cell_int8", cutouts, layer1, weights,
        _embed_pair(embed_weights), l)
    n = cutouts.shape[0]
    zt, template = zt.contiguous(), template.contiguous()
    # the gate's checks, with the carry standing in for the current rows
    _check_gate_args("serve_cell_int8", zt, zt, template, template, ct,
                     ct_valid, window_size, torch.int8, 16)
    if tuple(template.shape) != (n, l // 4 * 256) or (l // 4 * 256) % 512:
        raise ValueError(f"serve_cell_int8: template {tuple(template.shape)} "
                         f"is not ({n}, {l // 4 * 256}) with l a multiple "
                         "of 8")
    if window_size > int8_tiles.CELL_MAX_WINDOW:
        raise ValueError(f"serve_cell_int8: window_size={window_size} over "
                         f"{int8_tiles.CELL_MAX_WINDOW}")
    head_weights = check_head_int8_weights("serve_cell_int8",
                                           head_conv_weights, head_weights,
                                           num_classes, l // 4)
    smem = int8_tiles.cell_geometry(l)[2]
    if smem > int8_tiles.SMEM_MAX:
        raise ValueError(f"serve_cell_int8: {smem} bytes of shared memory at "
                         f"l={l}, over {int8_tiles.SMEM_MAX}")
    lib = _build.load("serve_cell_wg")
    _check_embed_k(lib)
    check_int8_plans(lib, "serve_cell_int8")
    tail, head = wg_laid(weights, 0), wg_laid(head_conv_weights, 1)
    we_laid = (embed_weights.laid if isinstance(embed_weights, CellEmbed)
               else int8_tiles.embed_weights(we_t))
    if we_laid.device != cutouts.device:
        raise ValueError(f"serve_cell_int8: embed on {we_laid.device}")
    new_t = torch.empty_like(template)
    new_z = torch.empty(n, EMBED_DIM, dtype=torch.bfloat16,
                        device=cutouts.device)
    sim = torch.empty(n, window_size, dtype=torch.float32,
                      device=cutouts.device)
    cls = torch.empty(n, num_classes, dtype=torch.float32,
                      device=cutouts.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=cutouts.device)
    fn = lib.serve_cell_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_float] \
        + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    _build.check(fn(cutouts.data_ptr(), zt.data_ptr(), template.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), float(in_scale),
                    int8_ptr_array(tail), we_laid.data_ptr(), be.data_ptr(),
                    int8_ptr_array(head), *head_ptrs(head_weights),
                    new_t.data_ptr(), new_z.data_ptr(), sim.data_ptr(),
                    cls.data_ptr(), reg.data_ptr(), n, ct, ct_valid,
                    window_size, l, num_classes, float(alpha), 1.0 - alpha,
                    float(s_x), s_t / 127.0, float(s_out),
                    _build.stream_ptr(cutouts.device)), "serve_cell_int8")
    serve_cell_int8.launches += 1
    return new_t, new_z, sim, cls, reg


def _check_embed_k(lib):
    """Raise unless the library's embed chunk is ``int8_tiles.EMBED_K``
    (once per process)."""
    if _check_embed_k.checked:
        return
    lib.cell_embed_k.restype = ctypes.c_int
    lib.cell_embed_k.argtypes = []
    k = lib.cell_embed_k()
    if k != int8_tiles.EMBED_K:
        raise RuntimeError(f"serve_cell_int8: the kernel's embed chunk is "
                           f"{k}, int8_tiles lays out {int8_tiles.EMBED_K}")
    _check_embed_k.checked = True


_check_embed_k.checked = False
serve_cell_int8.launches = 0
