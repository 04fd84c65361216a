"""K3, K6, K12 and K15: the serving spatial-attention gate in band form
(``csrc/gate.cu``, ``csrc/serve_cell.cu``, ``csrc/banded_mix.cu``), and the
gate API of the module-backbone serving step.

* K3 :func:`gate` replaces ``planar_optical_flow_tpu/infer/fast_gate.py``
  ``gate_fused_flat`` (kernel ``_gate_fused_kernel``): bf16 features and
  template, or f32 ones (the kernel computes in the features' dtype). In
  bf16 it runs ``band_mix_kernel`` (``csrc/band_mix.cuh``, K15's kernel
  too): tiles of :func:`band_mix_geometry` rows of one stream, their
  attention computed once, D walked in chunks staged by ``cp.async.bulk``
  and mixed in a register window; its new template equals
  :func:`gate_plain`'s to the bit on the same attention.
* K6 :func:`gate_int8` replaces ``gate_fused_int8_pm`` with
  ``per_stream=True`` (kernel ``_gate_int8_pm_stream_kernel``,
  ``_quantize_attn``, ``_mix_requant``): int8 features and template carry.
  Its blocks take :data:`GATE_ROWS` rows of one stream; the exact int32
  mix runs on the int8 tensor cores with the quantized band as one operand
  and the byte-transposed template rows as the other.
* K12 :func:`gate_head_int8` replaces ``gate_head_fused_int8_pm`` (kernel
  ``_gate_head_int8_pm_stream_kernel``): K6, then the int8 head (K7,
  ``conv_stack.head_int8``) on the fresh template in the same kernel,
  byte-identical to the two. It is K13's gate and head stage alone
  (``csrc/gate_head_wg.cuh``): each block of 16 rows of one stream reads
  its neighbours' carried rows, mixes on the int8 tensor cores and keeps
  its new template in shared memory for the head's wgmma convs.
* K15 :func:`banded_mix_update` replaces ``banded_mix_update`` (kernel
  ``_mix_kernel``): the standalone mix ``alpha * x + (1 - alpha) * sum_o
  attn[i, o] * template[(i + o) mod ct]``. On no serving path, as in JAX.
  It runs K3's bf16 mix kernel on the given attention, the halo rows
  wrapped, equal to :func:`banded_mix_update_plain` to the bit.

The gate API of ``make_serve_step`` (``infer/streaming.py``), as in JAX:
:func:`embed`, :func:`gate_bootstrap`, :func:`gate_step` (K3 through
:func:`gate_fused`, or ``use_pallas=False``: :func:`_band_attention` and
:func:`_banded_mix_xla` in plain torch, in the features' dtype).

Both share the front half, as the JAX kernels share ``_attention_body``
(:func:`_attention` here, ``band_attention`` in the source). The module gate
(``models/spatial_drow.py``) computes a dense ``(ct, ct)`` similarity and
mix although only the +-window/2 band is nonzero; these compute the same
math in band form on flat ``(N, .)`` arrays, ``N = streams * ct``
stream-major:

* ``s[i, o] = leaky(zx[i]) . leaky(zt[i + o])`` for the 2*hw+1 offsets,
* a softmax over the offsets valid in ``[0, ct_valid)`` (f32),
* the z carry ``new_z = alpha * zx + (1 - alpha) * sum_o bf16(attn[o]) *
  zt[i + o]`` (Dense + eval BatchNorm is affine, so it commutes with the
  mix),
* K3: ``new_t = alpha * x + (1 - alpha) * sum_o a[o] * template[i + o]``
  with ``a = bf16(attn)`` (bf16 is the JAX kernel's MXU operand), or the
  f32 ``attn`` in f32 mode, where the z mix takes it too,
* K6: ``q = clip(rint(127 * attn))`` from the f32 attention, the exact
  int32 sum ``m = sum_o q[o] * t[i + o]``, and ``new_t = clip(rint((alpha *
  (s_x * x) + (1 - alpha) * ((s_t / 127) * m)) / s_out))``,
* ``sim`` with the reference's edge-clamped duplicates (an invalid offset
  reads row 0 if ``i + o < 0``, else row ``ct_valid - 1``).

Rows ``>= ct_valid`` have no valid offset: their attention is 0.

Bound on the H100: bytes: per cutout at D=3584, ~22.3 KB for K3 (x and
template read, new_t written, bf16; twice that in f32), ~10.8 KB for K6
(the same in int8) and ~21.5 KB for K15 in bf16. The kernels write their
outputs to fresh buffers instead of over the carry as the TPU kernels do.
K3's bf16 mix and K15 copy a tile's rows whole with ``cp.async.bulk``, so
their wrappers raise on data that is not 16-byte aligned.
"""

from __future__ import annotations

import ctypes

import torch

from planar_optical_flow_tpu_torch.models.blocks import rounded
from planar_optical_flow_tpu_torch.ops.kernels import _build, int8_tiles
from planar_optical_flow_tpu_torch.ops.kernels import library
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    _wg_inputs,
    check_head_int8_weights,
    head_int8_plain,
    head_ptrs,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import div_f32
from planar_optical_flow_tpu_torch.ops.kernels.fold import GateParams

_LEAKY_SLOPE = 0.1
EMBED_DIM = 128

_EMBED_CHUNK = 16384  # rows per product of embed (bounds f32 copies)
# K6's block: GATE_ROWS rows of one stream, the template walked in chunks of
# GATE_COLS columns (csrc/gate.cu kGateRows, kGateCols); the band of a
# 16-row tile is one k32 step of the int8 mma for window <= 17, else two,
# its K window starting gate_halo(window) rows above the tile
GATE_ROWS = 64
GATE_COLS = 128


def gate_halo(window_size: int) -> int:
    """Rows above a 16-row tile where K6's band operand starts."""
    return 8 if window_size // 2 <= 8 else 16


# K3's bf16 mix and K15 (csrc/band_mix.cuh band_mix_kernel): a block takes
# at most MIX_ROWS rows of one stream, each of its 8 warps a run of MIX_RUN
# of them and one of MIX_SLICES slices of 256 bytes (8 a lane) of a staged
# row chunk of MIX_PITCH bytes; the chunks are staged in a ring of 2-3
# stages, after which come the (window, MIX_ROWS) f32 attention and
# MIX_BAR_BYTES of barriers
MIX_RUN = 8
MIX_SLICES = 2
MIX_ROWS = 8 // MIX_SLICES * MIX_RUN
MIX_PITCH = MIX_SLICES * 256
MIX_BAR_BYTES = 64
SM_SMEM_BYTES = 233472  # shared memory of an H100 SM
BLOCK_RESERVED = 1024   # of it, reserved for each resident block


def band_mix_geometry(ct: int, window_size: int):
    """The launch of ``band_mix_kernel`` (``csrc/band_mix.cuh``
    ``band_mix_geometry``): (rows a tile, tiles a stream, ring stages,
    bytes of dynamic shared memory a block). ``ct`` is cut into
    ``ceil(ct / MIX_ROWS)`` tiles as even as they come; three stages where
    two blocks still share an SM, else two."""
    n = -(-ct // MIX_ROWS)
    rows = -(-ct // n)

    def smem(stages):
        return (stages * (2 * MIX_ROWS + window_size - 1) * MIX_PITCH
                + window_size * MIX_ROWS * 4 + MIX_BAR_BYTES)

    stages = 3 if 2 * (smem(3) + BLOCK_RESERVED) <= SM_SMEM_BYTES else 2
    return rows, -(-ct // rows), stages, smem(stages)


def _check_aligned(what, *tensors):
    """The bulk copies of ``band_mix_kernel`` need 16-byte aligned rows."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: tensor data not 16-byte aligned")


__all__ = ["GateParams", "band_mix_geometry", "banded_mix_update",
           "banded_mix_update_plain", "embed", "gate",
           "gate_attention_probe", "gate_bootstrap", "gate_fused",
           "gate_head_int8", "gate_head_int8_plain", "gate_int8",
           "gate_int8_plain", "gate_mix_plain", "gate_plain", "gate_step",
           "int8_mix_plain"]


def _leaky(v):
    return torch.where(v > 0, v, _LEAKY_SLOPE * v)


# ------------------------------------------------------- the gate API


def embed(params: GateParams, x):
    """Pre-activation embedding ``zx = x @ W + b`` with f32 sums, in
    ``x``'s dtype; ``(B, ct, D)`` or flat ``(N, D)``. A plain product (XLA
    in JAX), taken in row chunks of f32 copies."""
    d = x.shape[-1]
    flat = x.reshape(-1, d)
    w, b = params.w.float(), params.b.float()
    z = torch.cat([flat[i:i + _EMBED_CHUNK].float() @ w + b
                   for i in range(0, flat.shape[0], _EMBED_CHUNK)])
    return z.reshape(*x.shape[:-1], -1).to(x.dtype)


def _shift_rows(a, o):
    """``shifted[:, i] = a[:, i + o]``, zero-padded (the JAX
    ``_shift_rows``)."""
    if o == 0:
        return a
    z = torch.zeros_like(a[:, :abs(o)])
    if o > 0:
        return torch.cat([a[:, o:], z], dim=1)
    return torch.cat([z, a[:, :o]], dim=1)


def _band_attention(params: GateParams, zx, zt):
    """Banded logits, masked softmax and the exact similarity band on
    ``(B, ct, 128)`` embeddings, op by op as the JAX ``_band_attention`` in
    the embeddings' dtype (bf16 rounds after every op). Returns (attn
    ``(B, ct, window)`` with zeros at invalid offsets, sim_band with the
    reference's edge-clamped duplicates)."""
    ct = zx.shape[1]
    hw = params.window_size // 2
    slope = rounded(_LEAKY_SLOPE, zx.dtype)
    ex = torch.where(zx > 0, zx, slope * zx)
    et = torch.where(zt > 0, zt, slope * zt)
    s = torch.stack([(ex * _shift_rows(et, o)).sum(-1)
                     for o in range(-hw, hw + 1)], dim=-1)
    i = torch.arange(ct, device=zx.device)[:, None]
    o = torch.arange(-hw, hw + 1, device=zx.device)[None, :]
    valid = (i + o >= 0) & (i + o < ct)
    masked = torch.where(valid, s, rounded(-1e10, s.dtype))
    e = torch.exp(masked - masked.amax(-1, keepdim=True))
    attn = e / e.sum(-1, keepdim=True)
    attn = torch.where(valid, attn, 0.0)
    attn = attn / torch.clamp(attn.sum(-1, keepdim=True),
                              min=rounded(1e-20, s.dtype))
    idx = (torch.clamp(i + o, 0, ct - 1) - i + hw).expand(s.shape)
    return attn, torch.gather(s, -1, idx)


def _banded_mix_xla(attn, template, hw):
    """``mixed[i] = sum_o attn[i, o] * template[i + o]``, zero-padded
    shifted multiply-adds in the template's dtype (the JAX
    ``_banded_mix_xla``)."""
    mixed = None
    for k, o in enumerate(range(-hw, hw + 1)):
        term = attn[..., k:k + 1] * _shift_rows(template, o)
        mixed = term if mixed is None else mixed + term
    return mixed


def gate_fused(zx, zt, x, template, alpha: float, window_size: int,
               d_chunk: int = 896):
    """``(B, ct, D)`` wrapper over :func:`gate` (K3): (new_template, new_z,
    sim_band), each ``(B, ct, .)``. ``d_chunk`` is accepted for API parity
    only."""
    del d_chunk
    b, ct, d = template.shape
    new_t, new_z, sim = gate(
        zx.reshape(b * ct, -1), zt.reshape(b * ct, -1), x.reshape(b * ct, d),
        template.reshape(b * ct, d), ct=ct, alpha=alpha,
        window_size=window_size)
    return (new_t.reshape(b, ct, d), new_z.reshape(b, ct, -1),
            sim.reshape(b, ct, -1))


def gate_step(params: GateParams, x, template, z_t, *,
              use_pallas: bool = True):
    """One gate update on ``(B, ct, D)`` features ``x``, the carried
    ``template`` and its carried pre-activation embedding ``z_t (B, ct,
    128)``: -> (new_template, new_z, sim_band). ``use_pallas``: K3 (bf16
    or f32, the features' dtype); else the banded attention and shifted
    multiply-adds in plain torch."""
    hw = params.window_size // 2
    zx = embed(params, x)
    if use_pallas:
        return gate_fused(zx, z_t, x, template, params.alpha,
                          params.window_size)
    attn, sim_band = _band_attention(params, zx, z_t)
    alpha = rounded(params.alpha, x.dtype)
    beta = rounded(1.0 - params.alpha, x.dtype)
    new_template = alpha * x + beta * _banded_mix_xla(attn, template, hw)
    new_z = alpha * zx + beta * _banded_mix_xla(attn, z_t, hw)
    return new_template, new_z, sim_band


def gate_bootstrap(params: GateParams, x):
    """First scan of a stream: the template is ``x`` and the gate only
    supplies the self-similarity band -> (template, z, sim_band)."""
    zx = embed(params, x)
    _, sim_band = _band_attention(params, zx, zx)
    return x, zx, sim_band


# ------------------------------------------------- the band-form kernels


def _band_rows(ct: int, ct_valid: int, window_size: int, device):
    hw = window_size // 2
    i = torch.arange(ct, device=device)[:, None]
    j = i + torch.arange(-hw, hw + 1, device=device)[None, :]
    valid = (j >= 0) & (j < ct_valid) & (i < ct_valid)
    # an invalid offset reads row 0 below the stream, else row ct_valid-1
    edge = torch.where(j < 0, 0, ct_valid - 1)
    return torch.where(valid, j, edge), valid  # (ct, window) each


def _attention(zx, zt, *, ct: int, ct_valid: int, window_size: int):
    """The shared front half (the JAX ``_attention_body``): -> (attn f32
    ``(b, ct, window)``, raw similarity ``s`` of the same shape, band rows
    ``(ct, window)``)."""
    b = zx.shape[0] // ct
    rows, valid = _band_rows(ct, ct_valid, window_size, zx.device)
    ex = _leaky(zx.float()).reshape(b, ct, 1, -1)
    et = _leaky(zt.float()).reshape(b, ct, -1)
    s = (ex * et[:, rows]).sum(-1)  # (b, ct, window)
    masked = torch.where(valid, s, torch.full_like(s, -1e10))
    e = torch.exp(masked - masked.amax(-1, keepdim=True))
    e = torch.where(valid, e, torch.zeros_like(e))
    attn = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-20)
    return attn, s, rows


def _band_mix(attn, carry, rows, ct):
    """``sum_o attn[..., o] * carry[i + o]`` per stream (f32)."""
    c = carry.float().reshape(attn.shape[0], ct, -1)
    acc = torch.zeros_like(c)
    for k in range(rows.shape[1]):
        acc += attn[..., k:k + 1] * c[:, rows[:, k]]
    return acc


def _new_z(zx, zt, attn_bf, rows, ct, alpha):
    b = attn_bf.shape[0]
    new_z = (alpha * zx.float().reshape(b, ct, -1)
             + (1.0 - alpha) * _band_mix(attn_bf, zt, rows, ct))
    return new_z.reshape(zx.shape[0], -1).to(zx.dtype)


def gate_plain(zx, zt, x, template, *, ct: int, alpha: float,
               window_size: int, ct_valid: int | None = None):
    """Plain PyTorch version of :func:`gate` (same arguments)."""
    ct_valid = ct_valid or ct
    n, d = template.shape
    attn, s, rows = _attention(zx, zt, ct=ct, ct_valid=ct_valid,
                               window_size=window_size)
    attn = attn.to(template.dtype).float()  # the mix operand: bf16 or f32
    b = attn.shape[0]
    new_t = (alpha * x.float().reshape(b, ct, d)
             + (1.0 - alpha) * _band_mix(attn, template, rows, ct))
    return (new_t.reshape(n, d).to(template.dtype),
            _new_z(zx, zt, attn, rows, ct, alpha), s.reshape(n, -1))


def gate_mix_plain(attn, x, template, *, ct: int, ct_valid: int,
                   alpha: float):
    """:func:`gate_plain`'s new template on a given mix operand ``attn
    (B, ct, window)`` (bf16 values, f32 dtype; 0 off the valid band):
    what K3's mix makes of the same attention, to the bit."""
    n, d = template.shape
    rows, _ = _band_rows(ct, ct_valid, attn.shape[-1], attn.device)
    new_t = (alpha * x.float().reshape(attn.shape[0], ct, d)
             + (1.0 - alpha) * _band_mix(attn, template, rows, ct))
    return new_t.reshape(n, d).to(template.dtype)


def gate_attention_probe(zx, zt, *, ct: int, window_size: int,
                         ct_valid: int | None = None):
    """K3's own bf16 mix operand ``(B, ct, window)``, read back through
    :func:`gate` in bf16: with x = 0, alpha = 0 and a template whose row j
    is 1 at column ``j mod window``, ``new_t[i, c]`` is exactly ``a[i, o]``
    for the offset o with ``i + o = c mod window``."""
    n, w, hw = zx.shape[0], window_size, window_size // 2
    rows = torch.arange(n, device=zx.device) % ct
    probe = torch.zeros(n, -(-w // 8) * 8, dtype=torch.bfloat16,
                        device=zx.device)
    probe[torch.arange(n, device=zx.device), rows % w] = 1.0
    out = gate(zx, zt, torch.zeros_like(probe), probe, ct=ct, alpha=0.0,
               window_size=w, ct_valid=ct_valid)[0]
    cols = (rows[:, None] + torch.arange(-hw, hw + 1, device=zx.device)) % w
    return torch.gather(out.float(), 1, cols).reshape(-1, ct, w)


def _check_gate_args(what, zx, zt, x, template, ct, ct_valid, window_size,
                     dtype, d_mult, z_dtype=torch.bfloat16):
    n, d = template.shape
    if n % ct or not 0 < ct_valid <= ct or d % d_mult:
        raise ValueError(f"{what}: N={n} must be a multiple of ct={ct}, "
                         f"0 < ct_valid={ct_valid} <= ct, D={d} % {d_mult} "
                         "== 0")
    if not 1 <= window_size <= 32 or window_size % 2 == 0:
        raise ValueError(f"{what}: window_size={window_size} must be odd, "
                         "<= 32")
    for name, t, shape, dt in (("zx", zx, (n, EMBED_DIM), z_dtype),
                               ("zt", zt, (n, EMBED_DIM), z_dtype),
                               ("x", x, (n, d), dtype),
                               ("template", template, (n, d), dtype)):
        if t.device.type != "cuda" or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{what} {name}: need {dt} {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return n, d, 512 if d % 512 == 0 else d


def gate(zx, zt, x, template, *, ct: int, alpha: float, window_size: int,
         ct_valid: int | None = None):
    """Post-embed gate on flat arrays -> (new_template, new_z, sim).

    ``zx``/``zt``: ``(N, 128)`` pre-activation embeddings of the current
    features and of the template; ``x``/``template``: ``(N, D)``; all bf16,
    or all f32 (K3's f32 mode: f32 attention in both mixes). Returns
    new_template ``(N, D)`` and new_z ``(N, 128)`` in that dtype, sim ``(N,
    window)`` f32. ``ct`` need not be a multiple of 8; ``D`` must be. Runs
    ``pof_torch::gate``: K3 on a CUDA tensor, :func:`gate_plain` on a CPU
    tensor.
    """
    return torch.ops.pof_torch.gate(zx, zt, x, template, ct, float(alpha),
                                    window_size, ct_valid)


def _cuda_gate(zx, zt, x, template, *, ct, alpha, window_size, ct_valid):
    """K3's launch: the CUDA kernel of ``pof_torch::gate``."""
    ct_valid = ct_valid or ct
    dtype = template.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"gate: template must be bf16 or f32, got {dtype}")
    n, d, d_chunk = _check_gate_args("gate", zx, zt, x, template, ct,
                                     ct_valid, window_size, dtype, 8, dtype)
    zx, zt, x, template = (t.contiguous() for t in (zx, zt, x, template))
    _check_aligned("gate", x, template)
    new_t = torch.empty_like(template)
    new_z = torch.empty_like(zx)
    sim = torch.empty(n, window_size, dtype=torch.float32, device=zx.device)
    fn = _build.load("gate").gate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(zx.data_ptr(), zt.data_ptr(), x.data_ptr(),
                    template.data_ptr(), new_t.data_ptr(), new_z.data_ptr(),
                    sim.data_ptr(), n, d, ct, ct_valid, window_size, d_chunk,
                    float(alpha), 1.0 - alpha, int(dtype == torch.float32),
                    _build.stream_ptr(zx.device)), "gate")
    gate.launches += 1
    return new_t, new_z, sim


def gate_int8_plain(zx, zt, x, template, *, ct: int, alpha: float,
                    window_size: int, s_x: float, s_t: float, s_out: float,
                    ct_valid: int | None = None):
    """Plain PyTorch version of :func:`gate_int8` (same arguments)."""
    ct_valid = ct_valid or ct
    attn, s, rows = _attention(zx, zt, ct=ct, ct_valid=ct_valid,
                               window_size=window_size)
    q = torch.clamp(torch.round(attn * 127.0), -127, 127).to(torch.int32)
    new_t = int8_mix_plain(q, x, template, ct=ct, ct_valid=ct_valid,
                           alpha=alpha, s_x=s_x, s_t=s_t, s_out=s_out)
    attn_bf = attn.to(torch.bfloat16).float()
    return (new_t, _new_z(zx, zt, attn_bf, rows, ct, alpha),
            s.reshape(template.shape[0], -1))


def int8_mix_plain(q, x, template, *, ct: int, ct_valid: int, alpha: float,
                   s_x: float, s_t: float, s_out: float):
    """K6's template mix from the quantized attention ``q (B, ct, window)``
    (0 off the valid band): the exact int32 sum ``m = sum_o q[o] * t[i +
    o]`` and ``clip(rint((alpha * (s_x * x) + (1 - alpha) * ((s_t / 127) *
    m)) / s_out))`` -> ``(N, D)`` int8."""
    n, d = template.shape
    b, _, window = q.shape
    rows, _ = _band_rows(ct, ct_valid, window, q.device)
    t = template.reshape(b, ct, d).to(torch.int32)
    mixed = torch.zeros_like(t)
    for k in range(window):
        mixed += q[..., k:k + 1].to(torch.int32) * t[:, rows[:, k]]
    # the JAX constants: Python doubles rounded once to f32; one true f32
    # division by s_out
    new_t = (alpha * (x.reshape(b, ct, d).float() * s_x)
             + (1.0 - alpha) * (mixed.float() * (s_t / 127.0)))
    new_t = torch.clamp(torch.round(div_f32(new_t, s_out)), -127, 127).to(
        torch.int8)
    return new_t.reshape(n, d)


def gate_int8(zx, zt, x, template, *, ct: int, alpha: float,
              window_size: int, s_x: float, s_t: float, s_out: float,
              ct_valid: int | None = None):
    """int8-carry gate on flat arrays -> (new_template, new_z, sim).

    ``zx``/``zt``: ``(N, 128)`` bf16 as for :func:`gate`; ``x``: ``(N, D)``
    int8 features at scale ``s_x``; ``template``: ``(N, D)`` int8 at
    ``s_t``. Returns new_template ``(N, D)`` int8 at ``s_out``, new_z
    ``(N, 128)`` bf16, sim ``(N, window)`` f32. A CUDA tensor launches K6
    (blocks of :data:`GATE_ROWS` rows of one stream walking the template in
    chunks of :data:`GATE_COLS` columns), a CPU tensor
    :func:`gate_int8_plain`, both as the op ``pof_torch::gate_int8``.
    """
    return torch.ops.pof_torch.gate_int8(
        zx, zt, x, template, ct, float(alpha), window_size, float(s_x),
        float(s_t), float(s_out), ct_valid)


def _cuda_gate_int8(zx, zt, x, template, *, ct, alpha, window_size, s_x, s_t,
                    s_out, ct_valid):
    """K6's launch: the CUDA kernel of ``pof_torch::gate_int8``."""
    ct_valid = ct_valid or ct
    n, d, _ = _check_gate_args("gate_int8", zx, zt, x, template, ct,
                               ct_valid, window_size, torch.int8, 16)
    zx, zt, x, template = (t.contiguous() for t in (zx, zt, x, template))
    new_t = torch.empty_like(template)
    new_z = torch.empty_like(zx)
    sim = torch.empty(n, window_size, dtype=torch.float32, device=zx.device)
    fn = _build.load("gate").gate_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    _build.check(fn(zx.data_ptr(), zt.data_ptr(), x.data_ptr(),
                    template.data_ptr(), new_t.data_ptr(), new_z.data_ptr(),
                    sim.data_ptr(), n, d, ct, ct_valid, window_size,
                    float(alpha), 1.0 - alpha, float(s_x), s_t / 127.0,
                    float(s_out), _build.stream_ptr(zx.device)), "gate_int8")
    gate_int8.launches += 1
    return new_t, new_z, sim


def gate_head_int8_plain(zx, zt, x, template, head_conv_weights,
                         head_weights, *, ct: int, alpha: float,
                         window_size: int, s_x: float, s_t: float,
                         s_out: float, num_classes: int, l4: int,
                         ct_valid: int | None = None):
    """Plain PyTorch version of :func:`gate_head_int8` (same arguments):
    :func:`gate_int8_plain`, then ``conv_stack.head_int8_plain``."""
    del num_classes  # the head's weights carry it
    new_t, new_z, sim = gate_int8_plain(
        zx, zt, x, template, ct=ct, alpha=alpha, window_size=window_size,
        s_x=s_x, s_t=s_t, s_out=s_out, ct_valid=ct_valid)
    cls, reg = head_int8_plain(new_t.reshape(-1, 256), head_conv_weights,
                               head_weights, l4=l4)
    return new_t, new_z, sim, cls, reg


def gate_head_int8(zx, zt, x, template, head_conv_weights, head_weights, *,
                   ct: int, alpha: float, window_size: int, s_x: float,
                   s_t: float, s_out: float, num_classes: int, l4: int,
                   ct_valid: int | None = None):
    """:func:`gate_int8`, then the int8 head on its new template ->
    (new_template, new_z, sim, cls ``(N, num_classes)`` f32, reg ``(N, 2)``
    f32).

    Gate arguments as for :func:`gate_int8` (``D = l4 * 256``; ``s_out``
    is the head's input scale); ``head_conv_weights``/``head_weights`` as
    for ``conv_stack.head_int8`` (the triples, laid out on every call, or
    ``conv_stack.head_weights_int8``, laid out once). A CUDA tensor
    launches K12 (blocks of 16 rows of one stream), a CPU tensor
    :func:`gate_head_int8_plain`, both as the op
    ``pof_torch::gate_head_int8``.
    """
    convs, laid = library.int8_stack(head_conv_weights)
    return torch.ops.pof_torch.gate_head_int8(
        zx, zt, x, template, convs, laid, list(head_weights), ct,
        float(alpha), window_size, float(s_x), float(s_t), float(s_out),
        num_classes, l4, ct_valid)


def _cuda_gate_head_int8(zx, zt, x, template, head_conv_weights,
                         head_weights, *, ct, alpha, window_size, s_x, s_t,
                         s_out, num_classes, l4, ct_valid):
    """K12's launch: the CUDA kernel of ``pof_torch::gate_head_int8``."""
    ct_valid = ct_valid or ct
    n, d, _ = _check_gate_args("gate_head_int8", zx, zt, x, template, ct,
                               ct_valid, window_size, torch.int8, 16)
    if d != l4 * 256:
        raise ValueError(f"gate_head_int8: D={d} is not l4 * 256 = "
                         f"{l4 * 256}")
    head_weights = check_head_int8_weights("gate_head_int8",
                                           head_conv_weights, head_weights,
                                           num_classes, l4)
    lib, laid, head = _wg_inputs("gate_head_int8", head_conv_weights, 1,
                                 int8_tiles.gate_head_geometry(l4)[2],
                                 "serve_cell")
    zx, zt, x, template = (t.contiguous() for t in (zx, zt, x, template))
    new_t = torch.empty_like(template)
    new_z = torch.empty_like(zx)
    sim = torch.empty(n, window_size, dtype=torch.float32, device=zx.device)
    cls = torch.empty(n, num_classes, dtype=torch.float32, device=zx.device)
    reg = torch.empty(n, 2, dtype=torch.float32, device=zx.device)
    fn = lib.gate_head_int8_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 \
        + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    _build.check(fn(zx.data_ptr(), zt.data_ptr(), x.data_ptr(),
                    template.data_ptr(), new_t.data_ptr(), new_z.data_ptr(),
                    sim.data_ptr(), head, *head_ptrs(head_weights),
                    cls.data_ptr(), reg.data_ptr(),
                    n, ct, ct_valid, window_size, l4, num_classes,
                    float(alpha), 1.0 - alpha, float(s_x), s_t / 127.0,
                    float(s_out), _build.stream_ptr(zx.device)),
                 "gate_head_int8")
    gate_head_int8.launches += 1
    return new_t, new_z, sim, cls, reg


def banded_mix_update_plain(attn, x, template, alpha: float,
                            window_size: int, d_chunk: int = 896):
    """Plain PyTorch version of :func:`banded_mix_update` (same
    arguments), in the TPU kernel's order: the o = 0 term, then o = -hw ..
    hw, rows rolled circularly within each stream."""
    del d_chunk
    b, ct, d = template.shape
    hw = window_size // 2
    t = template.float()
    a = attn.float().reshape(b, ct, 2 * hw + 1)
    acc = a[..., hw:hw + 1] * t
    for k, o in enumerate(range(-hw, hw + 1)):
        if o:
            acc = acc + a[..., k:k + 1] * torch.roll(t, -o, dims=1)
    return (alpha * x.float() + (1.0 - alpha) * acc).to(x.dtype)


def banded_mix_update(attn, x, template, alpha: float, window_size: int,
                      d_chunk: int = 896):
    """``alpha * x + (1 - alpha) * sum_o attn[i, o] * template[(i + o) mod
    ct]`` in f32, in ``x``'s dtype.

    ``attn``: ``(B, ct, window)``; ``x``, ``template``: ``(B, ct, D)``, bf16
    or f32 (the same). The roll is circular within each stream, as in the
    TPU kernel: equal to the zero-padded band wherever ``attn`` is 0 at the
    offsets that leave the stream. ``d_chunk`` is accepted for API parity
    only. Runs ``pof_torch::banded_mix_update``: K15 on a CUDA tensor,
    :func:`banded_mix_update_plain` on a CPU tensor.
    """
    del d_chunk
    return torch.ops.pof_torch.banded_mix_update(attn, x, template,
                                                 float(alpha), window_size)


def _cuda_banded_mix_update(attn, x, template, *, alpha, window_size):
    """K15's launch: the CUDA kernel of ``pof_torch::banded_mix_update``."""
    b, ct, d = template.shape
    window = window_size // 2 * 2 + 1
    if x.dtype not in (torch.bfloat16, torch.float32) or d % 8:
        raise ValueError(f"banded_mix_update: x/template bf16 or f32 with D "
                         f"% 8 == 0, got {x.dtype} D={d}")
    for name, t, shape, dt in (("x", x, (b, ct, d), x.dtype),
                               ("template", template, (b, ct, d), x.dtype),
                               ("attn", attn, (b, ct, window), attn.dtype)):
        if t.device.type != "cuda" or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"banded_mix_update {name}: need {dt} {shape} on "
                             f"cuda, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    attn = attn.float().contiguous()
    x, template = x.contiguous(), template.contiguous()
    _check_aligned("banded_mix_update", x, template)
    out = torch.empty_like(x)
    fn = _build.load("banded_mix").banded_mix_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]
    _build.check(fn(attn.data_ptr(), x.data_ptr(), template.data_ptr(),
                    out.data_ptr(), b * ct, d, ct, window, float(alpha),
                    1.0 - alpha, int(x.dtype == torch.float32),
                    _build.stream_ptr(x.device)), "banded_mix_update")
    banded_mix_update.launches += 1
    return out


gate.launches = 0
gate_int8.launches = 0
gate_head_int8.launches = 0
banded_mix_update.launches = 0
