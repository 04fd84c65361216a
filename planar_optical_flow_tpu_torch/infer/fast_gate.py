"""K3: the serving spatial-attention gate in band form (``csrc/gate.cu``).

Replaces ``planar_optical_flow_tpu/infer/fast_gate.py`` ``gate_fused_flat``
(kernel ``_gate_fused_kernel``, shared math ``_attention_body``). The module
gate (``models/spatial_drow.py``) computes a dense ``(ct, ct)`` similarity
and mix although only the +-window/2 band is nonzero; this computes the
same math in band form on flat ``(N, .)`` arrays, ``N = streams * ct``
stream-major:

* ``s[i, o] = leaky(zx[i]) . leaky(zt[i + o])`` for the 2*hw+1 offsets,
* a softmax over the offsets valid in ``[0, ct_valid)``, rounded to bf16
  (the JAX kernel's MXU operand),
* ``new_t = alpha * x + (1 - alpha) * sum_o attn[o] * template[i + o]``,
  and the same mix for the pre-activation embedding carry ``z`` (Dense +
  eval BatchNorm is affine, so it commutes with the mix),
* ``sim`` with the reference's edge-clamped duplicates (an invalid offset
  reads row 0 if ``i + o < 0``, else row ``ct_valid - 1``).

Rows ``>= ct_valid`` have no valid offset: their attention is 0.

Bound on the H100: bytes, ~22.3 KB per cutout at D=3584 (x and template
read, new_t written, bf16). The kernel writes ``new_t``/``new_z`` to fresh
buffers instead of over the carry as the TPU kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from planar_optical_flow_tpu_torch.ops.kernels import _build
from planar_optical_flow_tpu_torch.ops.kernels.fold import GateParams

_LEAKY_SLOPE = 0.1
EMBED_DIM = 128

__all__ = ["GateParams", "gate", "gate_plain"]


def _leaky(v):
    return torch.where(v > 0, v, _LEAKY_SLOPE * v)


def _band_rows(ct: int, ct_valid: int, window_size: int, device):
    hw = window_size // 2
    i = torch.arange(ct, device=device)[:, None]
    j = i + torch.arange(-hw, hw + 1, device=device)[None, :]
    valid = (j >= 0) & (j < ct_valid) & (i < ct_valid)
    # an invalid offset reads row 0 below the stream, else row ct_valid-1
    edge = torch.where(j < 0, 0, ct_valid - 1)
    return torch.where(valid, j, edge), valid  # (ct, window) each


def gate_plain(zx, zt, x, template, *, ct: int, alpha: float,
               window_size: int, ct_valid: int | None = None):
    """Plain PyTorch version of :func:`gate` (same arguments)."""
    ct_valid = ct_valid or ct
    n, d = template.shape
    b = n // ct
    rows, valid = _band_rows(ct, ct_valid, window_size, zx.device)
    ex = _leaky(zx.float()).reshape(b, ct, 1, -1)
    et = _leaky(zt.float()).reshape(b, ct, -1)
    s = (ex * et[:, rows]).sum(-1)  # (b, ct, window)
    masked = torch.where(valid, s, torch.full_like(s, -1e10))
    e = torch.exp(masked - masked.amax(-1, keepdim=True))
    e = torch.where(valid, e, torch.zeros_like(e))
    attn = e / torch.clamp(e.sum(-1, keepdim=True), min=1e-20)
    attn = attn.to(torch.bfloat16).float()

    def mix(carry):
        c = carry.float().reshape(b, ct, -1)
        acc = torch.zeros_like(c)
        for k in range(rows.shape[1]):
            acc += attn[..., k:k + 1] * c[:, rows[:, k]]
        return acc

    new_z = alpha * zx.float().reshape(b, ct, -1) + (1.0 - alpha) * mix(zt)
    new_t = alpha * x.float().reshape(b, ct, d) + (1.0 - alpha) * mix(
        template)
    return (new_t.reshape(n, d).to(template.dtype),
            new_z.reshape(n, -1).to(zx.dtype), s.reshape(n, -1))


def gate(zx, zt, x, template, *, ct: int, alpha: float, window_size: int,
         ct_valid: int | None = None):
    """Post-embed gate on flat arrays -> (new_template, new_z, sim).

    ``zx``/``zt``: ``(N, 128)`` bf16 pre-activation embeddings of the
    current features and of the template; ``x``/``template``: ``(N, D)``
    bf16. Returns new_template ``(N, D)`` bf16, new_z ``(N, 128)`` bf16,
    sim ``(N, window)`` f32. A CUDA tensor launches K3; a CPU tensor runs
    :func:`gate_plain`.
    """
    kw = dict(ct=ct, alpha=alpha, window_size=window_size, ct_valid=ct_valid)
    if zx.device.type == "cpu":
        return gate_plain(zx, zt, x, template, **kw)
    ct_valid = ct_valid or ct
    n, d = template.shape
    if n % ct or not 0 < ct_valid <= ct or d % 8:
        raise ValueError(f"gate: N={n} must be a multiple of ct={ct}, "
                         f"0 < ct_valid={ct_valid} <= ct, D={d} % 8 == 0")
    if not 1 <= window_size <= 32 or window_size % 2 == 0:
        raise ValueError(f"gate: window_size={window_size} must be odd, "
                         "<= 32")
    for name, t, shape in (("zx", zx, (n, EMBED_DIM)),
                           ("zt", zt, (n, EMBED_DIM)), ("x", x, (n, d)),
                           ("template", template, (n, d))):
        if (t.device.type != "cuda" or t.dtype != torch.bfloat16
                or tuple(t.shape) != shape):
            raise ValueError(f"gate {name}: need bf16 {shape} on cuda, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    zx, zt, x, template = (t.contiguous() for t in (zx, zt, x, template))
    d_chunk = 512 if d % 512 == 0 else d
    new_t = torch.empty_like(template)
    new_z = torch.empty_like(zx)
    sim = torch.empty(n, window_size, dtype=torch.float32, device=zx.device)
    fn = _build.load("gate").gate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_float, ctypes.c_void_p]
    _build.check(fn(zx.data_ptr(), zt.data_ptr(), x.data_ptr(),
                    template.data_ptr(), new_t.data_ptr(), new_z.data_ptr(),
                    sim.data_ptr(), n, d, ct, ct_valid, window_size, d_chunk,
                    float(alpha), _build.stream_ptr(zx.device)), "gate")
    gate.launches += 1
    return new_t, new_z, sim


gate.launches = 0
