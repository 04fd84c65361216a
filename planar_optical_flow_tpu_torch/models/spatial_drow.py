"""DR-SPAAM: spatial-attention auto-regressive template memory.

Counterpart of ``planar_optical_flow_tpu/models/spatial_drow.py``:

* each cutout's flat feature map ``(L*C)`` is embedded to 128-d (Dense +
  BatchNorm + LeakyReLU),
* pairwise similarity between current-scan and template embeddings
  (``(B, ct, ct)``),
* banded masked softmax over the +-window/2 neighbouring cutouts,
* template update ``alpha * x + (1 - alpha) * attn @ template``,
* the band of similarity values (pre-softmax, edge-clamped) is returned as
  the flow head's feature.

This is the dense path (the JAX ``banded_chunk=0`` default); the serving
engine's banded form lives in ``infer/fast_gate.py``.

``SpatialDrow.forward`` is the training unroll: the template from scan 0,
the gate through scans 1..S-1 (a single scan takes the self-attention
bootstrap), the head on the last template. In train mode the gate's
``embed_bn`` runs on batch statistics twice a step, on x and then on the
template, so its running statistics advance 2(S-1) times a forward, in that
order, as flax's do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import (
    batch_norm,
    leaky_relu,
    linear,
    make_batch_norm,
    make_linear,
)
from planar_optical_flow_tpu_torch.models.drow import (
    DrowBackbone,
    DrowHead,
    encode_cutouts,
)

EMBED_DIM = 128
FEAT_CHANNELS = 256  # DrowBackbone block2 output channels


def neighbor_band(n_cutout: int, window_size: int) -> np.ndarray:
    """Edge-clamped band indices ``(n_cutout, window)``."""
    hw = window_size // 2
    ids = np.arange(n_cutout)[:, None] + np.arange(-hw, hw + 1)[None, :]
    return np.clip(ids, 0, n_cutout - 1)


def band_mask(n_cutout: int, window_size: int) -> np.ndarray:
    """Dense ``(n_cutout, n_cutout)`` 0/1 mask with 1 on the clamped band."""
    mask = np.zeros((n_cutout, n_cutout), dtype=np.float32)
    np.put_along_axis(mask, neighbor_band(n_cutout, window_size), 1.0,
                      axis=1)
    return mask


@functools.lru_cache(maxsize=None)
def band_tensors(n_cutout: int, window_size: int, device: torch.device,
                 dtype: torch.dtype):
    """(band indices ``(n_cutout, window)`` int64, dense 0/1 mask
    ``(n_cutout, n_cutout)`` in ``dtype``) on ``device``, made once per
    argument set: a gate step then copies nothing from the host. Made
    outside inference mode, so any caller may use them."""
    with torch.inference_mode(False):
        band = torch.as_tensor(neighbor_band(n_cutout, window_size),
                               device=device)
        mask = torch.as_tensor(band_mask(n_cutout, window_size), dtype=dtype,
                               device=device)
    return band, mask


class SpatialAttentionGate(nn.Module):
    """One step of the template update on flat ``(B, ct, D)`` features."""

    def __init__(self, d_feat: int, alpha: float = 0.5, window_size: int = 7,
                 *, generator: torch.Generator):
        super().__init__()
        self.alpha = alpha
        self.window_size = window_size
        self.embed = make_linear(d_feat, EMBED_DIM, generator)
        self.embed_bn = make_batch_norm(EMBED_DIM)

    def embedding(self, f: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``(B, ct, D)`` -> leaky-ReLU embedding ``(B, ct, 128)``."""
        b, ct, d = f.shape
        e = batch_norm(linear(f.reshape(b * ct, d), self.embed),
                       self.embed_bn, 1, train)
        return leaky_relu(e).reshape(b, ct, EMBED_DIM)

    def forward(self, x: torch.Tensor, template: torch.Tensor,
                train: bool = False):
        """Returns (new_template ``(B, ct, D)``, sim_band ``(B, ct, window)``)."""
        b, ct, _ = x.shape
        emb_x = self.embedding(x, train)
        emb_t = self.embedding(template, train)
        sim = torch.einsum("bic,bjc->bij", emb_x, emb_t)
        band, mask = band_tensors(ct, self.window_size, x.device, sim.dtype)
        sim_band = torch.gather(sim, 2, band[None].expand(b, -1, -1))
        # the softmax op by op, as jax.nn.softmax (bf16 rounds each step;
        # no gradient through the max, which jax.nn.softmax stops)
        masked = sim - 1e10 * (1.0 - mask)
        e = torch.exp(masked - masked.amax(dim=-1, keepdim=True).detach())
        attn = e / e.sum(dim=-1, keepdim=True) * mask
        attn = attn / torch.clamp(attn.sum(dim=-1, keepdim=True), min=1e-20)
        mixed = torch.einsum("bij,bjd->bid", attn, template)
        return self.alpha * x + (1.0 - self.alpha) * mixed, sim_band


class SpatialDrow(nn.Module):
    """DROW backbone + spatial-attention temporal memory + detection head.

    ``num_cutout_pts`` sets the flat feature width ``D = (pts // 4) * 256``
    the gate embeds (flax infers it at init).
    """

    def __init__(self, alpha: float = 0.5, window_size: int = 7,
                 pedestrian_only: bool = False, num_cutout_pts: int = 48,
                 dropout: float = 0.0, remat: bool = False,
                 *, generator: torch.Generator):
        super().__init__()
        self.alpha = alpha
        self.window_size = window_size
        self.num_cutout_pts = num_cutout_pts
        self.remat = remat
        self.backbone = DrowBackbone(dropout, generator=generator)
        self.gate = SpatialAttentionGate(
            (num_cutout_pts // 4) * FEAT_CHANNELS, alpha, window_size,
            generator=generator)
        self.head = DrowHead(1 if pedestrian_only else 4, dropout,
                             generator=generator)

    def _encode(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        """``(B, ct, S, pts)`` -> ``(S, B, ct, L*C)`` flat features."""
        b, ct, s, p = x.shape
        xt = x.permute(2, 0, 1, 3).reshape(s * b * ct, p, 1)
        f = encode_cutouts(self.backbone, xt, train, rng, self.remat)
        return f.reshape(s, b, ct, f.shape[-2] * f.shape[-1])

    def _head(self, fused_flat: torch.Tensor, train: bool = False,
              rng: torch.Generator | None = None):
        b, ct, d = fused_flat.shape
        cls, reg = self.head(fused_flat.reshape(b * ct, d // FEAT_CHANNELS,
                                                FEAT_CHANNELS), train, rng)
        return cls.reshape(b, ct, -1), reg.reshape(b, ct, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None):
        """``(B, ct, S, pts)`` cutouts -> (cls, reg, sim_band): the template
        starts as scan 0's features and the gate runs through scans
        1..S-1."""
        feats = self._encode(x, train, rng)  # (S, B, ct, D)
        template, sim_band = feats[0], None
        for i in range(1, feats.shape[0]):
            template, sim_band = self.gate(feats[i], template, train)
        if sim_band is None:  # a single scan: self-attention bootstrap
            template, sim_band = self.gate(template, template, train)
        pred_cls, pred_reg = self._head(template, train, rng)
        return pred_cls, pred_reg, sim_band

    def stream_step(self, x: torch.Tensor, template: torch.Tensor | None = None):
        """One scan: ``x (B, ct, pts)`` cutouts, ``template (B, ct, L*C)`` or
        None to bootstrap. Returns (cls, reg, new_template, sim_band)."""
        feats = self._encode(x[:, :, None, :])[0]
        if template is None:
            # bootstrap: the features become the template; the gate only
            # supplies the similarity band
            new_template = feats
            _, sim_band = self.gate(feats, feats)
        else:
            new_template, sim_band = self.gate(feats, template)
        pred_cls, pred_reg = self._head(new_template)
        return pred_cls, pred_reg, new_template, sim_band
