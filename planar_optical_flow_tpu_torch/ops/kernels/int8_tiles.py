"""Host side of the wgmma convs (``csrc/wgmma_conv.cuh``) of K5/K9/K10 and
K7 (int8), of K4, K2 and K14's bf16 backbone (bf16) and of K14 in f32
(split bf16, ``csrc/fused_f32.cu``): the weights' layout for the wgmma B
operand and the launch geometry of the packed tile.

* **Weights.** Each conv's ``w (Cout, 3*Cin)`` (int8 from ``quant.
  kernel_stack_weights``; bf16, the transpose of ``fold``'s ``(3*Cin,
  Cout)``) is cut into chunks of ``NS = 64 * nj * wgn`` output channels x
  ``KC`` elements of K (:func:`chunk_k`), ordered ``[pass][chunk]``, and
  each chunk is laid out in the order a no-swizzle K-major wgmma descriptor
  reads: ``[16-byte K block][8-channel group][8 rows][16 bytes]`` (16 int8
  or 8 bf16 of K a core-matrix row), so the kernel's threads copy a chunk
  into a ring stage as one contiguous run (:func:`wgmma_weights`).
* **Packed tile.** A block keeps ``tile`` cutouts back to back, cutout c's
  position p in row ``c * S + 1 + p`` with ``S = row_stride(L)``, ``L + 1``
  rounded up to even (one or two zero rows after each cutout; row 0 zero).
  A conv's A row ``m = c * S + p`` reads rows ``m``, ``m + 1``, ``m + 2``;
  a max-pool pair is rows ``m`` (even) and ``m + 1``. 64-row wgmma tiles
  cover ``tile * S`` rows; the tile is stored channel-block major (16
  channels of every row, then the next 16), so that any 8 rows of a block
  are one core matrix of the wgmma A operand and a tap is a start row.
* **Geometry.** A block takes the most cutouts (16, halved while needed)
  whose ring, two tile regions and side buffers fit the 232,448 bytes of
  shared memory a block may use (:func:`backbone_geometry`,
  :func:`head_geometry`, :func:`head_bf16_geometry`,
  :func:`backbone_bf16_geometry`; the C side, ``int8_wg_geometry``,
  ``head_bf16_geometry`` and ``backbone_bf16_geometry``, computes the
  same). A bf16 tile takes twice the bytes: K4 takes 8 cutouts a block at
  L/4 = 14, the bf16 backbone (``csrc/backbone_bf16.cu``) 8 at L = 56.
* **K13.** One block of the cell (``csrc/serve_cell_wg.cu``) runs K9's
  backbone, the gate embed, K6's mix and K7's head on 16 cutouts of one
  stream, in two regions that each hold the largest packed tile of either
  stack, the head's f32 rows, the feats rows of the embed's 16-row tile at
  ``cell_pitch`` and the gate's staged template (:func:`cell_geometry`;
  the C side, ``cell_geometry``). Each warp reads its columns of the
  embed's ``W^T (128, D)`` from L2 in chunks of ``EMBED_K`` columns of K,
  each ``[8-element K block][column][8 elements]``: the bf16 wgmma layout
  of ``nj = 2`` (:func:`embed_weights`).
* **K12 and K8.** K12 (``csrc/serve_cell.cu``) is K13's gate and head
  stage alone, on 16 rows of one stream: the same regions without the
  backbone's tiles (:func:`gate_head_geometry`; the C side,
  ``gate_head_geometry``). K8 (``csrc/conv_stack_int8.cu``) is K5's block
  with K1's cutouts in front, 16 beams of one stream: K5's shared memory
  and the stream's scan, prefix sums and half-window angles
  (:func:`cut_geometry`; the C side, ``backbone_int8_cut_geometry``).
* **K14 f32.** Each f32 weight ``w`` is held as two bf16 values, ``hi =
  bf16(w)`` and ``lo = bf16(w - hi)``; each conv's ``(Cout, 3*Cin)`` hi and
  lo are laid out as the bf16 weights are, in chunks of :func:`chunk_k_x3`,
  and interleaved chunk by chunk, the hi part, then the lo part
  (:func:`plan_weights_f32`): the bytes of the f32 weights. The kernel's
  tiles are pairs of bf16 tiles (hi, then lo) and tight: a channel block
  holds the ``tile * S + 2`` rows with data, and the rows a 64-row tile
  reads past them are a spill of the last block (:func:`tight_tile_bytes`).
  At most 4 cutouts a block (:func:`fused_backbone_f32_geometry`,
  :func:`fused_head_f32_geometry`; the C side, ``fused_f32_geometry``).

``BACKBONE_PLAN``, ``HEAD_PLAN``, ``HEAD_BF16_PLAN`` and
``BACKBONE_BF16_PLAN`` are the kernels' conv plans: ``(Cin, Cout, row
tiles, n64 tiles)`` per warp group, and for the bf16 kernels a fifth entry,
the warp groups along N (2: both warp groups share the row tiles and split
N), as ``int8_wg.cuh``'s ``BbPlan*``/``HdPlan*``, ``head_bf16.cu``'s
``HbPlan*`` and ``backbone_bf16.cu``'s ``BfPlan*`` instantiate them
(``int8_wg_plan``, ``head_bf16_plan`` and ``backbone_bf16_plan`` report
them; ``conv_stack`` compares once per process).
``FUSED_BACKBONE_F32_PLAN`` and ``FUSED_HEAD_F32_PLAN`` are K14 f32's, as
``fused_f32.cu``'s ``BxPlan*``/``HxPlan*`` (``fused_f32_plan``), in the
same five-entry form.
"""

from __future__ import annotations

import torch

WG_TILE = 16            # most cutouts a block
STAGE_BYTES = 16384     # one weight chunk
STAGES = 4              # chunks in the ring
SMEM_MAX = 232448       # dynamic shared memory a block may use (H100)
# the weight ring and a conv's s_eff/b_eff (2 x 512 f32)
RING_BYTES = STAGES * STAGE_BYTES + 2 * 512 * 4
BACKBONE_PLAN = ((64, 64, 4, 1), (64, 128, 2, 2), (128, 128, 2, 2),
                 (128, 128, 2, 2), (128, 256, 2, 2))
HEAD_PLAN = ((256, 256, 2, 2), (256, 256, 2, 2), (256, 512, 2, 2),
             (512, 256, 1, 4), (256, 128, 1, 2))
HEAD_BF16_PLAN = ((256, 256, 1, 4, 1), (256, 256, 1, 4, 1),
                  (256, 512, 1, 4, 1), (512, 256, 1, 2, 2),
                  (256, 128, 1, 1, 2))
BACKBONE_BF16_PLAN = ((64, 64, 4, 1, 1), (64, 128, 2, 2, 1),
                      (128, 128, 2, 2, 1), (128, 128, 2, 2, 1),
                      (128, 256, 2, 2, 1))
F32_TILE = 4            # most cutouts a K14 f32 block
FUSED_BACKBONE_F32_PLAN = ((64, 64, 2, 1, 1), (64, 128, 2, 1, 1),
                           (128, 128, 1, 2, 1), (128, 128, 1, 2, 1),
                           (128, 256, 1, 2, 1))
FUSED_HEAD_F32_PLAN = ((256, 256, 1, 2, 2), (256, 256, 1, 2, 2),
                       (256, 512, 1, 2, 2), (512, 256, 1, 2, 2),
                       (256, 128, 1, 1, 2))
_L1_READ = 2  # the backbones' l1_mode that reads act1 rows (no cutouts)
EMBED_K = 64  # K of a K13 embed weight chunk: 128 x 64 bf16
CELL_ROWS = 16  # the rows of K13's mix tile (mma.m16n8k32) and embed tile
CELL_MAX_WINDOW = 32  # the quantized band's lanes a row (one warp)


def row_stride(l: int) -> int:
    """Rows a cutout of ``l`` positions takes in the packed tile."""
    return (l + 2) & ~1


def m_tiles(l: int, tile: int) -> int:
    """64-row wgmma tiles over the packed rows of ``tile`` cutouts."""
    return -(-tile * row_stride(l) // 64)


def ptile_bytes(l: int, c: int, tile: int) -> int:
    """Bytes of a packed tile of rows of ``c`` bytes: every row its 64-row
    tiles read."""
    return (m_tiles(l, tile) * 64 + 2) * c


def chunk_k(k: int, ns: int, esize: int = 1) -> int:
    """K elements (of ``esize`` bytes) a weight chunk of ``ns`` output
    channels holds: the largest multiple of 32 bytes dividing ``k`` with
    ``ns * kc`` elements within a stage."""
    step = 32 // esize
    return max(kc for kc in range(step, k + 1, step)
               if k % kc == 0 and (ns * kc * esize <= STAGE_BYTES
                                   or kc == step))


def _round128(x: int) -> int:
    return -(-x // 128) * 128


def backbone_smem_bytes(l: int, l1_mode: int, tile: int) -> int:
    """Dynamic shared memory of a K5/K9/K10 block of ``tile`` cutouts: the
    ring, two regions each holding the largest packed tile or the int8
    feats rows, and the f32 cutouts (not for K10)."""
    region = _round128(max(ptile_bytes(l, 64, tile),
                           ptile_bytes(l // 2, 128, tile),
                           tile * (l // 4) * 256))
    cut = tile * l * 4 if l1_mode != _L1_READ else 0
    return RING_BYTES + 2 * region + cut


def head_smem_bytes(l4: int, tile: int) -> int:
    """Dynamic shared memory of a K7 block of ``tile`` cutouts: the ring,
    two regions each holding the largest packed tile or the last conv's
    f32 rows, and the means."""
    region = _round128(max(ptile_bytes(l4, 256, tile),
                           ptile_bytes(l4 // 2, 512, tile),
                           tile * (l4 // 2) * 128 * 4))
    return RING_BYTES + 2 * region + tile * 128 * 4


def head_bf16_smem_bytes(l4: int, tile: int) -> int:
    """Dynamic shared memory of a K4 block of ``tile`` cutouts: the ring,
    two regions each holding the largest bf16 packed tile or the last
    conv's f32 rows, and the means."""
    region = _round128(max(ptile_bytes(l4, 256 * 2, tile),
                           ptile_bytes(l4 // 2, 512 * 2, tile),
                           tile * (l4 // 2) * 128 * 4))
    return RING_BYTES + 2 * region + tile * 128 * 4


def backbone_bf16_smem_bytes(l: int, l1_mode: int, tile: int) -> int:
    """Dynamic shared memory of a bf16 backbone block (K2, K14 bf16) of
    ``tile`` cutouts: the ring, two regions each holding the larger bf16
    packed tile of its two lengths (``l`` and ``l/2`` positions; the last
    conv writes device memory), and the f32 cutouts (not in the read mode,
    ``l1_mode`` 2)."""
    region = _round128(max(ptile_bytes(l, 64 * 2, tile),
                           ptile_bytes(l // 2, 128 * 2, tile)))
    cut = tile * l * 4 if l1_mode != _L1_READ else 0
    return RING_BYTES + 2 * region + cut


def cell_pitch(l4: int) -> int:
    """Bytes from one cutout's int8 feats rows (``l4 x 256``) to the next in
    K12's and K13's shared memory: 16 more than the rows, so that the rows
    of an mma fragment fall in different banks."""
    return l4 * 256 + 16


def _gate_tb_bytes(kt: int) -> int:
    """Bytes of K13's staged template chunk at ``kt`` k32 steps of the band:
    ``8 kt`` row quads of ``512 / kt`` columns and 8 words."""
    return 8 * kt * (512 // kt + 8) * 4


def cell_smem_bytes(l: int, tile: int) -> int:
    """Dynamic shared memory of a K13 block of ``tile`` cutouts: the ring,
    two regions each holding the largest packed tile of the backbone and
    the head, the head's f32 rows, the pitched feats rows and the staged
    template, then the means, zx, the quantized band and the f32
    cutouts."""
    l4 = l // 4
    region = _round128(max(ptile_bytes(l, 64, tile),
                           ptile_bytes(l // 2, 128, tile),
                           ptile_bytes(l4, 256, tile),
                           ptile_bytes(l4 // 2, 512, tile),
                           tile * (l4 // 2) * 128 * 4,
                           CELL_ROWS * cell_pitch(l4), _gate_tb_bytes(2)))
    return (RING_BYTES + 2 * region + tile * 128 * (4 + 2)
            + CELL_ROWS * CELL_MAX_WINDOW * 4 + tile * l * 4)


def tight_rows(l: int, tile: int) -> int:
    """Rows a channel block of a K14 f32 tile holds: ``tile`` cutouts, their
    zero rows and row 0."""
    return tile * row_stride(l) + 2


def tight_tile_bytes(l: int, c: int, tile: int) -> int:
    """Bytes of one tight bf16 tile of ``c`` channels (a K14 f32 tile pair
    is two): its rows, and the rows the last channel block's 64-row tiles
    read past them."""
    rows = tight_rows(l, tile)
    return rows * c * 2 + (m_tiles(l, tile) * 64 + 2 - rows) * 16


def fused_backbone_f32_smem_bytes(l: int, tile: int) -> int:
    """Dynamic shared memory of a K14 f32 backbone block: the ring and two
    regions each holding the largest tight tile pair."""
    region = _round128(2 * max(tight_tile_bytes(l, 64, tile),
                               tight_tile_bytes(l // 2, 128, tile)))
    return RING_BYTES + 2 * region


def fused_head_f32_smem_bytes(l4: int, tile: int) -> int:
    """Dynamic shared memory of a K14 f32 head block: the ring, two regions
    each holding the largest tight tile pair or the last conv's f32 rows,
    and the means."""
    region = _round128(max(2 * max(tight_tile_bytes(l4, 256, tile),
                                   tight_tile_bytes(l4 // 2, 512, tile)),
                           tile * (l4 // 2) * 128 * 4))
    return RING_BYTES + 2 * region + tile * 128 * 4


def _geometry(smem_of, l, start=WG_TILE):
    tile = start
    while tile > 1 and smem_of(tile) > SMEM_MAX:
        tile //= 2
    return tile, row_stride(l), smem_of(tile)


def backbone_geometry(l: int, l1_mode: int = 0):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K5 (0),
    K9 (1) or K10 (2) launch at cutout length ``l``."""
    return _geometry(lambda t: backbone_smem_bytes(l, l1_mode, t), l)


def head_geometry(l4: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K7 launch
    at ``l4`` positions."""
    return _geometry(lambda t: head_smem_bytes(l4, t), l4)


def head_bf16_geometry(l4: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K4 launch
    at ``l4`` positions."""
    return _geometry(lambda t: head_bf16_smem_bytes(l4, t), l4)


def backbone_bf16_geometry(l: int, l1_mode: int = 0):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a bf16
    backbone launch at cutout length ``l``: layer 1 from the cutouts
    (``l1_mode`` 0, K2; 1, K14) or read from act1 (2, K2)."""
    return _geometry(lambda t: backbone_bf16_smem_bytes(l, l1_mode, t), l)


def gate_head_smem_bytes(l4: int, tile: int) -> int:
    """Dynamic shared memory of a K12 block of ``tile`` cutouts: the ring,
    two regions each holding the largest packed tile of the head, its f32
    rows, the block's pitched feature rows and the staged template, then
    the means, zx and the quantized band."""
    region = _round128(max(ptile_bytes(l4, 256, tile),
                           ptile_bytes(l4 // 2, 512, tile),
                           tile * (l4 // 2) * 128 * 4,
                           tile * cell_pitch(l4), _gate_tb_bytes(2)))
    return (RING_BYTES + 2 * region + tile * 128 * (4 + 2)
            + CELL_ROWS * CELL_MAX_WINDOW * 4)


def scan_scratch_floats(p: int) -> int:
    """Floats of the row totals of a prefix sum of ``p`` values in XLA's
    order (``csrc/cutout.cuh`` ``scan_scratch_floats``)."""
    return (p + 14) // 15 + 4


def cut_smem_bytes(l: int, p: int, tile: int) -> int:
    """Dynamic shared memory of a K8 block of ``tile`` cutouts at ``p``
    beams a stream: K5's (:func:`backbone_smem_bytes`), then the stream's
    ranges and prefix sums, the prefix sum's row totals and the block's
    half-window angles."""
    return (backbone_smem_bytes(l, 0, tile)
            + (2 * p + 1 + scan_scratch_floats(p) + tile) * 4)


def gate_head_geometry(l4: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K12
    launch at ``l4`` positions."""
    return _geometry(lambda t: gate_head_smem_bytes(l4, t), l4)


def cut_geometry(l: int, p: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K8 launch
    at cutout length ``l`` and ``p`` beams a stream."""
    return _geometry(lambda t: cut_smem_bytes(l, p, t), l)


def cell_geometry(l: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K13
    launch at cutout length ``l``."""
    return _geometry(lambda t: cell_smem_bytes(l, t), l)


def fused_backbone_f32_geometry(l: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K14 f32
    backbone launch at cutout length ``l``."""
    return _geometry(lambda t: fused_backbone_f32_smem_bytes(l, t), l,
                     F32_TILE)


def fused_head_f32_geometry(l4: int):
    """(cutouts a block, rows a cutout, shared-memory bytes) of a K14 f32
    head launch at ``l4`` positions."""
    return _geometry(lambda t: fused_head_f32_smem_bytes(l4, t), l4,
                     F32_TILE)


def _chunk_shape(cout, k, nj, wgn=1, esize=1, kc=None):
    ns = 64 * nj * wgn
    kc = kc or chunk_k(k, ns, esize)
    blk = 16 // esize  # elements of a 16-byte K block
    # (pass, n8 group, row, chunk, k block, element) of w (Cout, K)
    return (cout // ns, ns // 8, 8, k // kc, kc // blk, blk)


# (pass, n8 group, row, chunk, k block, element) <-> (pass, chunk, k block,
# n8 group, row, element): the permutation is its own inverse
_CHUNK_ORDER = (0, 3, 4, 1, 2, 5)


def wgmma_weights(w, nj: int, wgn: int = 1, kc: int | None = None):
    """``w (Cout, K)`` int8, bf16 or f32 -> the 1-D chunk order the ring
    streams: for each pass of ``64 * nj * wgn`` output channels, its K
    chunks (of ``kc`` elements; by default :func:`chunk_k`'s), each
    ``[16-byte K block][8-channel group][8 rows][16 bytes]``."""
    cout, k = w.shape
    shape = _chunk_shape(cout, k, nj, wgn, w.element_size(), kc)
    return (w.reshape(shape).permute(_CHUNK_ORDER).contiguous()
            .reshape(-1))


def plan_weights(weights, plan):
    """``[(w, s_eff, b_eff), ...]`` of an int8 conv stack -> the same with
    each ``w`` in the chunk order of its layer of ``plan``."""
    return [(wgmma_weights(w, nj), s, b)
            for (w, s, b), (_, _, _, nj) in zip(weights, plan)]


def plan_weights_bf16(weights, plan=HEAD_BF16_PLAN):
    """``[(w (3*Cin, Cout) bf16, b), ...]`` of a bf16 conv stack -> each
    ``w`` transposed to ``(Cout, 3*Cin)`` and laid out in the chunk order of
    its layer of ``plan`` (1-D bf16)."""
    return [wgmma_weights(w.t().contiguous(), nj, wgn)
            for (w, _), (_, _, _, nj, wgn) in zip(weights, plan)]


def embed_weights(we_t):
    """K13's gate embed ``W^T (128, D)`` bf16 -> the 1-D chunk order the
    kernel reads: ``D / EMBED_K`` chunks, each ``[8-element K block][column
    (128)][8 elements]`` (:func:`wgmma_weights` at ``nj = 2``, ``kc =
    EMBED_K``)."""
    return wgmma_weights(we_t.contiguous(), 2, 1, EMBED_K)


def chunk_k_x3(k: int, ns: int) -> int:
    """K a K14 f32 weight chunk of ``ns`` output channels holds: the largest
    multiple of 16 dividing ``k`` whose bf16 hi and lo parts fit a stage."""
    return max(kc for kc in range(16, k + 1, 16)
               if k % kc == 0 and (ns * kc * 4 <= STAGE_BYTES or kc == 16))


def split_bf16(x):
    """f32 ``x`` -> (hi, lo) bf16: ``hi = bf16(x)``, ``lo = bf16(x -
    hi)``."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def plan_weights_f32(weights, plan):
    """``[(w (3*Cin, Cout) f32, b), ...]`` of a K14 f32 conv stack -> each
    ``w`` transposed to ``(Cout, 3*Cin)``, split (:func:`split_bf16`), hi
    and lo each laid out in the chunk order of its layer of ``plan``
    (:func:`chunk_k_x3`), and the two interleaved chunk by chunk (1-D
    bf16)."""
    out = []
    for (w, _), (cin, _, _, nj, wgn) in zip(weights, plan):
        ns = 64 * nj * wgn
        kc = chunk_k_x3(3 * cin, ns)
        parts = [wgmma_weights(x.contiguous(), nj, wgn, kc).reshape(-1,
                                                                    ns * kc)
                 for x in split_bf16(w.t())]
        out.append(torch.stack(parts, 1).reshape(-1))
    return out
