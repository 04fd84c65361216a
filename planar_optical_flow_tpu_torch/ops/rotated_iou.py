"""Rotated bounding-box IoU in plain PyTorch, on tensors of any device.

Counterpart of ``planar_optical_flow_tpu/ops/rotated_iou.py``, in the same
two forms and in f32:

* :func:`rotated_iou`, :func:`rotated_iou_paired`, :func:`rotated_iou_3d`
  and :func:`rotated_iou_3d_paired`: the order-free boundary-integral form.
  The area of the intersection of two convex polygons is the shoelace sum
  over every directed boundary piece, and those pieces are each polygon's
  edges clipped to the other's interior: clipping an edge by the 4
  half-planes of the other box is an intersection of ``t``-intervals. JAX
  loops over the 4 edges and the 4 planes on ``(N, K)`` arrays; here the
  edges and planes are two trailing axes of size 4, so one pass is a few
  dozen elementwise operations on ``(N, K, 4, 4)`` tensors (a plane's
  interval bounds combine by min/max, which is exact, so the loop's order
  does not matter) and the 4 edges' shoelace terms are summed in JAX's
  order. The arithmetic of each element is JAX's, spelled in the same
  order: the corners ``(cx + lx c) + ly s``, the unit normals through
  ``rsqrt``, the distances ``nx (px - jx) + ny (py - jy)``.

  The tie-break for collinear boundaries is JAX's: a piece of an edge
  lying ON an edge line of the other box (both endpoints within
  ``_ON_EPS``) is kept in the first pass always, and in the second only
  when it runs anti-parallel to the clip box's own edge (touching boxes:
  the two traversals cancel); an edge within ``_PAR_EPS`` of parallel is
  kept or dropped whole by the side it lies on.
* :func:`rotated_iou_sh`: the per-pair Sutherland-Hodgman clipper (an
  8-vertex padded buffer, compaction by a cumulative sum, the masked
  shoelace), here batched over the pairs; the independent oracle the tests
  hold the default form against.

Box formats: 2D ``[cx, cy, l, w, angle]`` (angle clockwise-positive), 3D
``[cx, cy, cz, l, w, h, rot_z]`` (z-aligned boxes). ``criterion``: -1 the
IoU, 0 the intersection over the first box's area, 1 over the second's,
anything else the intersection itself.
"""

from __future__ import annotations

import functools

import torch

_MAX_VERTS = 8
_EPS = 1e-8
# unit-normal half-plane tests make these true distances [m]
_ON_EPS = 5e-5   # both endpoints within this band: the edge lies ON the plane
_PAR_EPS = 2e-5  # |ds - de| below this: the edge is parallel to the plane
# the corner order of a box: clockwise, as box_corners gives it
_CORNER_SIGNS = ((-1.0, -1.0), (-1.0, 1.0), (1.0, 1.0), (1.0, -1.0))


@functools.lru_cache(maxsize=None)
def _corner_signs(device, dtype) -> torch.Tensor:
    """``_CORNER_SIGNS`` on ``device``, made once (no host copy a call, so
    a call can be captured in a CUDA graph)."""
    return torch.tensor(_CORNER_SIGNS, dtype=dtype, device=device)


def _f32(x, like=None) -> torch.Tensor:
    """``x`` as an f32 tensor (on ``like``'s device when given)."""
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# the order-free form
# ---------------------------------------------------------------------------


def _corners_xy(cx, cy, l, w, angle):
    """Corner coordinates ``(xs, ys)``, each ``(..., 4)`` in the clockwise
    order of :func:`box_corners`, of boxes given as component tensors."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    signs = _corner_signs(cx.device, cx.dtype)
    lx = signs[:, 0] * (0.5 * l)[..., None]
    ly = signs[:, 1] * (0.5 * w)[..., None]
    xs = cx[..., None] + lx * c + ly * s
    ys = cy[..., None] - lx * s + ly * c
    return xs, ys


def _next(v):
    """Each corner's successor along the boundary: ``v[(i + 1) % 4]``."""
    return torch.roll(v, -1, dims=-1)


def _clip_area_oneway(ax, ay, bx, by, bcx, bcy, first_pass: bool):
    """Signed shoelace sum (twice the signed area) of A's boundary clipped
    to B's interior. ``ax/ay``, ``bx/by``: ``(..., 4)`` corners;
    ``bcx/bcy``: B's centre, which fixes the inner side of each B edge."""
    # B's 4 interior half-planes (the last axis), unit normals: inside where
    # dot(n, x - b_j) >= 0
    ex, ey = _next(bx) - bx, _next(by) - by
    inv = torch.rsqrt(torch.clamp(ex * ex + ey * ey, min=1e-20))
    nx, ny = -ey * inv, ex * inv  # the left normal of the directed edge
    sgn = torch.where(
        nx * (bcx[..., None] - bx) + ny * (bcy[..., None] - by) >= 0.0,
        1.0, -1.0)
    nx, ny, jx, jy, ex, ey = (v[..., None, :] for v in (
        nx * sgn, ny * sgn, bx, by, ex, ey))
    # A's 4 edges p -> q (the second-last axis)
    px, py, qx, qy = (v[..., :, None] for v in (ax, ay, _next(ax),
                                                 _next(ay)))
    dx, dy = qx - px, qy - py

    ds = nx * (px - jx) + ny * (py - jy)
    de = nx * (qx - jx) + ny * (qy - jy)
    denom = ds - de  # the constraint ds + t (de - ds) >= 0
    on = (ds.abs() <= _ON_EPS) & (de.abs() <= _ON_EPS)
    par = denom.abs() <= _PAR_EPS
    skip = on | par
    t = ds / torch.where(skip, 1.0, denom)
    # denom > 0 (leaving): an upper bound; denom < 0 (entering): a lower one
    t1 = torch.where(~skip & (denom > 0), t, torch.inf).amin(-1)
    t0 = torch.where(~skip & (denom < 0), t, -torch.inf).amax(-1)
    t1, t0 = torch.clamp(t1, max=1.0), torch.clamp(t0, min=0.0)
    if first_pass:
        keep_on = torch.ones_like(on)
    else:  # the second pass keeps only anti-parallel (cancelling) pieces
        keep_on = dx * ex + dy * ey < 0.0
    alive = torch.where(on, keep_on, ~par | (ds >= 0.0)).all(-1)

    empty = (t0 > t1) | ~alive
    u0 = torch.where(empty, 0.0, t0)
    u1 = torch.where(empty, 0.0, t1)  # empty: a zero-length piece
    px, py, dx, dy = (v[..., 0] for v in (px, py, dx, dy))
    v0x, v0y = px + u0 * dx, py + u0 * dy
    v1x, v1y = px + u1 * dx, py + u1 * dy
    cross = v0x * v1y - v1x * v0y
    return ((cross[..., 0] + cross[..., 1]) + cross[..., 2]) + cross[..., 3]


def _intersection_area_batched(p1, p2):
    """Overlap area of rotated rectangles given as component tuples
    ``(cx, cy, l, w, angle)`` of broadcastable tensors."""
    ax, ay = _corners_xy(*p1)
    bx, by = _corners_xy(*p2)
    total = _clip_area_oneway(ax, ay, bx, by, p2[0], p2[1], first_pass=True)
    total = total + _clip_area_oneway(bx, by, ax, ay, p1[0], p1[1],
                                      first_pass=False)
    return 0.5 * total.abs()


def _iou_from_areas(inter, area1, area2, criterion):
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = area1
    elif criterion == 1:
        denom = area2
    else:
        return inter
    return inter / torch.clamp(denom, min=_EPS)


def _split2d(b):
    return tuple(b[..., i] for i in range(5))


def rotated_iou(boxes, query_boxes, criterion: int = -1) -> torch.Tensor:
    """Pairwise rotated IoU of ``boxes (N, 5)`` against ``query_boxes
    (K, 5)`` -> ``(N, K)`` f32, on ``boxes``' device."""
    boxes = _f32(boxes)
    query_boxes = _f32(query_boxes, boxes)
    p1 = _split2d(boxes[:, None, :])
    p2 = _split2d(query_boxes[None, :, :])
    inter = _intersection_area_batched(p1, p2)
    return _iou_from_areas(inter, p1[2] * p1[3], p2[2] * p2[3], criterion)


def rotated_iou_paired(boxes, others, criterion: int = -1) -> torch.Tensor:
    """Elementwise rotated IoU of broadcastable ``(..., 5)`` box tensors
    (a prediction against its target) without the ``(N, N)`` matrix."""
    boxes = _f32(boxes)
    others = _f32(others, boxes)
    p1, p2 = _split2d(boxes), _split2d(others)
    inter = _intersection_area_batched(p1, p2)
    return _iou_from_areas(inter, p1[2] * p1[3], p2[2] * p2[3], criterion)


def rotated_iou_3d(boxes, query_boxes, criterion: int = -1) -> torch.Tensor:
    """Pairwise 3D rotated IoU of ``boxes (N, 7)`` against ``query_boxes
    (K, 7)`` -> ``(N, K)`` f32."""
    boxes = _f32(boxes)
    query_boxes = _f32(query_boxes, boxes)
    return _iou_3d_core(boxes[:, None, :], query_boxes[None, :, :],
                        criterion)


def rotated_iou_3d_paired(boxes, others, criterion: int = -1
                          ) -> torch.Tensor:
    """Elementwise 3D rotated IoU of broadcastable ``(..., 7)`` box
    tensors."""
    boxes = _f32(boxes)
    return _iou_3d_core(boxes, _f32(others, boxes), criterion)


def _iou_3d_core(b1, b2, criterion):
    p1 = (b1[..., 0], b1[..., 1], b1[..., 3], b1[..., 4], b1[..., 6])
    p2 = (b2[..., 0], b2[..., 1], b2[..., 3], b2[..., 4], b2[..., 6])
    area_inter = _intersection_area_batched(p1, p2)
    top = torch.minimum(b1[..., 2] + 0.5 * b1[..., 5],
                        b2[..., 2] + 0.5 * b2[..., 5])
    bot = torch.maximum(b1[..., 2] - 0.5 * b1[..., 5],
                        b2[..., 2] - 0.5 * b2[..., 5])
    vol_inter = area_inter * torch.clamp(top - bot, min=0.0)
    vol1 = b1[..., 3] * b1[..., 4] * b1[..., 5]
    vol2 = b2[..., 3] * b2[..., 4] * b2[..., 5]
    return _iou_from_areas(vol_inter, vol1, vol2, criterion)


# ---------------------------------------------------------------------------
# Sutherland-Hodgman, batched over pairs (the cross-check oracle)
# ---------------------------------------------------------------------------


def box_corners(box) -> torch.Tensor:
    """Corners ``(..., 4, 2)`` of ``[cx, cy, l, w, angle]`` boxes
    ``(..., 5)``, clockwise, rotated clockwise for a positive angle."""
    box = _f32(box)
    c, s = torch.cos(box[..., 4:5]), torch.sin(box[..., 4:5])
    signs = _corner_signs(box.device, box.dtype)
    lx = signs[:, 0] * (0.5 * box[..., 2:3])
    ly = signs[:, 1] * (0.5 * box[..., 3:4])
    x = (lx * c + ly * s) + box[..., 0:1]
    y = (-lx * s + ly * c) + box[..., 1:2]
    return torch.stack([x, y], dim=-1)


def _clip_by_halfplane(verts, count, p, q, interior):
    """Clip the polygons ``verts (P, 8, 2)`` (``count (P,)`` valid, in
    boundary order) by the half-plane through the edge ``p -> q`` (``(P,
    2)``) that holds ``interior``."""
    n = torch.stack([-(q[:, 1] - p[:, 1]), q[:, 0] - p[:, 0]], dim=-1)
    d_in = interior - p
    sign = torch.where(n[:, 0] * d_in[:, 0] + n[:, 1] * d_in[:, 1] >= 0.0,
                       1.0, -1.0)
    n = n * sign[:, None]  # inside: dot(n, x - p) >= 0

    idx = torch.arange(_MAX_VERTS, device=verts.device)
    valid_in = idx < count[:, None]
    nxt = (idx + 1) % torch.clamp(count, min=1)[:, None]
    s_pt = verts
    e_pt = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))

    def dist(pt):
        rel = pt - p[:, None, :]
        return n[:, None, 0] * rel[..., 0] + n[:, None, 1] * rel[..., 1]

    ds, de = dist(s_pt), dist(e_pt)
    s_in, e_in = ds >= 0.0, de >= 0.0
    t = ds / torch.where((ds - de).abs() < _EPS, _EPS, ds - de)
    inter = s_pt + t[..., None] * (e_pt - s_pt)

    # each input edge emits its crossing point, then its end if inside
    emit_inter = (s_in ^ e_in) & valid_in
    emit_end = e_in & valid_in
    cand = torch.stack((inter, e_pt), dim=2).reshape(-1, 2 * _MAX_VERTS, 2)
    emit = torch.stack((emit_inter, emit_end), dim=2).reshape(
        -1, 2 * _MAX_VERTS)
    pos = torch.cumsum(emit.long(), dim=1) - 1
    pos = torch.where(emit, pos, 2 * _MAX_VERTS)  # dropped
    out = torch.zeros(verts.shape[0], 2 * _MAX_VERTS + 1, 2,
                      dtype=verts.dtype, device=verts.device)
    out.scatter_(1, pos[..., None].expand(-1, -1, 2), cand)
    return out[:, :_MAX_VERTS], emit.sum(dim=1)


def _polygon_area(verts, count):
    """Masked shoelace area of the first ``count`` vertices of each
    polygon."""
    idx = torch.arange(_MAX_VERTS, device=verts.device)
    nxt = (idx + 1) % torch.clamp(count, min=1)[:, None]
    vn = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 2))
    cross = verts[..., 0] * vn[..., 1] - vn[..., 0] * verts[..., 1]
    cross = torch.where(idx < count[:, None], cross, 0.0)
    return 0.5 * cross.sum(dim=1).abs()


def _rect_intersection_area(box1, box2):
    """Overlap areas of the rotated rectangles ``box1 (P, 5)`` and ``box2
    (P, 5)`` by Sutherland-Hodgman."""
    subj, clip = box_corners(box1), box_corners(box2)
    verts = torch.zeros(box1.shape[0], _MAX_VERTS, 2, dtype=subj.dtype,
                        device=subj.device)
    verts[:, :4] = subj
    count = torch.full((box1.shape[0],), 4, dtype=torch.long,
                       device=subj.device)
    for k in range(4):
        verts, count = _clip_by_halfplane(verts, count, clip[:, k],
                                          clip[:, (k + 1) % 4], box2[:, :2])
    return _polygon_area(verts, count)


def rotated_iou_sh(boxes, query_boxes, criterion: int = -1) -> torch.Tensor:
    """Sutherland-Hodgman form of :func:`rotated_iou` (same semantics), for
    cross-checks at small ``N * K``."""
    boxes = _f32(boxes)
    query_boxes = _f32(query_boxes, boxes)
    n, k = boxes.shape[0], query_boxes.shape[0]
    b1 = boxes[:, None, :].expand(n, k, 5).reshape(-1, 5)
    b2 = query_boxes[None, :, :].expand(n, k, 5).reshape(-1, 5)
    inter = _rect_intersection_area(b1, b2)
    iou = _iou_from_areas(inter, b1[:, 2] * b1[:, 3], b2[:, 2] * b2[:, 3],
                          criterion)
    return iou.reshape(n, k)


def aabb_iou(box1, box2) -> torch.Tensor:
    """Axis-aligned IoU of ``[cx, cy, l, w]`` boxes (batched over leading
    dims)."""
    box1 = _f32(box1)
    box2 = _f32(box2, box1)

    def bounds(b):
        return (b[..., 0] - 0.5 * b[..., 2], b[..., 0] + 0.5 * b[..., 2],
                b[..., 1] - 0.5 * b[..., 3], b[..., 1] + 0.5 * b[..., 3])

    x0a, x1a, y0a, y1a = bounds(box1)
    x0b, x1b, y0b, y1b = bounds(box2)
    iw = torch.clamp(torch.minimum(x1a, x1b) - torch.maximum(x0a, x0b),
                     min=0.0)
    ih = torch.clamp(torch.minimum(y1a, y1b) - torch.maximum(y0a, y0b),
                     min=0.0)
    inter = iw * ih
    union = box1[..., 2] * box1[..., 3] + box2[..., 2] * box2[..., 3] - inter
    return inter / torch.clamp(union, min=_EPS)
