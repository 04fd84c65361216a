"""Operations and bytes of the DR-SPAAM / FlowDROW step, counted from the
architecture (``reference/model.py``) at the rows the inputs need: one
cutout a beam, ``num_pts`` beams a stream, whatever a kernel pads to.

An operation is a multiply or an add (a multiply-add counts 2). Each
function gives the count for one cutout row (``c`` taps, so ``c // 4``
positions of 256 features after the backbone); the caller multiplies by the
rows of a launch or of a step.
"""

from __future__ import annotations

FEAT = 256
EMBED = 128


def _conv(length: int, cin: int, cout: int, k: int = 3) -> float:
    return 2.0 * length * k * cin * cout


def feat_dim(c: int) -> int:
    return (c // 4) * FEAT


def layer1_ops(c: int) -> float:
    """The backbone's first conv (1 -> 64 channels)."""
    return _conv(c, 1, 64)


def backbone_tail_ops(c: int) -> float:
    """Backbone convs 2-6: 64->64, 64->128 at ``c`` positions, 128->128,
    128->128, 128->256 at ``c // 2``."""
    h = c // 2
    return (_conv(c, 64, 64) + _conv(c, 64, 128) + _conv(h, 128, 128)
            + _conv(h, 128, 128) + _conv(h, 128, 256))


def embed_ops(c: int) -> float:
    """The gate's embedding of a feature row (``D -> 128``)."""
    return 2.0 * feat_dim(c) * EMBED


def gate_sim_ops(window: int) -> float:
    """Similarities of a row with its ``window`` neighbours."""
    return 2.0 * window * EMBED


def gate_mix_ops(c: int, window: int) -> float:
    """The attention-weighted mix of ``window`` template rows and the
    blend with the features."""
    return 2.0 * window * feat_dim(c) + 3.0 * feat_dim(c)


def head_conv_ops(c: int) -> float:
    """Head convs: 256->256, 256->256, 256->512 at ``c // 4`` positions,
    512->256, 256->128 at ``c // 8``."""
    q, e = c // 4, c // 8
    return (_conv(q, 256, 256) + _conv(q, 256, 256) + _conv(q, 256, 512)
            + _conv(e, 512, 256) + _conv(e, 256, 128))


def backbone_tail_params() -> int:
    """Weights of backbone convs 2-6 (3 taps each)."""
    return 3 * (64 * 64 + 64 * 128 + 128 * 128 + 128 * 128 + 128 * 256)


def head_conv_params() -> int:
    """Weights of the head's five convs (3 taps each)."""
    return 3 * (256 * 256 + 256 * 256 + 256 * 512 + 512 * 256 + 256 * 128)


def head_linear_ops(num_classes: int = 1) -> float:
    return 2.0 * 128 * (num_classes + 2)


def flow_head_ops(window: int) -> float:
    """The flow head at one beam: convs (w+1)->128, 128->64, 64->32 (k=3)
    and 32->2 (k=1)."""
    return (_conv(1, window + 1, 128) + _conv(1, 128, 64) + _conv(1, 64, 32)
            + _conv(1, 32, 2, k=1))


def step_ops(cfg: dict) -> dict:
    """``{precision: operations}`` of one forward of one cutout row, each
    layer at the precision the configuration runs it in (``cfg["layers"]``:
    ``layer1``, ``backbone``, ``embed``, ``gate_sim``, ``gate_mix``,
    ``head``, ``head_linear``, ``flow_head``)."""
    c = int(cfg["cutout"]["num_cutout_pts"])
    w = int(cfg["window_size"])
    prec = cfg["layers"]
    parts = {"layer1": layer1_ops(c), "backbone": backbone_tail_ops(c),
             "embed": embed_ops(c), "gate_sim": gate_sim_ops(w),
             "gate_mix": gate_mix_ops(c, w), "head": head_conv_ops(c),
             "head_linear": head_linear_ops()}
    if cfg["model"] == "flow_drow":
        parts["flow_head"] = flow_head_ops(w)
    out = {}
    for name, ops in parts.items():
        out[prec[name]] = out.get(prec[name], 0.0) + ops
    return out


def roofline_pct(view, kernels, main: str, ops: dict, nbytes: float):
    """A kernel's share of its roofline, in %: the bound of one launch
    (:func:`portbench.peaks.bound_s` of ``ops`` and ``nbytes``, the work of
    one launch) times the launches of ``main``, over the device time of the
    operations named by ``kernels`` in the traced slice ``view``. None where
    the slice holds no launch."""
    from portbench.peaks import bound_s

    if view is None:
        return None
    n, t = view.launches(main), view.time_s(kernels)
    if n == 0 or t <= 0.0:
        return None
    return 100.0 * n * bound_s(ops, nbytes) / t


def rows(ctx) -> int:
    """Cutout rows of one launch: every beam of every stream."""
    return int(ctx["streams"]) * int(ctx["cfg"]["num_pts"])
