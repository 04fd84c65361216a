"""Host-side visualization: flow color coding, scan/detection/flow plots,
video rendering.

Counterpart of ``planar_optical_flow_tpu/utils/viz.py``, on host numpy:
scan scatter plots, GT-vs-pred flow arrows, HSV flow coloring, detection
overlays and sequence videos, with matplotlib only (imported inside the
functions, so the package imports without it). A video is written with
matplotlib.animation's ffmpeg writer; where ffmpeg is missing, as PNG
frames in a directory named after the video (no cv2 dependency).
"""

from __future__ import annotations

import colorsys
import os

import numpy as np

from planar_optical_flow_tpu_torch.ops.geometry import get_laser_phi


def flow_to_hsv(flow: np.ndarray, saturate_at: float = 0.1) -> np.ndarray:
    """Per-point RGB colors encoding flow direction (hue) and magnitude
    (saturation), reference ``utils.py:574-584``."""
    flow = np.asarray(flow)
    r = np.hypot(flow[..., 0], flow[..., 1])
    phi = np.arctan2(flow[..., 1], flow[..., 0])
    h = (phi + 2.0 * np.pi) / (2.0 * np.pi) % 1.0
    s = np.minimum(r, saturate_at) / saturate_at
    out = np.zeros(flow.shape[:-1] + (3,))
    flat_h, flat_s = h.reshape(-1), s.reshape(-1)
    flat = out.reshape(-1, 3)
    for i in range(len(flat)):
        flat[i] = colorsys.hsv_to_rgb(flat_h[i], flat_s[i], 1.0)
    return out


def _scan_xy(scan, phi=None):
    phi = get_laser_phi(num_pts=len(scan)) if phi is None else phi
    return scan * np.cos(phi), scan * np.sin(phi)


def plot_scan(ax, scan, phi=None, color="black", s=1, lim=15):
    x, y = _scan_xy(scan, phi)
    ax.cla()
    ax.set_aspect("equal")
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.scatter(x, y, s=s, c=color)
    return ax


def plot_flow_arrows(ax, scan, flow, phi=None, color="blue", scale=1.0):
    x, y = _scan_xy(scan, phi)
    ax.quiver(x, y, flow[:, 0], flow[:, 1], color=color,
              angles="xy", scale_units="xy", scale=1.0 / max(scale, 1e-9))
    return ax


def plot_detections(ax, dets_xy, conf=None, color="red", radius=0.4):
    import matplotlib.pyplot as plt

    for i, (x, y) in enumerate(np.atleast_2d(dets_xy)):
        c = plt.Circle((x, y), radius=radius, color=color, fill=False)
        ax.add_artist(c)
        if conf is not None:
            ax.annotate(f"{float(np.ravel(conf)[i]):.2f}", (x, y),
                        fontsize=7, color=color)
    return ax


def plot_gt_pred_flow(scan, pred_flow, target_flow, phi=None, title=""):
    """One frame: scan points + predicted (blue) vs target (green) arrows."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    plot_scan(ax, scan, phi)
    plot_flow_arrows(ax, scan, pred_flow, phi, color="blue")
    plot_flow_arrows(ax, scan, target_flow, phi, color="green")
    ax.set_title(title)
    return fig


def plot_flow_hsv(scan, flow, phi=None, title=""):
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    x, y = _scan_xy(scan, phi)
    ax.set_aspect("equal")
    ax.scatter(x, y, s=4, c=flow_to_hsv(flow))
    ax.set_title(title)
    return fig


def render_sequence_video(frames_fn, num_frames: int, path: str, fps: int = 10):
    """Render a video by calling ``frames_fn(ax, i)`` per frame."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots(figsize=(8, 8))

    def update(i):
        frames_fn(ax, i)
        return []

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        if animation.writers.is_available("ffmpeg"):
            anim = animation.FuncAnimation(fig, update, frames=num_frames,
                                           blit=False)
            anim.save(path, fps=fps, writer="ffmpeg")
        else:
            # no ffmpeg: per-frame PNGs in a directory named after the video
            stem = os.path.splitext(path)[0]
            os.makedirs(stem, exist_ok=True)
            for i in range(num_frames):
                frames_fn(ax, i)
                fig.savefig(f"{stem}/frame_{i:05d}.png")
    finally:
        plt.close(fig)


def color_wheel(ax, resolution: int = 200, radius: float = 3.0):
    """HSV flow-direction legend wheel (reference
    ``viz_utils.color_wheel``, ``viz_utils.py:415-443``): hue encodes flow
    direction, saturation encodes magnitude up to ``radius``."""
    xs = np.linspace(-radius, radius, resolution)
    xx, yy = np.meshgrid(xs, xs)
    rgb = flow_to_hsv(np.stack([xx, yy], axis=-1), saturate_at=radius)
    rr = np.hypot(xx, yy)
    rgba = np.concatenate(
        [rgb, (rr <= radius)[..., None].astype(float)], axis=-1)
    ax.imshow(rgba, extent=(-radius, radius, -radius, radius),
              origin="lower")
    ax.set_aspect("equal")
    ax.set_xlabel("flow x")
    ax.set_ylabel("flow y")
    return ax


def render_detection_video(scans, results, path: str, fps: int = 10,
                           conf_radius: float = 0.4):
    """Scan + detections (+ flow arrows when present) per frame.

    When a result carries an ``instance_mask`` (per-point instance id from
    the vote NMS), flow arrows are colored per instance — the reference's
    joint person-flow rendering (``viz_utils.plot_person_flow``,
    ``viz_utils.py:445-510``); background (id 0) points stay blue."""
    import matplotlib.pyplot as plt

    def draw(ax, i):
        plot_scan(ax, scans[i])
        r = results[i]
        if len(r.get("dets", [])):
            plot_detections(ax, r["dets"], r.get("conf"),
                            radius=conf_radius)
        if r.get("flow") is not None:
            inst = r.get("instance_mask")
            if inst is not None and np.max(inst) > 0:
                cmap = plt.get_cmap("tab10")
                for k in np.unique(inst):
                    sel = np.asarray(inst) == k
                    color = "blue" if k == 0 else cmap((int(k) - 1) % 10)
                    plot_flow_arrows(ax, np.asarray(scans[i])[sel],
                                     np.asarray(r["flow"])[sel],
                                     phi=get_laser_phi(
                                         num_pts=len(scans[i]))[sel],
                                     color=color)
            else:
                plot_flow_arrows(ax, scans[i], r["flow"])
        ax.set_title(f"frame {i}")

    render_sequence_video(draw, len(scans), path, fps)


def plot_histogram(data, title: str = "", num_bins: int = 50):
    """Normalized histogram figure (reference ``utils.plot_histograms``)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots()
    data = np.asarray(data).reshape(-1)
    ax.hist(data, bins=num_bins, weights=np.ones(len(data)) / max(len(data), 1))
    ax.set_title(title)
    ax.set_xlabel("variable value")
    return fig


def render_flow_video(scans, pred_flows, target_flows, path: str,
                      fps: int = 10, epe_list=None, aae_list=None):
    """GT-vs-pred arrow video (reference ``plot_sequence_gt_pred_arrow``)."""

    def draw(ax, i):
        plot_scan(ax, scans[i])
        plot_flow_arrows(ax, scans[i], pred_flows[i], color="blue")
        plot_flow_arrows(ax, scans[i], target_flows[i], color="green")
        title = f"frame {i}"
        if epe_list is not None:
            title += f"  EPE {epe_list[i]:.3f} m"
        if aae_list is not None:
            title += f"  AAE {aae_list[i]:.1f} deg"
        ax.set_title(title)

    render_sequence_video(draw, len(scans), path, fps)
