"""Visualization helpers: cost-colored rollout overlays and gif recording
(counterpart of ``pytorch_mppi_tpu/utils/viz.py``).

Native replacement for the reference example flow
(``tests/smooth_mppi.py:265-285``: per-step frames captured with
window_recorder, sorted with sort_nicely, assembled into gifs via
imageio/ffmpeg): frames are rasterized straight from the matplotlib canvas
and assembled with PIL, with no window and no ffmpeg.  Rollouts and costs
may be tensors on any device, numpy arrays or lists.
"""
from __future__ import annotations

import numpy as np
import torch


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class GifRecorder:
    """Capture matplotlib-figure frames and write an animated gif.

    >>> rec = GifRecorder(fig)
    >>> for step in ...:
    ...     draw_this_step(ax)
    ...     rec.capture()
    >>> rec.save("evolution.gif", fps=8)
    """

    def __init__(self, fig):
        self.fig = fig
        self.frames: list = []

    def capture(self):
        self.fig.canvas.draw()
        buf = np.asarray(self.fig.canvas.buffer_rgba())
        self.frames.append(buf[..., :3].copy())
        return buf

    def save(self, path: str, fps: int = 5):
        if not self.frames:
            raise ValueError("no frames captured")
        from PIL import Image

        imgs = [Image.fromarray(f) for f in self.frames]
        imgs[0].save(
            path, save_all=True, append_images=imgs[1:],
            duration=max(1, int(1000 / fps)), loop=0,
        )
        return path


def draw_rollouts_colored(ax, start, rollouts, costs, cmap="viridis_r",
                          max_rollouts=40, linewidth=0.7, alpha=0.6):
    """Overlay candidate rollouts (R, T, >= 2) colored by their (R,) costs
    (the reference colors candidate trajectories by cost when rendering
    sample evolution, smooth_mppi.py:346-359).  Returns the created artists
    so callers can remove them before drawing the next frame."""
    import matplotlib
    from matplotlib.colors import Normalize

    rollouts = _numpy(rollouts)[:max_rollouts]
    costs = _numpy(costs)[:max_rollouts]
    norm = Normalize(vmin=float(costs.min()), vmax=float(costs.max() + 1e-9))
    colormap = matplotlib.colormaps[cmap] if isinstance(cmap, str) else cmap
    artists = []
    start = _numpy(start).reshape(1, -1)
    for rollout, c in zip(rollouts, costs):
        r = np.concatenate([start, rollout], axis=0)
        (ln,) = ax.plot(r[:, 0], r[:, 1], color=colormap(norm(float(c))),
                        linewidth=linewidth, alpha=alpha)
        artists.append(ln)
    return artists
