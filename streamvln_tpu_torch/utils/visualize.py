"""Trajectory maps, caption strips and episode videos of the PyTorch port.

Own copy of what the evaluator's `save_video` needs from
`streamvln_tpu/utils/visualize.py`: a 2D top-down trajectory map, the
caption strip under a frame and the episode video (reference eval loop:
streamvln_eval.py:355-358). PIL only: MP4 when imageio with ffmpeg is
present, else an animated GIF.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

AGENT_COLOR = (46, 126, 255)
REF_COLOR = (120, 220, 120)
GOAL_COLOR = (235, 80, 80)
START_COLOR = (250, 200, 60)


def draw_top_down_map(agent_path: Sequence, goal,
                      reference_path: Optional[Sequence] = None,
                      size: int = 512, margin: float = 1.0
                      ) -> np.ndarray:
    """Render a 2D trajectory map -> [size, size, 3] uint8."""
    from PIL import Image, ImageDraw
    pts = [np.asarray(p, np.float64)[:2] for p in agent_path]
    all_pts = pts + [np.asarray(goal, np.float64)[:2]]
    if reference_path is not None:
        all_pts += [np.asarray(p, np.float64)[:2]
                    for p in reference_path]
    arr = np.stack(all_pts)
    lo = arr.min(0) - margin
    hi = arr.max(0) + margin
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        xy = (np.asarray(p, np.float64)[:2] - lo) / span
        return (float(xy[0] * (size - 1)),
                float((1.0 - xy[1]) * (size - 1)))

    img = Image.new("RGB", (size, size), (245, 245, 245))
    d = ImageDraw.Draw(img)
    if reference_path is not None and len(reference_path) > 1:
        d.line([to_px(p) for p in reference_path], fill=REF_COLOR,
               width=3)
    if len(pts) > 1:
        d.line([to_px(p) for p in pts], fill=AGENT_COLOR, width=3)
    r = 6
    for p, color in ((pts[0], START_COLOR), (goal, GOAL_COLOR)):
        x, y = to_px(p)
        d.ellipse([x - r, y - r, x + r, y + r], fill=color)
    return np.asarray(img, np.uint8)


def append_text_underneath_image(image: np.ndarray,
                                 text: str) -> np.ndarray:
    """Add a white caption strip under the frame (reference:
    habitat's append_text_underneath_image used by the DAgger video)."""
    from PIL import Image, ImageDraw
    H, W = image.shape[:2]
    strip = 24
    canvas = np.full((H + strip, W, 3), 255, np.uint8)
    canvas[:H] = image[..., :3]
    img = Image.fromarray(canvas)
    ImageDraw.Draw(img).text((4, H + 4), text, fill=(0, 0, 0))
    return np.asarray(img, np.uint8)


def images_to_video(frames: List[np.ndarray], output_dir: str,
                    name: str, fps: int = 6, quality: int = 9) -> str:
    """Write an episode video (reference: streamvln_eval.py:355-358).
    MP4 via imageio-ffmpeg when available, else animated GIF."""
    os.makedirs(output_dir, exist_ok=True)
    try:
        import imageio
        path = os.path.join(output_dir, f"{name}.mp4")
        imageio.mimwrite(path, frames, fps=fps,
                         quality=quality)
        return path
    except Exception:
        from PIL import Image
        path = os.path.join(output_dir, f"{name}.gif")
        imgs = [Image.fromarray(f) for f in frames]
        imgs[0].save(path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return path
