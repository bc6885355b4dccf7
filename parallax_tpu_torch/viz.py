"""Host-side visualization.

The port of ``viz.py``: world states rendered to numpy RGB frames with no
display dependency.

* ``Renderer``: a pure-numpy rasterizer for world states (circles, boxes,
  polygons), fed by host (``.cpu()``) copies of the state;
* ``Painter``: draw hooks called on the host (debug use; each call reads
  its tensors from the device);
* ``Window``/``show``/``save_gif``: an optional pygame window and GIF
  writer; pygame and pillow are imported inside them only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from parallax_tpu_torch.geometry.shapes import BOX, CIRCLE


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class Renderer:
    """Rasterizes world-frame parts into an RGB uint8 frame."""

    def __init__(self, width=800, height=600, extent=(-8.0, 8.0, -6.0, 6.0)):
        self.width = width
        self.height = height
        self.extent = extent

    def _to_px(self, xy: np.ndarray) -> np.ndarray:
        x0, x1, y0, y1 = self.extent
        u = (xy[..., 0] - x0) / (x1 - x0) * (self.width - 1)
        v = (1.0 - (xy[..., 1] - y0) / (y1 - y0)) * (self.height - 1)
        return np.stack([u, v], axis=-1)

    def blank(self) -> np.ndarray:
        return np.zeros((self.height, self.width, 3), np.uint8)

    def _px_bbox(self, px_lo, px_hi):
        """Clamp a float pixel bbox to frame bounds -> (x0, x1, y0, y1) ints
        (half-open); empty boxes collapse to zero size."""
        x0 = max(int(np.floor(px_lo[0])), 0)
        y0 = max(int(np.floor(px_lo[1])), 0)
        x1 = min(int(np.ceil(px_hi[0])) + 1, self.width)
        y1 = min(int(np.ceil(px_hi[1])) + 1, self.height)
        return x0, max(x1, x0), y0, max(y1, y0)

    def draw_circle(self, frame, center, radius, color=(200, 200, 200)):
        c = self._to_px(np.asarray(center, np.float64))
        x0e, x1e, y0e, y1e = self.extent
        rpx = radius / (x1e - x0e) * (self.width - 1)
        # rasterize only the circle's pixel bbox, not the full frame
        x0, x1, y0, y1 = self._px_bbox(c - rpx, c + rpx)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        mask = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 <= rpx**2
        frame[y0:y1, x0:x1][mask] = color
        return frame

    def draw_polygon(self, frame, verts, color=(255, 255, 255)):
        """Scanline-free fill via half-plane tests (small n, debug use)."""
        v = np.asarray(verts, np.float64)
        px = self._to_px(v)
        # rasterize only the polygon's pixel bbox, not the full frame
        x0, x1, y0, y1 = self._px_bbox(px.min(axis=0), px.max(axis=0))
        yy, xx = np.mgrid[y0:y1, x0:x1]
        inside = np.ones(yy.shape, bool)
        n = len(px)
        # winding from the signed area: interior pixels sit on the same side
        # of every edge, and which side is fixed by the orientation
        area2 = sum(
            px[i][0] * px[(i + 1) % n][1] - px[(i + 1) % n][0] * px[i][1]
            for i in range(n)
        )
        sign = 1.0 if area2 >= 0 else -1.0
        for i in range(n):
            a, b = px[i], px[(i + 1) % n]
            e = b - a
            if np.allclose(e, 0):
                continue
            cross = e[0] * (yy - a[1]) - e[1] * (xx - a[0])
            inside &= (cross * sign) >= 0
        frame[y0:y1, x0:x1][inside] = color
        return frame

    def draw_box(self, frame, lower, upper, color=(255, 255, 255)):
        lo = self._to_px(np.asarray(lower, np.float64))
        hi = self._to_px(np.asarray(upper, np.float64))
        x0, x1 = sorted([int(lo[0]), int(hi[0])])
        y0, y1 = sorted([int(lo[1]), int(hi[1])])
        x0, x1 = max(x0, 0), min(x1, self.width - 1)
        y0, y1 = max(y0, 0), min(y1, self.height - 1)
        frame[y0 : y1 + 1, x0 : x1 + 1] = color
        return frame

    def render_parts(self, world_parts, colors=None) -> np.ndarray:
        """Render a world-frame ``Parts`` table of one world."""
        frame = self.blank()
        verts = _host(world_parts.verts)
        radius = _host(world_parts.radius)
        for p in range(world_parts.n_parts):
            color = colors[p] if colors else (128, 128, 128)
            kind = world_parts.kind[p]
            if kind == CIRCLE:
                self.draw_circle(frame, verts[p, 0], radius[p], color)
            elif kind == BOX:
                self.draw_box(frame, verts[p, 0], verts[p, 1], color)
            else:
                nv = world_parts.nverts[p]
                self.draw_polygon(frame, verts[p, :nv], color)
        return frame

    def render_env(self, env, state) -> np.ndarray:
        """Render one world of ``env`` at ``state`` (no leading batch axis;
        the lander's terrain from the state)."""
        b = state.bodies
        pos, ang = (torch.as_tensor(_host(x)) for x in (b.pos, b.angle))
        if hasattr(state, "terrain") and hasattr(env, "_world_with_terrain"):
            parts = env._world_with_terrain(state.terrain).parts
        else:
            parts = env.world.parts
        wp = parts.to("cpu").to_world(pos, torch.cos(ang), torch.sin(ang))
        return self.render_parts(wp)


class Painter:
    """Draw hooks that accumulate primitives into a host-side frame; each
    call reads its tensors on the host."""

    def __init__(self, renderer: Optional[Renderer] = None):
        self.renderer = renderer or Renderer()
        self.frame = self.renderer.blank()
        self.frames = []

    def draw_circle(self, center, radius, color=(128, 128, 128)):
        self.renderer.draw_circle(self.frame, _host(center), float(_host(radius)), color)

    def draw_line(self, a, b, color=(255, 255, 255)):
        pa = self.renderer._to_px(_host(a).astype(np.float64))
        pb = self.renderer._to_px(_host(b).astype(np.float64))
        n = int(max(abs(pb - pa))) + 1
        ts = np.linspace(0, 1, max(n, 2))
        pts = (pa[None] * (1 - ts[:, None]) + pb[None] * ts[:, None]).astype(int)
        ok = (
            (pts[:, 0] >= 0)
            & (pts[:, 0] < self.renderer.width)
            & (pts[:, 1] >= 0)
            & (pts[:, 1] < self.renderer.height)
        )
        self.frame[pts[ok, 1], pts[ok, 0]] = color

    def next(self):
        self.frames.append(self.frame.copy())
        self.frame = self.renderer.blank()


class Window:  # pragma: no cover - optional dependency, needs a display
    """Live pygame window (optional: requires pygame and a display)."""

    def __init__(self, width=800, height=600, title="parallax"):
        try:
            import pygame
        except ImportError as e:
            raise ImportError("viz.Window requires pygame") from e
        self._pygame = pygame
        pygame.init()
        self.screen = pygame.display.set_mode((width, height))
        pygame.display.set_caption(title)

    def show(self, frame: np.ndarray) -> bool:
        """Blit an RGB uint8 frame; returns False once the window is closed."""
        pg = self._pygame
        for event in pg.event.get():
            if event.type == pg.QUIT:
                pg.quit()
                return False
        surf = pg.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
        self.screen.blit(surf, (0, 0))
        pg.display.flip()
        return True

    def close(self):
        self._pygame.quit()


def show(frame: np.ndarray, window: Optional[Window] = None) -> Window:
    """Display a frame in a (new or reused) pygame window; returns the
    window for reuse across frames.  Requires pygame."""
    if window is None:
        window = Window(width=frame.shape[1], height=frame.shape[0])
    window.show(frame)
    return window


def save_gif(frames, path, fps=30):  # pragma: no cover - optional dependency
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("saving GIFs requires pillow") from e
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:], duration=1000 // fps, loop=0
    )
