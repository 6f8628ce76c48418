"""Headless snapshot rendering — pctpu's stand-in for the reference's
interactive PCLVisualizer sessions.

The reference opens spin-loop viewers in three binaries:
  * cloud_manip: input cloud red, transformed cloud green, dark-gray
    background (/root/reference/CloudManip.cpp:143-158);
  * top_part_registration: flat cloud red with every-10th-point normal
    whiskers of length 2, black background
    (/root/reference/TopPartRegistration.cpp:367-385);
  * pointcloud_pca_test: cloud red plus three principal-axis arrows
    (eigvec x 200 from the centroid, colored b/g/r), white background
    (/root/reference/main.cpp:100-135).

Interactive windows make no sense on a headless accelerator host, so pctpu renders
the same scenes to PNG: an orthographic point-splat with a device-side
z-buffer.  One ``scatter-max`` of ``depth_quantized * n_layers + layer``
per splatted pixel resolves visibility; the winning layer indexes an RGB
palette.  Line primitives (normal whiskers, arrows) are sampled host-side
into point runs and rendered as ordinary layers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_DEPTH_BITS = 20  # 20-bit depth + up to 2^10 layers fits int32


@functools.partial(jax.jit, static_argnames=("img_size", "n_layers", "point_size"))
def _render_layer_image(
    uv: jnp.ndarray,  # (P, 2) float32 projected coords
    depth: jnp.ndarray,  # (P,) float32
    layer: jnp.ndarray,  # (P,) int32
    mask: jnp.ndarray,  # (P,) bool
    lo: jnp.ndarray,  # (2,) float32 extent min
    hi: jnp.ndarray,  # (2,) float32 extent max
    img_size: int,
    n_layers: int,
    point_size: int,
) -> jnp.ndarray:
    """(S, S) int32 winning-layer image, -1 where empty."""
    s = img_size
    span = jnp.maximum(hi - lo, 1e-6)
    scale = (s - point_size) / span  # keep the splat fully inside
    # cull points outside the extent (the viewer's frustum) instead of
    # clamping them onto the border where they could occlude real points
    inside = (
        (uv[:, 0] >= lo[0]) & (uv[:, 0] <= hi[0])
        & (uv[:, 1] >= lo[1]) & (uv[:, 1] <= hi[1])
    )
    mask = mask & inside
    px = jnp.floor((uv[:, 0] - lo[0]) * scale[0]).astype(jnp.int32)
    py = jnp.floor((uv[:, 1] - lo[1]) * scale[1]).astype(jnp.int32)
    px = jnp.clip(px, 0, s - point_size)
    py = jnp.clip(py, 0, s - point_size)
    # v axis points up in world space, rows grow downward in the image
    row = (s - point_size) - py

    dmin = jnp.min(jnp.where(mask, depth, jnp.inf))
    dmax = jnp.max(jnp.where(mask, depth, -jnp.inf))
    drange = jnp.maximum(dmax - dmin, 1e-6)
    dq = jnp.clip(
        ((depth - dmin) / drange * ((1 << _DEPTH_BITS) - 1)).astype(jnp.int32),
        0,
        (1 << _DEPTH_BITS) - 1,
    )
    # nearer-to-camera (larger depth value) wins; equal depth → higher layer
    # index wins, i.e. later-added clouds draw on top like the viewer
    key = dq * n_layers + jnp.clip(layer, 0, n_layers - 1)
    key = jnp.where(mask, key, -1)

    flat = jnp.full((s * s + 1,), -1, jnp.int32)
    for dr in range(point_size):
        for dc in range(point_size):
            pix = jnp.where(mask, (row + dr) * s + (px + dc), s * s)
            flat = flat.at[pix].max(key)
    win = flat[: s * s]
    return jnp.where(win >= 0, win % n_layers, -1).reshape(s, s)


class Layer:
    """One renderable point set: (N, 3) xyz + an RGB color."""

    def __init__(self, xyz: np.ndarray, color: tuple[int, int, int],
                 mask: np.ndarray | None = None):
        self.xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        self.color = color
        self.mask = (
            np.ones(self.xyz.shape[0], bool) if mask is None
            else np.asarray(mask, bool).reshape(-1)
        )


def segment_points(
    p0: np.ndarray, p1: np.ndarray, samples_per_unit: float = 24.0,
    max_samples: int = 4096,
) -> np.ndarray:
    """Sample points along segments p0[i] → p1[i] (line/arrow primitives)."""
    p0 = np.asarray(p0, np.float32).reshape(-1, 3)
    p1 = np.asarray(p1, np.float32).reshape(-1, 3)
    out = []
    for a, b in zip(p0, p1):
        length = float(np.linalg.norm(b - a))
        n = int(min(max(length * samples_per_unit, 2), max_samples))
        t = np.linspace(0.0, 1.0, n, dtype=np.float32)[:, None]
        out.append(a[None, :] * (1 - t) + b[None, :] * t)
    return np.concatenate(out, axis=0) if out else np.zeros((0, 3), np.float32)


def render_snapshot(
    layers: list[Layer],
    img_size: int = 960,
    view: str = "top",
    background: tuple[int, int, int] = (0, 0, 0),
    point_size: int = 2,
    extent: tuple[float, float, float, float] | None = None,
    pad_frac: float = 0.03,
) -> np.ndarray:
    """Render layers to an (img_size, img_size, 3) uint8 RGB image.

    ``view``: "top" looks down −z (u=x, v=y, nearer = larger z); "front"
    looks along +y (u=x, v=z, nearer = smaller y).  ``extent`` is
    (u_min, u_max, v_min, v_max); by default it is fitted to the data with
    ``pad_frac`` padding (equal aspect).
    """
    if not layers or sum(l.xyz.shape[0] for l in layers) == 0:
        return np.full((img_size, img_size, 3), background, np.uint8)
    xyz = np.concatenate([l.xyz for l in layers], axis=0)
    mask = np.concatenate([l.mask for l in layers], axis=0)
    layer_idx = np.concatenate(
        [np.full(l.xyz.shape[0], i, np.int32) for i, l in enumerate(layers)]
    )
    if view == "top":
        uv = xyz[:, :2]
        depth = xyz[:, 2]
    elif view == "front":
        uv = xyz[:, [0, 2]]
        depth = -xyz[:, 1]
    else:
        raise ValueError(f"unknown view {view!r}")

    if extent is None:
        pts = uv[mask] if mask.any() else np.zeros((1, 2), np.float32)
        lo = pts.min(axis=0)
        hi = pts.max(axis=0)
        center = (lo + hi) / 2
        half = np.maximum((hi - lo).max() / 2, 1e-3) * (1 + pad_frac)
        lo = center - half
        hi = center + half
    else:
        lo = np.array([extent[0], extent[2]], np.float32)
        hi = np.array([extent[1], extent[3]], np.float32)

    win = np.asarray(
        _render_layer_image(
            jnp.asarray(uv), jnp.asarray(depth), jnp.asarray(layer_idx),
            jnp.asarray(mask), jnp.asarray(lo, dtype=jnp.float32),
            jnp.asarray(hi, dtype=jnp.float32),
            img_size, len(layers), point_size,
        )
    )
    palette = np.array([l.color for l in layers] + [background], np.uint8)
    return palette[np.where(win >= 0, win, len(layers))]
