"""Rounding primitives that reproduce the C/C++ semantics of the reference.

Two patterns appear in the reference's grid indexing:

1. ``round(f32_expr)`` where the whole expression is float (e.g. the multi-BEV
   layer index, /root/reference/BatchMultiBevGen.cpp:281, and the top-part
   grid, BatchTopPartRegistration.cpp:113-114).  C ``round`` is half away
   from zero and exact on its f32 input; :func:`c_round` reproduces it
   bit-exactly using floor + an exact fraction compare (``a - floor(a)`` is
   exact in f32 for our magnitudes), with no intermediate additions that
   could re-round.

2. ``round(f32_expr + 0.5)`` where the 0.5 literal promotes to double (the
   BEV cell index, BatchMultiBevGen.cpp:279-280).  Emulating the double
   addition needs no f64 at all: for t = f32_expr,
   round64(t + 0.5) = floor(t) + 1 when t >= -0.5 (because t+1.0 is exact in
   f64) and = ceil(t) when t < -0.5 (because (t+0.5)-0.5 is exact).
   :func:`bev_cell` implements that identity — bit-exact vs the C++ on
   f32-only hardware.

``jnp.round``/``np.round`` are round-half-to-even and must not be used here.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def c_round(v: jnp.ndarray) -> jnp.ndarray:
    """C ``round()`` of an f32 value: half away from zero, bit-exact."""
    a = jnp.abs(v)
    k = jnp.floor(a)
    r = k + (a - k >= 0.5)
    return jnp.where(v < 0, -r, r)


def c_round_np(v) -> np.ndarray:
    """C ``round()`` in numpy (float64 inputs)."""
    v = np.asarray(v)
    a = np.abs(v)
    k = np.floor(a)
    r = k + (a - k >= 0.5)
    return np.where(v < 0, -r, r)


def bev_cell(coord: jnp.ndarray, max_range: float, interval: float) -> jnp.ndarray:
    """The reference BEV cell index ``round((coord + MAX_RANGE)/interval + 0.5)``
    with its exact f32-then-f64 semantics (see module docstring).  int32."""
    t = (coord + jnp.float32(max_range)) / jnp.float32(interval)
    return jnp.where(
        t >= -0.5,
        jnp.floor(t).astype(jnp.int32) + 1,
        jnp.ceil(t).astype(jnp.int32),
    )


def bev_cell_np(coord, max_range: float, interval: float) -> np.ndarray:
    """Oracle twin of :func:`bev_cell` (f32 expr, f64 +0.5, C round)."""
    t = (np.float32(coord) + np.float32(max_range)) / np.float32(interval)
    t = t.astype(np.float64)
    return c_round_np(t + 0.5).astype(np.int32)


def cv_saturate_u8(v: np.ndarray) -> np.ndarray:
    """OpenCV ``saturate_cast<uchar>(float)``: rint (half-to-even) + clamp.

    Used when emulating cv::imwrite's CV_32F→CV_8U fallback for float BEV
    PNGs (/root/reference/BatchCloudManip.cpp:238 writes a CV_32F mat)."""
    return np.clip(np.rint(np.asarray(v)), 0, 255).astype(np.uint8)
