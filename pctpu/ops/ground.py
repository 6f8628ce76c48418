"""Ground marking: slope test per column + grid-average heights + rooftop veto.

Reproduces ``markGroundPoints`` (/root/reference/BatchMultiBevGen.cpp:119-252)
bit-for-bit as three fused, fully-vectorized passes with almost no dynamic
gathers or scatters:

1. **Slope sweep**: the reference compares each swept cell to the cell one
   ring up, falling back to col+2, col-2, then row-2 when the upper reading
   is missing (``intensity == -1``, :146-160).  All four candidate positions
   are *static offsets* in the flattened range image, so the value selection
   becomes slices/rolls + elementwise ``where`` — no gathers:
     u0 = p - H          (row above)
     u1 = row-roll(-2) of u0   ((col+2) % H stays in the row)
     u2 = p - H - 2      (the C++ (col-2) % H is negative for col < 2 and
                          walks into the previous row — i.e. a *flat* shift)
     u3 = p - 2H         (two rings up)
   The sequential bottom-up write pattern collapses to a closed form: a swept
   cell is -1 if its own pair is invalid, else 1 if its own test or the test
   of the cell below passed; the row above the sweep is written only by the
   sweep's top row.
2. **Grid averages**: per-sector z sums folded in point order and exact
   counts over the 75×50 2-metre grid (:187-210), with the 0.01 count
   epsilon (:135-136).
3. **Rooftop veto + labels**: the reference un-marks any cell > 0.30 m above
   the average of *any* valid 4-neighbor sector (:227-241) — equivalently,
   above the *minimum* valid neighbor average, which is a cheap (75, 50)
   shifted-min table and a single per-point gather.  The comparison keeps the
   exact C++ semantics: the f32 difference is compared against the double
   0.30, and f32(0.30) > 0.30 in f64, so ``diff > 0.30`` ⟺ ``diff >= f32(0.30)``.

Empty grid cells are all-zero points and participate exactly like in the
reference (zero coords pass the slope test, land in grid sector (37, 25)).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pctpu.cloud import Cloud
from pctpu.config import GroundConfig, SensorParams
from pctpu.ops.segment import ordered_segment_sum


def _strict_gt_f32_threshold(margin: float) -> np.float32:
    """Smallest f32 strictly greater than the f64 ``margin``.

    C++ semantics: the f32 rooftop difference is promoted to double and
    compared strictly against the double margin
    (/root/reference/BatchMultiBevGen.cpp:227-241).  For f32-valued d,
    ``d > m`` ⟺ ``d >= d0`` with d0 as returned here — for the default 0.30,
    f32(0.30) > 0.30 so d0 = f32(0.30); an exactly f32-representable margin
    like 0.25 needs one nextafter step so the comparison stays strict.
    """
    m64 = float(margin)
    m32 = np.float32(m64)
    # NB: compare in f64 explicitly — NumPy 2 weak promotion would otherwise
    # round m64 down to f32 and make the comparison trivially false
    if float(m32) > m64:
        return m32
    return np.nextafter(m32, np.float32(np.inf))


def _grid_table_lookup(
    table2d: jnp.ndarray, row: jnp.ndarray, col: jnp.ndarray
) -> jnp.ndarray:
    """table2d[row, col] via *factorized* one-hot contractions (two matmuls).

    A flat one-hot against an (R·C)-entry table costs P·R·C elementwise
    comparisons to build; factorizing into row/col one-hots costs P·(R+C) —
    30× fewer for the 75×50 ground grid — followed by two small
    contractions: ``(P,R) @ (R,C) → (P,C)``, then a masked row-sum against
    the col one-hot.  Exact: each one-hot row selects a single f32 value
    (Precision.HIGHEST keeps the f32 copy path; no accumulation happens as
    only one product per output is nonzero).
    """
    r, c = table2d.shape
    oh_row = (row[:, None] == jnp.arange(r, dtype=row.dtype)[None, :]).astype(
        jnp.float32
    )
    oh_col = (col[:, None] == jnp.arange(c, dtype=col.dtype)[None, :]).astype(
        jnp.float32
    )
    per_col = jax.lax.dot_general(
        oh_row,
        table2d,
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (P, C): value of table2d[row_p, :] per point
    return jnp.sum(per_col * oh_col, axis=1)


def _belonging_grid(x: jnp.ndarray, y: jnp.ndarray, cfg: GroundConfig):
    """Point → ground-grid sector (/root/reference/BatchMultiBevGen.h:73-99).

    The C++ stores ``x + 75.0`` into a *float* local (one f32 rounding —
    identical to an f32 add) and then floors the double quotient ``/ 2.0``;
    division by the default power-of-two cell is exact in f32, so the f32
    add + f32 divide below reproduces it bit-for-bit.
    """
    row = jnp.floor(
        (x + jnp.float32(cfg.offset_x)) / jnp.float32(cfg.cell_size)
    ).astype(jnp.int32)
    col = jnp.floor(
        (y + jnp.float32(cfg.offset_y)) / jnp.float32(cfg.cell_size)
    ).astype(jnp.int32)
    row = jnp.clip(row, 0, cfg.grid_rows - 1)
    col = jnp.clip(col, 0, cfg.grid_cols - 1)
    return row, col


@functools.lru_cache(maxsize=None)
def _ones_fold_table(n_max: int, eps: float) -> np.ndarray:
    """f32 values of ((eps + 1) + 1) + … after k additions, k = 0..n_max
    (``np.cumsum`` accumulates sequentially in the array's dtype)."""
    steps = np.ones(n_max + 1, np.float32)
    steps[0] = np.float32(eps)
    return np.cumsum(steps, dtype=np.float32)


def _grid_sums_bitexact(
    sector: jnp.ndarray, z: jnp.ndarray, ground: jnp.ndarray, cfg: GroundConfig
) -> jnp.ndarray:
    """Sequential-rounding (z, count) sector sums.

    Bit-exact vs the C++ point-order accumulation
    (the reference's BatchMultiBevGen.cpp:187-210):

    * z folds in point order per sector (``ops/segment.py``) after a
      stable sort by sector.  Points with z == 0 (among them every empty
      grid cell, which all land in one sector) leave a sum that never holds
      -0.0 unchanged, so they are skipped and that sector's run stays
      short;
    * the count accumulator starts AT the 0.01 epsilon (cv::Mat init,
      :135-136) and adds 1.0 per ground point — the same addend every step,
      so its value depends on the exact integer count alone and is read
      from the table of sequential folds.  (((0.01+1)+1)+…) rounds
      differently from exact_count + 0.01 once counts reach 32.
    """
    nsec = cfg.grid_rows * cfg.grid_cols
    fold_ids, z_s = jax.lax.sort(
        [jnp.where(ground & (z != 0.0), sector, nsec), z], num_keys=1,
        is_stable=True,
    )
    zsum = ordered_segment_sum(z_s[:, None], fold_ids, nsec)[:, 0]
    n = jnp.zeros((nsec + 1,), jnp.int32).at[jnp.where(ground, sector, nsec)].add(1)
    table = jnp.asarray(_ones_fold_table(z.shape[0], cfg.count_epsilon))
    return jnp.stack([zsum, table[n[:nsec]]], axis=1)


def _grid_sums_tolerance(
    srow: jnp.ndarray,
    scol: jnp.ndarray,
    z: jnp.ndarray,
    ground: jnp.ndarray,
    cfg: GroundConfig,
) -> jnp.ndarray:
    """Matmul segment-sum of the (z, count) sector accumulators.

    Factorized one-hot contraction: building (P, R) + (P, C) one-hots costs
    P·(R+C) comparisons (30× less than a flat (P, R·C) one-hot), then ONE
    dot_general ``(2R, P) @ (P, C) → (2R, C)`` puts all the accumulation in
    one matmul.  Non-ground points contribute exact zeros to both channels, so
    no masking of the one-hots is needed.

    Divergence vs the C++: f32 sums accumulate in the matmul's tree order
    instead of point order, and the count epsilon is added once at the end
    instead of seeding the accumulator — both ~1e-5-relative effects on the
    sector *averages*, which only feed the >0.30 m rooftop-veto threshold
    (north-star tolerance <1 px BEV, BASELINE.json:5; knife-edge label flips
    are bounded by the fuzz suite, tests/test_compat_tolerance.py).
    """
    r, c = cfg.grid_rows, cfg.grid_cols
    oh_row = (srow[:, None] == jnp.arange(r, dtype=srow.dtype)).astype(jnp.float32)
    oh_col = (scol[:, None] == jnp.arange(c, dtype=scol.dtype)).astype(jnp.float32)
    gmask = ground.astype(jnp.float32)
    zg = jnp.where(ground, z, 0.0)
    lhs = jnp.concatenate(
        [oh_row * zg[:, None], oh_row * gmask[:, None]], axis=1
    )  # (P, 2R): z-weighted and count-weighted row one-hots
    both = jax.lax.dot_general(
        lhs,
        oh_col,
        (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )  # (2R, C)
    zsum = both[:r].reshape(r * c)
    count = both[r:].reshape(r * c) + jnp.float32(cfg.count_epsilon)
    return jnp.stack([zsum, count], axis=1)


def mark_ground(
    ordered: Cloud,
    params: SensorParams,
    cfg: GroundConfig = GroundConfig(),
    compat: str = "bitexact",
) -> tuple[Cloud, jnp.ndarray]:
    """Label ground points 0 in a dense ordered cloud.

    Returns (cloud with updated labels, ground_mat int8 (n_scan, horizon_scan))
    with the reference encoding {-1 invalid, 0 no, 1 ground}.

    ``compat`` selects the sector-average accumulation: ``"bitexact"``
    (default) reproduces the C++ f32 rounding sequence with an in-order
    fold (``ops/segment.py``); ``"tolerance"`` uses a one-hot matmul
    segment-sum (~1e-5-relative average divergence, within the
    BASELINE.json:5 acceptance window).
    """
    if compat not in ("bitexact", "tolerance"):
        raise ValueError(f"compat must be 'bitexact' or 'tolerance', got {compat!r}")
    n, h = params.n_scan, params.horizon_scan
    g = n * h
    if params.ground_upper_scan >= n - 1:
        raise ValueError("ground_upper_scan must leave at least two rows above")

    flat = {
        "x": ordered.xyz[:, 0],
        "y": ordered.xyz[:, 1],
        "z": ordered.xyz[:, 2],
        "i": ordered.intensity,
    }
    r_min = n - params.ground_upper_scan  # lowest swept row index

    # --- pass 1: slope test via static shifts ------------------------------
    # candidate value planes for the swept rows [r_min, n), all (R, H)
    def rows2d(arr):
        return arr.reshape(n, h)

    def swept(arr2d):
        return arr2d[r_min:]

    def u0(arr2d):  # row above
        return arr2d[r_min - 1 : n - 1]

    def u1(arr2d):  # (col+2) % H on the row above
        return jnp.roll(u0(arr2d), shift=-2, axis=1)

    def u2(arr):  # flat index p - H - 2 (crosses row edges like the C++)
        return jnp.roll(arr, 2).reshape(n, h)[r_min - 1 : n - 1]

    def u3(arr2d):  # two rows above
        return arr2d[r_min - 2 : n - 2]

    planes2d = {k: rows2d(v) for k, v in flat.items()}
    cand = {}
    for k in ("x", "y", "z", "i"):
        cand[k] = (u0(planes2d[k]), u1(planes2d[k]), u2(flat[k]), u3(planes2d[k]))

    rr = jnp.arange(r_min, n)[:, None]  # row index per swept row
    i_up = cand["i"][0]
    sel1 = i_up == -1
    i_up = jnp.where(sel1, cand["i"][1], i_up)
    sel2 = i_up == -1
    i_up = jnp.where(sel2, cand["i"][2], i_up)
    sel3 = (i_up == -1) & (rr >= 2)
    i_up = jnp.where(sel3, cand["i"][3], i_up)

    def select(k):
        v = cand[k][0]
        v = jnp.where(sel1, cand[k][1], v)
        v = jnp.where(sel2, cand[k][2], v)
        v = jnp.where(sel3, cand[k][3], v)
        return v

    lo = {k: swept(planes2d[k]) for k in ("x", "y", "z", "i")}
    invalid = (lo["i"] == -1) | (i_up == -1)
    dx = select("x") - lo["x"]
    dy = select("y") - lo["y"]
    dz = select("z") - lo["z"]
    angle = jnp.degrees(jnp.arctan2(dz, jnp.sqrt(dx * dx + dy * dy)))
    slope_ok = (~invalid) & (jnp.abs(angle) <= cfg.slope_deg)

    # closed form of the sequential bottom-up writes: rows r_min..n-2 are
    # covered by swept_vals below, so the "marked from the cell below" write
    # only needs to land on row r_min-1 (the one row above the sweep)
    ground_from_below = jnp.zeros((n, h), bool)
    ground_from_below = ground_from_below.at[r_min - 1 : n - 1].set(slope_ok)
    mark = jnp.zeros((n, h), jnp.int8)
    mark = mark.at[r_min - 1].set(
        ground_from_below[r_min - 1].astype(jnp.int8)
    )
    swept_vals = jnp.where(
        invalid,
        jnp.int8(-1),
        (slope_ok | ground_from_below[r_min:]).astype(jnp.int8),
    )
    mark = mark.at[r_min:].set(swept_vals)

    ground1 = (mark == 1).reshape(g)

    # --- pass 2: grid-average ground heights (one fused scatter-add) -------
    # only rows >= r_min-1 can carry mark==1, so passes 2-3 slice to the
    # swept band: ~20% fewer scatter updates and lookups, and skipping the
    # zero-adds of the untouched rows matches the C++ exactly (it only
    # accumulates for ground cells, :187-210)
    lo0 = (r_min - 1) * h
    swept_slice = slice(lo0, g)
    x_sw = flat["x"][swept_slice]
    y_sw = flat["y"][swept_slice]
    z_sw = flat["z"][swept_slice]
    ground_sw = ground1[swept_slice]
    srow, scol = _belonging_grid(x_sw, y_sw, cfg)
    if compat == "bitexact":
        sector = srow * cfg.grid_cols + scol
        sums = _grid_sums_bitexact(sector, z_sw, ground_sw, cfg)
    else:
        sums = _grid_sums_tolerance(srow, scol, z_sw, ground_sw, cfg)
    avg = (sums[:, 0] / sums[:, 1]).reshape(cfg.grid_rows, cfg.grid_cols)

    # --- pass 3: rooftop veto (min valid-neighbor average) + labels --------
    big = jnp.float32(jnp.finfo(jnp.float32).max)
    # corrupt-input guard: a ±inf average (overflowed sector sum) would turn
    # the one-hot lookup's 0·inf products into NaN for EVERY query.  Mapping
    # NaN→+big (never vetoes, like the C++ `NaN > 0.3` = false) and ±inf→±big
    # (saturated subtraction keeps the veto decision) reproduces the per-
    # neighbor C++ comparisons (:227-241) without cloud-wide poisoning.
    avg = jnp.nan_to_num(avg, nan=big, posinf=big, neginf=-big)
    padded = jnp.pad(avg, 1, constant_values=big)
    # setNeighbors order (:73-84) is irrelevant under the min formulation
    nbr_min = jnp.minimum(
        jnp.minimum(padded[:-2, 1:-1], padded[2:, 1:-1]),
        jnp.minimum(padded[1:-1, :-2], padded[1:-1, 2:]),
    )
    m_per_point = _grid_table_lookup(nbr_min, srow, scol)
    veto_sw = (z_sw - m_per_point) >= jnp.float32(
        _strict_gt_f32_threshold(cfg.rooftop_margin)
    )
    veto = jnp.zeros((g,), bool).at[swept_slice].set(veto_sw)
    mark = jnp.where(veto.reshape(n, h), jnp.int8(0), mark)

    is_ground = (mark == 1).reshape(g)
    label = jnp.where(is_ground, 0, ordered.label)
    return ordered.replace(label=label), mark
