"""The fine-stage NN kernel (ops/pallas_knn.py, Pallas on the Triton route)
in interpret mode against the plain reference ``ops.knn.nn_1`` and brute
force.  The compiled kernel runs on a GPU only: ``chip_smoke.py`` checks it
there at 49k x 49k."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pctpu.ops.knn import nn_1
from pctpu.ops.pallas_knn import (
    check_against_nn_1,
    pallas_nn_1_pruned,
    spatial_sort,
)

nn_interp = functools.partial(pallas_nn_1_pruned, interpret=True)


@pytest.fixture
def icp_kernel_interpret(monkeypatch):
    """ICP's nn_impl="pruned" path with the kernel in the interpreter."""
    import pctpu.ops.icp as icp_mod

    monkeypatch.setattr(icp_mod, "pallas_nn_1_pruned", nn_interp)


def _sorted_clouds(seed, nq, nt, span=50.0, drop=0.1):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-span, span, (nq, 3)).astype(np.float32)
    t = rng.uniform(-span, span, (nt, 3)).astype(np.float32)
    qm = rng.random(nq) >= drop
    tm = rng.random(nt) >= drop
    qs, qsm, _ = spatial_sort(jnp.asarray(q), jnp.asarray(qm))
    ts, tsm, _ = spatial_sort(jnp.asarray(t), jnp.asarray(tm))
    return qs, qsm, ts, tsm


def test_pruned_nn_matches_bruteforce():
    """Masked targets (a whole tail tile among them) are never chosen."""
    rng = np.random.default_rng(0)
    q = rng.uniform(-10, 10, (200, 3)).astype(np.float32)
    t = rng.uniform(-10, 10, (600, 3)).astype(np.float32)
    tm = np.ones(600, bool)
    tm[550:] = False
    idx, d2 = nn_interp(q, np.ones(200, bool), t, tm, tq=64, tt=128)
    full = ((q[:, None] - t[None]) ** 2).sum(-1)
    full[:, ~tm] = np.inf
    np.testing.assert_array_equal(np.asarray(idx), full.argmin(1))
    np.testing.assert_allclose(np.asarray(d2), full.min(1), rtol=1e-6, atol=1e-7)


def test_pruned_nn_masked_queries():
    rng = np.random.default_rng(1)
    q = rng.uniform(-5, 5, (130, 3)).astype(np.float32)
    t = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    qm = np.ones(130, bool)
    qm[100:] = False
    idx, d2 = nn_interp(q, qm, t, np.ones(300, bool))
    assert np.all(np.isinf(np.asarray(d2)[100:]))
    assert np.all(np.isfinite(np.asarray(d2)[:100]))


def test_pruned_nn_exact_no_threshold():
    qs, qsm, ts, tsm = _sorted_clouds(0, 700, 900)
    i_ref, d_ref = nn_1(qs, qsm, ts, tsm)
    i_p, d_p = nn_interp(qs, qsm, ts, tsm, max_distance=None, tq=128, tt=256)
    valid = np.asarray(qsm)
    np.testing.assert_array_equal(np.asarray(i_ref)[valid], np.asarray(i_p)[valid])
    np.testing.assert_allclose(
        np.asarray(d_ref)[valid], np.asarray(d_p)[valid], rtol=0, atol=0
    )


@pytest.mark.parametrize("md", [2.0, 8.0])
def test_pruned_nn_threshold_semantics(md):
    qs, qsm, ts, tsm = _sorted_clouds(1, 600, 800, drop=0.0)
    i_ref, d_ref = nn_1(qs, qsm, ts, tsm)
    i_p, d_p = nn_interp(qs, qsm, ts, tsm, max_distance=md, tq=128, tt=256)
    d_ref, d_p = np.asarray(d_ref), np.asarray(d_p)
    within = d_ref <= md * md
    # within the threshold: exact NN; beyond: either +inf or a (rejected)
    # candidate farther than the threshold
    np.testing.assert_array_equal(np.asarray(i_ref)[within], np.asarray(i_p)[within])
    np.testing.assert_allclose(d_ref[within], d_p[within], rtol=0, atol=0)
    beyond = ~within
    assert np.all(~np.isfinite(d_p[beyond]) | (d_p[beyond] > md * md))


@pytest.mark.parametrize("tiles", [(32, 32), (64, 128), (128, 64)])
def test_pruned_nn_tile_sizes_agree(tiles):
    """Every tile shape the GPU sweep tries gives the reference's answer,
    with the last query and target tiles partly padding."""
    tq, tt = tiles
    qs, qsm, ts, tsm = _sorted_clouds(21, 333, 517)
    ref = nn_1(qs, qsm, ts, tsm)
    for md in (None, 3.0):
        got = nn_interp(qs, qsm, ts, tsm, max_distance=md, tq=tq, tt=tt)
        assert check_against_nn_1(ts, ref, got, max_distance=md) == 0


def test_pruned_nn_vmapped_matches_single():
    """vmap over a pair batch (how the registration stages call it) gives
    each pair's single-call result."""
    pairs = [_sorted_clouds(s, 300, 400) for s in (3, 4, 5)]
    stacked = [jnp.stack(x) for x in zip(*pairs)]
    for md in (None, 2.0):
        b_idx, b_d2 = jax.vmap(
            functools.partial(nn_interp, max_distance=md))(*stacked)
        for k, p in enumerate(pairs):
            idx, d2 = nn_interp(*p, max_distance=md)
            np.testing.assert_array_equal(np.asarray(b_idx[k]), np.asarray(idx))
            np.testing.assert_array_equal(np.asarray(b_d2[k]), np.asarray(d2))


def test_check_against_nn_1_rejects_wrong_winners():
    """The on-GPU comparison helper passes the reference against itself and
    fails a result with a far winner or a wrong distance."""
    qs, qsm, ts, tsm = _sorted_clouds(6, 300, 400, drop=0.0)
    ref = tuple(np.asarray(a) for a in nn_1(qs, qsm, ts, tsm))
    assert check_against_nn_1(ts, ref, ref) == 0
    idx, d2 = ref[0].copy(), ref[1].copy()
    idx[:5] = (idx[:5] + 200) % 400  # far-away winners
    d2[:5] += 100.0
    with pytest.raises(AssertionError, match="window"):
        check_against_nn_1(ts, ref, (idx, d2))
    d2 = ref[1].copy()
    d2[0] = np.nextafter(d2[0], np.float32(np.inf))
    with pytest.raises(AssertionError, match="distances differ"):
        check_against_nn_1(ts, ref, (ref[0], d2))


def test_icp_pruned_nn_matches_xla(icp_kernel_interpret):
    """Full ICP through the pruned-NN path == the XLA path (same scene as the
    oracle tests; spatial sorting only permutes reduction order)."""
    from pctpu.config import IcpConfig
    from pctpu.ops.icp import icp_point_to_point

    from .test_icp_differential import scene

    src, tgt = scene(42)
    sm = np.ones(len(src), bool)
    tm = np.ones(len(tgt), bool)
    guess = np.eye(4, dtype=np.float32)
    cfg = IcpConfig(max_correspondence_distance=4.0, max_iterations=8)
    a = icp_point_to_point(src, sm, tgt, tm, guess, cfg, nn_impl="xla")
    b = icp_point_to_point(src, sm, tgt, tm, guess, cfg, nn_impl="pruned")
    assert bool(a.converged) == bool(b.converged)
    np.testing.assert_allclose(np.asarray(a.transform), np.asarray(b.transform),
                               atol=1e-5)
    np.testing.assert_allclose(float(a.fitness), float(b.fitness), rtol=1e-4)


def test_pruned_nn_tie_breaks_to_lowest_index():
    """Exactly equidistant targets in different t-tiles: the winner must be
    the lowest global index (ops.knn.nn_1 convention), independent of the
    kernel's diagonal-start visit order."""
    # target layout chosen directly in sorted order (no spatial_sort: we
    # need controlled tile placement).  Tile size 256 -> targets 0 and 256
    # land in different tiles.
    t = np.full((512, 3), 50.0, np.float32)
    t[0] = [1.0, 0.0, 0.0]
    t[256] = [-1.0, 0.0, 0.0]  # same distance from the origin query
    q = np.zeros((128, 3), np.float32)
    tm = np.ones(512, bool)
    qm = np.zeros(128, bool)
    qm[0] = True
    idx, d2 = nn_interp(q, qm, jnp.asarray(t), tm, max_distance=None,
                        tq=128, tt=256)
    assert int(np.asarray(idx)[0]) == 0
    np.testing.assert_allclose(float(np.asarray(d2)[0]), 1.0, rtol=1e-6)


def test_icp_pruned_nan_normal_not_poisoning(icp_kernel_interpret):
    """A NaN normal on an excluded target (normal_mask False) plus masked
    source padding must not NaN-poison the point-to-plane solve through the
    pruned path's idx=0 convention for unmatched queries."""
    from pctpu.config import IcpConfig
    from pctpu.ops.icp import icp_point_to_plane

    rng = np.random.default_rng(3)
    n = 80
    u = rng.uniform(-6, 6, n)
    wall = rng.integers(0, 2, n)
    x = np.where(wall == 0, u, -4.0 + rng.normal(0, 0.01, n))
    y = np.where(wall == 0, 4.0 + rng.normal(0, 0.01, n), u)
    tgt = np.stack([x, y, np.zeros(n)], 1).astype(np.float32)
    nrm = np.where(
        wall[:, None] == 0,
        np.array([[0.0, 1.0, 0.0]], np.float32),
        np.array([[1.0, 0.0, 0.0]], np.float32),
    ).astype(np.float32)
    ok = np.ones(n, bool)
    # one excluded target with a NaN normal (the reference's isolated-point
    # case); make its coordinates extreme so Morton sorting parks it at a
    # tile the unmatched-idx convention can land on
    tgt[0] = [-100.0, -100.0, 0.0]
    nrm[0] = np.nan
    ok[0] = False
    src = (tgt[5:65] - np.float32([0.2, -0.1, 0.0])).astype(np.float32)
    # masked padding sources (unmatched -> idx 0 inside the kernel)
    sm = np.ones(60, bool)
    sm[55:] = False
    cfg = IcpConfig(max_correspondence_distance=2.0, max_iterations=6,
                    point_to_plane=True)
    guess = np.eye(4, dtype=np.float32)
    a = icp_point_to_plane(src, sm, tgt, np.ones(n, bool), nrm, ok, guess,
                           cfg, nn_impl="xla")
    b = icp_point_to_plane(src, sm, tgt, np.ones(n, bool), nrm, ok, guess,
                           cfg, nn_impl="pruned")
    for r in (a, b):
        assert np.isfinite(np.asarray(r.transform)).all()
        assert np.isfinite(float(r.fitness))
    np.testing.assert_allclose(np.asarray(a.transform), np.asarray(b.transform),
                               atol=1e-5)


@pytest.mark.gpu
def test_pruned_nn_compiled_matches_nn_1(gpu):
    """The compiled kernel against nn_1 on the card, at a fine-stage width."""
    with jax.default_device(gpu):
        qs, qsm, ts, tsm = _sorted_clouds(7, 8192, 8192, span=70.0, drop=0.0)
        ref = jax.device_get(nn_1(qs, qsm, ts, tsm))
        for md in (None, 1.0):
            got = jax.device_get(pallas_nn_1_pruned(qs, qsm, ts, tsm,
                                                    max_distance=md))
            check_against_nn_1(ts, ref, got, max_distance=md)


@pytest.mark.parametrize("md", [None, 1.0])
def test_pruned_nn_lowers_for_cuda(md):
    """The kernel, alone and vmapped over a pair batch, passes the Triton
    lowering rules for a CUDA target (lowering needs no GPU; the card
    compiles what this emits)."""
    q = jax.ShapeDtypeStruct((4, 4096, 3), jnp.float32)
    m = jax.ShapeDtypeStruct((4, 4096), jnp.bool_)
    f = functools.partial(pallas_nn_1_pruned, max_distance=md)
    for fn, args in ((jax.jit(f), (q.update(shape=q.shape[1:]),
                                   m.update(shape=m.shape[1:]))),
                     (jax.jit(jax.vmap(f)), (q, m))):
        text = fn.trace(args[0], args[1], args[0], args[1]).lower(
            lowering_platforms=("cuda",)).as_text()
        assert "nn_1_pruned" in text
