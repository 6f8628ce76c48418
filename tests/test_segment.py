"""In-order segment sums (ops/segment.py): the GPU fold kernel in interpret
mode against a sequential fold, the CPU scatter, and the plain-loop oracles
of its two users (ground-sector sums, voxel centroids)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pctpu.ops import segment
from pctpu.ops.segment import ordered_segment_sum
from pctpu.runtime import platform

from . import ref_impl


def sequential_fold(ids, vals, nseg):
    """``np.add.at`` adds in index order, in f32."""
    acc = np.zeros((nseg + 1, vals.shape[1]), np.float32)
    np.add.at(acc, ids, vals.astype(np.float32))
    return acc[:nseg]


@pytest.fixture
def fold_kernel_interpret(monkeypatch):
    """Production callers routed through the GPU fold kernel, run in the
    Pallas interpreter."""
    monkeypatch.setattr(segment, "platform_choice",
                        lambda: platform.platform_choice("gpu"))
    fold = segment._fold_pallas
    monkeypatch.setattr(segment, "_fold_pallas",
                        lambda v, i, n, interpret=False: fold(v, i, n, True))


def _sorted_case(seed, p=3000, nseg=200, ch=3, skip=0.1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, nseg, p)
    ids[rng.random(p) < skip] = nseg  # skipped points
    ids = np.sort(ids, kind="stable").astype(np.int32)
    vals = (rng.normal(0, 50, (p, ch)) * rng.random((p, 1)) ** 3).astype(
        np.float32)
    return ids, vals, nseg


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_kernel_matches_sequential_and_scatter(seed):
    ids, vals, nseg = _sorted_case(seed)
    ref = sequential_fold(ids, vals, nseg)
    got = ordered_segment_sum(jnp.asarray(vals), jnp.asarray(ids), nseg,
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(got), ref)
    # the CPU form (a scatter-add the CPU backend applies in order)
    cpu = ordered_segment_sum(jnp.asarray(vals), jnp.asarray(ids), nseg)
    np.testing.assert_array_equal(np.asarray(cpu), ref)


def test_fold_order_is_sequential_not_a_tree():
    """Values whose sum rounds differently in point order and in a pairwise
    tree: ((1e8 + 1) + -1e8) + 1 = 1 in f32, (1e8 + 1) + (-1e8 + 1) = 0."""
    vals = np.float32([[1e8], [1.0], [-1e8], [1.0], [2.0]])
    ids = np.int32([0, 0, 0, 0, 1])
    tree = (np.float32(1e8) + np.float32(1.0)) + (np.float32(-1e8)
                                                  + np.float32(1.0))
    assert tree == np.float32(0.0)
    got = np.asarray(ordered_segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         2, interpret=True))
    np.testing.assert_array_equal(got, np.float32([[1.0], [2.0]]))


def test_fold_kernel_empty_segments_and_lane_blocks():
    """Segments with no points read 0; segment counts that are not a
    multiple of the kernel's lane block are handled."""
    ids = np.int32([1, 1, 130, 130, 130, 257, 300, 300])
    vals = np.arange(8, dtype=np.float32)[:, None] + 0.25
    got = np.asarray(ordered_segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         300, interpret=True))
    ref = sequential_fold(ids, vals, 300)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 0.0 and got[299, 0] == 0.0


def test_fold_kernel_vmapped():
    cases = [_sorted_case(s, p=500, nseg=70) for s in (2, 3)]
    ids = jnp.asarray(np.stack([c[0] for c in cases]))
    vals = jnp.asarray(np.stack([c[1] for c in cases]))
    got = jax.vmap(lambda v, i: ordered_segment_sum(v, i, 70,
                                                    interpret=True))(vals, ids)
    for k, (i, v, n) in enumerate(cases):
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      sequential_fold(i, v, n))


def test_fold_kernel_lowers_for_cuda():
    """The kernel passes the Triton lowering rules for a CUDA target (no GPU
    needed to lower; the card compiles what this emits)."""
    v = jax.ShapeDtypeStruct((4096, 3), jnp.float32)
    i = jax.ShapeDtypeStruct((4096,), jnp.int32)
    f = jax.jit(functools.partial(segment._fold_pallas, num_segments=500))
    text = f.trace(v, i).lower(lowering_platforms=("cuda",)).as_text()
    assert "ordered_segment_fold" in text


def test_mark_ground_with_fold_kernel_matches_oracle(fold_kernel_interpret):
    """Bit-exact ground marking through the fold kernel == the plain-loop
    oracle (point-order f32 sector sums, the reference's
    BatchMultiBevGen.cpp:187-210)."""
    from pctpu.ops.ground import mark_ground
    from pctpu.ops.ordering import get_ordered_cloud

    from .test_fuzz_differential import REGIMES, _regime_points
    from .test_ops_preprocess import SMALL, ordered_ref_arrays, to_cloud

    for regime in (1, 3):
        n, neg1, z_lo, z_hi, r_lo, r_hi = REGIMES[regime]
        rng = np.random.default_rng(500 + regime)
        pts = _regime_points(rng, n, neg1, z_lo, z_hi, r_lo, r_hi, SMALL)
        ref_cloud, _ = ordered_ref_arrays(pts, SMALL)
        ref_impl.mark_ground_ref(ref_cloud, SMALL.n_scan, SMALL.horizon_scan,
                                 SMALL.ground_upper_scan)
        labeled, _ = mark_ground(get_ordered_cloud(to_cloud(pts), SMALL),
                                 SMALL)
        np.testing.assert_array_equal(
            np.asarray(labeled.label),
            np.array([p["label"] for p in ref_cloud], np.int32),
        )


def test_grid_sums_with_fold_kernel_are_sequential(fold_kernel_interpret):
    """The sector sums themselves, kernel path against a sequential fold of
    z in point order and the count table's sequential ones-fold."""
    from pctpu.config import GroundConfig
    from pctpu.ops.ground import _grid_sums_bitexact

    cfg = GroundConfig()
    nsec = cfg.grid_rows * cfg.grid_cols
    rng = np.random.default_rng(0)
    p = 20_000
    sector = rng.integers(0, 60, p).astype(np.int32)  # long runs per sector
    z = rng.uniform(-2.5, 0.5, p).astype(np.float32)
    z[::7] = 0.0
    ground = rng.random(p) < 0.6
    got = np.asarray(_grid_sums_bitexact(sector, z, ground, cfg))
    zref = sequential_fold(np.where(ground, sector, nsec),
                           np.where(ground, z, 0.0)[:, None], nsec)[:, 0]
    np.testing.assert_array_equal(got[:, 0], zref)
    counts = np.full(nsec, np.float32(cfg.count_epsilon))
    for s in sector[ground]:
        counts[s] = np.float32(counts[s] + np.float32(1.0))
    np.testing.assert_array_equal(got[:, 1], counts)


def test_voxel_with_fold_kernel_matches_oracle(fold_kernel_interpret):
    """Voxel centroids through the fold kernel == pcl::VoxelGrid semantics
    (sequential f32 accumulation in stable input order, README D14)."""
    from pctpu.ops.voxel import voxel_downsample

    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 10, (600, 3)).astype(np.float32)
    ref = ref_impl.voxel_ref(pts, 1.0)
    out, _, count = voxel_downsample(pts, np.ones(600, bool), 1.0)
    assert int(count) == len(ref)
    np.testing.assert_array_equal(np.asarray(out)[: int(count)], ref)
