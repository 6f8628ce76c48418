"""End-to-end two-stage registration differential: the production
``register_pair`` vs the COMPOSED plain-loop oracle
(``ref_impl.two_stage_ref``) on synthetic structured scenes.

Every stage already has its own differential test; this closes the remaining
gap — the *glue*: stage wiring, the f32 guess chain, best-of-two selection,
fine-stage seeding, and the success classification
(/root/reference/BatchTopPartRegistration.cpp:356-532).

Knife-edge policy (extending tests/test_icp_differential.py's): a scene only
asserts when the oracle's behavior is stable under a 1e-6 source perturbation
AND the trajectories that matter are well-posed (every transform-updating
iteration of the WINNING coarse guess and the fine stage had >=16
correspondences — see _MIN_WELLPOSED_NCORR).  Assertion strength then depends
on the regime: ANCHORED scenes (winner coarse fitness < 1 — genuine
registrations) get the full transform/fitness/report asserts; degenerate
scenes (non-matching pairs, spurious correspondences) get only the contracts
that survive implementation-defined trajectory drift — fitness within 50% and
the success classification when the oracle's fine fitness is not near the
1.5 threshold.  The C++ binary drifts from an f64 oracle the same way on
those scenes (docs/PARITY.md "Underdetermined ICP estimation steps").
"""

import math

import numpy as np
import pytest

from pctpu.cloud import make_cloud
from pctpu.config import WHOLE_ICP, RegistrationConfig
from pctpu.pipelines.registration import (
    _pair_precision,
    register_pair,
    register_whole_pairs,
)

from . import ref_impl


def twostage_scene(seed: int, n_clusters: int = 6, pts_per_cluster: int = 110,
                   n_ground: int = 900):
    """Buildings (label -2, >=20 pts per 20 m top-part cell) + ground points
    (label 0), cloud_2 = the same scene under a known rigid yaw+shift with
    small noise.  Returns (xyz1, labels1, xyz2, labels2, guess_deg,
    true_yaw_deg)."""
    rng = np.random.default_rng(seed)
    pts, labels = [], []
    for _ in range(n_clusters):
        cx, cy = rng.uniform(-45, 45, 2)
        pts.append(
            np.stack(
                [
                    cx + rng.normal(0, 2.0, pts_per_cluster),
                    cy + rng.normal(0, 2.0, pts_per_cluster),
                    rng.uniform(0.5, 8.0, pts_per_cluster),
                ],
                axis=1,
            )
        )
        labels.append(np.full(pts_per_cluster, -2))
    pts.append(
        np.stack(
            [
                rng.uniform(-60, 60, n_ground),
                rng.uniform(-60, 60, n_ground),
                rng.uniform(-2.0, -1.9, n_ground),
            ],
            axis=1,
        )
    )
    labels.append(np.zeros(n_ground))
    xyz = np.concatenate(pts).astype(np.float32)
    lab = np.concatenate(labels).astype(np.int32)

    if seed % 5 == 4:
        # non-matching pair: cloud_2 is an unrelated scene, so the fine
        # fitness should classify the pair as a failure (> 1.5, :508-510)
        xyz2, lab2, _, _, _, _ = twostage_scene(seed + 77_001)
        guess = float(rng.uniform(-180, 180))
        return xyz, lab, xyz2, lab2, guess, float("nan")

    true_yaw = float(rng.uniform(-40, 40))
    shift = rng.uniform(-1.5, 1.5, 3).astype(np.float32)
    shift[2] = 0.0
    th = math.radians(true_yaw)
    c, s = math.cos(th), math.sin(th)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    xyz2 = (xyz @ rot.T + shift).astype(np.float32)
    xyz2 = xyz2 + rng.normal(0, 0.02, xyz2.shape).astype(np.float32)
    guess = true_yaw + float(rng.uniform(-12, 12))
    # half the seeds approach via the +180 flip (the second coarse guess
    # must win, :464)
    if seed % 2:
        guess -= 180.0
    return xyz, lab, xyz2, lab, guess, true_yaw


def to_dicts(xyz: np.ndarray, labels: np.ndarray) -> list[dict]:
    return [
        {"x": float(p[0]), "y": float(p[1]), "z": float(p[2]),
         "label": int(l)}
        for p, l in zip(xyz, labels)
    ]


# Minimum correspondences for a WELL-POSED estimation step.  The coarse
# point-to-plane LLS solves a 6-DoF normal system regularized by 1e-12*I
# (PCL TransformationEstimationPointToPlaneLLS does the same); with fewer
# constraints than ~2-3x the DoF the system is singular/ill-conditioned and
# the solution's near-null-space components are implementation-defined —
# in PCL/Eigen exactly as here (observed: identical correspondence sets,
# transforms apart by O(1) between an f64 loop and the f32 op).  Such
# degenerate trajectories are outside any cross-stack tolerance contract.
_MIN_WELLPOSED_NCORR = 16

# Winner coarse fitness below this = a genuinely matched ("anchored") scene:
# correspondences are real structure, the ICP trajectory is an attractor, and
# the full transform/report tolerances apply.  Above it the correspondences
# are spurious (non-matching pairs) and small numeric noise legitimately
# moves the converged transform by more than any fixed tolerance.
_ANCHORED_FITNESS = 1.0

# Success classification (fitness <= 1.5) is only asserted when the oracle's
# fine fitness sits outside +/-30% of the threshold — closer than that, the
# degenerate-scene trajectory drift above can flip it on either stack.
_CLASSIFY_MARGIN = 0.3


def _estimations_well_posed(res) -> bool:
    """True when every transform-updating iteration in the trace had enough
    correspondences for a well-conditioned solve.  Abort entries (<3 corr,
    NaN mse) update nothing and are deterministic on both stacks."""
    return all(
        nc >= _MIN_WELLPOSED_NCORR
        for _, mse, nc in res["trace"]
        if np.isfinite(mse)
    )


def oracle_stable(xyz1, lab1, xyz2, lab2, guess_deg):
    """Run the composed oracle twice (with a 1e-6 source perturbation) and
    return (ref, True) when its discrete outcomes are stable and the
    trajectories the asserts depend on are well-posed."""
    d1, d2 = to_dicts(xyz1, lab1), to_dicts(xyz2, lab2)
    ref = ref_impl.two_stage_ref(d1, d2, guess_deg)
    win, lose = ref["best_i"], 1 - ref["best_i"]
    # the winner seeds the fine stage and the fine transform is the output —
    # both trajectories must be well-posed
    if not (
        _estimations_well_posed(ref["coarse"][win])
        and _estimations_well_posed(ref["fine"])
    ):
        return ref, False
    # selection robustness: the loser either solved well-posed systems too
    # (then a relative-gap check suffices), or lost by enough that an
    # implementation-defined loser transform cannot flip the ternary
    f_win = ref["coarse"][win]["fitness"]
    f_lose = ref["coarse"][lose]["fitness"]
    if _estimations_well_posed(ref["coarse"][lose]):
        gap_ok = abs(f_win - f_lose) > 1e-3 * max(f_win, f_lose, 1e-9)
    else:
        gap_ok = f_lose > 4.0 * max(f_win, 1e-9)
    d1p = to_dicts(xyz1 + np.float32(1e-6), lab1)
    refp = ref_impl.two_stage_ref(d1p, d2, guess_deg)
    stable = (
        gap_ok
        and ref["best_i"] == refp["best_i"]
        and len(ref["fine"]["trace"]) == len(refp["fine"]["trace"])
        and ref["fine"]["converged"] == refp["fine"]["converged"]
        and ref["success"] == refp["success"]
    )
    return ref, stable


def run_production(xyz1, lab1, xyz2, lab2, guess_deg, capacity=2048,
                   flat_cap=2048):
    c1 = make_cloud(xyz1, label=lab1, capacity=capacity)
    c2 = make_cloud(xyz2, label=lab2, capacity=capacity)
    return register_pair(c1, c2, angle_guess_deg=guess_deg, flat_cap=flat_cap)


def assert_two_stage_matches(best, fine, ref, cfg_failure_fitness=1.5):
    """The cross-stack assertions used by both the pinned suite seeds and
    scripts/fuzz_campaign.py --twostage.  Anchored scenes (winner coarse
    fitness < _ANCHORED_FITNESS) assert the full transform/fitness/report
    contract; degenerate scenes assert only drift-robust contracts (module
    docstring)."""
    anchored = ref["best"]["fitness"] < _ANCHORED_FITNESS
    t_best = np.asarray(best.transform)
    t_fine = np.asarray(fine.transform)
    d_win = np.abs(t_best - ref["best"]["transform"]).max()
    d_lose = np.abs(t_best - ref["coarse"][1 - ref["best_i"]]["transform"]).max()
    # On spurious-correspondence scenes (winner coarse fitness in the
    # hundreds) the coarse trajectory is CHAOTIC: the f32 matmul stack's
    # rounding acts as an input perturbation far larger than the oracle's
    # 1e-6 stability probe, and the two stacks can converge into different
    # basins entirely (D19; measured at seed 1200029 — production at a
    # 1e-5-perturbed input reproduces the oracle's basin exactly, and a
    # 1e-6 perturbation moves production's own fine fitness 27.5 → 61.8).
    # Fitness values are not comparable across basins, so the per-value
    # contracts below are gated on basin agreement.
    same_basin = d_win < 0.5
    if anchored or same_basin:
        assert d_win < d_lose, (
            f"production coarse winner disagrees with the oracle's "
            f"(d_win={d_win:.4g} vs d_lose={d_lose:.4g})"
        )
    else:
        # basin-diverged degenerate scene: the only cross-stack value
        # contract left is a sanity net — the production winner must still
        # be a plausible coarse solution, not a failed search
        f_ref = max(
            ref["best"]["fitness"],
            ref["coarse"][1 - ref["best_i"]]["fitness"],
        )
        assert float(best.fitness) <= 4.0 * f_ref, (
            f"basin-diverged coarse winner fitness {float(best.fitness):.4g} "
            f"implausibly worse than the oracle pair ({f_ref:.4g})"
        )
    if anchored:
        np.testing.assert_allclose(
            t_best, ref["best"]["transform"], atol=0.03, rtol=0,
            err_msg="coarse winner transform",
        )
        np.testing.assert_allclose(
            t_fine, ref["fine"]["transform"], atol=5e-3, rtol=0,
            err_msg="fine transform",
        )
        assert bool(fine.converged) == ref["fine"]["converged"]
        np.testing.assert_allclose(
            float(fine.fitness), ref["fine"]["fitness"], rtol=5e-2, atol=1e-6,
        )
        # the report arithmetic on both stacks' transforms
        # (icp_precision_report rows, :512-527).  The tolerance is DERIVED
        # from the measured transform agreement, not fixed: dxy/dyaw are
        # functions of both transforms, so they legitimately drift by the
        # (asserted-small) transform deltas — a fixed 0.02 fired on a
        # weakly-anchored scene whose coarse transform sat at 0.027 of its
        # allowed 0.03 while fine matched to 1e-6 (campaign seed 1200241).
        # When the transforms agree to 1e-4 (the common case) the derived
        # bound is ~3e-4, tighter than the old fixed one.
        d_fine = np.abs(t_fine - ref["fine"]["transform"]).max()
        tol_xy = math.sqrt(2.0) * (d_win + d_fine) + 1e-3
        # yaw = atan2(r10, r00) on near-unit rows: |dyaw_deg| <=
        # sqrt(2)*entry_delta*(180/pi) ~ 81*delta per transform
        tol_yaw = 81.0 * (d_win + d_fine) + 0.01
        dxy_p, dyaw_p = _pair_precision(t_best, t_fine)
        dxy_r, dyaw_r = _pair_precision(
            ref["best"]["transform"], ref["fine"]["transform"]
        )
        assert abs(dxy_p - dxy_r) < tol_xy, (dxy_p, dxy_r, tol_xy)
        assert abs(dyaw_p - dyaw_r) < tol_yaw, (dyaw_p, dyaw_r, tol_yaw)
    elif same_basin:
        np.testing.assert_allclose(
            float(fine.fitness), ref["fine"]["fitness"], rtol=0.5,
            err_msg="degenerate-scene fine fitness (order-of-magnitude)",
        )
    ref_fit = ref["fine"]["fitness"]
    if anchored or (
        abs(ref_fit - cfg_failure_fitness)
        > _CLASSIFY_MARGIN * cfg_failure_fitness
    ):
        prod_success = float(fine.fitness) <= cfg_failure_fitness
        assert prod_success == ref["success"], (
            f"success classification: prod fitness {float(fine.fitness):.4g} "
            f"vs oracle {ref_fit:.4g}"
        )


def whole_oracle_stable(xyz1, lab1, xyz2, lab2, guess_deg):
    """Composed whole-cloud ablation oracle + perturbation stability."""
    d1, d2 = to_dicts(xyz1, lab1), to_dicts(xyz2, lab2)
    ref = ref_impl.whole_ref(d1, d2, guess_deg)
    if not _estimations_well_posed(ref["fine"]):
        return ref, False
    d1p = to_dicts(xyz1 + np.float32(1e-6), lab1)
    refp = ref_impl.whole_ref(d1p, d2, guess_deg)
    stable = (
        len(ref["fine"]["trace"]) == len(refp["fine"]["trace"])
        and ref["fine"]["converged"] == refp["fine"]["converged"]
        and ref["success"] == refp["success"]
    )
    return ref, stable


def run_production_whole(xyz1, lab1, xyz2, lab2, guess_deg, capacity=2048):
    c1 = make_cloud(xyz1, label=lab1, capacity=capacity)
    c2 = make_cloud(xyz2, label=lab2, capacity=capacity)
    cfg = RegistrationConfig(fine=WHOLE_ICP)
    (fine,) = register_whole_pairs([(c1, c2, guess_deg)], cfg)
    return fine


def assert_whole_matches(fine, ref, cfg_failure_fitness=1.5):
    anchored = ref["fine"]["fitness"] < _ANCHORED_FITNESS
    if anchored:
        np.testing.assert_allclose(
            np.asarray(fine.transform), ref["fine"]["transform"], atol=5e-3,
            rtol=0, err_msg="whole-cloud fine transform",
        )
        assert bool(fine.converged) == ref["fine"]["converged"]
        np.testing.assert_allclose(
            float(fine.fitness), ref["fine"]["fitness"], rtol=5e-2, atol=1e-6,
        )
    else:
        np.testing.assert_allclose(
            float(fine.fitness), ref["fine"]["fitness"], rtol=0.5,
            err_msg="degenerate-scene whole fitness (order-of-magnitude)",
        )
    ref_fit = ref["fine"]["fitness"]
    if anchored or (
        abs(ref_fit - cfg_failure_fitness)
        > _CLASSIFY_MARGIN * cfg_failure_fitness
    ):
        assert (float(fine.fitness) <= cfg_failure_fitness) == ref["success"], (
            f"success classification: prod fitness {float(fine.fitness):.4g} "
            f"vs oracle {ref_fit:.4g}"
        )


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1])
def test_whole_registration_matches_composed_oracle(seed):
    """The ablation pipeline (direct WHOLE_ICP from the guess,
    /root/reference/BatchWholeRegistration.cpp:342-412) vs its composed
    oracle — the register_whole_pairs glue (guess chain, voxel wiring,
    classification)."""
    xyz1, lab1, xyz2, lab2, guess, _ = twostage_scene(seed)
    ref, stable = whole_oracle_stable(xyz1, lab1, xyz2, lab2, guess)
    if not stable:
        pytest.skip("oracle knife-edge scene (implementation-defined)")
    fine = run_production_whole(xyz1, lab1, xyz2, lab2, guess)
    assert_whole_matches(fine, ref)


@pytest.mark.slow
# 1200029: round-5 campaign find — a spurious-correspondence scene whose
# coarse trajectory is chaotic; the stacks converge into different basins
# and the assert contract's basin gating (D19) is what this seed pins.
# 1200196: round-5 campaign find — an ANCHORED scene where the bad-guess
# coarse trajectory NaN'd in f32 and the raw `<` best-of-two comparison
# picked the NaN side; pins the NaN-ranks-worst selector fix
# (pipelines/registration.py::_stage_coarse).
# 1200241: round-5 campaign find — weakly-anchored scene whose coarse
# drift (0.027 of the allowed 0.03) exceeded the old FIXED report-delta
# tolerance; pins the derived (measured-transform-delta) tolerance.
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 1200029, 1200196, 1200241])
def test_two_stage_matches_composed_oracle(seed):
    xyz1, lab1, xyz2, lab2, guess, true_yaw = twostage_scene(seed)
    ref, stable = oracle_stable(xyz1, lab1, xyz2, lab2, guess)
    if not stable:
        pytest.skip("oracle knife-edge scene (implementation-defined)")
    best, fine = run_production(xyz1, lab1, xyz2, lab2, guess)
    assert_two_stage_matches(best, fine, ref)
    # sanity vs ground truth on successful registrations
    if ref["success"] and not math.isnan(true_yaw):
        yaw = math.degrees(
            math.atan2(fine.transform[1, 0], fine.transform[0, 0])
        )
        diff = (yaw - true_yaw + 180.0) % 360.0 - 180.0
        assert abs(diff) < 0.5
