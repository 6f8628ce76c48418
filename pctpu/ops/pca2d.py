"""2-D PCA over (a subset of) a cloud — the PCA2D half of the installed
pcl_norm_2d library (/root/reference/include/PCA2D.h:27-125,
src/PCA2D.cpp:8-108).

Semantics reproduced:
  * fit (``initCompute``, PCA2D.cpp:8-42): centroid over the selected
    indices, unnormalized 2x2 scatter ``demean · demeanᵀ``, self-adjoint
    eigendecomposition with eigenpairs reordered DESCENDING;
  * ``project`` (:81-108): ``eigvecsᵀ · (p.xy − mean)`` with z = 0.

Design: the per-index accumulation becomes one masked moment matmul; the
2x2 eigenproblem is closed-form.  Eigenvector signs follow Eigen's
SelfAdjointEigenSolver only up to sign (inherently arbitrary); tests compare
up to sign.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from pctpu.ops.eig2 import eig2_sym_values, eig2_sym_vector


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Pca2dFit:
    mean: jnp.ndarray  # (2,)
    eigenvalues: jnp.ndarray  # (2,) descending
    eigenvectors: jnp.ndarray  # (2, 2) columns, descending order


@jax.jit
def pca2d_fit(xyz: jnp.ndarray, mask: jnp.ndarray) -> Pca2dFit:
    """Fit over the masked points (``setIndices`` subsets become masks)."""
    p2 = jnp.asarray(xyz)[:, :2].astype(jnp.float32)
    m = jnp.asarray(mask)
    cnt = jnp.maximum(jnp.sum(m.astype(jnp.float32)), 1.0)
    mean = jnp.sum(jnp.where(m[:, None], p2, 0.0), axis=0) / cnt
    d = jnp.where(m[:, None], p2 - mean, 0.0)
    # unnormalized scatter, like cloud_demean * cloud_demean^T (PCA2D.cpp:28)
    sxx = jnp.sum(d[:, 0] * d[:, 0])
    sxy = jnp.sum(d[:, 0] * d[:, 1])
    syy = jnp.sum(d[:, 1] * d[:, 1])
    lam_max, lam_min = eig2_sym_values(sxx, sxy, syy)
    # eigenvector of the LARGER eigenvalue (first column, descending order);
    # the minor one is its orthogonal complement
    vmax = eig2_sym_vector(sxx, sxy, syy, lam_max)
    vmin = jnp.stack([-vmax[1], vmax[0]])
    return Pca2dFit(
        mean=mean,
        eigenvalues=jnp.stack([lam_max, lam_min]),
        eigenvectors=jnp.stack([vmax, vmin], axis=1),
    )


@jax.jit
def pca2d_project(fit: Pca2dFit, xyz: jnp.ndarray) -> jnp.ndarray:
    """Project points into the PCA frame (PCA2D.cpp:81-108): returns (N, 3)
    with ``eigvecsᵀ (p.xy − mean)`` in xy and z = 0."""
    p2 = jnp.asarray(xyz)[:, :2].astype(jnp.float32)
    proj = jnp.matmul(
        p2 - fit.mean, fit.eigenvectors,
        precision=jax.lax.Precision.HIGHEST,  # CLAUDE.md: full-f32 matmuls
    )
    return jnp.concatenate([proj, jnp.zeros((proj.shape[0], 1), jnp.float32)], axis=1)


class PCA2D:
    """API-parity facade (PCA2D.h:27-125): set_input_cloud / set_indices /
    get_mean / get_eigen_values / get_eigen_vectors / project."""

    def __init__(self) -> None:
        self._xyz = None
        self._indices = None
        self._fit: Pca2dFit | None = None

    def set_input_cloud(self, xyz) -> None:
        self._xyz = jnp.asarray(xyz, jnp.float32)
        self._fit = None

    def set_indices(self, indices) -> None:
        self._indices = None if indices is None else jnp.asarray(indices, jnp.int32)
        self._fit = None

    def _compute(self) -> Pca2dFit:
        if self._xyz is None:
            raise RuntimeError("You have to set a cloud before ask any result !")
        if self._fit is None:
            n = self._xyz.shape[0]
            if self._indices is None:
                mask = jnp.ones((n,), bool)
                self._fit = pca2d_fit(self._xyz, mask)
            else:
                sub = self._xyz[self._indices]
                self._fit = pca2d_fit(sub, jnp.ones((sub.shape[0],), bool))
        return self._fit

    def get_mean(self):
        return self._compute().mean

    def get_eigen_values(self):
        return self._compute().eigenvalues

    def get_eigen_vectors(self):
        return self._compute().eigenvectors

    def project(self, xyz):
        return pca2d_project(self._compute(), jnp.atleast_2d(jnp.asarray(xyz)))
