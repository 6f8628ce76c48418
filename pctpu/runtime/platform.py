"""Per-platform choices and the persistent compile cache.

Every choice the program makes from the machine it runs on lives here, read
from ``jax.devices()[0].platform``:

  * ``gpu`` — the hand-written Pallas (Triton route) kernels: the
    bbox-pruned fine-stage NN (``ops/pallas_knn.py``) and the in-order
    segment fold behind the bit-exact ground sums and voxel centroids
    (``ops/segment.py``); 16 registration pairs per vmapped dispatch;
  * ``cpu`` — the plain XLA versions: the blocked-argmin NN
    (``ops/knn.py::nn_1``) and a scatter-add, which the CPU backend applies
    in update order; one pair per dispatch (the CPU pays real compute for
    every padded pair, so batching buys nothing there).

Interpret-mode kernels are never chosen here: only tests ask for them.
"""

from __future__ import annotations

import dataclasses
import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclasses.dataclass(frozen=True)
class PlatformChoice:
    nn_impl: str  # ops.icp nn_impl: "pruned" (Pallas kernel) or "xla"
    pair_batch: int  # registration pairs per vmapped dispatch
    ordered_sum: str  # ops.segment: "kernel" (Pallas fold) or "scatter"


_CHOICES = {
    "gpu": PlatformChoice(nn_impl="pruned", pair_batch=16, ordered_sum="kernel"),
    "cpu": PlatformChoice(nn_impl="xla", pair_batch=1, ordered_sum="scatter"),
}


def platform_choice(platform: str | None = None) -> PlatformChoice:
    """The implementation choices for ``platform`` (default: the platform
    of ``jax.devices()[0]``).  An unknown platform is an error: its scatter
    order and kernel support are unmeasured."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _CHOICES[platform]
    except KeyError:
        raise ValueError(
            f"unsupported platform {platform!r} (supported: {sorted(_CHOICES)})"
        ) from None


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is changed here; otherwise the cache lives at
    ``<checkout>/.jax_cache`` (a fixed path, so entries hit across runs).
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
