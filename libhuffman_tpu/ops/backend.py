"""How each Pallas kernel of this package is compiled, decided by platform.

  gpu   compiled through Triton (``backend="triton"``);
  cpu   run by the Pallas interpreter — the test route, never a product;
  any other platform has no route and raises, naming it.

Every ``pallas_call`` takes its keyword arguments from :func:`pallas_route`,
so the route is named on every call and decided in this one place.
"""

from __future__ import annotations

import jax
from jax.experimental.pallas import triton as pl_triton


def pallas_route(num_warps: int, platform: str | None = None) -> dict:
    """``pallas_call`` keyword arguments for ``platform`` (default: JAX's
    default backend).  ``num_warps`` sizes the Triton program."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return dict(backend="triton",
                    compiler_params=pl_triton.CompilerParams(
                        num_warps=num_warps, num_stages=1))
    if platform == "cpu":
        return dict(backend="triton", interpret=True)
    raise NotImplementedError(
        f"no Pallas route for platform {platform!r}: the kernels compile "
        "for 'gpu' through Triton and run interpreted on 'cpu'")
