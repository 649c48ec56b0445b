"""Device-mesh construction for the 2-D (lat, lon) domain decomposition.

The reference's only inter-process parallelism is a 2-D spatial domain
decomposition with MPI halo exchange (UM ``swap_bounds``,
``UM/vn10.7/sea_breeze_diag.F90:408-410``; stub
``generic/halo_exchange_mod.f90``).  Here it is a ``jax.sharding.Mesh``
with axes ('y', 'x') over the GPUs; lat shards ride 'y', lon shards ride
'x', and neighbor exchanges become ``ppermute`` steps (``parallel.halo``)
that XLA hands to NCCL.

The GPUs of one host reach each other all to all over NVLink at one rate,
so the network does not favour any axis: what a mesh shape costs is the
halo bytes each shard sends, which grow with its perimeter.
"""
from __future__ import annotations

import warnings

import numpy as np
import jax

AXIS_Y = "y"
AXIS_X = "x"


def make_mesh(shape: tuple[int, int] | None = None,
              devices=None) -> jax.sharding.Mesh:
    """Build a ('y', 'x') mesh.

    ``shape=None`` picks a near-square factorization of the available
    devices — near-square keeps each shard's perimeter, and so its halo
    bytes, small — with the extra factor on lon ('x'), usually the longer
    axis.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        py = int(np.floor(np.sqrt(n)))
        while n % py:
            py -= 1
        shape = (py, n // py)
    want = shape[0] * shape[1]
    if want > n:
        raise ValueError(f"mesh shape {shape} needs {want} devices, "
                         f"have {n}")
    if want < n:
        # Deliberate subsetting is legitimate (e.g. a 1x1 debug mesh on an
        # 8-chip host), but a typo'd --mesh should not silently run on a
        # fraction of the machine.
        warnings.warn(f"mesh shape {shape} uses only {want} of {n} "
                      f"available devices")
    dev_array = np.asarray(devices[:want]).reshape(shape)
    return jax.sharding.Mesh(dev_array, (AXIS_Y, AXIS_X))
