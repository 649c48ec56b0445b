"""The ppermute halo exchange vs a NumPy pad of the global field.

Each shard's padded block must equal the matching window of the global
field padded through the reference's boundary maps: clamped (or zero) rows
beyond the lat edges, periodic or quirky columns (``ops.indexing``) —
corner blocks, bounded-lat fills and the quirky-lon seam patches included.
Both the one-shot ``halo_pad`` and the split-phase ``halo_start`` +
``halo_finish`` are checked.
"""
import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from seabreeze_param_tpu.ops.indexing import (lat_index_clamped,
                                              lon_index_periodic,
                                              lon_index_quirky, pad_indices)
from seabreeze_param_tpu.parallel.halo import (halo_finish, halo_pad,
                                               halo_start)
from seabreeze_param_tpu.parallel.mesh import make_mesh


def _global_pad_blocks(field, py, px, hy, hx, lat_fill, exact_lon):
    """NumPy reference: pad the global field, cut each shard's window, and
    lay the windows out as shard_map's out_specs=P('y', 'x') would."""
    nlat, nlon = field.shape
    h, w = nlat // py, nlon // px
    cols = pad_indices(nlon, hx,
                       lon_index_quirky if exact_lon else lon_index_periodic)
    gpad = field[pad_indices(nlat, hy, lat_index_clamped)][:, cols]
    if lat_fill == "zero":
        gpad[:hy] = 0.0
        gpad[hy + nlat:] = 0.0
    rows = []
    for iy in range(py):
        rows.append(np.concatenate(
            [gpad[iy * h:iy * h + h + 2 * hy, ix * w:ix * w + w + 2 * hx]
             for ix in range(px)], axis=1))
    return np.concatenate(rows, axis=0)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (8, 1)])
@pytest.mark.parametrize("lat_fill,exact_lon", [("clamp", True),
                                                ("clamp", False),
                                                ("zero", False)])
def test_halo_exchange_matches_global_pad(mesh_shape, lat_fill, exact_lon):
    mesh = make_mesh(mesh_shape)
    py, px = mesh_shape
    nlat, nlon, hy, hx = 48, 64, 3, 3
    field = np.random.default_rng(5).standard_normal(
        (nlat, nlon)).astype(np.float32)

    def both(x):
        one_shot = halo_pad(x, hy, hx, lat_fill=lat_fill,
                            exact_lon=exact_lon)
        split = halo_finish(x, halo_start(x, hy, hx), hy, hx,
                            lat_fill=lat_fill, exact_lon=exact_lon)
        return one_shot, split

    spec = P("y", "x")
    run = jax.jit(jax.shard_map(both, mesh=mesh, in_specs=spec,
                                out_specs=(spec, spec), check_vma=False))
    one_shot, split = (np.asarray(a) for a in run(field))
    ref = _global_pad_blocks(field, py, px, hy, hx, lat_fill, exact_lon)
    np.testing.assert_array_equal(one_shot, ref)
    np.testing.assert_array_equal(split, ref)
