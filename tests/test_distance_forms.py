"""The XLA distance passes agree across their forms.

Pass 1 (masked sliding min along lon) and pass 2 (min over the lat window of
sdphi2 + po * extremum) each have a static-slice unroll and a ``fori_loop``
form, and pass 2 a single-extremum form (po >= 0, the ``distance_tables``
guarantee) beside the two-extremum one.  Every pair must pick the same
winning haversine parameter.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.ops.coastline import get_edges
from seabreeze_param_tpu.ops.distance import (distance_tables,
                                              effective_radius, pad_coast,
                                              pass1_extrema, pass2_min)

BIG = np.float32(1e30) / 2


def _close_1ulp(a, b):
    """Identical empty-window (BIG) structure; values within 1 ulp — the
    ``s + p*lo`` of pass 2 may contract to an FMA in one fusion and not in
    another."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(a > BIG, b > BIG)
    sel = b < BIG
    np.testing.assert_allclose(a[sel], b[sel], rtol=3e-7, atol=0)


@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("check", ["pass2_single_vs_two",
                                   "pass1_two_keeps_min",
                                   "pass1_unroll_vs_fori",
                                   "pass2_unroll_vs_fori"])
def test_distance_pass_forms_agree(case, check, request):
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    k = effective_radius(grid, 180.0)
    sdphi2, po, sdlam2 = distance_tables(grid, k)
    assert (po >= 0.0).all()
    cpad = pad_coast(jnp.asarray(get_edges(c["lsm"], c["ci_t"][0])), k)
    mmin, none = pass1_extrema(cpad, sdlam2, k)
    assert none is None
    if check == "pass2_single_vs_two":
        mmin2, mmax2 = pass1_extrema(cpad, sdlam2, k, need_max=True)
        _close_1ulp(pass2_min(mmin2, mmax2, sdphi2, po, k),
                    pass2_min(mmin, None, sdphi2, po, k))
    elif check == "pass1_two_keeps_min":
        mmin2, mmax2 = pass1_extrema(cpad, sdlam2, k, need_max=True)
        np.testing.assert_array_equal(np.asarray(mmin2), np.asarray(mmin))
        empty = np.asarray(mmin) > BIG
        assert (np.asarray(mmax2)[~empty] >= np.asarray(mmin)[~empty]).all()
    elif check == "pass1_unroll_vs_fori":
        fori, _ = pass1_extrema(cpad, sdlam2, k, unroll=False)
        unrolled, _ = pass1_extrema(cpad, sdlam2, k, unroll=True)
        np.testing.assert_array_equal(np.asarray(fori), np.asarray(unrolled))
    else:
        _close_1ulp(pass2_min(mmin, None, sdphi2, po, k, unroll=False),
                    pass2_min(mmin, None, sdphi2, po, k, unroll=True))
