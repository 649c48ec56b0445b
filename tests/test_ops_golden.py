"""Golden allclose tests: vectorized JAX ops vs the loop-faithful NumPy
oracle (tests/golden/reference_numpy.py), per SURVEY §4c."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.ops.coastline import get_edges, make_mask
from seabreeze_param_tpu.ops.distance import coast_distance
from seabreeze_param_tpu.ops.orography import sigmoid_weight
from seabreeze_param_tpu.ops.ring_search import ring_thc

from tests.golden.reference_numpy import (
    F, golden_get_edges, golden_get_dist, golden_search_radius,
    golden_sigmoid, golden_diag, lat_clamp, lon_quirky)


@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_get_edges_matches_golden(case, request):
    c = request.getfixturevalue(case)
    ref = golden_get_edges(c["lsm"], c["ci_t"][0])
    got = np.asarray(get_edges(c["lsm"], c["ci_t"][0]))
    np.testing.assert_array_equal(got, ref)


def test_get_edges_quirky_last_column(small_case):
    """The Fortran lon map aliases column nlons to column 1; a coastline in
    the last column must reproduce that behavior exactly."""
    nlat, nlon = 16, 24
    lsm = np.zeros((nlat, nlon), F)
    lsm[:, -1] = 1.0  # land only in the very last column
    ci = np.zeros_like(lsm)
    ref = golden_get_edges(lsm, ci)
    got = np.asarray(get_edges(lsm, ci))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_search_radius_matches(case, request):
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    assert grid.search_radius_cells(180.0) == golden_search_radius(
        c["lon"], c["lat"])


@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_get_dist_matches_golden(case, request):
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    assert grid.search_radius_cells(180.0) >= 1, "fixture too coarse"
    coast = golden_get_edges(c["lsm"], c["ci_t"][0])
    ref = golden_get_dist(coast, c["lsm"], c["lon"], c["lat"])
    got = np.asarray(coast_distance(jnp.asarray(coast), c["lsm"], grid))
    # identical sign/sentinel structure
    np.testing.assert_array_equal(np.sign(ref), np.sign(got))
    np.testing.assert_array_equal(ref == F(12000.0), got == F(12000.0))
    sel = ref != F(12000.0)
    np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5, atol=2e-3)


@pytest.mark.parametrize("unroll", [True, False])
def test_min_haversine_unroll_branches_agree(small_case, unroll):
    """The unrolled static-slice form and the fori_loop fallback (engaged in
    production only at k > 31) must produce identical winning parameters —
    goldened here so the two branches cannot silently diverge (ADVICE r2)."""
    from seabreeze_param_tpu.ops.distance import (
        distance_tables, finalize_distance, min_haversine_param_from_padded,
        pad_coast)
    c = small_case
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = golden_get_edges(c["lsm"], c["ci_t"][0])
    k = grid.search_radius_cells(180.0)
    tables = distance_tables(grid, k)
    amin = min_haversine_param_from_padded(
        pad_coast(jnp.asarray(coast), k), *tables, k, unroll=unroll)
    got = np.asarray(finalize_distance(amin, c["lsm"], 180.0))
    ref = golden_get_dist(coast, c["lsm"], c["lon"], c["lat"])
    np.testing.assert_array_equal(np.sign(ref), np.sign(got))
    sel = ref != F(12000.0)
    np.testing.assert_allclose(got[sel], ref[sel], rtol=2e-5, atol=2e-3)


def test_sigmoid_matches_golden(small_case):
    ref = golden_sigmoid(small_case["std"])
    got = np.asarray(sigmoid_weight(small_case["std"]))
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_ring_thc_matches_golden(case, request):
    """Cross-check the incremental-box-sum ring search against the literal
    expanding-while-loop on every coastal point."""
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = golden_get_edges(c["lsm"], c["ci_t"][0])
    cdist = golden_get_dist(coast, c["lsm"], c["lon"], c["lat"])
    smod = golden_sigmoid(c["std"])
    t0 = (c["theta_t"][0] - (np.float32(-0.0060956) * c["z"] * smod)).astype(F)

    from seabreeze_param_tpu.ops.ring_search import required_ring_radius_host
    k = grid.search_radius_cells(180.0)
    nn_max = max(k + 4, required_ring_radius_host(cdist, 180.0))
    got_thc, got_found = ring_thc(jnp.asarray(t0), jnp.asarray(cdist), nn_max)
    got_thc = np.asarray(got_thc)

    nlat, nlon = t0.shape
    checked = 0
    for i in range(nlat - 1):
        for j in range(nlon):
            if abs(cdist[i, j]) > F(180.0):
                continue
            mul = F(1.0) if cdist[i, j] >= 0 else F(-1.0)
            nn = 1
            while True:
                n_l = n_s = 0
                T_l = F(0.0)
                T_s = F(0.0)
                for ii in range(i - nn, i + nn + 1):
                    for jj in range(j - nn, j + nn + 1):
                        ki = lat_clamp(ii, nlat)
                        kj = lon_quirky(jj, nlon)
                        if cdist[ki, kj] >= 0:
                            T_l = F(T_l + t0[ki, kj])
                            n_l += 1
                        else:
                            T_s = F(T_s + t0[ki, kj])
                            n_s += 1
                if n_l > 0 and n_s > 0:
                    break
                nn += 1
            assert nn <= nn_max, (i, j, nn)
            ref = F(mul * (T_l / F(n_l) - T_s / F(n_s)))
            np.testing.assert_allclose(got_thc[i, j], ref, rtol=2e-4,
                                       atol=2e-3)
            checked += 1
    assert checked > 50  # the fixture must actually exercise coastal cells


@pytest.mark.parametrize("case", ["global_case"])
def test_pass1_nearest_matches_taps(case, request):
    """The O(log k) uniform-grid pass-1 (nearest/farthest coast by
    log-doubling) vs the exact tapped form: identical empty-window
    structure, values equal up to float32 rounding of the branched-lon
    table (the farthest/nearest POSITIONS are exact)."""
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.ops.coastline import get_edges
    from seabreeze_param_tpu.ops.distance import (
        BIG_PARAM, distance_tables, effective_radius, pad_coast,
        pass1_extrema, pass1_extrema_nearest, uniform_half_dlam)

    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    k = effective_radius(grid, 180.0)
    tables = distance_tables(grid, k)
    half = uniform_half_dlam(grid)
    assert half is not None
    # regional (non-full-circle) axes must refuse the fast form: their
    # index-periodic seam jumps by the domain width, not dj*dlam
    from seabreeze_param_tpu.core.grid import Grid as _G
    regional = _G(lon=np.linspace(100.0, 132.0, 64, endpoint=False),
                  lat=c["lat"])
    assert uniform_half_dlam(regional) is None
    coast = get_edges(c["lsm"], c["ci_t"][0])
    cpad = pad_coast(jnp.asarray(coast), k)

    ref_min, ref_none = pass1_extrema(cpad, tables[2], k)
    assert ref_none is None        # single-extremum default (po >= 0)
    ref_min = np.asarray(ref_min)
    got_min, got_none = pass1_extrema_nearest(cpad, k, half)
    assert got_none is None
    got_min = np.asarray(got_min)
    empty = ref_min > BIG_PARAM / 2
    np.testing.assert_array_equal(got_min > BIG_PARAM / 2, empty)
    sel = ~empty
    np.testing.assert_allclose(got_min[sel], ref_min[sel], rtol=1e-4,
                               atol=1e-9)
    # the optional two-extremum form is still available (need_max=True):
    # its min channel must be identical and its max channel well-formed
    ref2_min, ref2_max = map(np.asarray,
                             pass1_extrema(cpad, tables[2], k,
                                           need_max=True))
    np.testing.assert_array_equal(ref2_min, ref_min)
    np.testing.assert_array_equal(ref2_max < -BIG_PARAM / 2, empty)
    assert (ref2_max[sel] >= ref_min[sel]).all()


@pytest.mark.parametrize("case", ["global_case"])
def test_coast_distance_nearest_form(case, request):
    """End-to-end coast_distance with lon_form='nearest' vs the exact
    form: identical sentinel structure, kilometers allclose."""
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.ops.coastline import get_edges
    from seabreeze_param_tpu.ops.distance import coast_distance

    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    coast = get_edges(c["lsm"], c["ci_t"][0])
    ref = np.asarray(coast_distance(coast, c["lsm"], grid, 180.0,
                                    lon_form="taps"))
    got = np.asarray(coast_distance(coast, c["lsm"], grid, 180.0,
                                    lon_form="nearest"))
    sent = ref == np.float32(12000.0)
    # borderline cells at the 2*maxdist cap may flip with ulp-level
    # distance changes; require identical structure away from a whisker
    near_cap = np.abs(np.abs(ref) - 360.0) < 0.01
    np.testing.assert_array_equal((got == np.float32(12000.0))[~near_cap],
                                  sent[~near_cap])
    sel = ~sent & ~near_cap & (got != np.float32(12000.0))
    np.testing.assert_allclose(got[sel], ref[sel], rtol=1e-4, atol=1e-3)


def test_required_ring_radius_no_scipy(small_case, monkeypatch):
    """The pure-NumPy Chebyshev fallback must reproduce the scipy result
    (scipy is not a hard dependency)."""
    import builtins
    import sys
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu.ops.ring_search import required_ring_radius_host

    c = small_case
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    cdist = np.asarray(pipe.distance_field(jnp.asarray(c["lsm"]),
                                           jnp.asarray(c["ci_t"][0])))
    with_scipy = required_ring_radius_host(cdist, 180.0)

    real_import = builtins.__import__

    def no_scipy(name, *a, **k):
        if name.startswith("scipy"):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_scipy)
    for mod in [m for m in sys.modules if m.startswith("scipy")]:
        monkeypatch.delitem(sys.modules, mod)
    without_scipy = required_ring_radius_host(cdist, 180.0)
    assert without_scipy == with_scipy
