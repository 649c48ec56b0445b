"""Shard-count invariance: the shard_map pipeline over a virtual 8-device
CPU mesh must reproduce the single-device pipeline (the functional analogue
of a race detector, SURVEY §5.2 — and the idiomatic equivalent of the
reference's fake ``swap_bounds`` backend, ``generic/halo_exchange_mod.f90``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.core.params import Params
from seabreeze_param_tpu.core.state import TriggerState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline
from seabreeze_param_tpu.parallel.mesh import make_mesh
from seabreeze_param_tpu.parallel.sharded import ShardedPipeline


def _zero_state(nlat, nlon):
    return TriggerState.zeros((nlat, nlon))


def _run_single(pipe, c, nsteps):
    nlat, nlon = len(c["lat"]), len(c["lon"])
    state = _zero_state(nlat, nlon)
    return pipe.run(state, c["theta_t"][:nsteps], c["u_t"][:nsteps],
                    c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], c["p"],
                    ci_t=c["ci_t"][:nsteps])


def _run_sharded(pipe, mesh_shape, c, nsteps):
    mesh = make_mesh(mesh_shape)
    sp = ShardedPipeline(pipe, mesh)
    nlat, nlon = len(c["lat"]), len(c["lon"])
    state = _zero_state(nlat, nlon)
    return sp.run(state, c["theta_t"][:nsteps], c["u_t"][:nsteps],
                  c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], c["p"],
                  ci_t=c["ci_t"][:nsteps])


def _assert_state_close(a, b):
    assert int(a.tt) == int(b.tt)
    np.testing.assert_allclose(np.asarray(a.thc), np.asarray(b.thc),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.windspeed),
                               np.asarray(b.windspeed), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(np.asarray(a.winddir),
                               np.asarray(b.winddir), rtol=1e-5, atol=1e-3)


def _assert_outputs_close(got, ref):
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        g, r = np.asarray(got[key]), np.asarray(ref[key])
        assert g.shape == r.shape, key
        # identical missing/sentinel structure, tight values elsewhere
        miss = r == np.float32(2.0e20)
        np.testing.assert_array_equal(g == np.float32(2.0e20), miss, err_msg=key)
        sel = ~miss
        mism = ~np.isclose(g[sel], r[sel], rtol=1e-5, atol=1e-4)
        # reassociated float32 reductions (psum trees) may flip a borderline
        # threshold decision on a vanishing fraction of cells
        assert mism.mean() < 1e-3, f"{key}: {mism.sum()}/{mism.size}"


@pytest.mark.parametrize("mesh_shape", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_single_device(small_case, mesh_shape):
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    ref_state, ref_out = _run_single(pipe, c, nsteps)
    got_state, got_out = _run_sharded(pipe, mesh_shape, c, nsteps)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_lat_padding(global_case):
    """nlat=121 is not divisible by 2: exercises the replication-padding path
    and its valid-mask-corrected global statistics."""
    c = global_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    ref_state, ref_out = _run_single(pipe, c, nsteps)
    got_state, got_out = _run_sharded(pipe, (2, 4), c, nsteps)
    assert got_out["sb_con"].shape == ref_out["sb_con"].shape
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_overlap_matches_basic(small_case):
    """The overlapped two-exchange step structure and the basic
    three-exchange structure must produce identical results on the same
    mesh (the apron-replication correctness argument, sharded.py
    docstring)."""
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    mesh = make_mesh((2, 4))
    nlat, nlon = len(c["lat"]), len(c["lon"])

    results = []
    for overlap in (True, False):
        sp = ShardedPipeline(pipe, mesh, overlap=overlap)
        assert sp.overlap is overlap
        state = _zero_state(nlat, nlon)
        results.append(sp.run(state, c["theta_t"][:nsteps],
                              c["u_t"][:nsteps], c["v_t"][:nsteps],
                              c["lsm"], c["z"], c["std"], c["p"],
                              ci_t=c["ci_t"][:nsteps]))
    (ov_state, ov_out), (ba_state, ba_out) = results
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        np.testing.assert_array_equal(np.asarray(ov_out[key]),
                                      np.asarray(ba_out[key]), err_msg=key)
    np.testing.assert_array_equal(np.asarray(ov_state.windspeed),
                                  np.asarray(ba_state.windspeed))
    np.testing.assert_array_equal(np.asarray(ov_state.thc),
                                  np.asarray(ba_state.thc))


@pytest.mark.parametrize("mesh_shape", [(2, 4), (1, 8)])
def test_sharded_pallas_production_path(small_case, mesh_shape):
    """The GPU production combination — shard_map + the ring kernel —
    executed on the virtual CPU mesh via interpret mode, against the
    single-device XLA reference."""
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    ref_state, ref_out = _run_single(TriggerPipeline(grid), c, nsteps)
    pipe = TriggerPipeline(grid, use_pallas=True, pallas_interpret=True)
    got_state, got_out = _run_sharded(pipe, mesh_shape, c, nsteps)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_halo_width_guard(small_case):
    """A mesh whose local shard is narrower than the widest halo must be
    rejected up front (silent garbage-width exchanges otherwise)."""
    c = small_case
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid, ring_nn=50)   # force nn_max > 64/8 shard
    with pytest.raises(ValueError, match="halo width"):
        ShardedPipeline(pipe, make_mesh((8, 1)))


def test_sharded_static_coastline_matches_single_device(small_case):
    """ci_t=None: the distance transform runs once outside the scan in both
    pipelines; results must still agree."""
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    nlat, nlon = len(c["lat"]), len(c["lon"])
    ref_state, ref_out = pipe.run(
        _zero_state(nlat, nlon), c["theta_t"][:nsteps], c["u_t"][:nsteps],
        c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], c["p"], ci_t=None)
    sp = ShardedPipeline(pipe, make_mesh((2, 4)))
    got_state, got_out = sp.run(
        _zero_state(nlat, nlon), c["theta_t"][:nsteps], c["u_t"][:nsteps],
        c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], c["p"], ci_t=None)
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_3d_pressure_matches_single_device(small_case):
    """The UM coupling contract at scale (VERDICT r4 weak item 5): 3-D
    per-column pressure (``UM/vn10.7/sea_breeze_diag.F90:79-82, 265-274``)
    sharded P(None, 'y', 'x') through the overlapped mesh pipeline must
    match the single-device run — the nearest-level selection is local per
    column, so shard-count invariance must hold exactly as for 1-D pres."""
    c = small_case
    nsteps = 2
    nlat, nlon = len(c["lat"]), len(c["lon"])
    nlev = len(c["p"])
    rng = np.random.default_rng(21)
    # column-dependent perturbation big enough to flip the nearest-level
    # choice between columns (same construction as tests/test_coupling.py)
    p3 = (c["p"][:, None, None] + 9000.0 * rng.standard_normal(
        (nlev, nlat, nlon))).astype(np.float32)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid)
    ref_state, ref_out = pipe.run(
        _zero_state(nlat, nlon), c["theta_t"][:nsteps], c["u_t"][:nsteps],
        c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], p3,
        ci_t=c["ci_t"][:nsteps])
    for mesh_shape in ((2, 4), (4, 2)):
        sp = ShardedPipeline(pipe, make_mesh(mesh_shape))
        assert sp.overlap
        got_state, got_out = sp.run(
            _zero_state(nlat, nlon), c["theta_t"][:nsteps],
            c["u_t"][:nsteps], c["v_t"][:nsteps], c["lsm"], c["z"],
            c["std"], p3, ci_t=c["ci_t"][:nsteps])
        _assert_outputs_close(got_out, ref_out)
        _assert_state_close(got_state, ref_state)
    # basic (non-overlapped) step structure covers the same contract
    sp = ShardedPipeline(pipe, make_mesh((2, 4)), overlap=False)
    got_state, got_out = sp.run(
        _zero_state(nlat, nlon), c["theta_t"][:nsteps], c["u_t"][:nsteps],
        c["v_t"][:nsteps], c["lsm"], c["z"], c["std"], p3,
        ci_t=c["ci_t"][:nsteps])
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_pallas_wind_refresh_cadence(small_case):
    """Production combination at the 6-hourly wind-refresh step (tt=15):
    the sharded ring-kernel path must agree with the single-device XLA
    path on the refresh branch too."""
    import jax.numpy as jnp
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    nlat, nlon = len(c["lat"]), len(c["lon"])
    rng = np.random.default_rng(3)
    thc0 = (290 + rng.standard_normal((nlat, nlon))).astype(np.float32)
    ws0 = (5 + rng.random((nlat, nlon))).astype(np.float32)
    wd0 = (360 * rng.random((nlat, nlon)) - 180).astype(np.float32)

    def state():   # pipe.run donates its state argument — build fresh
        return TriggerState(tt=jnp.int32(15), thc=jnp.asarray(thc0),
                            windspeed=jnp.asarray(ws0),
                            winddir=jnp.asarray(wd0))

    pipe_ref = TriggerPipeline(grid)
    ref_state, ref_out = pipe_ref.run(state(), c["theta_t"][:nsteps],
                                      c["u_t"][:nsteps], c["v_t"][:nsteps],
                                      c["lsm"], c["z"], c["std"], c["p"],
                                      ci_t=c["ci_t"][:nsteps])
    pipe = TriggerPipeline(grid, use_pallas=True, pallas_interpret=True)
    sp = ShardedPipeline(pipe, make_mesh((2, 4)))
    got_state, got_out = sp.run(state(), c["theta_t"][:nsteps],
                                c["u_t"][:nsteps], c["v_t"][:nsteps],
                                c["lsm"], c["z"], c["std"], c["p"],
                                ci_t=c["ci_t"][:nsteps])
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


def test_sharded_clean_periodic_mode(small_case):
    """exact_lon_indexing=False (clean periodicity, no quirky seam
    patches): the overlapped sharded step must still match the
    single-device pipeline."""
    c = small_case
    nsteps = 2
    grid = Grid(lon=c["lon"], lat=c["lat"])
    pipe = TriggerPipeline(grid, params=Params(exact_lon_indexing=False))
    ref_state, ref_out = _run_single(pipe, c, nsteps)
    sp = ShardedPipeline(pipe, make_mesh((2, 4)))
    assert sp.overlap
    nlat, nlon = len(c["lat"]), len(c["lon"])
    got_state, got_out = sp.run(_zero_state(nlat, nlon),
                                c["theta_t"][:nsteps], c["u_t"][:nsteps],
                                c["v_t"][:nsteps], c["lsm"], c["z"],
                                c["std"], c["p"], ci_t=c["ci_t"][:nsteps])
    _assert_outputs_close(got_out, ref_out)
    _assert_state_close(got_state, ref_state)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_sharded_lat_padding_edge_rows(mesh_shape):
    """Replication-padding rows below the last real latitude must look, to
    the ring search, exactly like the reference's lat clamp (the edge row
    itself): their own Sobel coastline can differ from the edge row's, and
    with it their cdist class.  No mismatch fraction is allowed here."""
    import bench
    nlat, nlon, nsteps = 361, 720, 3
    lsm, z, std, pres, theta, u, v, ci = bench.make_world(nlat, nlon, 4,
                                                          nsteps, seed=0)
    grid = Grid.regular(nlat, nlon, lat0=90.0, lat1=-90.0)
    pipe = TriggerPipeline(grid)
    args = (theta, u, v, lsm, z, std, pres)
    ref_state, ref_out = pipe.run(_zero_state(nlat, nlon), *args, ci_t=ci)
    sp = ShardedPipeline(pipe, make_mesh(mesh_shape))
    assert sp.nlat_pad > nlat
    got_state, got_out = sp.run(_zero_state(nlat, nlon), *args, ci_t=ci)
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        g, r = np.asarray(got_out[key]), np.asarray(ref_out[key])
        np.testing.assert_array_equal(g == np.float32(2.0e20),
                                      r == np.float32(2.0e20), err_msg=key)
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4, err_msg=key)
    _assert_state_close(got_state, ref_state)
