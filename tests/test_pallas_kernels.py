"""The coastal-band ring kernel vs its jnp reference (interpret mode on CPU).

The kernel sums every window in the XLA form's order, so in interpret mode
(exact division) it must agree bit for bit; the trigger tail after it is
shared XLA code.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from seabreeze_param_tpu.core.grid import Grid
from seabreeze_param_tpu.core.params import Params
from seabreeze_param_tpu.core.state import TriggerState
from seabreeze_param_tpu.models.pipeline import TriggerPipeline
from seabreeze_param_tpu.ops.coastline import get_edges
from seabreeze_param_tpu.ops.distance import coast_distance
from seabreeze_param_tpu.ops.indexing import pad2d
from seabreeze_param_tpu.ops.pallas import ring_kernel
from seabreeze_param_tpu.ops.pallas.ring_kernel import ring_thc_pallas
from seabreeze_param_tpu.ops.ring_search import ring_thc
from seabreeze_param_tpu.ops.trigger import trigger_step

MISSING = np.float32(2.0e20)


def _cdist(c, grid):
    coast = get_edges(c["lsm"], c["ci_t"][0])
    return coast_distance(coast, c["lsm"], grid, 180.0)


def _step_inputs(c, tt, seed):
    rng = np.random.default_rng(seed)
    shape = c["lsm"].shape
    state = TriggerState(
        tt=jnp.int32(tt),
        thc=jnp.asarray(290 + rng.standard_normal(shape), jnp.float32),
        windspeed=jnp.asarray(5 + rng.random(shape), jnp.float32),
        winddir=jnp.asarray(360 * rng.random(shape) - 180, jnp.float32))
    theta = jnp.asarray(288 + 5 * rng.standard_normal(shape), jnp.float32)
    nlev = len(c["p"])
    u = jnp.asarray(6 * rng.standard_normal((nlev,) + shape), jnp.float32)
    v = jnp.asarray(6 * rng.standard_normal((nlev,) + shape), jnp.float32)
    return state, theta, u, v


def _assert_step_equal(got, ref):
    (g_state, g_out), (r_state, r_out) = got, ref
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        np.testing.assert_array_equal(np.asarray(g_out[key]),
                                      np.asarray(r_out[key]), err_msg=key)
    assert int(g_state.tt) == int(r_state.tt)
    for name in ("thc", "windspeed", "winddir"):
        np.testing.assert_array_equal(np.asarray(getattr(g_state, name)),
                                      np.asarray(getattr(r_state, name)),
                                      err_msg=name)


@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("tile_rows,tile_cols", [(32, 64), (64, 256),
                                                 (16, 128)])
def test_ring_kernel_matches_jnp(case, tile_rows, tile_cols, request,
                                 monkeypatch):
    """Ring kernel (2-D blocks, coastal-block skip, early exit) vs
    ops.ring_search with the same coastal-band mask: same window sums in
    the same order -> bit-identical."""
    monkeypatch.setattr(ring_kernel, "BLOCK_ROWS", tile_rows)
    monkeypatch.setattr(ring_kernel, "BLOCK_COLS", tile_cols)
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    nn = TriggerPipeline(grid).nn_max
    cdist = _cdist(c, grid)
    rng = np.random.default_rng(4)
    t0 = (290.0 + 8.0 * rng.standard_normal(c["lsm"].shape)).astype(
        np.float32)

    ref, _ = ring_thc(jnp.asarray(t0), cdist, nn, maxdist=180.0)
    got = ring_thc_pallas(pad2d(jnp.asarray(t0), nn, nn),
                          pad2d(cdist, nn, nn), cdist, nn, 180.0,
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    non_coastal = np.abs(np.asarray(cdist)) > 180.0
    assert non_coastal.any() and (np.asarray(got)[non_coastal] == 0.0).all()


@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("tt,tile", [(1, (32, 64)), (5, (16, 128)),
                                     (15, (64, 256))])
def test_fused_trigger_kernel_matches_xla_step(case, tt, tile, request,
                                               monkeypatch):
    """trigger_step with the ring kernel at a given block shape reproduces
    the XLA trigger_step exactly across the state cadences: tt=1
    (first-step seeding), tt=5 (no wind refresh at the default 24-min/6-h
    cadence), tt=15 (6-hourly refresh step)."""
    monkeypatch.setattr(ring_kernel, "BLOCK_ROWS", tile[0])
    monkeypatch.setattr(ring_kernel, "BLOCK_COLS", tile[1])
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    params = Params()
    nn = TriggerPipeline(grid).nn_max
    cdist = _cdist(c, grid)
    state, theta, u, v = _step_inputs(c, tt, seed=7)
    args = (state, theta, u, v, cdist, c["z"], c["std"], c["p"], params, nn)
    _assert_step_equal(
        trigger_step(*args, use_pallas=True, pallas_interpret=True),
        trigger_step(*args, use_pallas=False))


@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("tt", [1, 5, 15])
def test_trigger_step_pallas_matches_xla(case, tt, request):
    """The complete use_pallas=True trigger_step (interpret mode) vs the XLA
    path — all four output slots and the carried state.  In particular the
    last-lat-row quirk: outputs are zero there (the reference never writes
    that row) while the wind state stays frozen at the carried value."""
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    params = Params()
    nn = TriggerPipeline(grid).nn_max
    cdist = _cdist(c, grid)
    state, theta, u, v = _step_inputs(c, tt, seed=11)
    args = (state, theta, u, v, cdist, c["z"], c["std"], c["p"], params, nn)
    got = trigger_step(*args, use_pallas=True, pallas_interpret=True)
    _assert_step_equal(got, trigger_step(*args, use_pallas=False))
    got_state, got_out = got
    np.testing.assert_array_equal(np.asarray(got_out["windspeed"])[-1], 0.0)
    np.testing.assert_array_equal(np.asarray(got_state.windspeed)[-1],
                                  np.asarray(state.windspeed)[-1])


@pytest.mark.parametrize("case", ["small_case", "global_case"])
@pytest.mark.parametrize("tile", [(8, 32), (16, 64), (32, 16)])
def test_ring_kernel_partial_blocks(case, tile, request, monkeypatch):
    """A grid that is no multiple of the block shape (partial edge blocks,
    sentinel-padded centre) through the whole trigger_step, last-row quirk
    included, against the XLA path."""
    monkeypatch.setattr(ring_kernel, "BLOCK_ROWS", tile[0])
    monkeypatch.setattr(ring_kernel, "BLOCK_COLS", tile[1])
    c = request.getfixturevalue(case)
    nlat, nlon = len(c["lat"]) - 3, len(c["lon"]) - 5
    crop = {k: (c[k][..., :nlat, :nlon] if k not in ("lat", "lon", "p")
                else c[k]) for k in c}
    crop["lat"], crop["lon"] = c["lat"][:nlat], c["lon"][:nlon]
    assert nlat % tile[0] and nlon % tile[1]
    grid = Grid(lon=crop["lon"], lat=crop["lat"])
    nn = TriggerPipeline(grid).nn_max
    cdist = _cdist(crop, grid)
    state, theta, u, v = _step_inputs(crop, 15, seed=13)
    args = (state, theta, u, v, cdist, crop["z"], crop["std"], crop["p"],
            Params(), nn)
    got = trigger_step(*args, use_pallas=True, pallas_interpret=True)
    _assert_step_equal(got, trigger_step(*args, use_pallas=False))
    np.testing.assert_array_equal(np.asarray(got[1]["sb_con"])[-1], 0.0)
    assert (np.asarray(got[1]["sb_con"]) == MISSING).any()


def _assert_scan_equal(got, ref, nsteps, shape):
    (got_state, got_out), (ref_state, ref_out) = got, ref
    for key in ("sb_con", "t0", "windspeed", "winddir"):
        g, r = np.asarray(got_out[key]), np.asarray(ref_out[key])
        assert g.shape == r.shape == (nsteps,) + shape, key
        np.testing.assert_array_equal(g, r, err_msg=key)
    assert int(got_state.tt) == int(ref_state.tt)
    for name in ("thc", "windspeed", "winddir"):
        np.testing.assert_array_equal(np.asarray(getattr(got_state, name)),
                                      np.asarray(getattr(ref_state, name)),
                                      err_msg=name)


@pytest.mark.parametrize("with_ci", [True, False])
def test_stacked_scan_runner_matches_xla(small_case, with_ci):
    """The use_pallas scan (TriggerPipeline.run) vs the plain XLA scan:
    every per-step output slot and the final state agree over a multi-step
    run that crosses the 6-hourly wind-refresh cadence (tt=14..16)."""
    c = small_case
    nsteps = 3
    nlat, nlon = len(c["lat"]), len(c["lon"])
    grid = Grid(lon=c["lon"], lat=c["lat"])
    rng = np.random.default_rng(5)
    thc0 = (290 + rng.standard_normal((nlat, nlon))).astype(np.float32)
    ws0 = (5 + rng.random((nlat, nlon))).astype(np.float32)
    wd0 = (360 * rng.random((nlat, nlon)) - 180).astype(np.float32)

    def state0():
        # fresh buffers per run: the jitted runner donates its state arg
        return TriggerState(tt=jnp.int32(14), thc=jnp.asarray(thc0),
                            windspeed=jnp.asarray(ws0),
                            winddir=jnp.asarray(wd0))

    ci_t = c["ci_t"][:nsteps] if with_ci else None
    args = (c["theta_t"][:nsteps], c["u_t"][:nsteps], c["v_t"][:nsteps],
            c["lsm"], c["z"], c["std"], c["p"])
    ref = TriggerPipeline(grid).run(state0(), *args, ci_t=ci_t)
    pipe = TriggerPipeline(grid, use_pallas=True, pallas_interpret=True)
    _assert_scan_equal(pipe.run(state0(), *args, ci_t=ci_t), ref, nsteps,
                       (nlat, nlon))


def test_stacked_compact_multi_tile_moving_coast(monkeypatch):
    """Block skipping on a multi-block grid where some blocks have NO
    coastal cell (they store zeros without a ring loop) and a block BECOMES
    coastal mid-run when sea ice appears.  Full parity against the XLA
    scan."""
    monkeypatch.setattr(ring_kernel, "BLOCK_ROWS", 32)
    monkeypatch.setattr(ring_kernel, "BLOCK_COLS", 128)
    F = np.float32
    nlat, nlon, nlev, nsteps = 64, 512, 3, 4
    # 4 column-blocks of 128.  Coastlines: the continent edge at x=20
    # (block 0) and the index-periodic wrap seam at x=0/511 (blocks 0+3 —
    # the reference's stencils wrap in index space, so the regional
    # domain's east/west edges read as coast).  Blocks 1 and 2 are far
    # beyond 2*maxdist -> never coastal... until step 2, when sea ice
    # appears at x ~ 300 and creates a new ice coastline in block 2.
    lat = np.linspace(20.0, -19.7, nlat).astype(F)
    lon = np.linspace(0.0, 100.0, nlon, endpoint=False).astype(F)
    rng = np.random.default_rng(9)
    x = np.arange(nlon)[None, :].repeat(nlat, 0)
    lsm = (x < 20).astype(F) * (0.6 + 0.4 * rng.random((nlat, nlon))).astype(F)
    ci_t = np.zeros((nsteps, nlat, nlon), F)
    ci_t[2:, :, 300:310] = 0.9          # new ice coastline, block 2
    z = (500.0 * lsm * rng.random((nlat, nlon))).astype(F)
    std = (90.0 * lsm * rng.random((nlat, nlon))).astype(F)
    p = np.array([100000.0, 85000.0, 70000.0], F)
    theta = (288.0 + 6.0 * rng.standard_normal((nsteps, nlat, nlon))).astype(F)
    u = (6.0 * rng.standard_normal((nsteps, nlev, nlat, nlon))).astype(F)
    v = (6.0 * rng.standard_normal((nsteps, nlev, nlat, nlon))).astype(F)

    grid = Grid(lon=lon, lat=lat)
    pipe_x = TriggerPipeline(grid)
    coastal = [np.abs(np.asarray(pipe_x.distance_field(
        jnp.asarray(lsm), jnp.asarray(ci_t[t])))) <= 180.0 for t in (0, 2)]
    per_block = [cm.reshape(2, 32, 4, 128).any(axis=(1, 3)) for cm in coastal]
    assert per_block[0].any() and not per_block[0][:, 2].any()
    assert per_block[1][:, 2].any()

    rngs = np.random.default_rng(3)
    ws0 = (5 + rngs.random((nlat, nlon))).astype(F)
    wd0 = (360 * rngs.random((nlat, nlon)) - 180).astype(F)

    def state0():
        return TriggerState(tt=jnp.int32(14),
                            thc=jnp.zeros((nlat, nlon), jnp.float32),
                            windspeed=jnp.asarray(ws0),
                            winddir=jnp.asarray(wd0))

    args = (theta, u, v, lsm, z, std, p)
    ref = pipe_x.run(state0(), *args, ci_t=ci_t)
    pipe = TriggerPipeline(grid, use_pallas=True, pallas_interpret=True)
    _assert_scan_equal(pipe.run(state0(), *args, ci_t=ci_t), ref, nsteps,
                       (nlat, nlon))


@pytest.mark.chip
@pytest.mark.parametrize("case", ["small_case", "global_case"])
def test_ring_kernel_compiled_on_card(case, request):
    """The kernel as Triton compiles it for the card (no interpret mode)
    against the XLA ring search on the same card: bit-identical, because
    both sum in the same order and divide alike there."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m chip)")
    c = request.getfixturevalue(case)
    grid = Grid(lon=c["lon"], lat=c["lat"])
    nn = TriggerPipeline(grid).nn_max
    cdist = _cdist(c, grid)
    t0 = jnp.asarray((290.0 + 8.0 * np.random.default_rng(4).standard_normal(
        c["lsm"].shape)).astype(np.float32))
    ref = jax.jit(lambda t, cd: ring_thc(t, cd, nn, maxdist=180.0)[0])(
        t0, cdist)
    got = jax.jit(lambda t, cd: ring_thc_pallas(
        pad2d(t, nn, nn), pad2d(cd, nn, nn), cd, nn, 180.0))(t0, cdist)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
