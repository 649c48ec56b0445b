"""Aux-subsystem tests: tracing, checkpoint/resume, composites, dummy model.

These cover SURVEY §5's auxiliary inventory: the DrHook-equivalent tracer
(§5.1), orbax checkpoint/resume of the threaded state (§5.4), the
seasonal-composite analysis driver (§2.19), and the runnable dummy-model
coupling example (§2.10).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

F = np.float32


# -- tracing (§5.1) ---------------------------------------------------------
def test_tracer_records_and_reports():
    from seabreeze_param_tpu.utils.tracing import Tracer
    tr = Tracer(enabled=True)
    with tr.hook("outer"):
        with tr.hook("inner"):
            sum(range(1000))
    rep = tr.report()
    assert "outer" in rep and "inner" in rep
    assert tr.records["outer"].calls == 1
    assert tr.records["outer"].child_s <= tr.records["outer"].total_s
    # self time of outer excludes inner
    assert tr.records["outer"].self_s >= 0
    tr.reset()
    assert not tr.records


def test_tracer_disabled_is_passthrough():
    from seabreeze_param_tpu.utils.tracing import Tracer
    tr = Tracer(enabled=False)
    with tr.hook("x"):
        pass
    assert not tr.records


def test_device_info():
    from seabreeze_param_tpu.utils.tracing import device_info
    info = device_info()
    assert info["num_devices"] == 8  # conftest virtual mesh
    assert info["platform"] == "cpu"


# -- checkpoint / resume (§5.4) --------------------------------------------
def test_checkpoint_roundtrip(tmp_path):
    from seabreeze_param_tpu.core.checkpoint import (latest_step,
                                                     restore_state,
                                                     save_state)
    from seabreeze_param_tpu.core.state import TriggerState

    ckdir = str(tmp_path / "ck")
    assert latest_step(ckdir) is None
    state0, extra0 = restore_state(ckdir)
    assert state0 is None and extra0 is None

    rng = np.random.default_rng(0)
    st = TriggerState(tt=np.int32(7),
                      thc=rng.random((8, 16)).astype(F),
                      windspeed=rng.random((8, 16)).astype(F),
                      winddir=rng.random((8, 16)).astype(F))
    step = save_state(ckdir, st, extra={"sb_con": np.ones((8, 16), F)})
    assert step == 7
    assert latest_step(ckdir) == 7

    back, extra = restore_state(ckdir)
    assert int(np.asarray(back.tt)) == 7
    np.testing.assert_array_equal(back.thc, st.thc)
    np.testing.assert_array_equal(extra["sb_con"], np.ones((8, 16), F))


def test_checkpoint_resume_continues_run(tmp_path):
    """Save mid-run, restore, continue — final state equals the unbroken
    run (the reference's cross-file state-threading contract,
    test_run.py:39-49)."""
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.checkpoint import restore_state, save_state
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline

    nlat, nlon, nlev, nt = 24, 32, 3, 6
    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:nlat, 0:nlon]
    lsm = ((x > nlon // 2).astype(F) * (0.7 + 0.3 * rng.random((nlat, nlon))))
    z = 300.0 * lsm
    std = (80.0 * lsm).astype(F)
    pres = np.array([100000.0, 70000.0, 50000.0], F)
    th = (288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon))).astype(F)
    uu = (5.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    vv = (5.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)

    grid = Grid.regular(nlat, nlon, lat0=30.0, lat1=-30.0)
    pipe = TriggerPipeline(grid)
    # unbroken run  (fresh states each run: pipe.run donates the state arg)
    full, _ = pipe.run(TriggerState.zeros((nlat, nlon)), th, uu, vv, lsm, z,
                       std, pres)

    # broken run: 3 steps, checkpoint, restore, 3 more
    mid, _ = pipe.run(TriggerState.zeros((nlat, nlon)), th[:3], uu[:3],
                      vv[:3], lsm, z, std, pres)
    save_state(str(tmp_path / "ck"), mid)
    res, _ = restore_state(str(tmp_path / "ck"))
    fin, _ = pipe.run(
        TriggerState(tt=jnp.asarray(res.tt), thc=jnp.asarray(res.thc),
                     windspeed=jnp.asarray(res.windspeed),
                     winddir=jnp.asarray(res.winddir)),
        th[3:], uu[3:], vv[3:], lsm, z, std, pres)

    assert int(np.asarray(fin.tt)) == int(np.asarray(full.tt))
    np.testing.assert_allclose(np.asarray(fin.thc), np.asarray(full.thc),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(fin.windspeed),
                               np.asarray(full.windspeed), atol=1e-6)


# -- composites (§2.19) -----------------------------------------------------
def test_diurnal_mean_and_composite_math(tmp_path):
    from datetime import datetime
    from seabreeze_param_tpu.cli.composites import diurnal_mean
    from seabreeze_param_tpu.io import Dataset, date2num

    # two days, 4 steps/day, value = day index -> diurnal mean = 0.5
    nlat, nlon = 4, 6
    times = [datetime(1987, 1, 1 + d, 6 * h) for d in range(2)
             for h in range(4)]
    units = "hours since 1987-01-01 00:00:00"
    data = np.zeros((8, nlat, nlon), F)
    data[4:] = 1.0
    path = str(tmp_path / "in.nc")
    with Dataset(path, "w") as f:
        f.createDimension("time", None)
        f.createDimension("lat", nlat)
        f.createDimension("lon", nlon)
        f.createVariable("time", "d", ("time",))
        f.variables["time"][:] = date2num(times, units)
        f.variables["time"].setncattr("units", units)
        v = f.createVariable("sb_con", "f", ("time", "lat", "lon"))
        v[:] = data
    cycle = diurnal_mean(path, "sb_con")
    assert cycle.shape == (4, nlat, nlon)
    np.testing.assert_allclose(cycle, 0.5)


# -- dummy model (§2.10) ----------------------------------------------------
@pytest.mark.parametrize("sharded", [False, True])
def test_dummy_model_runs(sharded):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import dummy_model
    final, sb = dummy_model.run(steps=3, sharded=sharded)
    sb = np.asarray(sb)
    assert sb.shape[0] == 3
    assert int(np.asarray(final.tt)) == 4
    active = sb[sb < 1.0e19]
    assert np.isfinite(active).all()


# -- metrics (§5.5) ---------------------------------------------------------
def test_step_metrics():
    import io, json
    from seabreeze_param_tpu.utils.metrics import StepMetrics
    buf = io.StringIO()
    m = StepMetrics(grid_points=1000, stream=buf)
    for _ in range(3):
        with m.step():
            sum(range(10000))
    m.add(halo_bytes=42)
    m.emit()
    rec = json.loads(buf.getvalue())
    assert rec["steps"] == 3
    assert rec["points_per_s"] > 0
    assert rec["halo_bytes"] == 42


# -- failure detection / elastic recovery (§5.3) -----------------------------
def test_run_resilient_recovers_from_failures(tmp_path):
    """A unit that fails transiently is retried from the last checkpoint and
    the final state matches an uninterrupted run exactly."""
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.utils.resilience import run_resilient

    shape = (4, 6)

    def mk_state():
        return TriggerState(tt=np.int32(1), thc=np.zeros(shape, F),
                            windspeed=np.zeros(shape, F),
                            winddir=np.zeros(shape, F))

    def step(state, unit):
        return TriggerState(tt=state.tt + 1,
                            thc=state.thc + F(unit),
                            windspeed=state.windspeed + F(2 * unit),
                            winddir=state.winddir)

    units = [1.0, 2.0, 3.0, 4.0]
    # uninterrupted reference
    ref = mk_state()
    for u in units:
        ref = step(ref, u)

    fails = {"left": 2}

    def flaky(state, unit):
        if unit == 3.0 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("transient backend failure")
        return step(state, unit)

    final, done = run_resilient(units, flaky, mk_state(),
                                str(tmp_path / "ck"), save_every=1,
                                max_retries=3)
    assert done == len(units)
    assert fails["left"] == 0
    assert int(final.tt) == int(ref.tt)
    np.testing.assert_array_equal(np.asarray(final.thc), np.asarray(ref.thc))
    np.testing.assert_array_equal(np.asarray(final.windspeed),
                                  np.asarray(ref.windspeed))


def test_run_resilient_resumes_across_processes(tmp_path):
    """A new runner pointed at the same checkpoint dir skips completed
    units — the automatic form of the reference's manual state threading."""
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.utils.resilience import run_resilient

    shape = (3, 3)
    state0 = TriggerState(tt=np.int32(1), thc=np.zeros(shape, F),
                          windspeed=np.zeros(shape, F),
                          winddir=np.zeros(shape, F))

    seen = []

    def step(state, unit):
        seen.append(unit)
        if unit == "c":
            raise KeyboardInterrupt  # simulated preemption
        return TriggerState(tt=state.tt + 1, thc=state.thc + F(1.0),
                            windspeed=state.windspeed, winddir=state.winddir)

    units = ["a", "b", "c", "d"]
    with pytest.raises(KeyboardInterrupt):
        run_resilient(units, step, state0, str(tmp_path / "ck"),
                      save_every=1, max_retries=0)
    assert seen == ["a", "b", "c"]

    # "new process": same directory, same units, failure gone
    def step2(state, unit):
        seen.append(("2", unit))
        return TriggerState(tt=state.tt + 1, thc=state.thc + F(1.0),
                            windspeed=state.windspeed, winddir=state.winddir)

    final, done = run_resilient(units, step2, state0, str(tmp_path / "ck"))
    assert done == len(units)
    assert [x[1] for x in seen if isinstance(x, tuple)] == ["c", "d"]
    assert int(final.tt) == 5
    np.testing.assert_array_equal(np.asarray(final.thc),
                                  np.full(shape, 4.0, F))


def test_run_resilient_watchdog_aborts_stalled_unit(tmp_path):
    """The acting watchdog: a unit making no progress past the deadline is
    aborted (async StallError in the runner thread) and re-entered through
    the restore/retry path; the run then completes normally."""
    import time
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.utils.resilience import StallError, run_resilient

    shape = (3, 3)
    state0 = TriggerState(tt=np.int32(1), thc=np.zeros(shape, F),
                          windspeed=np.zeros(shape, F),
                          winddir=np.zeros(shape, F))
    attempts = []

    def step(state, unit):
        attempts.append(unit)
        if unit == "b" and attempts.count("b") == 1:
            # Hang in short Python-level sleeps so the async exception can
            # land (a single blocked C call could not be interrupted —
            # documented limitation).
            try:
                for _ in range(100):
                    time.sleep(0.05)
            except StallError:
                raise
            raise AssertionError("watchdog never fired")
        return TriggerState(tt=state.tt + 1, thc=state.thc + F(1.0),
                            windspeed=state.windspeed, winddir=state.winddir)

    units = ["a", "b", "c"]
    final, done = run_resilient(units, step, state0, str(tmp_path / "ck"),
                                save_every=1, max_retries=2,
                                watchdog_deadline_s=0.4)
    assert done == len(units)
    assert attempts.count("b") == 2          # aborted once, retried once
    assert int(final.tt) == 4
    np.testing.assert_array_equal(np.asarray(final.thc),
                                  np.full(shape, 3.0, F))


def test_watchdog_detects_stall():
    import time
    from seabreeze_param_tpu.utils.resilience import Watchdog

    stalls = []
    with Watchdog(deadline_s=0.15, on_stall=stalls.append,
                  poll_s=0.03) as wd:
        wd.beat()
        time.sleep(0.35)           # no beats -> stall fires once
        assert wd.stall_count == 1
        wd.beat()                  # re-arm
        time.sleep(0.35)
        assert wd.stall_count == 2
    assert len(stalls) == 2 and stalls[0] >= 0.15


def test_checkpoint_sharded_roundtrip(tmp_path):
    """Sharded save/restore: fields stay jax.Arrays with their NamedSharding
    (no host gather); the restored state carries the target sharding and the
    original values."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from seabreeze_param_tpu.core.checkpoint import (restore_state_sharded,
                                                     save_state_sharded)
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((2, 4))
    fld = NamedSharding(mesh, P("y", "x"))
    repl = NamedSharding(mesh, P())
    rng = np.random.default_rng(2)
    arr = lambda: jax.device_put(
        rng.standard_normal((16, 32)).astype(np.float32), fld)
    state = TriggerState(tt=jax.device_put(jnp.int32(9), repl), thc=arr(),
                         windspeed=arr(), winddir=arr())
    step = save_state_sharded(str(tmp_path), state)
    assert step == 9

    like = TriggerState(
        tt=jax.ShapeDtypeStruct((), jnp.int32, sharding=repl),
        thc=jax.ShapeDtypeStruct((16, 32), jnp.float32, sharding=fld),
        windspeed=jax.ShapeDtypeStruct((16, 32), jnp.float32, sharding=fld),
        winddir=jax.ShapeDtypeStruct((16, 32), jnp.float32, sharding=fld))
    got = restore_state_sharded(str(tmp_path), like)
    assert got.thc.sharding.is_equivalent_to(fld, 2)
    assert int(got.tt) == 9
    np.testing.assert_array_equal(np.asarray(got.thc),
                                  np.asarray(state.thc))
    np.testing.assert_array_equal(np.asarray(got.winddir),
                                  np.asarray(state.winddir))
    # missing checkpoint -> None
    assert restore_state_sharded(str(tmp_path / "empty"), like) is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_directory_rule(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and the code then sets no directory of
    its own; unset, the cache lives at a fixed path inside the checkout."""
    import jax
    from seabreeze_param_tpu.utils import compile_cache

    updates = {}
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.__setitem__(name, val))
    monkeypatch.setattr(compile_cache.os, "makedirs",
                        lambda path, exist_ok=False: updates.setdefault(
                            "makedirs", path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable() == str(tmp_path)
        assert "jax_compilation_cache_dir" not in updates
        assert "makedirs" not in updates
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(repo, ".jax_cache")
        assert compile_cache.enable() == want
        assert updates["jax_compilation_cache_dir"] == want
        assert updates["makedirs"] == want
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
