#!/usr/bin/env python
"""On-card smoke test of the trigger pipeline.

Drives the main path — ``cli.run`` -> ``read_nc`` -> ``api.diag`` ->
``TriggerPipeline`` scan -> CF netCDF — on an NVIDIA GPU at the full width of
the north-star configuration (``global010``: the 0.1-degree globe, 1801 x 3600,
k = 15, nn = 19), with seed-generated data, and checks every result:

1. device  — JAX's default backend must be a GPU; prints its kind, the device
   count and the card's name and power limit;
2. kernel  — at the ``global025`` and ``global010`` widths, the compiled
   ring kernel (``ops.pallas.ring_kernel``) against the XLA ring search (bit
   for bit), then the step with it against the plain jnp ``trigger_step``
   at tt in {1, 15, 16}, all four outputs and the carried state; then
   ms/step of the scan both ways;
3. api     — ``api.diag`` at ``regional025`` over 3 steps entered at tt = 14
   (the 6-hourly wind refresh falls inside) against the C++ oracle
   (``native/oracle.cc``), and at ``global010`` over 3 steps against the
   same jnp program on the host CPU backend of this process;
4. driver  — two seed-generated ``global010`` monthly netCDF files of 8
   six-hourly steps (nlev = 4) plus static files, run through
   ``cli.run``; the written ``sb_con`` and ``thc`` are read back and checked
   against the phase-3 reference; the second file must hit the executable
   cache.

``--four-gpus`` runs only the sharded path instead: ``api.diag(...,
mesh="auto")`` on four cards at ``global010`` against one card, with ms/step
and peak device memory of each card.

Every phase raises on failure; the script then exits non-zero and prints no
result.  On success the last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Usage::

    python chip_smoke.py [--seed 0] [--four-gpus [--trace-dir DIR]]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MISSING = np.float32(2.0e20)
#: value tolerance of two runs of the same program: bench.py's on-device gate
RTOL, ATOL = 2e-5, 2e-4
#: cdist comes out of sqrt and atan2, whose last bits differ between XLA:GPU,
#: XLA:CPU and the C++ oracle's libm (a few ulp: 3e-5 km per ulp at 360 km).
#: A cell whose reference |cdist| sits within EPS_KM of maxdist (the coastal
#: band's edge) or of 2 * maxdist (the sentinel cap) may therefore flip
#: between coastal and not, or between a distance and the sentinel.  Such a
#: flip is allowed at that cell and — because it changes the cell's land/sea
#: class — inside the ring windows (radius nn_max) around it; everywhere
#: else the comparison is exact in structure and within RTOL/ATOL in value.
EPS_KM = 1e-3
#: Runs that are not the same XLA program on the same backend — XLA:GPU
#: against XLA:CPU, or four shards against one card, whose global sigmoid
#: statistics are summed in another order — differ in the last bits of t0
#: and of the ring-window means (exp, division, reduction order): up to 4
#: ulp of ~300 K, 1.2e-4 K, in n_thc.  sb_con = scale_thc * scale_wind
#: amplifies an n_thc change by scale_wind * thresh_thc / thc^2, at most
#: thresh_wind / thresh_thc (14.7 at the defaults), so there sb_con is held
#: to that product as its absolute tolerance (sb_atol); every other field
#: keeps RTOL/ATOL.
T0_ULPS = 4 * float(np.spacing(np.float32(300.0)))


def sb_atol(params):
    """Absolute sb_con tolerance between runs that differ in t0's last bits
    (see T0_ULPS)."""
    return params.thresh_wind / params.thresh_thc * T0_ULPS


#: The C++ oracle sums each ring window cell by cell from scratch, the
#: pipeline incrementally (ops.ring_search), both in float32 as the
#: reference does.  The two orders round differently, and the worst-case
#: rounding of a float32 sum grows with its number of terms.  Against the
#: oracle a cell is therefore held to the repo's golden tolerance
#: (tests/test_diag_e2e.py: rtol = atol = 5e-4) times (r / nn)^2, where r is
#: the cell's own ring radius and nn the grid's physical ring bound (k + 2 +
#: margin): 1 for every cell of a physical coastline; larger only where the
#: regional025 domain's fake wrap seam pushes a window to ~110 cells, i.e.
#: ~50,000 values of ~300 K summing to ~1.5e7 (1 ulp = 1.0).
ORACLE_TOL = 5e-4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of every generated field")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path: global010 on four "
                         "cards against one card")
    ap.add_argument("--trace-dir", default=None,
                    help="with --four-gpus: write a jax.profiler trace of "
                         "one four-card scan here")
    return ap.parse_args(argv)


def select_phases(args):
    """The (name, function) phases the arguments ask for, in order."""
    if args.four_gpus:
        return [("four_gpus", phase_four_gpus)]
    return [("kernel", phase_kernel), ("api", phase_api),
            ("driver", phase_driver)]


# ---------------------------------------------------------------------------
# helpers

def _bench():
    sys.path.insert(0, REPO)
    import bench
    return bench


def _grid(name):
    from seabreeze_param_tpu.core.grid import Grid
    bench = _bench()
    nlat, nlon = bench.GRIDS[name]
    lat0, lat1, span = bench.GRID_DOMAIN.get(name, (90.0, -90.0, 360.0))
    return Grid.regular(nlat, nlon, lat0=lat0, lat1=lat1, lon1=span)


def _world(name, nt, seed):
    nlat, nlon = _bench().GRIDS[name]
    return _bench().make_world(nlat, nlon, 4, nt, seed=seed)


def _state(tt, shape, seed):
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.state import TriggerState
    rng = np.random.default_rng(seed)
    return TriggerState(
        tt=jnp.int32(tt),
        thc=jnp.asarray(290.0 + rng.standard_normal(shape), jnp.float32),
        windspeed=jnp.asarray(5.0 + rng.random(shape), jnp.float32),
        winddir=jnp.asarray(360.0 * rng.random(shape) - 180.0, jnp.float32))


def _flip_zone(grid, cds, maxdist):
    """Cells where a threshold flip of cdist is allowed (see EPS_KM): the
    near-threshold cells of any step, grown by the ring bound api.diag
    compiles with for these distance fields."""
    from scipy.ndimage import maximum_filter
    from seabreeze_param_tpu.core.params import Params
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu.ops.ring_search import required_ring_radius_host
    near = np.zeros(np.shape(cds[0]), bool)
    for cd in cds:
        a = np.abs(np.asarray(cd))
        near |= ((np.abs(a - maxdist) < EPS_KM)
                 | (np.abs(a - 2.0 * maxdist) < EPS_KM))
    if not near.any():
        return 0, near
    margin = Params().ring_search_margin
    nn = max([TriggerPipeline(grid).nn_max]
             + [required_ring_radius_host(cd, maxdist) + margin
                for cd in cds])
    return int(near.sum()), maximum_filter(near, size=2 * nn + 1,
                                           mode="wrap")


def _cell_radius(cds):
    """Per cell, the largest over steps of the ring radius at which its
    window first holds both cdist classes (Chebyshev distance to the nearer
    class, lon wrapped, lat edge-replicated as the reference's maps do)."""
    from scipy.ndimage import distance_transform_cdt
    r = 1
    for cd in cds:
        land = np.asarray(cd) >= 0.0
        p = max(land.shape)
        padded = np.pad(np.pad(land, ((0, 0), (p, p)), mode="wrap"),
                        ((p, p), (0, 0)), mode="edge")
        d = np.maximum(distance_transform_cdt(padded, metric="chessboard"),
                       distance_transform_cdt(~padded, metric="chessboard"))
        r = np.maximum(r, d[p:-p, p:-p])
    return r


def compare(label, got, ref, zone=None, rtol=RTOL, atol=ATOL):
    """Identical missing-value structure and allclose values, outside the
    allowed flip zone (tolerances may be per-cell arrays); raises with the
    worst difference otherwise."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    if got.shape != ref.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {ref.shape}")
    keep = np.ones(ref.shape, bool)
    if zone is not None:
        keep &= ~np.broadcast_to(zone, ref.shape)
    miss_g, miss_r = got == MISSING, ref == MISSING
    bad_miss = (miss_g != miss_r) & keep
    if bad_miss.any():
        raise AssertionError(f"{label}: missing-value structure differs in "
                             f"{int(bad_miss.sum())} cells")
    sel = keep & ~miss_r
    if not np.isfinite(got[sel]).all():
        raise AssertionError(f"{label}: non-finite values")
    diff = np.abs(got[sel] - ref[sel])
    rtol = np.broadcast_to(rtol, ref.shape)[sel]
    atol = np.broadcast_to(atol, ref.shape)[sel]
    over = diff > atol + rtol * np.abs(ref[sel])
    if over.any():
        raise AssertionError(f"{label}: {int(over.sum())} of {over.size} "
                             f"cells beyond tolerance; max |diff| "
                             f"{float(diff.max())}")
    return float(diff.max()) if diff.size else 0.0


def _time_scan(fn, make_args, reps=3):
    """Median and min wall seconds of ``fn(*make_args())`` after one warm-up
    call, each ended by block_until_ready (arguments are rebuilt per call:
    the runners donate their state)."""
    import jax
    jax.block_until_ready(fn(*make_args()))
    ts = []
    for _ in range(reps):
        args = jax.block_until_ready(make_args())
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


# ---------------------------------------------------------------------------
# phase 2: the ring kernel against the plain jnp trigger_step

def phase_kernel(ctx):
    import jax
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.params import Params
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu.ops.indexing import pad2d
    from seabreeze_param_tpu.ops.pallas.ring_kernel import ring_thc_pallas
    from seabreeze_param_tpu.ops.ring_search import ring_thc
    from seabreeze_param_tpu.ops.trigger import trigger_step

    params = Params()
    for name in ("global025", "global010"):
        nt = 8
        grid = _grid(name)
        lsm, z, std, pres, theta, u, v, ci = _world(name, nt, ctx.seed)
        pipe = TriggerPipeline(grid)
        nn = pipe.nn_max
        statics = tuple(jnp.asarray(a) for a in (lsm, z, std, pres))
        cdist = jax.jit(pipe.distance_field)(statics[0], jnp.asarray(ci[0]))

        def stepper(use_pallas):
            return jax.jit(lambda st, th, uu, vv, cd, z_, std_, p_:
                           trigger_step(st, th, uu, vv, cd, z_, std_, p_,
                                        params, nn, use_pallas=use_pallas))

        # The kernel alone against the XLA ring search on the same inputs:
        # both sum every window in the same order and divide alike on the
        # card, so they must agree bit for bit.
        ring_xla = jax.jit(lambda t, cd: ring_thc(t, cd, nn,
                                                  maxdist=params.maxdist)[0])
        ring_kernel = jax.jit(lambda t, cd: ring_thc_pallas(
            pad2d(t, nn, nn), pad2d(cd, nn, nn), cd, nn, params.maxdist))
        t = jnp.asarray(theta[0])
        n_diff = int(np.sum(np.asarray(ring_kernel(t, cdist))
                            != np.asarray(ring_xla(t, cdist))))
        if n_diff:
            raise AssertionError(f"{name}: ring kernel differs from the XLA "
                                 f"ring search in {n_diff} cells")
        print(f"[kernel] {name}: ring kernel == XLA ring search, bit for bit",
              flush=True)

        xla_step, kernel_step = stepper(False), stepper(True)
        for tt in (1, 15, 16):
            state = _state(tt, lsm.shape, ctx.seed + tt)
            args = (state, jnp.asarray(theta[0]), jnp.asarray(u[0]),
                    jnp.asarray(v[0]), cdist, *statics[1:])
            r_state, r_out = xla_step(*args)
            g_state, g_out = kernel_step(*args)
            pairs = [(key, g_out[key], r_out[key]) for key in
                     ("sb_con", "t0", "windspeed", "winddir")]
            pairs += [(f"state {key}", getattr(g_state, key),
                       getattr(r_state, key))
                      for key in ("thc", "windspeed", "winddir")]
            diffs = {key: compare(f"{name} tt={tt} {key}", g, r)
                     for key, g, r in pairs}
            if int(g_state.tt) != int(r_state.tt):
                raise AssertionError(f"{name} tt={tt}: state.tt differs")
            worst = max(diffs, key=diffs.get)
            print(f"[kernel] {name} tt={tt}: kernel == jnp step "
                  f"(max |diff| {diffs[worst]:.3g}, in {worst})", flush=True)

        xs = (jnp.asarray(theta), jnp.asarray(u), jnp.asarray(v),
              jnp.asarray(ci))
        times = {}
        for label, use_pallas in (("xla", False), ("kernel", True),
                                  ("kernel", True), ("xla", False)):
            runner = TriggerPipeline(grid, use_pallas=use_pallas) \
                ._get_runner(True, jit=True)
            med, best = _time_scan(
                runner, lambda: (TriggerState.zeros(lsm.shape), xs)
                + statics + (None,))
            times.setdefault(label, []).append(med / nt * 1e3)
        print(f"[kernel] {name} scan of {nt} steps, ms/step (median of 3, "
              f"two rounds): ring kernel {times['kernel']}, "
              f"jnp {times['xla']} on {ctx.card}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: api.diag against the C++ oracle and the host CPU backend

def _oracle(tt, lsm, z, std, lon, lat, pres, u, v, theta, ci, ws, wd, thc,
            maxdist):
    sys.path.insert(0, REPO)
    from tests.golden import native_oracle as no
    if not no.available():
        build = subprocess.run(["make", "-C", os.path.join(REPO, "native"),
                                "liboracle.so"], capture_output=True,
                               text=True)
        raise RuntimeError(f"C++ oracle did not build (native/Makefile):\n"
                           f"{build.stdout[-2000:]}{build.stderr[-2000:]}")
    ws, wd, thc = (np.array(a, np.float32) for a in (ws, wd, thc))
    outs, cds = [], []
    for t in range(theta.shape[0]):
        coast = no.native_get_edges(lsm, ci[t])
        cd = no.native_get_dist(coast, lsm, lon, lat, maxdist)
        out = no.native_diag(tt + t, pres, z, std, theta[t], v[t], u[t], cd,
                             ws, wd, thc, maxdist=maxdist)
        thc, ws, wd = out[1].copy(), out[2].copy(), out[3].copy()
        outs.append(out)
        cds.append(cd)
    return np.stack(outs, axis=1), (thc, ws, wd), cds


def _check_diag(label, got, ref_outs, ref_state, zone, sb_tol=None,
                **tol):
    """``got`` = api.diag(..., full_output=True); ``ref_outs`` = (4, T, ...)
    in the oracle's slot order (sb_con, t0, windspeed, winddir).  ``sb_tol``
    overrides ``tol`` for sb_con.  Returns the largest difference."""
    _, sb, thc, ws, wd, outs = got
    sb_tol = tol if sb_tol is None else sb_tol
    pairs = [("sb_con", sb, ref_outs[0], sb_tol),
             ("outs sb_con", outs["sb_con"], ref_outs[0], sb_tol)]
    pairs += [(key, outs[key], ref_outs[slot], tol) for slot, key in
              enumerate(("t0", "windspeed", "winddir"), start=1)]
    pairs += [(f"state {key}", g, r, tol) for key, g, r in
              zip(("thc", "windspeed", "winddir"), (thc, ws, wd), ref_state)]
    return max(compare(f"{label} {key}", g, r, zone, **t)
               for key, g, r, t in pairs)


def phase_api(ctx):
    import jax
    from seabreeze_param_tpu import api
    from seabreeze_param_tpu.core.params import Params
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline

    maxdist = Params().maxdist
    # regional025, entered at tt=14: steps 14, 15 (6-hourly refresh), 16
    grid = _grid("regional025")
    lsm, z, std, pres, theta, u, v, ci = _world("regional025", 3, ctx.seed)
    st = _state(14, lsm.shape, ctx.seed + 14)
    ws0, wd0, thc0 = (np.asarray(a) for a in (st.windspeed, st.winddir,
                                                st.thc))
    got = api.diag(14, lsm, z, std, grid.lon, grid.lat, pres, u, v, theta,
                   ci, ws=ws0, wd=wd0, thc=thc0, full_output=True)
    ref_outs, ref_state, cds = _oracle(14, lsm, z, std, grid.lon, grid.lat,
                                       pres, u, v, theta, ci, ws0, wd0,
                                       thc0, maxdist)
    n_near, zone = _flip_zone(grid, cds, maxdist)
    # The reference threads its output slots back in as state, and those are
    # zero in the last lat row, which it never computes; the pipeline keeps
    # the carried state there (core.state).  That row is compared by neither
    # side's contract (tests/test_diag_e2e.py leaves it out too).
    zone = zone.copy()
    zone[-1] = True
    nn = TriggerPipeline(grid).nn_max
    scale = np.maximum(1.0, (_cell_radius(cds) / nn) ** 2)
    worst = _check_diag("regional025 vs oracle", got, ref_outs, ref_state,
                        zone, rtol=ORACLE_TOL * scale, atol=ORACLE_TOL * scale)
    print(f"[api] regional025 api.diag tt=14..16 == C++ oracle (rtol=atol="
          f"{ORACLE_TOL} x (r/{nn})^2, scale up to {scale.max():.3g}; max "
          f"|diff| {worst:.3g}; {n_near} cells within {EPS_KM} km of a cdist "
          f"threshold)", flush=True)

    # global010 over 3 steps from tt=1: the first steps of the driver's
    # first file (phase 4 checks its output against this reference)
    grid = _grid("global010")
    lsm, z, std, pres, theta, u, v, ci = ctx.global010_series()
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u[:3], v[:3],
            theta[:3], ci[:3])
    got = api.diag(*args, full_output=True)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        ref = api.diag(*args, full_output=True, use_pallas=False)
        pipe = TriggerPipeline(grid)
        dist = pipe.distance_field_jit()
        cds = [np.asarray(dist(lsm, ci[t])) for t in range(3)]
    _, sb, thc, ws, wd, outs = ref
    ref_outs = np.stack([outs[k] for k in ("sb_con", "t0", "windspeed",
                                           "winddir")])
    n_near, zone = _flip_zone(grid, cds, maxdist)
    sb_tol = dict(rtol=RTOL, atol=sb_atol(Params()))
    worst = _check_diag("global010 gpu vs cpu", got, ref_outs,
                        (thc, ws, wd), zone, sb_tol=sb_tol)
    print(f"[api] global010 api.diag tt=1..3 on the card == jnp on the host "
          f"CPU (sb_con atol {sb_tol['atol']:.3g}; max |diff| {worst:.3g}; "
          f"{n_near} cells within {EPS_KM} km of a cdist threshold)",
          flush=True)
    ctx.global010_ref = (ref_outs, zone, sb_tol)


# ---------------------------------------------------------------------------
# phase 4: the batch driver over generated netCDF files

def _write_inputs(root, lon, lat, series, months):
    """Static files and one monthly file per (u, v, t2m, ci) and month, in
    the layout io.meta discovers (datadir/YYYY/prefix{var}_YYYY_MM.nc)."""
    from datetime import datetime, timedelta
    from seabreeze_param_tpu.io import Dataset, date2num
    lsm, z, std, pres = series[:4]
    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "1987"))

    def static(path, fields):
        with Dataset(path, "w") as f:
            f.createDimension("longitude", len(lon))
            f.createDimension("latitude", len(lat))
            for nm, val in (("longitude", lon), ("latitude", lat)):
                f.createVariable(nm, "f", (nm,))[:] = val
            for nm, val in fields.items():
                f.createVariable(nm, "f", ("latitude", "longitude"))[:] = val

    static(os.path.join(data, "static_slm.nc"), {"lsm": lsm})
    static(os.path.join(data, "static_topo.nc"), {"z": z, "sdfor": std})
    units = "hours since 1987-01-01 00:00:00"
    for m, (theta, u, v, ci) in enumerate(months):
        times = [datetime(1987, m + 1, 1) + timedelta(hours=6 * i)
                 for i in range(theta.shape[0])]
        for var, arr in (("u", u), ("v", v), ("t2m", theta), ("ci", ci)):
            path = os.path.join(data, "1987", f"Synth_{var}_1987_{m + 1:02d}"
                                ".nc")
            with Dataset(path, "w") as f:
                f.createDimension("time", None)
                f.createDimension("level", len(pres))
                f.createDimension("latitude", len(lat))
                f.createDimension("longitude", len(lon))
                f.createVariable("time", "d", ("time",))[:] = date2num(
                    times, units)
                f.variables["time"].setncattr("units", units)
                f.createVariable("level", "f", ("level",))[:] = pres
                dims = ("time", "latitude", "longitude")
                if arr.ndim == 4:
                    dims = ("time", "level") + dims[1:]
                f.createVariable(var, "f", dims)[:] = arr
    conf = os.path.join(root, "run.conf")
    with open(conf, "w") as f:
        f.write(f"""datadir = {data}
landfracfile = {data}/static_slm.nc
topofile = {data}/static_topo.nc
orofile = {data}/static_topo.nc
prefix = Synth_
vtheta = t2m
vu = u
vv = v
vlon = longitude
vlat = latitude
vpres = level
vci = ci
vlandfrac = lsm
vz = z
vstd = sdfor
vtime = time
plev = 700
start = 1987-01-01_00:00
end = 1987-02-03_00:00
""")
    return conf


def phase_driver(ctx):
    from seabreeze_param_tpu import api
    from seabreeze_param_tpu.cli.run import main as run_main
    from seabreeze_param_tpu.io import Dataset

    grid = _grid("global010")
    series = ctx.global010_series()
    lsm, z, std, pres, theta, u, v, ci = series
    months = [tuple(a[8 * m:8 * (m + 1)] for a in (theta, u, v, ci))
              for m in range(2)]
    root = os.path.join(REPO, ".smoke_data")
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        conf = _write_inputs(root, grid.lon, grid.lat, series, months)
        print(f"[driver] wrote 2 x 8 steps of global010 input (nlev=4) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        api.clear_exec_cache()
        metrics = os.path.join(root, "metrics.jsonl")
        t0 = time.perf_counter()
        run_main(conf, progress=None, metrics_file=metrics)
        wall = time.perf_counter() - t0
        with open(metrics) as f:
            lines = [json.loads(line) for line in f]
        if len(lines) != 2:
            raise AssertionError(f"driver processed {len(lines)} files, "
                                 f"want 2")
        if lines[1]["exec_cache_misses"] != lines[0]["exec_cache_misses"] \
                or lines[1]["exec_cache_hits"] <= lines[0]["exec_cache_hits"]:
            raise AssertionError(f"second file missed the executable cache: "
                                 f"{lines}")
        done = 0
        for line in lines:
            steps, done = line["steps"] - done, line["steps"]
            print(f"[driver] {line['file']}: api.diag "
                  f"{line['step_ms'] * steps / 1e3:.2f} s for {steps} steps "
                  f"({line['step_ms']} ms/step incl. host probe and "
                  f"transfers); exec cache hits {line['exec_cache_hits']}, "
                  f"misses {line['exec_cache_misses']}", flush=True)
        print(f"[driver] whole run {wall:.1f} s on {ctx.card}", flush=True)

        ref_outs, zone, sb_tol = ctx.global010_ref
        for m in range(2):
            path = os.path.join(root, "data", "1987",
                                f"Synth_sb_1987_{m + 1:02d}.nc")
            with Dataset(path) as f:
                sb = np.ma.getdata(f.variables["sb_con"][:])
                thc = np.ma.getdata(f.variables["thc"][:])
            if sb.shape != (8,) + lsm.shape or thc.shape != sb.shape:
                raise AssertionError(f"{path}: shapes {sb.shape}, "
                                     f"{thc.shape}")
            for key, arr in (("sb_con", sb), ("thc", thc)):
                live = arr != MISSING
                if not np.isfinite(arr[live]).all():
                    raise AssertionError(f"{path} {key}: non-finite values")
            if m == 0:
                compare("driver sb_con steps 1-3", sb[:3], ref_outs[0], zone,
                        **sb_tol)
                compare("driver thc steps 1-3", thc[:3], ref_outs[1], zone)
        print("[driver] written sb_con and thc read back; file 1 steps "
              "1-3 == the phase-3 CPU reference", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# --four-gpus: the sharded path on four cards against one card

def phase_four_gpus(ctx):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from seabreeze_param_tpu import api
    from seabreeze_param_tpu.core.params import Params
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu.parallel.mesh import make_mesh
    from seabreeze_param_tpu.parallel.sharded import ShardedPipeline

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-gpus needs 4 cards, found {len(devices)}")
    grid = _grid("global010")
    nt = 8
    lsm, z, std, pres, theta, u, v, ci = _world("global010", nt, ctx.seed)
    args = (1, lsm, z, std, grid.lon, grid.lat, pres, u[:3], v[:3],
            theta[:3], ci[:3])
    one = api.diag(*args, full_output=True)
    four = api.diag(*args, full_output=True, mesh="auto")
    _, sb, thc, ws, wd, outs = one
    ref_outs = np.stack([outs[k] for k in ("sb_con", "t0", "windspeed",
                                           "winddir")])
    pipe = TriggerPipeline(grid, use_pallas=True)
    dist = pipe.distance_field_jit()
    cds = [np.asarray(dist(lsm, ci[t])) for t in range(3)]
    n_near, zone = _flip_zone(grid, cds, Params().maxdist)
    sb_tol = dict(rtol=RTOL, atol=sb_atol(Params()))
    worst = _check_diag("global010 4 cards vs 1", four, ref_outs,
                        (thc, ws, wd), zone, sb_tol=sb_tol)
    print(f"[four_gpus] api.diag(mesh='auto') on 4 cards == 1 card over 3 "
          f"steps (sb_con atol {sb_tol['atol']:.3g}; max |diff| {worst:.3g}; "
          f"{n_near} cells within {EPS_KM} km of a cdist threshold)",
          flush=True)

    # device-resident scans of nt steps: one card, then the 2x2 mesh
    statics = tuple(jnp.asarray(a) for a in (lsm, z, std, pres))
    xs = tuple(jnp.asarray(a) for a in (theta, u, v, ci))
    runner = pipe._get_runner(True, jit=True)
    med1, _ = _time_scan(runner, lambda: (TriggerState.zeros(lsm.shape), xs)
                         + statics + (None,))
    sp = ShardedPipeline(pipe, make_mesh(None, devices[:4]))
    fn = sp.build(True, False)
    fld = NamedSharding(sp.mesh, P("y", "x"))
    put = lambda a, spec: jax.device_put(  # noqa: E731
        jnp.asarray(np.asarray(a)), NamedSharding(sp.mesh, spec))
    from seabreeze_param_tpu.parallel.sharded import _pad_lat_host
    pad = lambda a: _pad_lat_host(np.asarray(a), sp.nlat_pad)  # noqa: E731
    xs4 = (put(pad(theta), P(None, "y", "x")),
           put(pad(u), P(None, None, "y", "x")),
           put(pad(v), P(None, None, "y", "x")),
           put(pad(ci), P(None, "y", "x")))
    st4 = tuple(put(pad(a), P("y", "x")) for a in (lsm, z, std))
    tables = tuple(jax.device_put(jnp.asarray(t), NamedSharding(sp.mesh, P()))
                   for t in sp.tables)
    shape4 = (sp.nlat_pad, lsm.shape[1])

    def state4():
        zero = jax.device_put(jnp.zeros(shape4, jnp.float32), fld)
        return (TriggerState(tt=jnp.int32(1), thc=zero, windspeed=zero,
                             winddir=zero), xs4)

    p4 = jnp.asarray(pres)
    med4, _ = _time_scan(fn, lambda: state4() + st4 + (p4,) + tables)
    if ctx.trace_dir:
        args4 = jax.block_until_ready(state4() + st4 + (p4,) + tables)
        with jax.profiler.trace(ctx.trace_dir):
            jax.block_until_ready(fn(*args4))
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
             for d in devices[:4]]
    print(f"[four_gpus] global010 scan of {nt} steps, ms/step: 1 card "
          f"{med1 / nt * 1e3:.4f}, 4 cards (2x2 mesh) {med4 / nt * 1e3:.4f}; "
          f"peak_bytes_in_use per card {peaks} on {ctx.card}", flush=True)


# ---------------------------------------------------------------------------

class _Context:
    """What the phases share: the seed, the card line, and the global010
    series (made once, used by phases 3 and 4)."""

    def __init__(self, args, card):
        self.seed = args.seed
        self.trace_dir = args.trace_dir
        self.card = card
        self.global010_ref = None
        self._series = None

    def global010_series(self):
        if self._series is None:
            self._series = _world("global010", 16, self.seed + 100)
        return self._series


def main(argv=None):
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from seabreeze_param_tpu.utils.compile_cache import enable
    from seabreeze_param_tpu.utils.tracing import card_info, require_gpu
    devices = require_gpu()
    enable()
    card = card_info()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    print(f"[device] {device['count']} x {device['kind']} "
          f"({device['platform']})", flush=True)
    print(card, flush=True)
    ctx = _Context(args, card.splitlines()[0])
    for name, phase in select_phases(args):
        t0 = time.perf_counter()
        phase(ctx)
        print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
