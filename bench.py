#!/usr/bin/env python
"""Benchmark harness: full trigger pipeline throughput.

Runs the flagship workload — the global 0.25-degree trigger pipeline with a
moving sea-ice field (so the coastline + coast-distance transform is rebuilt
every step, the reference's hot path, ``__init__.py:219-245``) — on one GPU
and prints ONE JSON line per grid::

    {"metric": ..., "value": N, "unit": "grid-points/s", "vs_baseline": N,
     "ms_per_step": N, "device": {...}, "verified": bool}

The device block names the platform, ``device_kind``, device count and the
card's name and power limit.  Without a GPU it exits non-zero; it never
falls back to the CPU.

``vs_baseline`` compares against the recorded CPU-host baseline in
``benchmarks/baseline_cpu.json`` (the reference is Fortran+OpenMP on CPU; no
Fortran compiler exists in this image, so the committed baseline is the same
pipeline semantics executed on all host CPU cores — see
benchmarks/README.md).  Falls back to 1.0 when absent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def make_world(nlat, nlon, nlev, nt, seed=0):
    rng = np.random.default_rng(seed)
    F = np.float32
    y, x = np.mgrid[0:nlat, 0:nlon]
    coastx = (0.55 * nlon + 0.08 * nlon * np.sin(2 * np.pi * y / nlat * 2.3)
              + 0.03 * nlon * np.sin(2 * np.pi * y / nlat * 7.1))
    land = (x > coastx).astype(F)
    for cy, cx, r in ((int(0.3 * nlat), int(0.25 * nlon), 0.05),
                      (int(0.7 * nlat), int(0.15 * nlon), 0.03)):
        land[(y - cy) ** 2 + (x - cx) ** 2 < (r * nlon) ** 2] = 1.0
    lsm = (land * (0.6 + 0.4 * rng.random((nlat, nlon)))).astype(F)
    z = (700.0 * lsm * rng.random((nlat, nlon))).astype(F)
    std = (110.0 * lsm * rng.random((nlat, nlon))).astype(F)
    pres = np.linspace(100000.0, 50000.0, nlev).astype(F)
    theta = (288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon))).astype(F)
    u = (6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    v = (6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F)
    ci = np.zeros((nt, nlat, nlon), F)
    ci[:, : nlat // 12, :] = 0.8  # polar sea ice: coastline moves every step
    return lsm, z, std, pres, theta, u, v, ci


GRIDS = {
    # name: (nlat, nlon)  — global lat-lon resolutions
    "global100": (181, 360),     # 1.0 deg
    "global050": (361, 720),     # 0.5 deg
    "global025": (721, 1440),    # 0.25 deg  (headline config, BASELINE.md #3)
    "global010": (1801, 3600),   # 0.1 deg   (north-star config, BASELINE.md #4)
    # regional 0.25 deg (BASELINE.md config #2): a maritime-continent-sized
    # domain, ~40S-40N x 80 deg of longitude
    "regional025": (320, 320),
}

#: non-global domains: (lat0, lat1, lon_span_deg)
GRID_DOMAIN = {"regional025": (40.0, -39.75, 80.0)}


def _enable_compile_cache():
    from seabreeze_param_tpu.utils.compile_cache import enable
    enable()


def _grid(grid_name):
    from seabreeze_param_tpu.core.grid import Grid
    nlat, nlon = GRIDS[grid_name]
    lat0, lat1, lon_span = GRID_DOMAIN.get(grid_name, (90.0, -90.0, 360.0))
    return Grid.regular(nlat, nlon, lat0=lat0, lat1=lat1, lon1=lon_span)


def verify(grid_name: str, nlev: int, steps: int = 3):
    """On-device check of the ring kernel: a SHORT SCAN (``steps`` >= 3,
    entered at tt=14 so the window spans the 6-hourly wind-refresh cadence
    branch at tt=15: 15 * 24 min = 6 h) with the compiled kernel vs the
    pure-XLA path, both on the card.  Running the compiled scan — not a
    single step — also verifies the state carry.

    Returns True when every per-step output field and the final carried
    state (thc/windspeed/winddir) agree: identical missing-value structure,
    allclose elsewhere.  The ring search itself is bit-identical on the
    card; the two scans are separately compiled programs, whose t0 (and so
    the thc state) can differ in its last bit.
    """
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline

    nlat, nlon = GRIDS[grid_name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, nlev, steps,
                                                    seed=3)
    grid = _grid(grid_name)
    results = {}
    for name, use_pallas in (("pallas", True), ("xla", False)):
        pipe = TriggerPipeline(grid, use_pallas=use_pallas)
        # tt=14: steps 14 (pre-refresh), 15 (refresh), 16 (post-refresh)
        state = TriggerState(tt=jnp.int32(14),
                             thc=jnp.zeros((nlat, nlon), jnp.float32),
                             windspeed=jnp.full((nlat, nlon), 5.0,
                                                jnp.float32),
                             winddir=jnp.full((nlat, nlon), 90.0,
                                              jnp.float32))
        st, out = pipe.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        results[name] = {k: np.asarray(val) for k, val in out.items()}
        results[name]["_thc_state"] = np.asarray(st.thc)
        results[name]["_ws_state"] = np.asarray(st.windspeed)
        results[name]["_wd_state"] = np.asarray(st.winddir)
    ok = True
    for key in ("sb_con", "t0", "windspeed", "winddir", "_thc_state",
                "_ws_state", "_wd_state"):
        g, r = results["pallas"][key], results["xla"][key]
        miss_g, miss_r = g == np.float32(2e20), r == np.float32(2e20)
        if not np.array_equal(miss_g, miss_r):
            ok = False
            print(f"# VERIFY FAIL {key}: missing-value structure differs",
                  file=sys.stderr)
            continue
        sel = ~miss_r
        if not np.allclose(g[sel], r[sel], rtol=2e-5, atol=2e-4):
            bad = np.abs(g[sel] - r[sel]).max()
            ok = False
            print(f"# VERIFY FAIL {key}: max abs diff {bad}",
                  file=sys.stderr)
    return ok


def run(grid_name: str, steps: int, nlev: int, use_pallas: bool,
        repeats: int = 3):
    """Best-of-``repeats`` wall time of one jitted ``steps``-long scan (the
    runner ``api.diag`` uses), ended by ``block_until_ready``."""
    import jax
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline

    nlat, nlon = GRIDS[grid_name]
    lsm, z, std, pres, theta, u, v, ci = make_world(nlat, nlon, nlev, steps)
    pipe = TriggerPipeline(_grid(grid_name), use_pallas=use_pallas)
    xs = (jnp.asarray(theta), jnp.asarray(u), jnp.asarray(v),
          jnp.asarray(ci))
    statics = (jnp.asarray(lsm), jnp.asarray(z), jnp.asarray(std),
               jnp.asarray(pres))
    runner = pipe._get_runner(True, jit=True)

    def once():
        state = jax.block_until_ready(TriggerState.zeros((nlat, nlon)))
        t0 = time.perf_counter()
        jax.block_until_ready(runner(state, xs, *statics, None))
        return time.perf_counter() - t0

    once()                                   # compile + warm up
    best = min(once() for _ in range(repeats))
    return steps * nlat * nlon / best, best / steps, pipe.k, pipe.nn_max


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", default="global025", choices=sorted(GRIDS))
    ap.add_argument("--steps", type=int, default=32,
                    help="timesteps per timed scan (bounds device memory)")
    ap.add_argument("--nlev", type=int, default=4)
    ap.add_argument("--no-pallas", dest="pallas", action="store_false",
                    help="time the pure-XLA ring search instead of the "
                         "ring kernel")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the on-device kernel-vs-XLA check of a "
                         "3-step scan spanning the wind-refresh cadence")
    ap.add_argument("--all-configs", action="store_true",
                    help="emit one JSON line per BASELINE.md config "
                         "(global025, regional025, global010) instead of "
                         "only --grid")
    args = ap.parse_args()

    _enable_compile_cache()
    from seabreeze_param_tpu.utils.tracing import card_info, require_gpu
    devices = require_gpu()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": card_info()}

    base_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "benchmarks", "baseline_cpu.json")
    base = {}
    if os.path.exists(base_file):
        with open(base_file) as f:
            base = json.load(f)

    def one_config(grid_name, steps):
        verified = (verify(grid_name, args.nlev)
                    if args.verify and args.pallas else None)
        throughput, step_s, k, nn = run(grid_name, steps, args.nlev,
                                        args.pallas, args.repeats)
        vs = 1.0
        ref = base.get(grid_name, {}).get("grid_points_per_s")
        if ref:
            vs = throughput / ref
        line = {
            "metric": f"trigger-pipeline throughput, {grid_name} "
                      f"(k={k}, nn={nn}, {steps} steps, "
                      f"{'ring kernel' if args.pallas else 'xla'})",
            "value": round(throughput, 1),
            "unit": "grid-points/s",
            "vs_baseline": round(vs, 3),
            "ms_per_step": round(step_s * 1e3, 4),
            "device": device,
        }
        if verified is not None:
            line["verified"] = bool(verified)
        print(json.dumps(line))
        sys.stdout.flush()
        return verified

    if args.all_configs:
        # global010 gets fewer steps to bound device memory
        plans = (("global025", args.steps), ("regional025", args.steps),
                 ("global010", min(args.steps, 8)))
        flags = [one_config(g, s) for g, s in plans]
    else:
        flags = [one_config(args.grid, args.steps)]
    if any(v is False for v in flags):
        # the on-device allclose gate failed: report it loudly in the exit
        # status too, so automation gating on bench cannot record a
        # miscompiled kernel's throughput as a valid baseline
        sys.exit(1)


if __name__ == "__main__":
    main()
