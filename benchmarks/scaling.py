#!/usr/bin/env python
"""Weak-scaling harness for the sharded trigger pipeline.

Measures step time of the full sharded pipeline while growing the device
mesh and the global grid together (fixed work per device), and reports
weak-scaling efficiency — the BASELINE.md north-star metric (>= 90%
1 -> N).  On a CPU host this exercises the *code path* on virtual devices
(``--xla_force_host_platform_device_count``), the idiomatic stand-in for a
multi-device host (SURVEY §4b); on a host with several GPUs the same
script measures real scaling over NVLink.

Usage::

    python benchmarks/scaling.py [--base-lat=256] [--base-lon=512]
                                 [--steps=4] [--devices=1,2,4]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def world(nlat, nlon, nlev, nt, seed=0):
    from bench import make_world
    return make_world(nlat, nlon, nlev, nt, seed)


def measure(n_dev, base_lat, base_lon, steps, nlev, repeats=3):
    import jax
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline
    from seabreeze_param_tpu.parallel.mesh import make_mesh
    from seabreeze_param_tpu.parallel.sharded import ShardedPipeline

    mesh = make_mesh(devices=jax.devices()[:n_dev])
    py, px = mesh.shape["y"], mesh.shape["x"]
    nlat, nlon = base_lat * py, base_lon * px
    lsm, z, std, pres, theta, u, v, ci = world(nlat, nlon, nlev, steps)
    grid = Grid.regular(nlat, nlon, lat0=90.0, lat1=-90.0)
    sp = ShardedPipeline(TriggerPipeline(grid), mesh)

    def once():
        state = TriggerState.zeros((nlat, nlon))
        t0 = time.perf_counter()
        final, outs = sp.run(state, theta, u, v, lsm, z, std, pres, ci_t=ci)
        jax.block_until_ready(outs)
        return time.perf_counter() - t0

    once()  # compile
    best = min(once() for _ in range(repeats))
    return dict(devices=n_dev, mesh=(py, px), grid=(nlat, nlon),
                step_s=best / steps,
                points_per_s=steps * nlat * nlon / best)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--base-lat", type=int, default=256)
    ap.add_argument("--base-lon", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--nlev", type=int, default=4)
    ap.add_argument("--devices", default="1,2,4")
    ap.add_argument("--virtual-devices", type=int, default=None,
                    help="run on N virtual CPU devices instead of the real "
                         "backend — the structural (code-path) curve of "
                         "SURVEY §4b; wall-clock efficiency is then bounded "
                         "by the HOST's core count, not the framework")
    args = ap.parse_args()

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count="
              f"{args.virtual_devices}").strip()
        import jax
        jax.config.update("jax_platforms", "cpu")

    results = []
    for n in (int(x) for x in args.devices.split(",")):
        r = measure(n, args.base_lat, args.base_lon, args.steps, args.nlev)
        if results:
            r["weak_efficiency"] = round(
                r["points_per_s"] / (results[0]["points_per_s"] /
                                     results[0]["devices"] * n), 3)
        else:
            r["weak_efficiency"] = 1.0
        results.append(r)
        print(json.dumps(r))
    return results


if __name__ == "__main__":
    main()
