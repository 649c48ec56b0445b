"""Model-coupling skeleton — the ``dummy_model`` equivalent.

The reference ships a Fortran fake model (``generic/dummy_model.f90:24-56``
with the field registry ``generic/get_all_fields_mod.f90:6-21``) to
demonstrate the coupling contract: every atmosphere step runs

    get_edges -> get_dist -> physics(seabreeze_diag)

before the next dynamics step, threading the trigger state forward.  Here
the same contract is one jitted ``lax.scan``: a toy "dynamics" (advecting
temperature + rotating wind) interleaved with the trigger pipeline, on the
reference dummy grid (nx=128, ny=96, nz=56 levels -> 8 pressure levels
used).  Unlike the reference skeleton ("not intended to work",
``dummy_model.f90:2-4``), this one runs.

Run:  python examples/dummy_model.py [--steps=N] [--sharded]
"""
from __future__ import annotations

import sys
import time

import numpy as np


# Field registry (generic/get_all_fields_mod.f90:6-21): grid constants and
# the canonical coupled-field set.
NX, NY, NZ = 128, 96, 8          # lon, lat, plev (56 model levels -> 8 p)
TIMESTEP_H = 24.0 / 60.0         # 24-minute step, as the reference


def init_fields(seed=0):
    """The get_all_fields equivalent: allocate + initialize everything."""
    rng = np.random.default_rng(seed)
    F = np.float32
    y, x = np.mgrid[0:NY, 0:NX]
    coastx = 0.55 * NX + 0.1 * NX * np.sin(2 * np.pi * y / NY * 2.0)
    land = (x > coastx).astype(F)
    return dict(
        land_frac=(land * (0.6 + 0.4 * rng.random((NY, NX)))).astype(F),
        ice_frac=np.zeros((NY, NX), F),
        z=(700.0 * land * rng.random((NY, NX))).astype(F),
        sigma=(110.0 * land * rng.random((NY, NX))).astype(F),
        p=np.linspace(100000.0, 30000.0, NZ).astype(F),
        u=(6.0 * rng.standard_normal((NZ, NY, NX))).astype(F),
        v=(6.0 * rng.standard_normal((NZ, NY, NX))).astype(F),
        theta=(288.0 + 5.0 * rng.standard_normal((NY, NX))
               + 4.0 * land).astype(F),
    )


def atmos_step(carry, _, pipe, fields_static):
    """One coupled step: toy dynamics, then the trigger physics
    (the dummy_model.f90:27-37 call sequence)."""
    import jax.numpy as jnp
    state, theta, u, v = carry
    # -- fake dynamics: shift theta eastward, precess the wind ----------
    theta = jnp.roll(theta, 1, axis=-1)
    cs, sn = jnp.float32(np.cos(0.05)), jnp.float32(np.sin(0.05))
    u, v = cs * u - sn * v, sn * u + cs * v
    # -- physics: coastline -> distance -> trigger ----------------------
    lsm, z, sigma, pres, ci = fields_static
    new_state, outs = pipe.step(state, theta, u, v, lsm, z, sigma, pres,
                                ci=ci)
    return (new_state, theta, u, v), outs["sb_con"]


def run(steps=12, sharded=False, devices=None):
    import jax
    import jax.numpy as jnp
    from seabreeze_param_tpu.core.grid import Grid
    from seabreeze_param_tpu.core.state import TriggerState
    from seabreeze_param_tpu.models.pipeline import TriggerPipeline

    f = init_fields()
    grid = Grid.regular(NY, NX, lat0=60.0, lat1=-60.0)
    pipe = TriggerPipeline(grid)
    state = TriggerState.zeros((NY, NX))
    statics = tuple(jnp.asarray(f[k]) for k in
                    ("land_frac", "z", "sigma", "p", "ice_frac"))

    if sharded:
        from seabreeze_param_tpu.parallel.mesh import make_mesh
        from seabreeze_param_tpu.parallel.sharded import ShardedPipeline
        mesh = make_mesh(devices=devices)
        sp = ShardedPipeline(pipe, mesh)
        theta_t = np.repeat(f["theta"][None], steps, axis=0)
        u_t = np.repeat(f["u"][None], steps, axis=0)
        v_t = np.repeat(f["v"][None], steps, axis=0)
        final, outs = sp.run(state, theta_t, u_t, v_t, f["land_frac"],
                             f["z"], f["sigma"], f["p"])
        return final, outs["sb_con"]

    def scan_fn(carry, x):
        return atmos_step(carry, x, pipe, statics)

    carry0 = (state, jnp.asarray(f["theta"]), jnp.asarray(f["u"]),
              jnp.asarray(f["v"]))
    (final, *_), sb = jax.jit(
        lambda c: jax.lax.scan(scan_fn, c, None, length=steps))(carry0)
    return final, sb


if __name__ == "__main__":
    steps, sharded = 12, False
    for arg in sys.argv[1:]:
        if arg.startswith("--steps="):
            steps = int(arg.split("=")[1])
        elif arg == "--sharded":
            sharded = True
    t0 = time.time()
    final, sb = run(steps=steps, sharded=sharded)
    sb = np.asarray(sb)
    active = sb[sb < 1.0e19]
    print(f"{steps} coupled steps on {NY}x{NX} in {time.time()-t0:.1f}s "
          f"(tt={int(final.tt)})")
    print(f"sb_con: {np.count_nonzero(active)} active cells, "
          f"range [{active.min():.3f}, {active.max():.3f}]")
