"""The full trigger pipeline: mask -> coastline -> distance -> trigger.

This is the JAX equivalent of the reference's per-timestep inner loop
(``python_wrapper/seabreezediag/__init__.py:219-245``): per step, rebuild the
coastline and coast-distance from the (moving) sea-ice field, run the trigger
kernel, and thread the persistent state forward.  The whole loop is one
jitted ``lax.scan`` with donated state — the reference's per-step
Python->Fortran boundary (and its double ``c2f`` copy of every field,
``__init__.py:229-239``) disappears entirely.

Call-sequence parity with the model-coupling contract
(``generic/dummy_model.f90:27-55``): ``get_edges`` -> ``get_dist`` ->
``physics/seabreeze_diag`` once per step, *before* the trigger.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from ..core.grid import Grid
from ..core.params import Params
from ..core.state import TriggerState
from ..ops.coastline import get_edges
from ..ops.distance import coast_distance, effective_radius
from ..ops.orography import sigmoid_weight
from ..ops.trigger import trigger_step

#: Trace-time counter (incremented inside the jitted scan body, which under
#: ``jax.jit`` executes only when XLA actually re-traces).  Lets tests and
#: the batch driver assert that repeated ``run`` calls on one pipeline reuse
#: the cached executable instead of re-tracing per input file — the
#: re-trace-per-file disease is this framework's analogue of the reference's
#: per-step c2f copy tax (``__init__.py:229-239``).
TRACE_STATS = {"traces": 0}


def use_pallas_default() -> bool:
    """Whether the ring search runs as the coastal-band kernel by default:
    on a GPU, where it compiles and beats the dense XLA form (PERF.md);
    pure XLA elsewhere."""
    return jax.default_backend() == "gpu"


@dataclass(frozen=True)
class TriggerPipeline:
    """Bound pipeline over static fields.

    Static inputs mirror the reference ``diag(tt, lsm, z, std, lon, lat,
    pres, ...)`` signature (``__init__.py:91``): land fraction, orography,
    sub-grid orography std, coordinates, pressure levels.
    """

    grid: Grid
    params: Params = field(default_factory=Params)
    use_pallas: bool = False
    # Optional explicit ring-search bound (see ops.ring_search.
    # required_ring_radius_host); None = the provable global-grid bound.
    ring_nn: int | None = None
    # Pass-1 lon form: 'taps' (exact reference parity) or 'nearest' (the
    # O(log k) uniform-grid form, allclose parity — see
    # ops.distance.pass1_extrema_nearest).
    distance_lon_form: str = "taps"
    # Run the ring kernel in interpret mode: tests set it to exercise the
    # use_pallas path on the CPU.
    pallas_interpret: bool = False

    @property
    def k(self) -> int:
        return effective_radius(self.grid, self.params.maxdist)

    @property
    def nn_max(self) -> int:
        """Static ring-search bound: both cdist signs provably occur within
        k+2 cells of any |cdist| <= maxdist point on physically-periodic
        grids (SURVEY §7 hard part 2); regional grids with a fake wrap seam
        can need more — measure with required_ring_radius_host and pass
        ``ring_nn``."""
        if self.ring_nn is not None:
            return max(1, int(self.ring_nn))
        return max(3, self.k + 2 + self.params.ring_search_margin)

    # ------------------------------------------------------------------
    def distance_field(self, lsm, ci=None):
        """Coastline + signed coast distance for one (lsm, sea-ice) pair."""
        coast = get_edges(lsm, ci, exact_lon=self.params.exact_lon_indexing)
        return coast_distance(coast, lsm, self.grid, self.params.maxdist,
                              lon_form=self.distance_lon_form)

    def step(self, state: TriggerState, theta, u, v, lsm, z, std, pres,
             ci=None, smod=None):
        """One full timestep (distance rebuild + trigger)."""
        cdist = self.distance_field(lsm, ci)
        return trigger_step(state, theta, u, v, cdist, z, std, pres,
                            self.params, self.nn_max, smod=smod,
                            use_pallas=self.use_pallas,
                            pallas_interpret=self.pallas_interpret)

    # ------------------------------------------------------------------
    def distance_field_jit(self):
        """Jitted, per-pipeline-cached form of :meth:`distance_field`.

        The batch driver probes the first timestep's distance field on every
        input file (``api.diag``); a fresh ``jax.jit(lambda ...)`` there
        would re-trace the whole transform per file."""
        fn = getattr(self, "_dist_jit", None)
        if fn is None:
            fn = jax.jit(lambda lsm, ci=None: self.distance_field(lsm, ci))
            object.__setattr__(self, "_dist_jit", fn)
        return fn

    def _get_runner(self, has_ci: bool, jit: bool):
        """The scan runner, cached per (has_ci, jit) on this pipeline.

        The scan function takes every field as an EXPLICIT argument (no
        fresh closures over lsm/z/std/pres), so repeated ``run`` calls hit
        jax's jit cache: one trace + one executable per pipeline per input
        shape, however many files a batch run processes.
        """
        cache = getattr(self, "_runners", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_runners", cache)
        key = (has_ci, jit)
        if key in cache:
            return cache[key]

        def scan_all(state, xs, lsm, z, std, pres, cdist0):
            TRACE_STATS["traces"] += 1

            def scan_fn(carry, x):
                if has_ci:
                    th, uu, vv, ci = x
                    return self.step(carry, th, uu, vv, lsm, z, std, pres,
                                     ci=ci)
                th, uu, vv = x
                return trigger_step(
                    carry, th, uu, vv, cdist0, z, std, pres, self.params,
                    self.nn_max, use_pallas=self.use_pallas,
                    pallas_interpret=self.pallas_interpret)

            return jax.lax.scan(scan_fn, state, xs)

        runner = jax.jit(scan_all, donate_argnums=(0,)) if jit else scan_all
        cache[key] = runner
        return runner

    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None, *, jit: bool = True):
        """Scan over the leading time axis.

        theta_t : (T, nlat, nlon); u_t, v_t : (T, nlev, nlat, nlon);
        ci_t : (T, nlat, nlon) or None (then the distance field is computed
        once from lsm alone, like the reference's ci=None branch,
        ``__init__.py:216-218``).

        Returns (final_state, outputs) with outputs a dict of
        (T, nlat, nlon) stacked fields.
        """
        lsm = jnp.asarray(lsm, jnp.float32)
        z = jnp.asarray(z, jnp.float32)
        std = jnp.asarray(std, jnp.float32)
        pres = jnp.asarray(pres, jnp.float32)
        has_ci = ci_t is not None

        # Without sea ice the coastline is static: compute the distance field
        # once outside the scan (the reference's ci=None branch likewise
        # computes it once, __init__.py:216-218).
        cdist0 = None if has_ci else self.distance_field_jit()(lsm)

        xs = (jnp.asarray(theta_t, jnp.float32),
              jnp.asarray(u_t, jnp.float32),
              jnp.asarray(v_t, jnp.float32))
        if has_ci:
            xs = xs + (jnp.asarray(ci_t, jnp.float32),)

        runner = self._get_runner(has_ci, jit)
        return runner(state, xs, lsm, z, std, pres, cdist0)
