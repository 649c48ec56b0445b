"""In-model coupling API — the UM-variant contract.

The reference's UM vn10.7 integration (``UM/vn10.7/sea_breeze_diag.F90``)
is how a *host climate model* calls the trigger from inside its physics
suite, with a different contract than the batch python_wrapper:

  * 3-D pressure on rho levels; the target wind level is found per column
    with an early-exit scan (``UM/...F90:79-82, 265-274``);
  * the ``mask`` argument is the *precomputed signed coast distance*
    (``UM/...F90:96-98``) — ``get_edges``/``get_dist`` run earlier in the
    step, outside physics (``generic/dummy_model.f90:27-37``);
  * an integer ``error`` out-argument with a grid-bounds validity check
    (``UM/...F90:102, 196-202``);
  * DrHook enter/exit tracing around the routine (``UM/...F90:172, 324``);
  * OpenMP chunking via ``compute_chunk_size`` (``UM/...F90:188-192``) —
    here this concern disappears into XLA/Pallas tiling, so there is no
    API surface for it (SURVEY §2 native-checklist item 6).

:class:`CoupledTrigger` provides that contract on top of the same fused
ops the batch pipeline uses, so a host model (or the ``examples/
dummy_model.py`` skeleton) can drive the trigger step-by-step inside its
own jitted loop.  :func:`sea_breeze_diag` is the argument-for-argument
functional form.  :func:`cumulus_mask` is the downstream consumer shim: the
boolean trigger mask a mass-flux convection scheme would ingest
(BASELINE.md config #5, "trigger feeding a mock cumulus mask").
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .core.params import Params
from .core.state import TriggerState
from .ops.coastline import get_edges
from .ops.distance import coast_distance
from .ops.trigger import trigger_step
from .utils.tracing import tracer as _default_tracer

#: UM error codes (UM/vn10.7/sea_breeze_diag.F90:102,196-202).
ERROR_NONE = 0
ERROR_BAD_GRID = 1


def validate_grid(nlats: int, nlons: int, nlev: int) -> int:
    """The UM bounds check (``UM/...F90:196-202``): error=1 on an empty
    horizontal grid or vertical axis.  Host-side — shapes are static."""
    if nlats < 1 or nlons < 1 or nlev < 1:
        return ERROR_BAD_GRID
    return ERROR_NONE


@dataclasses.dataclass(frozen=True)
class CoupledTrigger:
    """The trigger as an in-model physics routine.

    Bind once per model configuration; call :meth:`prepare_mask` when the
    land/ice mask changes (per step with moving sea ice, once at init
    otherwise — the coupling cadence of ``generic/dummy_model.f90:11-20``)
    and :meth:`physics` inside the physics suite.  Both are jit-safe.
    """

    grid: "object"                   # core.grid.Grid
    params: Params = dataclasses.field(default_factory=Params)
    use_pallas: bool = False
    nn_max: int | None = None
    tracer: "object" = None

    def _tracer(self):
        return self.tracer if self.tracer is not None else _default_tracer

    def _nn(self) -> int:
        if self.nn_max is not None:
            return int(self.nn_max)
        from .ops.distance import effective_radius
        k = effective_radius(self.grid, self.params.maxdist)
        return max(3, k + 2 + self.params.ring_search_margin)

    # ------------------------------------------------------------------
    def prepare_mask(self, land_frac, ice_frac=None):
        """coastline + signed coast distance — the pre-physics half of the
        coupling sequence (``dummy_model.f90:32-33``).  Returns cdist, the
        UM routine's ``mask`` argument."""
        with self._tracer().hook("coupling:get_edges"):
            coast = get_edges(land_frac, ice_frac,
                              exact_lon=self.params.exact_lon_indexing)
        with self._tracer().hook("coupling:get_dist"):
            return coast_distance(coast, land_frac, self.grid,
                                  self.params.maxdist)

    # ------------------------------------------------------------------
    def physics(self, state: TriggerState, p, u, v, theta, z, sigma, mask):
        """The ``seabreeze_diag`` physics call (``UM/...F90:55-326``).

        p : (nlev,) or (nlev, nlat, nlon) pressure — 3-D triggers the UM
            per-column wind-level selection.
        mask : signed coast distance from :meth:`prepare_mask`.

        Returns ``(new_state, outputs)`` like the batch pipeline.
        """
        with self._tracer().hook("coupling:seabreeze_diag"):
            return trigger_step(state, theta, u, v, mask, z, sigma, p,
                                self.params, self._nn(),
                                use_pallas=self.use_pallas)


def sea_breeze_diag(timestep, timestep_number, p, u, v, theta, z, sigma,
                    mask, windspeed, winddir, thc, grid, *,
                    params: Params | None = None, use_pallas: bool = False):
    """Argument-for-argument functional form of the UM routine
    (``UM/vn10.7/sea_breeze_diag.F90:55-56``).

    Returns ``(sb_con, windspeed, winddir, thc, error)`` — the inout
    fields updated, plus the UM error code.  ``timestep`` is seconds (the
    UM convention, ``UM/...F90:83``); the bound :class:`Params` carries it
    in minutes.
    """
    p = jnp.asarray(p, jnp.float32)
    nlev = p.shape[0]
    nlats, nlons = np.shape(theta)
    error = validate_grid(nlats, nlons, nlev)
    if error != ERROR_NONE:
        return (jnp.asarray(0.0), windspeed, winddir, thc, error)

    params = (params or Params()).replace(timestep=float(timestep) / 60.0)
    ct = CoupledTrigger(grid=grid, params=params, use_pallas=use_pallas)
    state = TriggerState(tt=jnp.asarray(timestep_number, jnp.int32),
                         thc=jnp.asarray(thc, jnp.float32),
                         windspeed=jnp.asarray(windspeed, jnp.float32),
                         winddir=jnp.asarray(winddir, jnp.float32))
    new_state, out = ct.physics(state, p, u, v, theta, z, sigma, mask)
    return (out["sb_con"], new_state.windspeed, new_state.winddir,
            new_state.thc, ERROR_NONE)


def cumulus_mask(sb_con, *, min_strength: float = 0.0):
    """Mock downstream consumer: the boolean trigger mask a mass-flux
    cumulus scheme would read (sb_con > threshold at valid points — the
    science intent of the diagnostic, README.md:1-4; missing-value cells
    excluded).  BASELINE.md config #5's "mock cumulus mask"."""
    from .core.params import MISSING_VALUE
    sb = jnp.asarray(sb_con, jnp.float32)
    valid = jnp.abs(sb) < MISSING_VALUE / 2
    return valid & (sb > jnp.float32(min_strength))
