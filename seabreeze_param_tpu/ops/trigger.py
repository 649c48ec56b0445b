"""The sea-breeze trigger core — vectorized equivalent of ``diag``
(``python_wrapper/seabreezediag/seabreeze_diag_python.f90:49-285``).

The reference is one OpenMP point-loop mixing unit conversion, sea-level
temperature, the expanding-ring THC search, wind evaluation at a target
pressure level, four threshold rules, scaling, and state update.  Here it is
a handful of fused elementwise maps over (nlat, nlon) fields plus the
bounded ring search of ``ops.ring_search`` — one XLA fusion group, no
Python-level control flow on data.

All arithmetic is float32 with the reference's exact constants
(rad2deg = 57.2957, gmma = -0.0060956; seabreeze_diag_python.f90:125-126).
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..core.params import Params, RAD2DEG_TRIGGER, GMMA, MISSING_VALUE
from ..core.state import TriggerState
from .orography import sigmoid_weight
from .ring_search import ring_quantities, ring_thc_from_padded


def sea_level_temperature(theta, z, smod):
    """t0 = theta - gmma * z * smod  (seabreeze_diag_python.f90:158):
    theoretical sea-level temperature from moist adiabatic descent, weighted
    by the orography sigmoid so flat terrain is left untouched."""
    return jnp.asarray(theta, jnp.float32) - (
        GMMA * jnp.asarray(z, jnp.float32) * smod)


def wind_at_level(u, v, pres, target_plev_pa):
    """Wind speed/direction at the model level nearest the target pressure.

    p_lev = first argmin of |p - target| (seabreeze_diag_python.f90:228);
    speed = sqrt(u^2 + v^2); direction = atan2(-u, -v) * rad2deg
    (seabreeze_diag_python.f90:231-233) — meteorological "from" convention.

    ``pres`` may be 1-D (nlev,) — the python_wrapper contract — or 3-D
    (nlev, nlat, nlon) pressure on rho levels, the UM coupling contract
    (``UM/vn10.7/sea_breeze_diag.F90:79-82``) where the nearest level is
    found *per column* (the UM's early-exit scan over k,
    ``UM/...F90:265-274``; argmin returns the same first minimum because
    |p - target| is unimodal along a monotone pressure column).
    """
    p = jnp.asarray(pres, jnp.float32)
    u = jnp.asarray(u, jnp.float32)
    v = jnp.asarray(v, jnp.float32)
    if p.ndim == 1:
        p_lev = jnp.argmin(jnp.abs(p - jnp.float32(target_plev_pa)))
        ul = lax.dynamic_index_in_dim(u, p_lev, 0, keepdims=False)
        vl = lax.dynamic_index_in_dim(v, p_lev, 0, keepdims=False)
    else:
        p_lev = jnp.argmin(jnp.abs(p - jnp.float32(target_plev_pa)),
                           axis=0)[None]                      # (1, lat, lon)
        ul = jnp.take_along_axis(u, p_lev, axis=0)[0]
        vl = jnp.take_along_axis(v, p_lev, axis=0)[0]
    speed = jnp.sqrt(ul * ul + vl * vl)
    direction = jnp.arctan2(-ul, -vl) * RAD2DEG_TRIGGER
    return speed, direction


def trigger_core(state: TriggerState, t0, cdist, ws_new, wd_new, t0_pad,
                 cd_pad, params: Params, nn_max: int, *, row_offset=0,
                 nlat_total: int | None = None, use_pallas: bool = False,
                 pallas_interpret: bool = False):
    """The per-cell part of a trigger timestep, from pre-padded inputs.

    Everything of the Fortran ``diag`` downstream of t0 and the wind-level
    selection (seabreeze_diag_python.f90:165-282): the expanding-ring THC,
    the four threshold rules, scaling, and state update.  ``t0_pad`` /
    ``cd_pad`` are the (h+2NN, w+2NN) ring-search inputs, boundary-resolved
    through the reference maps (single-device ``pad2d``; sharded: halo
    exchange + ``parallel.halo.quirky_seam_patch``) — precomputing them is
    what lets the sharded caller overlap the exchange with the wind
    compute.  ``t0``/``cdist`` are the unpadded centers (the target cell's
    own class/coastal predicate is read unremapped,
    seabreeze_diag_python.f90:171,220).  ``use_pallas`` runs the ring search
    as the coastal-band GPU kernel (``ops.pallas.ring_kernel``);
    ``pallas_interpret`` runs that kernel in interpret mode (tests only).
    """
    cdist = jnp.asarray(cdist, jnp.float32)
    coastal = jnp.abs(cdist) <= jnp.float32(params.maxdist)
    is_first = state.tt < 2
    upd = jnp.mod(state.tt.astype(jnp.float32) * params.timestep_seconds,
                  params.target_time_seconds) < jnp.float32(1.0e-4)

    if use_pallas:
        from .pallas.ring_kernel import ring_thc_pallas
        n_thc = ring_thc_pallas(t0_pad, cd_pad, cdist, nn_max,
                                params.maxdist, interpret=pallas_interpret)
    else:
        # quantities computed elementwise ON the padded fields — identical
        # to padding the quantities (every pad slot is a value copy).
        mul = jnp.where(cdist >= 0.0, jnp.float32(1.0), jnp.float32(-1.0))
        n_thc, _ = ring_thc_from_padded(ring_quantities(t0_pad, cd_pad),
                                        mul, nn_max, coastal=coastal)

    # First-timestep seeding (seabreeze_diag_python.f90:236-240): coastal
    # points adopt the fresh wind before differences are formed.
    ws_base = jnp.where(is_first & coastal, ws_new, state.windspeed)
    wd_base = jnp.where(is_first & coastal, wd_new, state.winddir)

    thc_abs = jnp.abs(n_thc)
    mws = (ws_base + ws_new) / jnp.float32(2.0)
    dws = jnp.abs(ws_base - ws_new)
    dwd = jnp.abs(
        jnp.mod((wd_base - wd_new) + jnp.float32(180.0), jnp.float32(360.0))
        - jnp.float32(180.0))

    cond = ((dwd < jnp.float32(params.thresh_winddir))
            & (dws < jnp.float32(params.thresh_windch))
            & (mws < jnp.float32(params.thresh_wind))
            & (thc_abs > jnp.float32(params.thresh_thc)))
    scale_wind = (jnp.float32(params.thresh_wind) - mws) / jnp.maximum(
        jnp.float32(1.0), mws)
    thc_safe = jnp.where(n_thc == 0.0, jnp.float32(1.0), n_thc)
    scale_thc = (thc_abs - jnp.float32(params.thresh_thc)) / thc_safe
    sb_con = jnp.where(coastal,
                       jnp.where(cond, scale_thc * scale_wind,
                                 jnp.float32(0.0)),
                       MISSING_VALUE)

    # State update cadence (seabreeze_diag_python.f90:268-274): wind state
    # refreshes only every target_time hours; float32 arithmetic as Fortran.
    take_wind = coastal & (is_first | upd)
    ws_out = jnp.where(take_wind, ws_new, state.windspeed)
    wd_out = jnp.where(take_wind, wd_new, state.winddir)

    out_sb, out_t0, out_ws, out_wd = sb_con, t0, ws_out, wd_out
    if params.skip_last_lat_row:
        # Reference loop bound `do i=1,nlats-1` (seabreeze_diag_python.f90:165)
        # never writes the last latitude row (uninitialized memory in the
        # f2py build).  We emit zeros there and freeze its state.
        nlat = nlat_total if nlat_total is not None else t0.shape[0]
        row_ok = ((row_offset + jnp.arange(t0.shape[0])) < nlat - 1)[:, None]
        zero = jnp.float32(0.0)
        out_sb = jnp.where(row_ok, out_sb, zero)
        out_t0 = jnp.where(row_ok, out_t0, zero)
        out_ws = jnp.where(row_ok, out_ws, zero)
        out_wd = jnp.where(row_ok, out_wd, zero)
        ws_out = jnp.where(row_ok, ws_out, state.windspeed)
        wd_out = jnp.where(row_ok, wd_out, state.winddir)

    # The threaded "thc" state slot carries t0 by reference convention
    # (python_wrapper __init__.py:244 assigns out[1]; see core.state).
    new_state = TriggerState(tt=state.tt + 1, thc=out_t0,
                             windspeed=ws_out, winddir=wd_out)
    outputs = {"sb_con": out_sb, "t0": out_t0, "windspeed": out_ws,
               "winddir": out_wd}
    return new_state, outputs


def trigger_step(state: TriggerState, theta, u, v, cdist, z, std, pres,
                 params: Params, nn_max: int, *, smod=None,
                 axis_names: tuple[str, ...] = (), ring_pad_fn=None,
                 row_offset=0, nlat_total: int | None = None,
                 valid_mask=None, use_pallas: bool = False,
                 pallas_interpret: bool = False):
    """One trigger timestep.

    Parameters mirror the Fortran ``diag`` argument list
    (seabreeze_diag_python.f90:49-52) with the persistent triple carried in
    ``state``.  ``nn_max`` is the static ring-search bound.  ``smod`` may be
    passed precomputed (it depends only on the static ``std`` field; the
    reference recomputes it every call, seabreeze_diag_python.f90:157 — the
    result is identical either way).

    Sharded operation: ``ring_pad_fn(stack, nn_max)`` supplies the
    halo-exchange pad for the ring inputs, ``axis_names`` routes the
    sigmoid's global reductions, ``row_offset``/``nlat_total`` locate this
    block's rows in the global grid (for the last-row quirk), and
    ``valid_mask`` flags replication-padding cells excluded from global
    statistics.  (The overlapped sharded pipeline in ``parallel.sharded``
    instead calls :func:`trigger_core` directly with halo-exchanged pads.)

    Returns ``(new_state, outputs)`` with outputs a dict of the four Fortran
    output slots (seabreeze_diag_python.f90:277-280): ``sb_con``, ``t0``,
    ``windspeed``, ``winddir``.
    """
    if smod is None:
        smod = sigmoid_weight(std, axis_names=axis_names,
                              valid_mask=valid_mask)
    t0 = sea_level_temperature(theta, z, smod)
    cdist = jnp.asarray(cdist, jnp.float32)
    ws_new, wd_new = wind_at_level(u, v, pres, params.target_plev_pa)

    if ring_pad_fn is None:
        from .indexing import pad2d
        t0_pad = pad2d(t0, nn_max, nn_max,
                       exact_lon=params.exact_lon_indexing)
        cd_pad = pad2d(cdist, nn_max, nn_max,
                       exact_lon=params.exact_lon_indexing)
    else:
        padded = ring_pad_fn(jnp.stack([t0, cdist]), nn_max)
        t0_pad, cd_pad = padded[0], padded[1]

    return trigger_core(state, t0, cdist, ws_new, wd_new, t0_pad, cd_pad,
                        params, nn_max, row_offset=row_offset,
                        nlat_total=nlat_total, use_pallas=use_pallas,
                        pallas_interpret=pallas_interpret)
