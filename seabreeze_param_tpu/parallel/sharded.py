"""Sharded trigger pipeline: shard_map over a ('y', 'x') device mesh.

2-D spatial domain decomposition with explicit halo exchange — the JAX
re-design of the reference's MPI-decomposed UM variant
(``UM/vn10.7/sea_breeze_diag.F90``, SURVEY §2.8, §5.8).  Everything that was
a ``swap_bounds`` call becomes a ``parallel.halo`` exchange; the sigmoid's
global statistics become psum/pmax/pmin (SURVEY §2 native-checklist item 2).

Two step structures, selected per configuration:

**Overlapped (production; SURVEY §7 item 6).**  The reference issues four
blocking ``swap_bounds`` per step (``UM/...F90:408-410, 531-545``) — every
exchange a barrier.  Here each step issues exactly TWO exchanges, both at
the top of the step, and computes the rest of its halos locally:

  1. ``mask`` with an (nn + k + 1)-wide apron — wide enough that the Sobel
     coastline, the k-radius distance gather, and the ring search's nn-wide
     cdist halo are all *computed* on the apron instead of exchanged
     (communication traded for a few percent of replicated compute on the
     apron ring);
  2. ``theta`` with an nn-wide apron (t0 = theta - gmma*z*smod is
     elementwise, and z's apron is static — exchanged once per dispatch).

  Both exchanges are issued with ``halo_start`` before the step's biggest
  independent compute — ``wind_at_level``, which reads the full 3-D u/v
  fields — and finished after it, so XLA's scheduler may overlap the
  transfers (NCCL send/recv between GPUs) with that sweep.  On four H100s
  it does not: the trace shows 75-88% of the NCCL time with no kernel
  beside it (PERF.md, ``benchmarks/trace_overlap.py``).  The sigmoid's global
  reduction is
  hoisted out of the time scan entirely (std is static), removing a
  per-step collective barrier.

**Basic (fallback).**  The apron trade needs nn + k + 1 <= the local shard
extent; on very small shards (tiny grids / very wide meshes) the pipeline
falls back to the previous structure — three narrower sequential exchanges
(mask 1-wide, coast k-wide, ring inputs nn-wide) per step.

Apron-replication correctness (the reason the overlapped form is exact):

  * every halo/apron slot holds a positional copy of a global column/row,
    so elementwise ops commute with the exchange;
  * the quirky-lon seam differs from clean periodicity in exactly two
    column slots, patched identically in every copy
    (``parallel.halo.quirky_seam_patch``);
  * coast cells sobel-computed on the apron replicate the owner's
    computation bit-for-bit (same patched window values);
  * spurious coast cells on beyond-globe apron rows (clamp-replicated mask)
    cannot win the distance min: the global distance tables poison
    out-of-grid source rows with BIG (``ops.distance.distance_tables``);
  * beyond-globe cdist/t0 apron rows are explicitly clamp-replicated from
    the real globe-edge row, reproducing the reference's lat clamp.

Lat divisibility is handled by **edge-row replication padding**, which is
*exactly idempotent* under the reference's boundary semantics:

  * the Fortran lat clamp maps every beyond-edge row to the edge row, so a
    window that sees replicated fake rows sums precisely the duplicates the
    clamp would have summed;
  * replicated rows carry replicated phi, so any fake coastline cell is a
    duplicate (identical haversine parameter) of a real edge-row coastline
    cell — provably a subset of the edge row's coast — and the distance min
    dedups it;
  * fake-row t0 comes out as an exact copy of the edge row's; fake-row
    cdist need not (the fake row's own Sobel coastline can differ from the
    edge row's), so every row beyond the real edge is explicitly given the
    edge row's cdist, keeping the ring-search class counts identical to
    the clamp's.

Global statistics exclude fake rows via ``valid_mask``; outputs are sliced
back to the real rows on the host.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core.grid import Grid
from ..core.state import TriggerState
from ..models.pipeline import TriggerPipeline
from ..ops.coastline import make_mask, sobel_edges_from_padded
from ..ops.distance import (distance_tables, finalize_distance,
                            min_haversine_param_from_padded)
from ..ops.orography import sigmoid_weight
from ..ops.trigger import (sea_level_temperature, trigger_core, trigger_step,
                           wind_at_level)
from .halo import halo_finish, halo_pad, halo_start, quirky_seam_patch
from .mesh import AXIS_Y, AXIS_X


def _pad_lat_host(arr, nlat_pad, axis=-2):
    """Replicate the last lat row up to nlat_pad (see module docstring)."""
    arr = np.asarray(arr)
    nlat = arr.shape[axis]
    if nlat == nlat_pad:
        return arr
    idx = np.minimum(np.arange(nlat_pad), nlat - 1)
    return np.take(arr, idx, axis=axis)


def _clamp_to_edge_row(cd, beyond, edge):
    """``cd`` with every row flagged ``beyond`` the real globe edge replaced
    by row ``edge`` (the edge row's local index).  A replication-padding row
    copies the edge row's INPUTS, but its own Sobel coastline — and so its
    signed distance, and with it the land/sea class the ring search counts
    — can differ from the edge row's; the reference's lat clamp reads the
    edge row itself."""
    edge_row = lax.dynamic_slice_in_dim(cd, edge, 1, axis=0)
    return jnp.where(beyond, edge_row, cd)


@dataclasses.dataclass
class ShardedPipeline:
    """shard_map-parallel version of :class:`TriggerPipeline`.

    Requires nlon % mesh_x == 0; nlat is replication-padded to a multiple of
    mesh_y.  ``overlap`` selects the step structure: "auto" (default) uses
    the overlapped two-exchange form whenever the mask apron fits the local
    shard, else the basic three-exchange form; True/False force it.
    """

    pipeline: TriggerPipeline
    mesh: jax.sharding.Mesh
    overlap: object = "auto"

    def __post_init__(self):
        grid = self.pipeline.grid
        py, px = (self.mesh.shape[AXIS_Y], self.mesh.shape[AXIS_X])
        if grid.nlon % px:
            raise ValueError(
                f"nlon={grid.nlon} not divisible by mesh x={px}")
        self.nlat_real = grid.nlat
        self.nlat_pad = ((grid.nlat + py - 1) // py) * py
        lat_padded = _pad_lat_host(grid.lat, self.nlat_pad, axis=-1)
        self.grid_padded = Grid(lon=grid.lon, lat=lat_padded)
        # Search radius must come from the *real* grid (the padded grid has
        # a duplicated last lat, which would corrupt the 70-deg cell size
        # only if 70 deg were the duplicated row — compute on real anyway).
        self.k = self.pipeline.k
        self.tables = distance_tables(self.grid_padded, self.k)
        self.nn_max = self.pipeline.nn_max
        self.half_dlam = None
        if self.pipeline.distance_lon_form == "nearest":
            from ..ops.distance import uniform_half_dlam
            self.half_dlam = uniform_half_dlam(grid, self.k)
            if self.half_dlam is None:
                raise ValueError(
                    "distance_lon_form='nearest' needs a uniform global "
                    "lon axis with k*dlam <= 180 deg")
        # Halo-width guard: the exchanges slice strips out of the LOCAL
        # shard, so every exchanged width must fit inside one shard (a mesh
        # too large for the grid would otherwise exchange garbage-width
        # strips or fail deep inside shard_map).
        local_h = self.nlat_pad // py
        local_w = grid.nlon // px
        a_m = self.nn_max + self.k + 1          # overlapped mask apron
        basic = max(1, self.k, self.nn_max)     # basic-path widths
        # Lon: STRICTLY narrower than the shard when the quirky seam
        # patches are on — at hx == w the copy of global column nlon-1
        # landing in a neighbor's opposite halo has no patch position
        # (parallel.halo.quirky_seam_patch covers hx < w only).
        exact = self.pipeline.params.exact_lon_indexing
        max_w = local_w - 1 if exact else local_w
        if self.overlap == "auto":
            self.overlap = a_m <= local_h and a_m <= max_w
        widest = a_m if self.overlap else basic
        if widest > local_h or widest > max_w:
            raise ValueError(
                f"halo width {widest} (overlap={self.overlap}: mask apron "
                f"nn+k+1={a_m}, basic max(1,k={self.k},nn={self.nn_max})="
                f"{basic}) exceeds the local shard extent "
                f"{local_h}x{local_w}"
                f"{' minus the quirky-seam margin' if exact else ''} on a "
                f"{py}x{px} mesh; use fewer shards or a finer grid")

    # ------------------------------------------------------------------
    def _core_overlap(self, state, xs, lsm, z, std, pres, sdphi2_g, po_g,
                      sdlam2_g, *, has_ci: bool = True):
        """Overlapped per-shard scan (see module docstring)."""
        pipe = self.pipeline
        params = pipe.params
        exact = params.exact_lon_indexing
        h, w = lsm.shape
        nn, k = self.nn_max, self.k
        a_m = nn + k + 1
        row_offset = lax.axis_index(AXIS_Y) * h
        col_offset = lax.axis_index(AXIS_X) * w
        valid = ((row_offset + jnp.arange(h)) < self.nlat_real)[:, None]

        # --- once per dispatch: global stats, static aprons, ext tables --
        smod = sigmoid_weight(std, axis_names=(AXIS_Y, AXIS_X),
                              valid_mask=valid)
        z_ext = halo_pad(z, nn, nn, lat_fill="clamp", exact_lon=False)
        lsm_ext = halo_pad(lsm, nn, nn, lat_fill="clamp", exact_lon=False)
        smod_ext = halo_pad(smod, nn, nn, lat_fill="clamp", exact_lon=False)
        gr = row_offset - nn + jnp.arange(h + 2 * nn)
        ridx = jnp.clip(gr, 0, self.nlat_pad - 1)
        sdphi2_e = jnp.take(sdphi2_g, ridx, axis=0)
        po_e = jnp.take(po_g, ridx, axis=0)
        cidx = jnp.mod(col_offset - nn + jnp.arange(w + 2 * nn),
                       self.grid_padded.nlon)
        sdlam2_e = jnp.take(sdlam2_g, cidx, axis=0)
        below = (gr < 0)[:, None]
        # beyond the REAL globe edge: replication-padding rows and rows past
        # the padded grid alike (see _clamp_to_edge_row)
        above = (gr > self.nlat_real - 1)[:, None]
        edge = jnp.clip(self.nlat_real - 1 - row_offset + nn, 0,
                        h + 2 * nn - 1)

        def distance_ext(mask_pad):
            """Signed coast distance on the (h+2nn, w+2nn) ext block, all
            computed locally from the mask apron."""
            coast_ext = sobel_edges_from_padded(mask_pad)
            amin = min_haversine_param_from_padded(
                coast_ext, sdphi2_e, po_e, sdlam2_e, k,
                half_dlam=self.half_dlam)
            cd = finalize_distance(amin, lsm_ext, params.maxdist)
            # rows beyond the globe take the edge row's values: the
            # reference's lat clamp
            cd = jnp.where(below, cd[nn:nn + 1, :], cd)
            return _clamp_to_edge_row(cd, above, edge)

        cd_ext0 = None
        if not has_ci:
            mask = make_mask(lsm, None)
            cd_ext0 = distance_ext(halo_pad(mask, a_m, a_m,
                                            lat_fill="clamp",
                                            exact_lon=exact))

        def step_fields(x):
            """Everything of one overlapped step up to the trigger core:
            issue the exchanges, overlap them with the wind read, finish
            them, and derive (t0, cdist, ring pads, fresh wind)."""
            if has_ci:
                th, uu, vv, ci = x
                mask = make_mask(lsm, ci)
                fm = halo_start(mask, a_m, a_m)
            else:
                th, uu, vv = x
            ft = halo_start(th, nn, nn)
            # the step's largest independent read of device memory, free to
            # overlap the transfers issued above
            ws_new, wd_new = wind_at_level(uu, vv, pres,
                                           params.target_plev_pa)
            if has_ci:
                mask_pad = halo_finish(mask, fm, a_m, a_m,
                                       lat_fill="clamp", exact_lon=exact)
                cd_ext = distance_ext(mask_pad)
            else:
                cd_ext = cd_ext0
            th_pad = halo_finish(th, ft, nn, nn, lat_fill="clamp",
                                 exact_lon=False)
            t0_ext = sea_level_temperature(th_pad, z_ext, smod_ext)
            t0 = t0_ext[nn:-nn, nn:-nn]
            cdist = cd_ext[nn:-nn, nn:-nn]
            if exact:
                t0_ring = quirky_seam_patch(t0_ext, nn, w)
                cd_ring = quirky_seam_patch(cd_ext, nn, w)
            else:
                t0_ring, cd_ring = t0_ext, cd_ext
            return t0, cdist, ws_new, wd_new, t0_ring, cd_ring

        def scan_fn(carry, x):
            t0, cdist, ws_new, wd_new, t0_ring, cd_ring = step_fields(x)
            return trigger_core(
                carry, t0, cdist, ws_new, wd_new, t0_ring, cd_ring, params,
                nn, row_offset=row_offset, nlat_total=self.nlat_real,
                use_pallas=pipe.use_pallas,
                pallas_interpret=pipe.pallas_interpret)

        return lax.scan(scan_fn, state, xs)

    # ------------------------------------------------------------------
    def _core_basic(self, state, xs, lsm, z, std, pres, sdphi2_g, po_g,
                    sdlam2_g, *, has_ci: bool = True):
        """Basic per-shard scan: three sequential exchanges per step."""
        pipe = self.pipeline
        params = pipe.params
        exact = params.exact_lon_indexing
        h, w = lsm.shape
        row_offset = lax.axis_index(AXIS_Y) * h
        col_offset = lax.axis_index(AXIS_X) * w
        valid = ((row_offset + jnp.arange(h)) < self.nlat_real)[:, None]
        sdphi2 = lax.dynamic_slice_in_dim(sdphi2_g, row_offset, h, 0)
        po = lax.dynamic_slice_in_dim(po_g, row_offset, h, 0)
        sdlam2 = lax.dynamic_slice_in_dim(sdlam2_g, col_offset, w, 0)

        def ring_pad(q, nn):
            return halo_pad(q, nn, nn, lat_fill="clamp", exact_lon=exact)

        def distance(ci):
            mask = make_mask(lsm, ci)
            mpad = halo_pad(mask, 1, 1, lat_fill="clamp", exact_lon=exact)
            coast = sobel_edges_from_padded(mpad)
            # get_dist uses the clean periodic lon map (sobel.f90:163-164)
            cpad = halo_pad(coast, self.k, self.k, lat_fill="zero",
                            exact_lon=False)
            amin = min_haversine_param_from_padded(
                cpad, sdphi2, po, sdlam2, self.k, half_dlam=self.half_dlam)
            cd = finalize_distance(amin, lsm, params.maxdist)
            return _clamp_to_edge_row(cd, ~valid,
                                      jnp.clip(self.nlat_real - 1 - row_offset,
                                               0, h - 1))

        # Static coastline (no sea ice): one distance transform outside the
        # scan, like the unsharded pipeline (reference __init__.py:216-218).
        cdist0 = None if has_ci else distance(None)

        def scan_fn(carry, x):
            if has_ci:
                th, uu, vv, ci = x
                cdist = distance(ci)
            else:
                th, uu, vv = x
                cdist = cdist0
            new_state, out = trigger_step(
                carry, th, uu, vv, cdist, z, std, pres, params, self.nn_max,
                axis_names=(AXIS_Y, AXIS_X), ring_pad_fn=ring_pad,
                row_offset=row_offset, nlat_total=self.nlat_real,
                valid_mask=valid, use_pallas=pipe.use_pallas,
                pallas_interpret=pipe.pallas_interpret)
            return new_state, out

        return lax.scan(scan_fn, state, xs)

    def _core(self, state, xs, lsm, z, std, pres, sdphi2_g, po_g, sdlam2_g,
              *, has_ci: bool = True):
        core = self._core_overlap if self.overlap else self._core_basic
        return core(state, xs, lsm, z, std, pres, sdphi2_g, po_g, sdlam2_g,
                    has_ci=has_ci)

    # ------------------------------------------------------------------
    def build(self, has_ci: bool = True, pres_3d: bool = False):
        """The jitted shard_map-wrapped scan function (cached per variant —
        rebuilding the wrapper every call would re-trace).

        ``pres_3d`` selects the UM coupling contract
        (``UM/vn10.7/sea_breeze_diag.F90:79-82``): (nlev, nlat, nlon)
        pressure on rho levels, sharded P(None, 'y', 'x') — the per-column
        nearest-level selection (``ops.trigger.wind_at_level``) is purely
        local, so no halo is needed and the MPI-decomposed UM variant's
        behavior carries over shard-count-invariantly.
        """
        cache = getattr(self, "_built", None)
        if cache is None:
            cache = self._built = {}
        key = (has_ci, pres_3d)
        if key in cache:
            return cache[key]
        fld = P(AXIS_Y, AXIS_X)
        state_spec = TriggerState(tt=P(), thc=fld, windspeed=fld, winddir=fld)
        xs_spec = (P(None, AXIS_Y, AXIS_X), P(None, None, AXIS_Y, AXIS_X),
                   P(None, None, AXIS_Y, AXIS_X))
        if has_ci:
            xs_spec = xs_spec + (P(None, AXIS_Y, AXIS_X),)
        pres_spec = P(None, AXIS_Y, AXIS_X) if pres_3d else P()
        # Distance tables ride replicated: each shard gathers the table rows
        # of its (apron-extended) block itself — a few hundred KB at 0.1 deg.
        in_specs = (state_spec, xs_spec, fld, fld, fld, pres_spec,
                    P(None, None), P(None, None), P(None, None))
        out_specs = (state_spec,
                     {k: P(None, AXIS_Y, AXIS_X)
                      for k in ("sb_con", "t0", "windspeed", "winddir")})
        # check_vma=False: loop carries inside the ops layer are initialized
        # from fresh constants (jnp.full/zeros), which the vma checker types
        # as unvarying even though the loop bodies mix them with (y,x)-varying
        # data.  The ops are mesh-agnostic by design (the same code runs
        # single-device), so we opt out of the static check; shard-count
        # invariance is instead enforced dynamically by tests/test_sharded.py.
        fn = jax.shard_map(functools.partial(self._core, has_ci=has_ci),
                           mesh=self.mesh, in_specs=in_specs,
                           out_specs=out_specs, check_vma=False)
        cache[key] = jax.jit(fn)
        return cache[key]

    # ------------------------------------------------------------------
    def run(self, state: TriggerState, theta_t, u_t, v_t, lsm, z, std, pres,
            ci_t=None):
        """Host-friendly entry: pads lat, shards, runs, slices back."""
        nlat, nlon = self.nlat_pad, self.pipeline.grid.nlon
        padf = functools.partial(_pad_lat_host, nlat_pad=nlat)
        has_ci = ci_t is not None
        xs = (jnp.asarray(padf(theta_t), jnp.float32),
              jnp.asarray(padf(u_t), jnp.float32),
              jnp.asarray(padf(v_t), jnp.float32))
        if has_ci:
            xs = xs + (jnp.asarray(padf(ci_t), jnp.float32),)
        state_p = TriggerState(
            tt=state.tt,
            thc=jnp.asarray(padf(np.asarray(state.thc)), jnp.float32),
            windspeed=jnp.asarray(padf(np.asarray(state.windspeed)),
                                  jnp.float32),
            winddir=jnp.asarray(padf(np.asarray(state.winddir)), jnp.float32))
        pres_a = np.asarray(pres, np.float32)
        pres_3d = pres_a.ndim == 3
        args = (state_p, xs, jnp.asarray(padf(lsm), jnp.float32),
                jnp.asarray(padf(z), jnp.float32),
                jnp.asarray(padf(std), jnp.float32),
                jnp.asarray(padf(pres_a) if pres_3d else pres_a,
                            jnp.float32),
                jnp.asarray(self.tables[0]), jnp.asarray(self.tables[1]),
                jnp.asarray(self.tables[2]))
        final, outs = self.build(has_ci, pres_3d)(*args)
        sl = slice(0, self.nlat_real)
        final = TriggerState(tt=final.tt, thc=final.thc[sl],
                             windspeed=final.windspeed[sl],
                             winddir=final.winddir[sl])
        outs = {k: v[:, sl] for k, v in outs.items()}
        return final, outs
