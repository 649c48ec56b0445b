"""Canonical field registry — the ``get_all_fields_mod`` equivalent.

The reference declares its coupled-field universe in one Fortran module
(``generic/get_all_fields_mod.f90:6-21``): grid constants (nx=128, ny=96,
nz=56, halo_size=4, timestep=24/60 h), coordinate vectors, the 3-D
prognostics (p, u, v), the 2-D trigger fields (sb_con, land_frac, ice_frac,
windspeed, winddir, thc, z, sigma) and the halo-padded work arrays
(mask, theta).

Here the registry is data, not declarations: a spec table describing every
field's rank, units, and role, plus allocators.  It is the single source of
truth for the coupling layer (:mod:`seabreeze_param_tpu.coupling`), the
dummy-model example, the IO metadata writer, and the synthetic worlds used
by tests and benchmarks.  Halo-padded duplicates are *not* part of the
registry — halos are materialized transiently by
``parallel.halo.halo_pad`` inside the step, not carried in the field set.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# Reference dummy grid constants (generic/get_all_fields_mod.f90:9-11).
NX = 128               # longitudes
NY = 96                # latitudes
NZ = 56                # model levels (the pipeline consumes p-levels)
HALO_SIZE = 4          # reference halo width (transient here, see docstring)
TIMESTEP_H = 24.0 / 60.0   # 24-minute coupling step


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """One registry row.

    dims : tuple of dimension names; 'lev' is the vertical axis.
    role : 'coord' | 'static' | 'prognostic' | 'diagnostic' | 'state'.
    """

    name: str
    dims: tuple
    units: str
    role: str
    description: str


#: The canonical field set (generic/get_all_fields_mod.f90:12-20), in the
#: layout convention (lev, lat, lon) / (lat, lon) — C-order leading
#: batch axes, no Fortran transposes (utils.layout handles the boundary).
REGISTRY: tuple = (
    FieldSpec("lon", ("lon",), "degrees_east", "coord", "longitudes"),
    FieldSpec("lat", ("lat",), "degrees_north", "coord", "latitudes"),
    FieldSpec("p", ("lev",), "Pa", "coord",
              "pressure levels (3-D in the UM variant; see coupling)"),
    FieldSpec("u", ("lev", "lat", "lon"), "m s-1", "prognostic",
              "zonal wind on rho levels"),
    FieldSpec("v", ("lev", "lat", "lon"), "m s-1", "prognostic",
              "meridional wind on rho levels"),
    FieldSpec("theta", ("lat", "lon"), "K", "prognostic",
              "(potential) temperature at the surface level"),
    FieldSpec("land_frac", ("lat", "lon"), "1", "static", "land fraction"),
    FieldSpec("ice_frac", ("lat", "lon"), "1", "prognostic",
              "sea-ice fraction (moves the effective coastline per step)"),
    FieldSpec("z", ("lat", "lon"), "m", "static", "orography height"),
    FieldSpec("sigma", ("lat", "lon"), "m", "static",
              "sub-grid orography standard deviation"),
    FieldSpec("sb_con", ("lat", "lon"), "1", "diagnostic",
              "sea-breeze convection trigger strength"),
    FieldSpec("thc", ("lat", "lon"), "K", "state",
              "threaded state slot (holds t0 by reference convention, "
              "python_wrapper __init__.py:244)"),
    FieldSpec("windspeed", ("lat", "lon"), "m s-1", "state",
              "wind speed at the target pressure level (6-hourly cadence)"),
    FieldSpec("winddir", ("lat", "lon"), "degrees", "state",
              "wind direction (from), same cadence"),
    FieldSpec("mask", ("lat", "lon"), "km", "diagnostic",
              "signed distance to coast (the UM variant's 'mask' argument, "
              "UM/vn10.7/sea_breeze_diag.F90:96-98)"),
)

BY_NAME = {f.name: f for f in REGISTRY}


def field_names(role: str | None = None) -> list:
    """All registered names, optionally filtered by role."""
    return [f.name for f in REGISTRY if role is None or f.role == role]


def _shape_of(spec: FieldSpec, nlat: int, nlon: int, nlev: int):
    axes = {"lev": nlev, "lat": nlat, "lon": nlon}
    return tuple(axes[d] for d in spec.dims)


def allocate(nlat: int = NY, nlon: int = NX, nlev: int = NZ,
             dtype=np.float32) -> dict:
    """Zero-allocate the full field set (the module-variable declarations of
    get_all_fields_mod.f90:12-20, minus halo padding)."""
    out = {}
    for spec in REGISTRY:
        if spec.name == "lon":
            out["lon"] = np.linspace(0.0, 360.0, nlon, endpoint=False,
                                     dtype=dtype)
        elif spec.name == "lat":
            out["lat"] = np.linspace(90.0, -90.0, nlat, dtype=dtype)
        elif spec.name == "p":
            out["p"] = np.linspace(100000.0, 30000.0, nlev, dtype=dtype)
        else:
            out[spec.name] = np.zeros(_shape_of(spec, nlat, nlon, nlev),
                                      dtype)
    return out


def synthetic_world(nlat: int = NY, nlon: int = NX, nlev: int = 8,
                    nt: int = 1, seed: int = 0, polar_ice: bool = False):
    """Idealized coastline world — the shared test/bench fixture.

    A meandering north-south coastline plus two islands, random orography
    over land, mid-latitude temperatures, and random winds; optionally a
    polar sea-ice cap so the effective coastline moves every step (the
    reference's per-step distance-recompute path, ``__init__.py:223-228``).

    Returns a dict with the registry's static + prognostic fields, the
    prognostics carrying a leading time axis of length ``nt``.
    """
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
    ci = np.zeros((nt, nlat, nlon), F)
    if polar_ice:
        ci[:, : nlat // 12, :] = 0.8
    return dict(
        land_frac=lsm,
        ice_frac=ci,
        z=(700.0 * lsm * rng.random((nlat, nlon))).astype(F),
        sigma=(110.0 * lsm * rng.random((nlat, nlon))).astype(F),
        p=np.linspace(100000.0, 50000.0, nlev).astype(F),
        theta=(288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon))).astype(F),
        u=(6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F),
        v=(6.0 * rng.standard_normal((nt, nlev, nlat, nlon))).astype(F),
    )
