"""Loop-faithful NumPy oracle of the reference numerics.

This is an *independent transcription of the semantics* of
``python_wrapper/seabreezediag/seabreeze_diag_python.f90``
and ``sobel.f90`` (the authoritative variant per SURVEY.md §0) into plain
Python loops over float32 scalars, cited per routine below.  It exists so
the vectorized JAX implementation can be validated with allclose golden
tests without compiling or copying the Fortran.  Everything here is
deliberately slow and simple.

Layout: (nlat, nlon) C-order; loop variable ``i`` is the latitude row,
``j`` the longitude column, both 0-based.  The Fortran's 1-based
(nlons, nlats) indexing is translated index-by-index in comments.
"""
from __future__ import annotations

import numpy as np

F = np.float32
R_EARTH = F(6370.9989)   # sobel.f90:115
PI = F(3.1415926)        # sobel.f90:116
D2R = PI / F(180.0)
RAD2DEG = F(57.2957)     # seabreeze_diag_python.f90:125
GMMA = F(-0.0060956)     # seabreeze_diag_python.f90:126


def lon_quirky(j, nlon):
    """Fortran ``max(1, modulo(j, nlons))`` on 1-based j -> 0-based result.

    Used by get_edges (sobel.f90:68) and the diag ring search
    (seabreeze_diag_python.f90:202).  j here is 0-based, possibly
    out-of-range."""
    return max(1, (j + 1) % nlon) - 1


def lat_clamp(i, nlat):
    """Fortran ``min(max(1, i), nlats)`` -> 0-based clamp."""
    return min(max(0, i), nlat - 1)


def golden_get_edges(lsm, ci):
    """sobel.f90:19-89."""
    lsm = np.asarray(lsm, F)
    ci = np.asarray(ci, F)
    nlat, nlon = lsm.shape
    mask = lsm + ci                                   # sobel.f90:51
    # weight(r,c): columns (-1,-2,-1), (0,0,0), (1,2,1)  (sobel.f90:54-56)
    w = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], F)  # w[r,c] = weight(r+1,c+1)
    coast = np.zeros((nlat, nlon), F)
    for y in range(nlat):
        for x in range(nlon):
            px = F(0.0)
            py = F(0.0)
            for jof in (-1, 0, 1):          # j in Fortran: lon offset
                for iof in (-1, 0, 1):      # i in Fortran: lat offset
                    yy = lat_clamp(y + iof, nlat)      # sobel.f90:67
                    xx = lon_quirky(x + jof, nlon)     # sobel.f90:68
                    mm = F(1.0) if mask[yy, xx] > F(0.4) else F(0.0)
                    px = px + w[iof + 1, jof + 1] * mm  # weight(i+2,j+2)
                    py = py + w[jof + 1, iof + 1] * mm  # weight(j+2,i+2)
            p = np.sqrt(px * px + py * py, dtype=F)
            coast[y, x] = F(0.0) if p == F(0.0) else F(1.0)
    return coast


def _branch_lon(lonval):
    """sobel.f90:165-174 — re-branch to (-180, 180] degrees, in radians."""
    if lonval > F(180.0):
        return D2R * (lonval - F(360.0))
    return D2R * lonval


def golden_search_radius(lon, lat, maxdist=F(180.0)):
    """sobel.f90:129-137 — k = int(maxdist / dx(70 deg))."""
    lon = np.asarray(lon, F)
    lat = np.asarray(lat, F)
    phi = (D2R * lat).astype(F)
    lam = (D2R * lon).astype(F)
    tlat = int(np.argmin(np.abs(F(70.0) - lat)))
    if tlat + 1 >= lat.shape[0]:
        tlat = lat.shape[0] - 2
    dphi = F(phi[tlat + 1] - phi[tlat])
    dlam = F(lam[1] - lam[0])
    a = F(np.sin(dphi / 2, dtype=F) ** 2
          + np.cos(phi[tlat + 1], dtype=F)
          * (np.cos(phi[tlat], dtype=F) * np.sin(dlam / 2, dtype=F) ** 2))
    dx = R_EARTH * F(2.0) * np.arctan2(np.sqrt(a, dtype=F),
                                       np.sqrt(F(1.0) - a, dtype=F), dtype=F)
    return int(F(maxdist) / dx)


def golden_get_dist(coast, mask, lon, lat, maxdist=180.0):
    """sobel.f90:91-193.

    One deliberate deviation: the reference applies the
    ``|cdist| > 2*maxdist -> 12000`` reset *inside* the scatter loop
    (sobel.f90:188), which is loop-order-dependent (and thread-racy under
    OpenMP): a later-ordered coastal point can scatter a >2*maxdist distance
    into an already-reset cell.  On the reference's real (global, periodic)
    workloads no in-window distance exceeds 2*maxdist, so the orders are
    indistinguishable there; they differ only on regional grids whose
    index-periodic lon wrap spans a real geographic gap.  Both this oracle
    and the framework implement the deterministic final-pass reset.
    """
    coast = np.asarray(coast, F)
    mask = np.asarray(mask, F)
    lon = np.asarray(lon, F)
    lat = np.asarray(lat, F)
    maxdist = F(maxdist)
    nlat, nlon = coast.shape
    phi = (D2R * lat).astype(F)
    k = golden_search_radius(lon, lat, maxdist)
    cdist = np.full((nlat, nlon), F(12000.0), F)     # sobel.f90:141-149
    for i in range(nlat):
        for j in range(nlon):
            if coast[i, j] > F(0.0):                 # sobel.f90:157
                for ii in range(-k, k + 1):
                    yy = lat_clamp(i + ii, nlat)     # sobel.f90:159
                    dphi = F(phi[i] - phi[yy])
                    for jj in range(-k, k + 1):
                        xx = (j + jj) % nlon         # sobel.f90:163-164
                        l1 = _branch_lon(lon[j])
                        l2 = _branch_lon(lon[xx])
                        dlam = F(l1 - l2)
                        a = F(np.sin(dphi / 2, dtype=F) ** 2
                              + np.cos(phi[i], dtype=F)
                              * (np.cos(phi[yy], dtype=F)
                                 * np.sin(dlam / 2, dtype=F) ** 2))
                        c = F(R_EARTH * F(2.0)
                              * np.arctan2(np.sqrt(a, dtype=F),
                                           np.sqrt(F(1.0) - a, dtype=F),
                                           dtype=F) + F(0.5))
                        if c < abs(cdist[yy, xx]):   # sobel.f90:178
                            if mask[yy, xx] > F(0.0):
                                cdist[yy, xx] = c
                            else:
                                cdist[yy, xx] = -c
    # sobel.f90:188 as a deterministic final pass (see docstring).
    cdist[np.abs(cdist) > F(2.0) * maxdist] = F(12000.0)
    return cdist


def golden_sigmoid(ary):
    """seabreeze_diag_python.f90:287-311 (deterministic variance sum)."""
    a = np.asarray(ary, F)
    n = a.size
    mean = F(a.sum(dtype=F) / F(n))
    var = F(((a - mean) ** 2).sum(dtype=F))
    s = F(2.0) / np.sqrt(var / F(n), dtype=F)
    r = F((a.max() - a.min()) / F(4.0))
    return (F(1.0) / (F(1.0) + np.exp(-s * (a - r), dtype=F))).astype(F)


def golden_diag(tt, p, z, std, theta, v, u, cdist, windspeed, winddir, thc,
                target_plev=700.0, thresh_wind=11.0, thresh_winddir=90.0,
                thresh_windch=5.0, thresh_thc=0.75, target_time=6.0,
                timestep=24.0, maxdist=180.0):
    """seabreeze_diag_python.f90:49-285.

    Arrays are (nlat, nlon); u, v are (nlev, nlat, nlon); p is (nlev,).
    Returns the (4, nlat, nlon) output array (slot order sb_con, t0,
    windspeed, winddir per :277-280) with zeros in the never-written last
    latitude row (the f2py build leaves it uninitialized).
    State arrays are modified in place like the Fortran locals.
    """
    p = np.asarray(p, F)
    theta = np.asarray(theta, F)
    z = np.asarray(z, F)
    std = np.asarray(std, F)
    u = np.asarray(u, F)
    v = np.asarray(v, F)
    cdist = np.asarray(cdist, F)
    windspeed = np.array(windspeed, F)
    winddir = np.array(winddir, F)
    thc = np.array(thc, F)
    nlat, nlon = theta.shape

    timestep_s = F(timestep) * F(60.0)               # :146
    target_time_s = F(target_time) * F(60.0) ** 2    # :147
    target_plev_pa = F(target_plev) * F(100.0)       # :148
    maxdist = F(maxdist)

    smod = golden_sigmoid(std)                       # :157
    t0 = (theta - (GMMA * z * smod)).astype(F)       # :158

    output = np.zeros((4, nlat, nlon), F)
    sb_con = np.zeros((nlat, nlon), F)

    for i in range(nlat - 1):                        # :165  do i=1,nlats-1
        for j in range(nlon):
            if abs(cdist[i, j]) > maxdist:           # :171
                sb_con[i, j] = F(2.0e20)
            else:
                mul = F(1.0) if cdist[i, j] >= F(0.0) else F(-1.0)
                nn = 1
                while True:                          # :191 expanding ring
                    n_l = F(0.0)
                    n_s = F(0.0)
                    T_l = F(0.0)
                    T_s = F(0.0)
                    for ii in range(i - nn, i + nn + 1):
                        for jj in range(j - nn, j + nn + 1):
                            ki = lat_clamp(ii, nlat)       # :201
                            kj = lon_quirky(jj, nlon)      # :202
                            if cdist[ki, kj] >= F(0.0):
                                T_l = F(T_l + t0[ki, kj])
                                n_l = F(n_l + 1)
                            else:
                                T_s = F(T_s + t0[ki, kj])
                                n_s = F(n_s + 1)
                    if n_s > 0 and n_l > 0:
                        break
                    nn += 1
                n_thc = F(mul * (T_l / n_l - T_s / n_s))   # :221

                p_lev = int(np.argmin(np.abs(p - target_plev_pa)))  # :228
                n_ws = F(np.sqrt(u[p_lev, i, j] ** 2 + v[p_lev, i, j] ** 2,
                                 dtype=F))
                n_wd = F(np.arctan2(-u[p_lev, i, j], -v[p_lev, i, j],
                                    dtype=F) * RAD2DEG)

                if tt < 2:                           # :236-240
                    thc[i, j] = n_thc
                    winddir[i, j] = n_wd
                    windspeed[i, j] = n_ws

                thc_abs = F(abs(n_thc))
                mws = F((windspeed[i, j] + n_ws) / F(2.0))
                dws = F(abs(windspeed[i, j] - n_ws))
                dwd = F(abs(np.mod((winddir[i, j] - n_wd) + F(180.0),
                                   F(360.0), dtype=F) - F(180.0)))

                if (dwd < F(thresh_winddir) and dws < F(thresh_windch)
                        and mws < F(thresh_wind) and thc_abs > F(thresh_thc)):
                    scale_wind = F((F(thresh_wind) - mws)
                                   / max(F(1.0), mws))
                    scale_thc = F((thc_abs - F(thresh_thc)) / n_thc)
                    sb_con[i, j] = F(scale_thc * scale_wind)
                else:
                    sb_con[i, j] = F(0.0)

                thc[i, j] = n_thc                    # :268
                if np.mod(F(tt) * timestep_s, target_time_s) < F(1.0e-4):
                    windspeed[i, j] = n_ws           # :271-274
                    winddir[i, j] = n_wd

            output[0, i, j] = sb_con[i, j]           # :277-280
            output[1, i, j] = t0[i, j]
            output[2, i, j] = windspeed[i, j]
            output[3, i, j] = winddir[i, j]
    return output


def golden_diag_sequence(nsteps, p, z, std, theta_t, v_t, u_t, lsm, ci_t,
                         lon, lat, **kw):
    """The python_wrapper time loop (__init__.py:219-245): per step recompute
    the coast distance from the sea-ice mask, run diag, thread
    (thc, ws, wd) = out[1:4] forward.  Returns stacked (4, T, nlat, nlon)."""
    nlat, nlon = lsm.shape
    ws = np.zeros((nlat, nlon), F)
    wd = np.zeros((nlat, nlon), F)
    thc = np.zeros((nlat, nlon), F)
    outs = []
    tt = 1
    for ts in range(nsteps):
        coast = golden_get_edges(lsm, ci_t[ts])
        cdist = golden_get_dist(coast, lsm, lon, lat,
                                kw.get("maxdist", 180.0))
        out = golden_diag(tt, p, z, std, theta_t[ts], v_t[ts], u_t[ts],
                          cdist, ws, wd, thc, **kw)
        outs.append(out)
        thc, ws, wd = out[1].copy(), out[2].copy(), out[3].copy()
        tt += 1
    return np.stack(outs, axis=1)
