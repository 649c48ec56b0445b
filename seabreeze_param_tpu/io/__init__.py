"""IO layer: config parsing, netCDF access, static metadata, input reading.

Re-design of the reference's L3 config/IO layer
(``python_wrapper/seabreezediag/configdir.py`` + ``read_nc``,
``__init__.py:53-89``) without the netCDF4 dependency (see ``netcdf.py``).
"""
from __future__ import annotations

import types

import numpy as np

from .config import Config, CONFIG_SCHEMA
from .meta import Meta, VAR_METADATA, MISSING
from .netcdf import Dataset, Variable, date2num, num2date

__all__ = ["Config", "CONFIG_SCHEMA", "Meta", "VAR_METADATA", "MISSING",
           "Dataset", "Variable", "date2num", "num2date", "read_nc"]


def read_nc(fnv, fnu, fntheta, fnci, vv="v", vu="u", vtheta="t2m", vci="ci",
            vpres="pres", vtime="time"):
    """Open the four dated input files and bind lazy variable handles.

    Same contract as the reference ``read_nc`` (``__init__.py:53-89``):
    returns an object with ``.u/.v/.theta/.ci`` lazy variables, ``.pres``,
    ``.time`` (datetimes), ``.dt`` (minutes between the first two steps),
    and ``.nc`` (the open datasets, for the caller to close).
    """
    names = dict(v=vv, u=vu, theta=vtheta, ci=vci)
    meta = types.SimpleNamespace()
    meta.nc = {"v": Dataset(fnv), "u": Dataset(fnu),
               "theta": Dataset(fntheta), "ci": Dataset(fnci)}
    for key, ncf in meta.nc.items():
        setattr(meta, key, ncf.variables[names[key]])
    tvar = meta.nc["v"].variables[vtime]
    meta.time = num2date(tvar[:], tvar.units)
    meta.pres = np.array(meta.nc["v"].variables[vpres][:])
    meta.dt = (meta.time[1] - meta.time[0]).seconds / 60.0
    return meta
