"""Minimal self-contained netCDF layer (no ``netCDF4`` dependency).

The reference does all IO through the netCDF4 package
(``configdir.py:13``, ``__init__.py:71``).  This module provides the subset
the framework needs on top of NumPy and SciPy alone:

  * **read**: classic netCDF (CDF-1/2/5) through the native mmap reader
    (``io.native_nc``) or ``scipy.io.netcdf_file``; netCDF-4 files *are*
    HDF5 files, recognised by their signature and read through ``h5py``,
    which only such inputs need;
  * **write/append**: classic netCDF with 64-bit offsets (CDF-2) through
    ``scipy.io.netcdf_file``, which every netCDF tool reads;
  * **calendar**: ``date2num``/``num2date`` for "<unit> since <epoch>"
    time axes (standard calendar), as used by the reference
    (``configdir.py:162,168``; ``__init__.py:85-86``).

The surface deliberately mirrors the tiny slice of the netCDF4 API the
reference exercises (``Dataset(...).variables[name][...]``, ``.units``,
``createDimension``, ``createVariable``, attribute assignment) so drivers
written against the reference port mechanically.
"""
from __future__ import annotations

import os
import re
from datetime import datetime, timedelta

import numpy as np

_UNIT_SECONDS = {
    "second": 1.0, "seconds": 1.0, "sec": 1.0, "secs": 1.0, "s": 1.0,
    "minute": 60.0, "minutes": 60.0, "min": 60.0, "mins": 60.0,
    "hour": 3600.0, "hours": 3600.0, "hr": 3600.0, "hrs": 3600.0, "h": 3600.0,
    "day": 86400.0, "days": 86400.0, "d": 86400.0,
}

_UNITS_RE = re.compile(
    r"^\s*(\w+)\s+since\s+(\d{1,4})-(\d{1,2})-(\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2}(?:\.\d*)?))?)?", re.IGNORECASE)


def _parse_units(units: str):
    m = _UNITS_RE.match(units)
    if not m:
        raise ValueError(f"unparseable time units: {units!r}")
    scale = _UNIT_SECONDS.get(m.group(1).lower())
    if scale is None:
        raise ValueError(f"unknown time unit {m.group(1)!r} in {units!r}")
    y, mo, d = int(m.group(2)), int(m.group(3)), int(m.group(4))
    hh = int(m.group(5) or 0)
    mm = int(m.group(6) or 0)
    ss = float(m.group(7) or 0.0)
    return scale, datetime(y, mo, d, hh, mm) + timedelta(seconds=ss)


def date2num(dates, units: str):
    """datetime(s) -> numeric time axis in the given CF units."""
    scale, epoch = _parse_units(units)
    one = isinstance(dates, datetime)
    seq = [dates] if one else list(dates)
    out = np.array([(t - epoch).total_seconds() / scale for t in seq])
    return out[0] if one else out


def num2date(values, units: str):
    """Numeric CF time axis -> datetime objects (standard calendar)."""
    scale, epoch = _parse_units(units)
    arr = np.asarray(values, dtype=np.float64)
    flat = [epoch + timedelta(seconds=float(v) * scale) for v in arr.ravel()]
    if arr.ndim == 0:
        return flat[0]
    return np.array(flat, dtype=object).reshape(arr.shape)


# ---------------------------------------------------------------------------
class Variable:
    """Lazy variable handle: slicing reads from disk; netCDF attributes are
    plain Python attributes (``v.units``); masked where ``missing_value`` /
    ``_FillValue`` matches, as netCDF4 does (the reference relies on masked
    sea-ice arrays, ``__init__.py:225``)."""

    def __init__(self, ds, name, raw, backend):
        self._ds = ds
        self.name = name
        self._raw = raw
        self._backend = backend

    @property
    def shape(self):
        return tuple(self._raw.shape)

    @property
    def dtype(self):
        if self._backend == "scipy":
            return self._raw.data.dtype.newbyteorder("=")
        return np.dtype(self._raw.dtype)

    @property
    def dimensions(self):
        if self._backend == "h5":
            dims = []
            for i, dim in enumerate(self._raw.dims):
                # iterating a DimensionProxy yields the attached scales'
                # names; fall back to the h5 path of the scale object
                names = [n if isinstance(n, str)
                         else os.path.basename(getattr(n, "name", "") or "")
                         for n in dim]
                dims.append(names[0] if names else f"phony_dim_{i}")
            return tuple(dims)
        return tuple(self._raw.dimensions)

    def ncattrs(self):
        if self._backend == "h5":
            return [k for k in self._raw.attrs
                    if not k.startswith(("_Netcdf4", "DIMENSION", "CLASS",
                                         "NAME", "REFERENCE_LIST"))]
        if self._backend == "native":
            return sorted(self._raw.attrs())
        return sorted(self._raw._attributes)

    def __getattr__(self, key):
        try:
            if self._backend == "h5":
                val = self._raw.attrs[key]
            elif self._backend == "native":
                val = self._raw.att(key)
                if val is None:
                    raise KeyError(key)
            else:
                val = self._raw._attributes[key]
        except KeyError:
            raise AttributeError(key) from None
        if isinstance(val, bytes):
            return val.decode()
        return val

    def _writable(self):
        if self._backend != "scipy" or self._ds.mode == "r":
            raise OSError(f"{self._ds.filename}: opened read-only")

    def setncattr(self, key, value):
        self._writable()
        setattr(self._raw, key, value)

    __setattr__ = object.__setattr__  # attrs on the handle stay Python-side

    def __getitem__(self, key):
        data = self._raw[key]
        if self._backend == "scipy":
            data = np.array(data)  # detach from the file's buffer
        fill = None
        for attr in ("missing_value", "_FillValue"):
            try:
                fill = getattr(self, attr)
                break
            except AttributeError:
                continue
        if fill is not None and np.issubdtype(np.asarray(data).dtype,
                                              np.number):
            mask = np.isclose(data, np.asarray(fill, data.dtype))
            if mask.any():
                return np.ma.masked_array(data, mask=mask)
        return data

    def __setitem__(self, key, value):
        """Writes; assigning ``[:]`` to a record variable grows the
        unlimited axis to fit (netCDF append semantics)."""
        self._writable()
        self._raw[key] = np.asarray(value, self.dtype)

    def __len__(self):
        return self.shape[0]


_HDF5_SIGNATURE = b"\x89HDF\r\n\x1a\n"

#: createVariable type codes (the netCDF4 package's) -> classic dtypes
_DTYPES = {"f": np.float32, "d": np.float64, "i": np.int32, "h": np.int16,
           "b": np.int8}


def is_hdf5(path) -> bool:
    """True for a netCDF-4 (HDF5) file, judged by its signature."""
    with open(path, "rb") as f:
        return f.read(len(_HDF5_SIGNATURE)) == _HDF5_SIGNATURE


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError(
            "reading netCDF-4 (HDF5) input needs the h5py package; install "
            "h5py or convert the file to classic netCDF "
            "(nccopy -k 64-bit-offset)") from None
    return h5py


class Dataset:
    """netCDF dataset: ``Dataset(path)`` to read, ``mode='w'``/``'a'`` to
    write or append classic netCDF (CDF-2)."""

    def __init__(self, filename, mode="r"):
        self.filename = os.path.expanduser(str(filename))
        self.mode = mode
        self._scipy = None
        self._native = None
        self._h5 = None
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode must be 'r', 'w' or 'a', got {mode!r}")
        if mode != "w" and is_hdf5(self.filename):
            if mode == "a":
                raise OSError(f"{self.filename}: appending to netCDF-4 "
                              f"(HDF5) files is not supported; outputs are "
                              f"classic netCDF")
            self._h5 = _h5py().File(self.filename, "r")
            return
        from scipy.io import netcdf_file
        if mode == "r":
            # classic netCDF: prefer the native mmap reader
            # (native/ncreader.cc — GIL-free reads, prefetch-friendly),
            # fall back to scipy where no toolchain exists.
            from . import native_nc
            if native_nc.available():
                try:
                    self._native = native_nc.NativeNCFile(self.filename)
                except IOError:
                    self._native = None
            if self._native is None:
                self._scipy = netcdf_file(self.filename, "r", mmap=False)
        else:
            self._scipy = netcdf_file(self.filename, mode, mmap=False,
                                      version=2)

    # -- reference API slice ------------------------------------------
    @property
    def variables(self):
        out = {}
        if self._h5 is not None:
            h5py = _h5py()
            for name, node in self._h5.items():
                if isinstance(node, h5py.Dataset):
                    out[name] = Variable(self, name, node, "h5")
        elif self._native is not None:
            for name, var in self._native.variables.items():
                out[name] = Variable(self, name, var, "native")
        else:
            for name, var in self._scipy.variables.items():
                out[name] = Variable(self, name, var, "scipy")
        return out

    @property
    def dimensions(self):
        if self._h5 is not None:
            return {name: node.shape[0] for name, node in self._h5.items()
                    if node.attrs.get("CLASS") == b"DIMENSION_SCALE"}
        if self._native is not None:
            import ctypes
            from . import native_nc
            L = native_nc.lib()
            dims = {}
            buf = ctypes.create_string_buffer(256)
            ln = ctypes.c_longlong()
            for di in range(L.ncr_ndims(self._native._h)):
                L.ncr_dim(self._native._h, di, buf, 256, ctypes.byref(ln))
                dims[buf.value.decode()] = int(ln.value)
            return dims
        return dict(self._scipy.dimensions)

    def createDimension(self, name, size=None):
        if self._scipy is None or self.mode == "r":
            raise OSError(f"{self.filename}: opened read-only")
        if name in self._scipy.dimensions:
            raise RuntimeError(f"dimension {name!r} exists")
        self._scipy.createDimension(name, size)

    def createVariable(self, name, datatype, dimensions=()):
        if self._scipy is None or self.mode == "r":
            raise OSError(f"{self.filename}: opened read-only")
        if name in self._scipy.variables:
            raise RuntimeError(f"variable {name!r} exists")
        var = self._scipy.createVariable(
            name, np.dtype(_DTYPES.get(datatype, datatype)), tuple(dimensions))
        return Variable(self, name, var, "scipy")

    def close(self):
        for handle in (self._h5, self._scipy, self._native):
            if handle is not None:
                handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
