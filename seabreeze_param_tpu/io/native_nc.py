"""ctypes binding for the native classic-netCDF reader + prefetch pool
(``native/ncreader.cc``).

The reference reads its dated input series serially through the netCDF4
package (``test_run.py:30``, ``seabreezediag/__init__.py:53-89``).  Here
classic (CDF-1/2/5) files go through a native mmap parser whose calls
release the GIL, and :class:`PrefetchPool` warms the *next* files of the
series into the page cache on background C++ threads while the device
computes the current one.  netCDF-4/HDF5 files fall back to the h5py
backend in :mod:`seabreeze_param_tpu.io.netcdf`.

Builds on demand with make (cached .so), like the golden oracle binding
(``tests/golden/native_oracle.py``); every entry point degrades gracefully
to ``None``/no-op when no toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           os.pardir, os.pardir, "native")
_LIB = None
_TRIED = False

#: classic nc_type -> numpy dtype (native endianness; the C side swaps)
_DTYPES = {1: np.int8, 2: np.dtype("S1"), 3: np.int16, 4: np.int32,
           5: np.float32, 6: np.float64, 7: np.uint8, 8: np.uint16,
           9: np.uint32, 10: np.int64, 11: np.uint64}


def lib():
    """Build (if needed) and load libncreader.so; None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libncreader.so")
    src = os.path.join(_NATIVE_DIR, "ncreader.cc")
    try:
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            subprocess.run(["make", "-C", _NATIVE_DIR, "libncreader.so"],
                           check=True, capture_output=True)
        L = ctypes.CDLL(so)
    except (OSError, subprocess.CalledProcessError):
        return None
    L.ncr_open.restype = ctypes.c_void_p
    L.ncr_open.argtypes = [ctypes.c_char_p]
    L.ncr_close.argtypes = [ctypes.c_void_p]
    L.ncr_nvars.argtypes = [ctypes.c_void_p]
    L.ncr_numrecs.restype = ctypes.c_longlong
    L.ncr_numrecs.argtypes = [ctypes.c_void_p]
    L.ncr_ndims.argtypes = [ctypes.c_void_p]
    L.ncr_dim.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p,
                          ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    L.ncr_var_info.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    L.ncr_var_dimname.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    L.ncr_read.restype = ctypes.c_longlong
    L.ncr_read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_longlong, ctypes.c_void_p]
    L.ncr_natts.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.ncr_att_name.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_int]
    L.ncr_att_info.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_longlong)]
    L.ncr_att_read.restype = ctypes.c_longlong
    L.ncr_att_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_char_p, ctypes.c_void_p]
    L.ncr_pool_new.restype = ctypes.c_void_p
    L.ncr_pool_new.argtypes = [ctypes.c_int]
    L.ncr_pool_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    L.ncr_pool_pending.argtypes = [ctypes.c_void_p]
    L.ncr_pool_free.argtypes = [ctypes.c_void_p]
    _LIB = L
    return _LIB


def available() -> bool:
    return lib() is not None


class NativeVar:
    """Lazy per-variable handle (shape, dtype, dims, attrs, sliced reads)."""

    def __init__(self, nf, index, name, shape, dtype_code, is_record, dims):
        self._nf = nf
        self._index = index
        self.name = name
        self.shape = shape
        self.dtype = np.dtype(_DTYPES[dtype_code])
        self.is_record = is_record
        self.dimensions = dims

    def attrs(self):
        L = lib()
        n = L.ncr_natts(self._nf._h, self._index)
        buf = ctypes.create_string_buffer(256)
        out = {}
        for ai in range(max(0, n)):
            if L.ncr_att_name(self._nf._h, self._index, ai, buf, 256) == 0:
                name = buf.value.decode()
                out[name] = self.att(name)
        return out

    def att(self, name):
        L = lib()
        t = ctypes.c_int()
        ln = ctypes.c_longlong()
        if L.ncr_att_info(self._nf._h, self._index, name.encode(),
                          ctypes.byref(t), ctypes.byref(ln)) != 0:
            return None
        arr = np.empty(ln.value, dtype=_DTYPES[t.value])
        L.ncr_att_read(self._nf._h, self._index, name.encode(),
                       arr.ctypes.data_as(ctypes.c_void_p))
        if t.value == 2:  # NC_CHAR -> text
            return arr.tobytes().decode(errors="replace")
        return arr[0] if ln.value == 1 else arr

    # -- reads ----------------------------------------------------------
    def read(self, rec0: int = 0, nrec: int | None = None) -> np.ndarray:
        """Whole variable, or records [rec0, rec0+nrec) of a record var."""
        L = lib()
        if self.is_record:
            total = self.shape[0]
            if nrec is None:
                nrec = total - rec0
            shape = (nrec,) + self.shape[1:]
        else:
            rec0, nrec = 0, 1
            shape = self.shape
        out = np.empty(shape, dtype=self.dtype)
        got = L.ncr_read(self._nf._h, self._index, rec0, nrec,
                         out.ctypes.data_as(ctypes.c_void_p))
        if got < 0:
            raise IOError(f"native read failed: {self.name}")
        return out

    def __getitem__(self, key):
        whole = isinstance(key, slice) and key == slice(None) \
            or key is Ellipsis
        if whole or not self.is_record:
            data = self.read()
            return data if whole else data[key]
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += self.shape[0]
            return self.read(i, 1)[0]
        if isinstance(key, slice):
            r0, r1, step = key.indices(self.shape[0])
            data = self.read(r0, max(0, r1 - r0))
            return data[::step]
        return self.read()[key]

    def __len__(self):
        return self.shape[0]


class NativeNCFile:
    """Native classic-netCDF file handle.

    ``variables`` maps names to :class:`NativeVar`.  Raises ``IOError`` for
    non-classic (e.g. HDF5/netCDF-4) files — callers fall back to the
    Python backends.
    """

    def __init__(self, path):
        L = lib()
        if L is None:
            raise IOError("native reader unavailable")
        self._h = L.ncr_open(os.fsencode(os.path.expanduser(str(path))))
        if not self._h:
            raise IOError(f"not a classic netCDF file: {path}")
        self.path = str(path)
        self.variables = {}
        name = ctypes.create_string_buffer(256)
        shape = (ctypes.c_longlong * 16)()
        dt = ctypes.c_int()
        isrec = ctypes.c_int()
        for vi in range(L.ncr_nvars(self._h)):
            nd = L.ncr_var_info(self._h, vi, name, 256, shape, 16,
                                ctypes.byref(dt), ctypes.byref(isrec))
            if nd < 0:
                continue
            dims = []
            dbuf = ctypes.create_string_buffer(256)
            for d in range(nd):
                L.ncr_var_dimname(self._h, vi, d, dbuf, 256)
                dims.append(dbuf.value.decode())
            self.variables[name.value.decode()] = NativeVar(
                self, vi, name.value.decode(), tuple(shape[:nd]), dt.value,
                bool(isrec.value), tuple(dims))

    def close(self):
        if self._h:
            lib().ncr_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchPool:
    """Background C++ threads that warm upcoming input files into the page
    cache — IO/compute overlap for the batch driver's dated file series
    (the reference reads each month's files cold and serially,
    ``test_run.py:18-30``)."""

    def __init__(self, nthreads: int = 2):
        L = lib()
        self._pool = L.ncr_pool_new(nthreads) if L else None

    def prefetch(self, *paths):
        if self._pool is None:
            return
        L = lib()
        for p in paths:
            if p:
                L.ncr_pool_prefetch(self._pool,
                                    os.fsencode(os.path.expanduser(str(p))))

    def pending(self) -> int:
        return lib().ncr_pool_pending(self._pool) if self._pool else 0

    def close(self):
        if self._pool is not None:
            lib().ncr_pool_free(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
