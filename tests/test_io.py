"""IO layer tests: config parsing, netCDF round-trips, metadata, batch driver.

The reference ships no tests for its L3 layer (SURVEY §4); these cover the
same surface its drivers exercise: ``Config`` coercion rules
(``configdir.py:296-345``), ``Meta`` static loading + date discovery +
CF writing (``configdir.py:15-181``), ``read_nc`` (``__init__.py:53-89``),
and the full ``test_run.py``-equivalent batch loop.
"""
import os
from datetime import datetime, timedelta

import numpy as np
import pytest

from seabreeze_param_tpu.io import (Config, Dataset, Meta, date2num,
                                    num2date, read_nc)
from seabreeze_param_tpu.utils.layout import c2f, f2c

F = np.float32


# ---------------------------------------------------------------------------
def test_config_parsing(tmp_path):
    p = tmp_path / "t.conf"
    p.write_text("""# a comment line
filename = 'foo.nc' # quoted string
variable = bar # trailing comment
 x1 = 9.0 # float
x2 =10  # int
active = true
off = False
nothing = None
times = 1,2,3 # tuple
[section-like junk]
""")
    c = Config(p)
    assert c.filename == "foo.nc"
    assert c["variable"] == "bar"
    assert c.x1 == 9.0 and isinstance(c.x1, float)
    assert c.x2 == 10 and isinstance(c.x2, int)
    assert c.active is True and c.off is False and c.nothing is None
    assert c.times == (1.0, 2.0, 3.0)
    assert "section-likejunk" not in c
    with pytest.raises(AttributeError):
        c.missing_key
    r = repr(c)
    assert "filename" in r and "foo.nc" in r


def test_config_env_expansion(tmp_path, monkeypatch):
    p = tmp_path / "t.conf"
    p.write_text("datadir = $MYDATA/sub\nbad = $UNSET_VAR_XYZ/sub\n")
    monkeypatch.setenv("MYDATA", "/data/root")
    monkeypatch.delenv("UNSET_VAR_XYZ", raising=False)
    with pytest.raises(KeyError):
        Config(p)
    p.write_text("datadir = $MYDATA/sub\n")
    assert Config(p).datadir == "/data/root/sub"


def test_config_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Config(tmp_path / "nope.conf")


def test_c2f_roundtrip():
    a = np.arange(2 * 3 * 4, dtype=F).reshape(2, 3, 4)
    b = c2f(a)
    assert b.shape == (4, 3, 2)
    assert np.array_equal(b, a.T)
    assert np.array_equal(f2c(b), a)


def test_date2num_roundtrip():
    units = "Seconds since 1970-01-01 00:00:00"
    times = [datetime(1987, 1, 1) + timedelta(hours=6 * i) for i in range(4)]
    num = date2num(times, units)
    assert num[0] == datetime(1987, 1, 1).timestamp() - 0  # epoch-aligned
    back = num2date(num, units)
    assert list(back) == times
    # other unit strings
    num_h = date2num(times, "hours since 1987-01-01")
    assert np.allclose(num_h, [0.0, 6.0, 12.0, 18.0])


# ---------------------------------------------------------------------------
def _write_static(path, lon, lat, fields, extra_rank=0):
    """Write a static netCDF with optional leading singleton dims."""
    with Dataset(path, "w") as f:
        f.createDimension("longitude", len(lon))
        f.createDimension("latitude", len(lat))
        f.createVariable("longitude", "f", ("longitude",))
        f.createVariable("latitude", "f", ("latitude",))
        f.variables["longitude"][:] = lon
        f.variables["latitude"][:] = lat
        dims = ("latitude", "longitude")
        for _ in range(extra_rank):
            pass
        for name, data in fields.items():
            if extra_rank:
                for dname in ("time_d", "lev_d")[:extra_rank]:
                    if dname not in f.dimensions:
                        f.createDimension(dname, 1)
                dims_full = (("time_d", "lev_d")[:extra_rank]) + dims
                v = f.createVariable(name, "f", dims_full)
                v[:] = data.reshape((1,) * extra_rank + data.shape)
            else:
                v = f.createVariable(name, "f", dims)
                v[:] = data


def _write_input(path, varname, data, pres, times, units):
    shape = data.shape
    with Dataset(path, "w") as f:
        f.createDimension("time", None)
        f.createDimension("level", shape[1] if data.ndim == 4 else 1)
        f.createDimension("latitude", shape[-2])
        f.createDimension("longitude", shape[-1])
        for nm, typ in (("time", "d"), ("level", "f")):
            f.createVariable(nm, typ, (nm,))
        f.variables["time"][:] = date2num(times, units)
        f.variables["time"].setncattr("units", units)
        f.variables["level"][:] = (pres if data.ndim == 4
                                   else pres[:1])
        dims = (("time", "level", "latitude", "longitude") if data.ndim == 4
                else ("time", "latitude", "longitude"))
        v = f.createVariable(varname, "f", dims)
        v[:] = data


def _build_synthetic_run(root, nlat=24, nlon=32, nlev=3, nt=4):
    """A complete synthetic data tree + run.conf (daily layout, 2 days)."""
    datadir = root / "data" / "1987"
    datadir.mkdir(parents=True)
    rng = np.random.default_rng(11)
    lon = np.linspace(0, 360, nlon, endpoint=False).astype(F)
    lat = np.linspace(40, -40, nlat).astype(F)
    y, x = np.mgrid[0:nlat, 0:nlon]
    lsm = (x > 0.5 * nlon).astype(F) * (0.7 + 0.3 * rng.random((nlat, nlon)))
    z = (300.0 * lsm).astype(F)
    std = (80.0 * lsm).astype(F)
    pres = np.array([1000.0, 700.0, 500.0], F)  # hPa like ERA levels
    _write_static(root / "data" / "static_slm.nc", lon, lat,
                  {"lsm": lsm}, extra_rank=2)   # rank-4 fallback path
    _write_static(root / "data" / "static_topo.nc", lon, lat,
                  {"z": z, "sdfor": std}, extra_rank=0)
    units = "hours since 1987-01-01 00:00:00"
    days = []
    for day in (1, 2):
        times = [datetime(1987, 1, day, 6 * i) for i in range(nt)]
        t2m = 288.0 + 5.0 * rng.standard_normal((nt, nlat, nlon)).astype(F)
        uu = 5.0 * rng.standard_normal((nt, nlev, nlat, nlon)).astype(F)
        vv = 5.0 * rng.standard_normal((nt, nlev, nlat, nlon)).astype(F)
        ci = np.zeros((nt, nlat, nlon), F)
        tag = f"1987_01_{day:02d}"
        _write_input(datadir / f"Synth_t2m_{tag}.nc", "t2m", t2m, pres,
                     times, units)
        _write_input(datadir / f"Synth_u_{tag}.nc", "u", uu, pres, times,
                     units)
        _write_input(datadir / f"Synth_v_{tag}.nc", "v", vv, pres, times,
                     units)
        _write_input(datadir / f"Synth_ci_{tag}.nc", "ci", ci, pres, times,
                     units)
        days.append(tag)
    conf = root / "run.conf"
    conf.write_text(f"""datadir = {root}/data
landfracfile = {root}/data/static_slm.nc
topofile = {root}/data/static_topo.nc
orofile = {root}/data/static_topo.nc
prefix = Synth_
vtheta = t2m
vu = u
vv = v
vlon = longitude
vlat = latitude
vpres = level
vci = ci
vlandfrac = lsm
vz = z
vstd = sdfor
vtime = time
plev = 700
start = 1987-01-01_00:00
end = 1987-01-03_00:00
""")
    return dict(root=root, conf=conf, days=days, lsm=lsm, z=z, std=std,
                lon=lon, lat=lat, pres=pres)


@pytest.fixture(scope="module")
def synthetic_run(tmp_path_factory):
    return _build_synthetic_run(tmp_path_factory.mktemp("synthrun"))


def test_meta_static_and_dates(synthetic_run):
    s = synthetic_run
    meta = Meta(Config(s["conf"]))
    # static fields through the rank fallback (rank-4 landfrac, rank-2 topo)
    assert meta.landfrac.shape == s["lsm"].shape
    np.testing.assert_allclose(meta.landfrac, s["lsm"], rtol=1e-6)
    np.testing.assert_allclose(meta.z, s["z"], rtol=1e-6)
    assert meta.dates == s["days"]


def test_read_nc(synthetic_run):
    s = synthetic_run
    meta = Meta(Config(s["conf"]))
    tag = s["days"][0]
    nc_data = read_nc(meta.input_path("v", tag), meta.input_path("u", tag),
                      meta.input_path("t2m", tag),
                      meta.input_path("ci", tag), vtheta="t2m",
                      vpres="level")
    assert nc_data.dt == 360.0  # 6-hourly
    assert nc_data.pres.tolist() == s["pres"].tolist()
    assert nc_data.v[:].shape == (4, 3, 24, 32)
    assert nc_data.time[0] == datetime(1987, 1, int(tag[-2:]), 0)
    for f in nc_data.nc.values():
        f.close()


def test_batch_driver_end_to_end(synthetic_run):
    """Full test_run.py-equivalent loop: writes one sb file per day with CF
    metadata; state threads across files."""
    import json
    from seabreeze_param_tpu.cli.run import main
    s = synthetic_run
    mfile = os.path.join(os.path.dirname(str(s["conf"])), "metrics.jsonl")
    tt, thc, ws, wd, written = main(str(s["conf"]), progress=None,
                                    metrics_file=mfile)
    assert tt == 1 + 2 * 4  # two daily files, four steps each
    assert len(written) == 2
    with open(mfile) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()]
    assert len(lines) == 2                      # one metrics line per file
    assert all(ln["points_per_s"] > 0 for ln in lines)
    assert lines[-1]["steps"] == 8 and "file" in lines[-1]
    for path in written:
        assert os.path.isfile(path)
        with Dataset(path) as f:
            v = f.variables["sb_con"]
            raw = v[:]
            data = np.ma.getdata(raw)
            assert data.shape == (4, 24, 32)
            assert v.units == " "
            assert v.long_name.startswith("Subgrid Sea-Breeze")
            assert np.isclose(float(v.missing_value), 2.0e20)
            np.testing.assert_allclose(f.variables["lat"][:], s["lat"],
                                       rtol=1e-6)
            # missing value marks far-from-coast cells
            assert (data >= 1e19).any()
            assert (np.abs(data[data < 1e19]) >= 0).all()


def test_batch_driver_reuses_cached_executable(tmp_path_factory):
    """The 2nd+ file of a batch run must NOT re-trace the scan: api.diag
    caches pipeline instances keyed by (grid, params, flags, ring bound),
    and each pipeline caches its jitted runner, so the trace counter stays
    flat after the first file (the re-trace-per-file analogue of the
    reference's per-step c2f copy tax, ``__init__.py:229-239``)."""
    from seabreeze_param_tpu import api
    from seabreeze_param_tpu.cli.run import main
    from seabreeze_param_tpu.models import pipeline as plmod
    s = _build_synthetic_run(tmp_path_factory.mktemp("synthcache"))
    api.clear_exec_cache()
    t0 = plmod.TRACE_STATS["traces"]
    main(str(s["conf"]), progress=None)
    traces_first = plmod.TRACE_STATS["traces"] - t0
    # two files, ONE trace of the scan (sticky ring bound keeps the second
    # file on the compiled executable)
    assert traces_first == 1, traces_first
    assert api.CACHE_STATS["pipeline_hits"] >= 2    # base + ring, file 2
    # a whole fresh driver run on the same config re-traces nothing
    t1 = plmod.TRACE_STATS["traces"]
    main(str(s["conf"]), progress=None)
    assert plmod.TRACE_STATS["traces"] == t1


def test_create_nc_append(synthetic_run, tmp_path):
    s = synthetic_run
    meta = Meta(Config(s["conf"]))
    path = str(tmp_path / "out.nc")
    times = [datetime(1987, 1, 1, 6 * i) for i in range(2)]
    field = np.zeros((2, len(meta.lat), len(meta.lon)), F)
    meta.create_nc(field, path, "sb_con", times)
    meta.create_nc(field + 1.0, path, "thc", times, add=" (appended)")
    with Dataset(path) as f:
        assert set(f.variables) >= {"sb_con", "thc", "lat", "lon", "time"}
        assert f.variables["thc"].long_name.endswith("(appended)")
        assert np.ma.getdata(f.variables["thc"][:]).max() == 1.0


def test_create_nc_writes_classic_netcdf(synthetic_run, tmp_path):
    """CF output is classic netCDF (CDF-2) that scipy reads back unaided:
    values, the missing value, the record axis and the coordinates."""
    from scipy.io import netcdf_file
    s = synthetic_run
    meta = Meta(Config(s["conf"]))
    path = tmp_path / "out.nc"
    times = [datetime(1987, 1, 1, 6 * i) for i in range(3)]
    field = np.random.default_rng(2).random(
        (3, len(meta.lat), len(meta.lon))).astype(F)
    field[:, 0, :] = 2.0e20
    meta.create_nc(field, str(path), "sb_con", times)
    assert path.read_bytes()[:4] == b"CDF\x02"
    with netcdf_file(str(path), "r", mmap=False) as f:
        assert f.dimensions["time"] is None           # unlimited record axis
        sb = f.variables["sb_con"]
        np.testing.assert_array_equal(sb[:], field)
        assert np.float32(sb.missing_value) == np.float32(2.0e20)
        np.testing.assert_array_equal(f.variables["lat"][:], meta.lat)
        np.testing.assert_array_equal(f.variables["time"][:],
                                      date2num(times, "seconds since "
                                               "1970-01-01 00:00:00"))


def test_hdf5_input_without_h5py_names_the_package(tmp_path, monkeypatch):
    """netCDF-4 (HDF5) input is recognised by its signature; without h5py
    the error says which package it needs instead of failing obscurely."""
    import sys
    path = tmp_path / "era5.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(504))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        Dataset(str(path))


def test_composites_end_to_end(synthetic_run, tmp_path):
    """plot.py-equivalent: batch outputs -> seasonal composite nc -> maps."""
    from seabreeze_param_tpu.cli.composites import main as composites_main
    from seabreeze_param_tpu.cli.run import main as run_main
    s = synthetic_run
    # ensure sb files exist (idempotent if test_batch ran first)
    run_main(str(s["conf"]), progress=None)
    outdir = str(tmp_path / "maps")
    ncout, maps = composites_main(str(s["conf"]), outdir=outdir,
                                  progress=None)
    assert os.path.isfile(ncout)
    with Dataset(ncout) as f:
        assert set(f.variables) >= {"sb_con", "thc", "temp"}
        # 4 seasons x 4 steps/day
        assert np.ma.getdata(f.variables["sb_con"][:]).shape[0] == 16
        # only DJF has data (January inputs): others averaged over 0 files
    assert len(maps) == 4
    for p in maps:
        assert os.path.getsize(p) > 1000


def test_batch_driver_sharded_mesh(tmp_path_factory):
    """--mesh routes the driver through the sharded pipeline; outputs must
    match the single-device run.  Uses a finer grid than the module fixture
    (the coarse 24x32 world needs ring radius ~15 — wider than any shard)."""
    from seabreeze_param_tpu.cli.run import main
    s = _build_synthetic_run(tmp_path_factory.mktemp("synthshard"),
                             nlat=160, nlon=288, nt=2)
    tt1, thc1, ws1, wd1, written1 = main(str(s["conf"]), progress=None)
    tt2, thc2, ws2, wd2, written2 = main(str(s["conf"]), progress=None,
                                         mesh="2x2")
    assert tt1 == tt2
    np.testing.assert_allclose(thc2, thc1, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(ws2, ws1, rtol=1e-5, atol=1e-4)
    with Dataset(written2[-1]) as f2, Dataset(written1[-1]) as f1:
        a = np.ma.getdata(f1.variables["sb_con"][:])
        b = np.ma.getdata(f2.variables["sb_con"][:])
        miss = a >= 1e19
        np.testing.assert_array_equal(b >= 1e19, miss)
        mism = ~np.isclose(b[~miss], a[~miss], rtol=1e-5, atol=1e-4)
        assert mism.mean() < 1e-3


def test_batch_driver_sharded_with_recovery(tmp_path_factory, tmp_path):
    """mesh + ckpt_dir together: the sharded driver under the elastic
    runner resumes across 'processes' and matches a plain sharded run."""
    from seabreeze_param_tpu.cli.run import main
    s = _build_synthetic_run(tmp_path_factory.mktemp("synthshardck"),
                             nlat=160, nlon=288, nt=2)
    ref = main(str(s["conf"]), progress=None, mesh="2x2")
    # first "process": run under recovery (completes the whole series)
    got = main(str(s["conf"]), progress=None, mesh="2x2",
               ckpt_dir=str(tmp_path / "ck"))
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-5)
    # second "process" pointed at the same dir: everything already done,
    # state comes straight from the checkpoint
    again = main(str(s["conf"]), progress=None, mesh="2x2",
                 ckpt_dir=str(tmp_path / "ck"))
    assert again[0] == ref[0]
    np.testing.assert_allclose(again[1], got[1], rtol=0, atol=0)
