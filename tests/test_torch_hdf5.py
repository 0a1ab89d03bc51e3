"""The port's HDF5 reader and writer (multimodalfusion_tpu_torch/data/
hdf5.py) against h5py, on files the JAX package's ``data.io.save_hdf5``
writes (chunked, chunk shape (1, ...), unfiltered: a 155-row bag walks a
chunk B-tree of depth 2) and on files h5py writes directly.  The reader
must return exactly h5py's arrays, h5py must read the writer's files
exactly, and what the reader does not take must raise the errors that
keep the JAX loader's verdict on a radiology bag (OSError, KeyError for
a missing one)."""
import os

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from multimodalfusion_tpu.data import io as jio
from multimodalfusion_tpu_torch.data import hdf5
from multimodalfusion_tpu_torch.data import io as tio


def _h5py_all(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = obj[()]
        f.visititems(visit)
    return out


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _bag(rng, n, d=1024):
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.permutation(n + 5)[:n].astype(np.int64))


@pytest.mark.parametrize("n", [1, 3, 155, 300])
def test_reads_jax_feature_h5_like_h5py(tmp_path, n):
    """One write through the JAX writer (155 and 300 rows: a chunk B-tree
    of depth 2 at h5py's default K)."""
    feats, sids = _bag(np.random.default_rng(n), n)
    p = str(tmp_path / "s.h5")
    jio.save_hdf5(p, {"features": feats, "slice_index": sids}, mode="w")
    want = _h5py_all(p)
    with hdf5.File(p) as f:
        assert f.keys() == sorted(want)
        for k, v in want.items():
            _same(f[k], v)
    got_f, got_s = tio.load_features_h5(p)
    want_f, want_s = jio.load_features_h5(p)
    _same(got_f, want_f)
    _same(got_s, want_s)
    _same(got_f, feats)


def test_reads_three_appends_like_h5py(tmp_path):
    rng = np.random.default_rng(1)
    p = str(tmp_path / "a.h5")
    parts = [_bag(rng, n) for n in (40, 60, 50, 7)]
    jio.save_hdf5(p, {"features": parts[0][0], "slice_index": parts[0][1]},
                  mode="w")
    for f, s in parts[1:]:
        jio.save_hdf5(p, {"features": f, "slice_index": s})
    want = _h5py_all(p)
    assert want["features"].shape == (157, 1024)
    got_f, got_s = tio.load_features_h5(p)
    _same(got_f, want["features"])
    _same(got_s, want["slice_index"])


def test_reads_h5py_files_of_other_layouts(tmp_path):
    """Contiguous and compact datasets, a group holding the two feature
    datasets with attributes, a user block, chunks with partial edges and
    chunks never written (read as the fill value), every integer and float
    width, a scalar, an empty dataset and a root group of 40 members (more
    than one symbol-table node)."""
    p = str(tmp_path / "h.h5")
    rng = np.random.default_rng(2)
    feats, sids = _bag(rng, 20, 64)
    with h5py.File(p, "w", userblock_size=512) as f:
        f.create_dataset("features", data=feats)           # contiguous
        f.create_dataset("slice_index", data=sids)
        g = f.create_group("grp")
        g.attrs["note"] = "radiology"
        g.create_dataset("features", data=feats, chunks=(3, 64))
        g.create_dataset("slice_index", data=sids, chunks=(4,))
        g["features"].attrs["scale"] = 2.5
        f.create_dataset("edges", data=np.arange(77, dtype=np.uint16
                                                 ).reshape(7, 11),
                         chunks=(3, 4))
        part = f.create_dataset("part", shape=(5, 6), chunks=(2, 2),
                                dtype=np.float64, fillvalue=-7.5)
        part[0:2, 0:3] = 1.0
        for dt in ("i1", "u1", "i2", "u2", "i4", "u4", "i8", "u8", "f2",
                   "f4", "f8"):
            f.create_dataset(f"t_{dt}", data=(rng.standard_normal(9) * 50
                                              ).astype(dt))
        f.create_dataset("scalar", data=np.float32(3.25))
        f.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        f.create_dataset("small", data=np.arange(6, dtype=np.int32),
                         dcpl=_compact_dcpl())
        for i in range(40):
            f.create_dataset(f"m{i:02d}", data=np.arange(i + 1))
    want = _h5py_all(p)
    with hdf5.File(p) as f:
        assert "grp" in f and "grp/features" in f and "nope" not in f
        for k, v in want.items():
            _same(f[k], v)
    assert (want["part"] == -7.5).sum() == 24


def _compact_dcpl():
    plist = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    plist.set_layout(h5py.h5d.COMPACT)
    return plist


@pytest.mark.parametrize("dtype", ["float32", "int64", "float64", "uint8",
                                   "int16", "float16"])
def test_h5py_reads_the_writer_exactly(tmp_path, dtype):
    rng = np.random.default_rng(3)
    feats, sids = _bag(rng, 155)
    arrays = {"features": feats.astype(dtype),
              "slice_index": sids,
              "grid": (rng.standard_normal((2, 3, 5)) * 9).astype(dtype),
              "scalar": np.asarray(7, dtype),
              "empty": np.zeros((0, 3), dtype)}
    p = tio.save_hdf5(str(tmp_path / "w.h5"), arrays)
    got = _h5py_all(p)
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        _same(got[k], np.asarray(v))
    with hdf5.File(p) as f:
        for k, v in arrays.items():
            _same(f[k], np.asarray(v))
    # and the JAX loader reads the port's radiology file as the port does
    jf, js = jio.load_features_h5(p)
    tf, ts = tio.load_features_h5(p)
    _same(tf, jf)
    _same(ts, js)


def test_writer_takes_many_datasets_and_refuses_what_it_cannot(tmp_path):
    arrays = {f"d{i:02d}": np.arange(i, dtype=np.int32) for i in range(21)}
    p = hdf5.write(str(tmp_path / "many.h5"), arrays)
    got = _h5py_all(p)
    for k, v in arrays.items():
        _same(got[k], v)
    with pytest.raises(NotImplementedError, match="appends"):
        tio.save_hdf5(p, {"x": np.zeros(2)}, mode="a")
    with pytest.raises(NotImplementedError, match="numbers and str"):
        tio.save_hdf5(p, {"x": np.zeros(2)}, {"x": {"a": np.array([True])}})
    with pytest.raises(KeyError, match="not written"):
        tio.save_hdf5(p, {"x": np.zeros(2)}, {"y": {"a": 1}})
    with pytest.raises(NotImplementedError, match="integers and IEEE"):
        hdf5.write(p, {"x": np.array(["a"])})
    with pytest.raises(ValueError, match="dataset name"):
        hdf5.write(p, {"a/b": np.zeros(2)})


def test_load_without_slice_index_matches_jax(tmp_path):
    p = str(tmp_path / "f.h5")
    feats = np.arange(12, dtype=np.float32).reshape(3, 4)
    with h5py.File(p, "w") as f:
        f["features"] = feats
    tf, ts = tio.load_features_h5(p)
    jf, js = jio.load_features_h5(p)
    _same(tf, jf)
    assert ts is None and js is None


def _raises_like_h5py(path, key, err):
    """The port raises ``err`` reading the feature file (``key`` None) or
    one dataset, and so does h5py (through the JAX loader)."""
    with pytest.raises(err):
        tio.load_features_h5(path) if key is None else hdf5.read(path, key)
    with pytest.raises(err):
        if key is None:
            jio.load_features_h5(path)
        else:
            with h5py.File(path, "r") as f:
                f[key][()]


def test_unsupported_and_broken_files_raise(tmp_path):
    x = np.arange(4000, dtype=np.float32).reshape(4, 1000)
    # gzip, lzf (32000, which h5py writes without a plugin) and the
    # libver='latest' layout read as JAX reads them; scale-offset (6)
    # raises naming the filter
    gz = str(tmp_path / "gz.h5")
    with h5py.File(gz, "w") as f:
        f.create_dataset("features", data=x, chunks=(1, 1000),
                         compression="gzip")
    lzf = str(tmp_path / "lzf.h5")
    with h5py.File(lzf, "w") as f:
        f.create_dataset("features", data=x, chunks=(1, 1000),
                         compression="lzf")
    latest = str(tmp_path / "latest.h5")
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("features", data=x, chunks=(1, 1000),
                         maxshape=(None, 1000))
    for path in (gz, lzf, latest):
        (got, no_index), (want, _) = (tio.load_features_h5(path),
                                      jio.load_features_h5(path))
        _same(got, want)
        assert no_index is None
    scaled = str(tmp_path / "scaleoffset.h5")
    with h5py.File(scaled, "w") as f:
        f.create_dataset("features", data=x.astype(np.int32),
                         chunks=(1, 1000), scaleoffset=0)
    with pytest.raises(NotImplementedError, match="filter 6 .scale-offset"):
        tio.load_features_h5(scaled)

    ok = str(tmp_path / "ok.h5")
    jio.save_hdf5(ok, {"features": x}, mode="w")
    raw = open(ok, "rb").read()
    for n in (0, 7, 100, 2000, len(raw) // 2, len(raw) - 1):
        cut = str(tmp_path / f"cut{n}.h5")
        with open(cut, "wb") as f:
            f.write(raw[:n])
        _raises_like_h5py(cut, None, OSError)
    junk = str(tmp_path / "junk.h5")
    with open(junk, "wb") as f:
        f.write(b"not an hdf5 file\n" * 64)
    _raises_like_h5py(junk, None, OSError)
    _raises_like_h5py(str(tmp_path / "absent.h5"), None, OSError)
    empty = str(tmp_path / "nofeat.h5")
    with h5py.File(empty, "w") as f:
        f["slice_index"] = np.arange(3)
    _raises_like_h5py(empty, None, KeyError)
    _raises_like_h5py(ok, "missing", KeyError)
    with pytest.raises(KeyError):
        hdf5.read(ok, "features/deeper")


@settings(max_examples=25, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(n=st.integers(1, 300), d=st.integers(1, 4096),
       seed=st.integers(0, 2 ** 16))
def test_property_reader_matches_h5py_on_jax_files(tmp_path, n, d, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    sids = rng.permutation(n).astype(np.int64)
    p = str(tmp_path / f"p{n}_{d}.h5")
    jio.save_hdf5(p, {"features": feats, "slice_index": sids}, mode="w")
    got_f, got_s = tio.load_features_h5(p)
    want_f, want_s = jio.load_features_h5(p)
    _same(got_f, want_f)
    _same(got_s, want_s)
    os.remove(p)
    # and the writer's file, read by h5py
    tio.save_hdf5(p, {"features": feats, "slice_index": sids})
    want_f, want_s = jio.load_features_h5(p)
    _same(want_f, feats)
    _same(want_s, sids)
    os.remove(p)
