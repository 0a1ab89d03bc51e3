"""Dataset attributes in the port's HDF5 reader and writer
(multimodalfusion_tpu_torch/data/hdf5.py) against h5py: the WSI patcher's
``coords`` attributes (int64 scalars, float64 and int64 pairs, ``name``
as a variable-length UTF-8 string in a global heap) written by the JAX
package's ``save_hdf5`` read back by the port equal to h5py's, and
written by the port read back by h5py equal to JAX's, ``name`` a
``str``; h5py's own attributes of other kinds; many and long strings."""
import h5py
import numpy as np
import pytest

from multimodalfusion_tpu.data import io as jio
from multimodalfusion_tpu_torch.data import hdf5
from multimodalfusion_tpu_torch.data import io as tio


def _coords_attrs(name="synthetic_1"):
    return {"coords": {
        "patch_size": 256, "patch_level": 0,
        "downsample": np.asarray((1.0, 2.0039062)),
        "downsampled_level_dim": np.asarray((2048, 1536)),
        "level_dim": np.asarray((2048, 1536)), "name": name}}


def _h5py_attrs(path, name):
    with h5py.File(path, "r") as f:
        return dict(f[name].attrs)


def _same_attrs(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, str):
            assert type(g) is str and g == w, k
        else:
            w = np.asarray(w)
            g = np.asarray(g)
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["synthetic_1", "TCGA-AB-1234-01Z-00-DX1",
                                  "slide é ü 😀", ""])
def test_jax_files_read_like_h5py_and_port_files_like_jax(tmp_path, name):
    coords = np.random.default_rng(0).integers(0, 5000, (37, 2))
    attrs = _coords_attrs(name)
    jpath, tpath = str(tmp_path / "j.h5"), str(tmp_path / "t.h5")
    jio.save_hdf5(jpath, {"coords": coords}, attrs, mode="w")
    tio.save_hdf5(tpath, {"coords": coords}, attrs)
    want = _h5py_attrs(jpath, "coords")
    with hdf5.File(jpath) as f:
        _same_attrs(f.attrs("coords"), want)
        np.testing.assert_array_equal(f["coords"], coords)
    _same_attrs(_h5py_attrs(tpath, "coords"), want)
    with hdf5.File(tpath) as f:
        _same_attrs(f.attrs("coords"), want)
        assert list(f.attrs("coords")) == sorted(want)
    with h5py.File(tpath, "r") as f:
        np.testing.assert_array_equal(f["coords"][()], coords)


def test_h5py_attribute_kinds(tmp_path):
    p = str(tmp_path / "h.h5")
    with h5py.File(p, "w") as f:
        d = f.create_dataset("x", data=np.arange(6.0).reshape(2, 3))
        d.attrs["f32"] = np.float32(1.5)
        d.attrs["i16"] = np.arange(5, dtype=np.int16)
        d.attrs["u8"] = np.uint8(200)
        d.attrs["grid"] = np.arange(6, dtype=np.int32).reshape(2, 3)
        d.attrs["fixed"] = np.bytes_(b"abc")
        d.attrs["strs"] = ["a", "bb", "ccc"]
        d.attrs["s"] = "hello"
        f.create_dataset("bare", data=np.zeros(2))
    with hdf5.File(p) as f:
        got = f.attrs("x")
        assert f.attrs("bare") == {}
    want = _h5py_attrs(p, "x")
    assert got["fixed"] == "abc" and got["s"] == "hello"
    assert got["strs"].tolist() == ["a", "bb", "ccc"]
    for k in ("f32", "i16", "u8", "grid"):
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_writer_many_datasets_long_and_many_strings(tmp_path):
    arrays = {f"d{i}": np.arange(i + 1, dtype=np.float32) for i in range(7)}
    attrs = {f"d{i}": {"name": "x" * (1000 * i), "k": i,
                       "v": np.arange(i + 2, dtype=np.float64) / 3}
             for i in range(0, 7, 2)}
    attrs["d1"] = {f"s{j}": f"value {j}" for j in range(300)}
    p = hdf5.write(str(tmp_path / "m.h5"), arrays, attrs)
    with h5py.File(p, "r") as f:
        for k, v in arrays.items():
            np.testing.assert_array_equal(f[k][()], v)
    for k in arrays:
        want = attrs.get(k, {})
        _same_attrs(_h5py_attrs(p, k), {a: (v if isinstance(v, str) else
                                            np.asarray(v, np.int64 if
                                                       isinstance(v, int)
                                                       else None))
                                        for a, v in want.items()})
        with hdf5.File(p) as f:
            _same_attrs(f.attrs(k), _h5py_attrs(p, k))


def test_writer_refuses_what_it_cannot_store(tmp_path):
    p = str(tmp_path / "r.h5")
    with pytest.raises(NotImplementedError, match="numbers and str"):
        hdf5.write(p, {"x": np.zeros(2)}, {"x": {"b": np.array([True])}})
    with pytest.raises(KeyError, match="not written"):
        hdf5.write(p, {"x": np.zeros(2)}, {"y": {"a": 1}})
    with pytest.raises(NotImplementedError, match="appends"):
        tio.save_hdf5(p, {"x": np.zeros(2)}, mode="a")
