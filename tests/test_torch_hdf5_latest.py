"""The port's HDF5 reader (multimodalfusion_tpu_torch/data/hdf5.py and
data/hdf5_blocks.py) on the files h5py writes outside its default format:
superblocks 2 and 3, version-2 object headers, groups of links (compact
and dense: fractal heaps under version-2 B-trees), dense attributes, the
chunk indexes of data layout version 4 (single chunk, implicit, fixed
array, extensible array, version-2 B-tree) and the lzf filter (the C++
decoder and the plain one).  Held to h5py, directly and through the JAX
package's loader, at tolerance 0: arrays bit for bit, attributes equal,
the same exception class on a corrupt or truncated file (so both
packages' datasets count the same bags missing), and
``NotImplementedError`` naming each structure the port leaves refused.
The committed fixtures of ``testdata/h5/`` (tools/make_h5_fixtures.py)
are held to their manifest."""
import hashlib
import importlib.util
import json
import os
import shutil
import struct

import h5py
import numpy as np
import pytest

from multimodalfusion_tpu.data import io as jio
from multimodalfusion_tpu.data.survival_dataset import \
    SurvivalDataset as JaxDataset
from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.cli import extract_features_fp as tfp
from multimodalfusion_tpu_torch.data import hdf5
from multimodalfusion_tpu_torch.data import hdf5_blocks as blocks
from multimodalfusion_tpu_torch.data import io as tio
from multimodalfusion_tpu_torch.data.survival_dataset import \
    SurvivalDataset as PortDataset
from multimodalfusion_tpu_torch.utils import lzf
from multimodalfusion_tpu_torch.utils.lookup3 import hashlittle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "multimodalfusion_tpu_torch", "testdata", "h5")
_spec = importlib.util.spec_from_file_location(
    "make_h5_fixtures", os.path.join(REPO, "tools", "make_h5_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

LIBVERS = [("earliest", True), ("v108", False), ("v110", False),
           ("latest", False)]
LAYOUTS = ["compact", "contiguous", "single", "implicit", "fixed",
           "fixed_paged", "extensible", "btree"]
FILTERS = [None, "gzip", "lzf", "lzf_fletcher32"]
# HDF5 filters chunked data only, and the implicit index is what early
# allocation gives a chunked dataset without filters
CASES = [(lv, lay, flt) for lv in LIBVERS for lay in LAYOUTS
         for flt in FILTERS
         if flt is None or lay not in ("compact", "contiguous", "implicit")]
# (rows, columns, chunk rows) by layout: 1,100 one-row chunks make the
# fixed array paged (pages of 1,024), 300 one-row chunks give the
# extensible array super blocks and the B-tree internal nodes
SHAPES = {"fixed_paged": (1100, 8, 1), "extensible": (300, 8, 1),
          "btree": (300, 8, 1)}


def _features(rng, n, d):
    """Post-ReLU features: about half are zeros, so lzf shrinks chunks."""
    return np.maximum(rng.standard_normal((n, d), dtype=np.float32), 0)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _same_attrs(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, (str, bytes)):
            assert got[k] == (v.decode() if isinstance(v, bytes) else v), k
        else:
            a, b = np.asarray(got[k]), np.asarray(v)
            if b.dtype.kind == "S":  # fixed-length strings come as str
                b = np.array([w.decode() for w in b.reshape(-1)],
                             object).reshape(b.shape)
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == object:
                assert a.tolist() == b.tolist(), k
            else:
                assert a.tobytes() == b.tobytes(), k


def _write_case(path, libver, track, layout, filters, seed=0):
    rng = np.random.default_rng(seed)
    n, d, rows = SHAPES.get(layout, (40, 64, 4))
    feats = _features(rng, n, d)
    ids = rng.permutation(n + 7)[:n].astype(np.int64)
    base = "fixed" if layout == "fixed_paged" else layout
    with fx.new_file(path, libver, track) as f:
        put = dict(filters=filters, track_order=track)
        if base not in ("compact", "contiguous", "single"):
            put["chunks"] = (rows, d)
        fx.put(f, "features", feats, base, **put)
        if "chunks" in put:
            # an 8-byte chunk does not shrink under lzf
            put["chunks"] = (max(rows, 8),)
        fx.put(f, "slice_index", ids, base, **put)
    return feats, ids


@pytest.mark.parametrize("libver,layout,filters", CASES, ids=[
    f"{lv}{'_track' if tr else ''}-{lay}-{flt or 'none'}"
    for (lv, tr), lay, flt in CASES])
def test_layouts_read_like_h5py(tmp_path, libver, layout, filters):
    lv, track = libver
    path = str(tmp_path / "bag.h5")
    feats, ids = _write_case(path, lv, track, layout, filters)
    want_f, want_s = jio.load_features_h5(path)
    _same(want_f, feats)
    _same(want_s, ids)
    got_f, got_s = tio.load_features_h5(path)
    _same(got_f, want_f)
    _same(got_s, want_s)
    with hdf5.File(path, plain=True) as f:
        _same(f["features"], want_f)
        _same(f["slice_index"], want_s)
    if filters and "lzf" in filters:
        # h5py stores a chunk lzf does not shrink raw: at least one chunk
        # of each dataset must have gone through the decoder
        with h5py.File(path, "r") as f:
            assert fx.lzf_chunks(f["features"]) >= 1
            assert fx.lzf_chunks(f["slice_index"]) >= 1
    sigs = fx.signatures(path)
    if lv in ("v110", "latest") and layout != "compact":
        want = {"fixed": "FAHD", "fixed_paged": "FAHD", "extensible": "EASB",
                "btree": "BTIN"}.get(layout)
        assert want is None or sigs.get(want), sigs


def test_partial_writes_read_the_fill_value(tmp_path):
    """Chunks never written, pages of a fixed array never initialised,
    super blocks and paged data blocks of an extensible array (over
    131,072 chunks) never allocated: the fill value, as h5py reads it."""
    path = str(tmp_path / "sparse.h5")
    with fx.new_file(path, "latest") as f:
        a = f.create_dataset("fixed", shape=(4000, 2), dtype="i8",
                             chunks=(1, 2), fillvalue=7)
        a[10:20] = np.arange(20).reshape(10, 2)
        a[3000] = [5, 6]
        b = f.create_dataset("ext", shape=(140000,), dtype="u1",
                             chunks=(1,), maxshape=(None,), fillvalue=9)
        for i in (5, 131100, 134500, 137000, 139999):
            b[i] = i % 200
        c = f.create_dataset("tree", shape=(50, 6), dtype="f4",
                             chunks=(4, 4), maxshape=(None, None),
                             fillvalue=-1.5, compression="lzf")
        c[8:20, 1:3] = 2.5
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        for name in ("fixed", "ext", "tree"):
            _same(g[name], f[name][()])


def test_paged_extensible_array(tmp_path):
    """140,000 one-byte chunks: the extensible array's data blocks past
    131,072 elements are paged."""
    path = str(tmp_path / "paged.h5")
    x = (np.arange(140000) % 251).astype(np.uint8)
    with fx.new_file(path, "latest") as f:
        fx.put(f, "x", x, "extensible")
    with hdf5.File(path) as f:
        _same(f["x"], x)


@pytest.mark.parametrize("shape,chunks,maxshape", [
    ((50, 2), (4, 1), (80, 2)),         # a fixed array past the extent
    ((2, 50), (1, 3), (2, None)),       # the unlimited axis second
    ((7, 5, 3), (2, 2, 2), (None, 5, 3)),
])
def test_chunk_numbering_over_the_largest_extent(tmp_path, shape, chunks,
                                                 maxshape):
    path = str(tmp_path / "x.h5")
    x = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    with fx.new_file(path, "latest") as f:
        f.create_dataset("x", data=x, chunks=chunks, maxshape=maxshape)
    with hdf5.File(path) as f:
        _same(f["x"], x)


def _attr_values(rng):
    return {"patch_level": 0, "patch_size": 256, "name": "slide-7",
            "downsample": np.array([1.0, 1.0]),
            "level_dim": np.array([40000, 30000], np.int64),
            "fixed": np.bytes_(b"abc"), "f32": np.float32(0.25),
            "u8s": np.arange(5, dtype=np.uint8), "i16": np.int16(-3),
            "words": np.array([b"ab", b"cde"], dtype="S3"),
            **{f"x{i}": float(rng.uniform()) for i in range(6)}}


@pytest.mark.parametrize("members,track", [(9, False), (9, True),
                                           (40, False), (300, True)])
def test_dense_groups_and_attributes(tmp_path, members, track):
    """Groups past 8 members keep their links in a fractal heap under a
    name index (and, tracked, a creation-order index); 40 and 300 members
    make the heap's root an indirect block.  Every member, the keys, and 16
    attributes of each kind (dense) read as h5py reads them."""
    rng = np.random.default_rng(members)
    path = str(tmp_path / "dense.h5")
    with fx.new_file(path, "latest", track) as f:
        ds = fx.put(f, "features", _features(rng, 6, 16), "contiguous",
                    track_order=track)
        for k, v in _attr_values(rng).items():
            ds.attrs[k] = v
        # created against the names' order: h5py lists a tracked group
        # by creation order
        for i in range(members - 1, 0, -1):
            fx.put(f, f"m{i:03d}", rng.integers(0, 99, i % 7 + 1),
                   "contiguous")
    sigs = fx.signatures(path)
    assert sigs.get("FRHP") == 2 and sigs.get("BTHD") == 2 + 2 * track
    # past about 30 links the heap's root is an indirect block
    assert bool(sigs.get("FHIB")) == (members > 9)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g.keys() == list(f.keys())
        assert (g.keys() == sorted(g.keys())) == (not track)
        for name in f:
            _same(g[name], f[name][()])
        want = dict(f["features"].attrs)
        _same_attrs(g.attrs("features"), want)
        for k, v in want.items():
            _same_attrs({k: g.attr_get("features", k)}, {k: v})
        assert g.attr_get("features", "absent", 3) == 3
        assert "m001" in g and "m999" not in g


@pytest.mark.parametrize("libver,track", [("earliest", True),
                                          ("latest", False),
                                          ("latest", True)])
def test_compact_group_lists_members_as_h5py(tmp_path, libver, track):
    path = str(tmp_path / "compact_group.h5")
    with fx.new_file(path, libver, track) as f:
        for name in ("zeta", "alpha", "slice_index", "features"):
            fx.put(f, name, np.arange(3), "contiguous")
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g.keys() == list(f.keys())
        assert (g.keys()[0] == "zeta") == track


def test_compact_attributes_in_version2_headers(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "compact.h5")
    values = dict(list(_attr_values(rng).items())[:8])
    with fx.new_file(path, "v110") as f:
        ds = fx.put(f, "coords", np.arange(8).reshape(4, 2), "fixed")
        ds.attrs.update(values)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        _same_attrs(g.attrs("coords"), dict(f["coords"].attrs))


# -- the lzf decoders ---------------------------------------------------

def test_lzf_decoders_equal_h5py_on_raw_chunks(tmp_path):
    rng = np.random.default_rng(5)
    path = str(tmp_path / "lzf.h5")
    data = {"f32": (_features(rng, 64, 300), (8, 300)),
            "i64": (rng.integers(0, 1000, (500, 3)), (100, 3)),
            "u8": (np.repeat(rng.integers(0, 255, 700, dtype=np.uint8), 5),
                   (1500,)),
            "f64": (np.maximum(rng.standard_normal((90, 40)), 0), (9, 40))}
    with h5py.File(path, "w") as f:
        for name, (x, chunks) in data.items():
            f.create_dataset(name, data=x, chunks=chunks, compression="lzf")
    decoded = 0
    with h5py.File(path, "r") as f:
        for name in data:
            ds = f[name]
            for i in range(ds.id.get_num_chunks()):
                info = ds.id.get_chunk_info(i)
                if info.filter_mask & 1:
                    continue
                mask, raw = ds.id.read_direct_chunk(info.chunk_offset)
                sel = tuple(slice(o, o + c) for o, c in
                            zip(info.chunk_offset, ds.chunks))
                want = np.zeros(ds.chunks, ds.dtype)
                part = ds[sel]
                want[tuple(slice(0, s) for s in part.shape)] = part
                size = want.nbytes
                assert lzf.decompress(raw, size) == want.tobytes()
                assert native.lzf_decode(raw, size) == want.tobytes()
                decoded += 1
    assert decoded >= 8


@pytest.mark.parametrize("stream,size", [
    (b"\x05abc", 64),             # a literal run cut short
    (b"\x01ab\x20", 64),          # a reference without its offset byte
    (b"\x01ab\xe0", 64),          # a long reference without its length
    (b"\x00a\x20\x05", 64),       # a reference before the output starts
    (b"\x03abcd\x20\x01", 5),     # output past its size
    (b"\x1fabcdefghijklmnopqrstuvwxyz012345", 16),
])
def test_lzf_corrupt_streams_raise_in_both(stream, size):
    with pytest.raises(ValueError):
        lzf.decompress(stream, size)
    with pytest.raises(ValueError):
        native.lzf_decode(stream, size)


def test_lzf_overlapping_reference():
    # "ab" then a reference one back, 7 long: the copy reads what it wrote
    stream = b"\x01ab\xa0\x00"
    want = b"ab" + b"b" * 7
    assert lzf.decompress(stream, 64) == want
    assert native.lzf_decode(stream, 64) == want


def test_corrupt_lzf_chunk_raises_oserror_like_h5py(tmp_path):
    path = str(tmp_path / "bag.h5")
    _write_case(path, "latest", False, "fixed", "lzf")
    with h5py.File(path, "r") as f:
        ds = f["features"]
        info = next(ds.id.get_chunk_info(i)
                    for i in range(ds.id.get_num_chunks())
                    if not ds.id.get_chunk_info(i).filter_mask & 1)
    raw = bytearray(open(path, "rb").read())
    raw[info.byte_offset + info.size - 3] ^= 0xFF
    raw[info.byte_offset] = 0x1F  # a literal run past the chunk's end
    with open(path, "wb") as fh:
        fh.write(bytes(raw))
    with pytest.raises(OSError):
        jio.load_features_h5(path)
    for plain in (False, True):
        with pytest.raises(OSError, match="lzf"):
            with hdf5.File(path, plain=plain) as f:
                f["features"]


# -- corruption ---------------------------------------------------------

def _jax_coords(path):
    """extract_features_fp's read of a coordinates file in the JAX CLI."""
    with h5py.File(path, "r") as f:
        coords = f["coords"][:]
        patch_level = int(f["coords"].attrs.get("patch_level", 0))
        patch_size = int(f["coords"].attrs.get("patch_size", 256))
    return coords, patch_level, patch_size


def _outcome(fn, path):
    try:
        return "ok", fn(path)
    except KeyError:
        return "KeyError", None
    except OSError:
        return "OSError", None
    except Exception as e:  # the class h5py raises, whatever it is
        return type(e).__name__, None


def _same_outcome(want, got):
    assert got[0] == want[0]
    if want[0] == "ok":
        for a, b in zip(want[1], got[1]):
            if isinstance(a, np.ndarray):
                _same(b, a)
            else:
                assert a == b


@pytest.fixture(scope="module")
def corrupt_cases(tmp_path_factory):
    """{kind: (path, reader, byte offsets to flip)}: one file per kind of
    checksummed block, each flip on the block's header fields or inside
    its body (a page's elements, for the paged kinds)."""
    d = tmp_path_factory.mktemp("corrupt")
    rng = np.random.default_rng(9)
    files = {}
    for name, (lv, layout, flt) in {
            "fixed": ("latest", "fixed", "lzf"),
            "fixed_paged": ("latest", "fixed_paged", None),
            "extensible": ("latest", "extensible", "gzip"),
            "btree": ("latest", "btree", "lzf_fletcher32")}.items():
        files[name] = str(d / f"{name}.h5")
        _write_case(files[name], lv, False, layout, flt)
    files["dense"] = str(d / "dense.h5")
    with fx.new_file(files["dense"], "latest", True) as f:
        fx.put(f, "features", _features(rng, 6, 16), "fixed")
        fx.put(f, "slice_index", np.arange(6), "fixed")
        for i in range(300):
            fx.put(f, f"m{i:03d}", np.arange(3), "contiguous")
    files["ea_paged"] = str(d / "ea_paged.h5")
    with fx.new_file(files["ea_paged"], "latest") as f:
        b = f.create_dataset("features", shape=(140000,), dtype="u1",
                             chunks=(1,), maxshape=(None,), fillvalue=9)
        for i in (5, 131100, 134500, 137000, 139999):
            b[i] = i % 200
    files["coords"] = str(d / "coords.h5")
    with fx.new_file(files["coords"], "latest", True) as f:
        ds = fx.put(f, "coords", np.arange(600).reshape(300, 2),
                    "extensible", track_order=True)
        ds.attrs.update({k: v for k, v in _attr_values(rng).items()})
    # the committed coordinates: their dataset header continues in an
    # OCHK block
    files["ea_coords"] = os.path.join(FIXTURES, "coords_extensible.h5")
    raws = {k: open(v, "rb").read() for k, v in files.items()}

    def at(name, sig, offsets, limit=6):
        raw, out, i = raws[name], [], raws[name].find(sig)
        while i >= 0 and len(out) < limit * len(offsets):
            out += [i + o for o in offsets]
            i = raw.find(sig, i + 1)
        return out

    feats, coords = tio.load_features_h5, tfp.read_coords
    return {
        "superblock": (files["fixed"], feats, [9, 13, 30, 44]),
        "OHDR": (files["fixed"], feats, at("fixed", b"OHDR", [2, 5, 9,
                                                             40])),
        "OCHK": (files["ea_coords"], coords, at("ea_coords", b"OCHK",
                                                [5, 20])),
        "FRHP": (files["dense"], feats, at("dense", b"FRHP", [5, 30])),
        "FHIB": (files["dense"], feats, at("dense", b"FHIB", [5, 30])),
        "FHDB": (files["dense"], feats, at("dense", b"FHDB", [5, 40],
                                           limit=12)),
        "BTHD": (files["btree"], feats, at("btree", b"BTHD", [5, 12])),
        "BTIN": (files["btree"], feats, at("btree", b"BTIN", [5, 30])),
        "BTLF": (files["dense"], feats, at("dense", b"BTLF", [5, 40],
                                           limit=12)),
        "FAHD": (files["fixed"], feats, at("fixed", b"FAHD", [5, 9])),
        "FADB": (files["fixed"], feats, at("fixed", b"FADB", [5, 20])),
        "FADB page": (files["fixed_paged"], feats,
                      at("fixed_paged", b"FADB", [19 + 3, 19 + 8 * 1025])),
        "EAHD": (files["extensible"], feats, at("extensible", b"EAHD",
                                                [5, 10])),
        "EAIB": (files["extensible"], feats, at("extensible", b"EAIB",
                                                [5, 20])),
        "EASB": (files["extensible"], feats, at("extensible", b"EASB",
                                                [5, 20])),
        "EADB": (files["extensible"], feats, at("extensible", b"EADB",
                                                [5, 20])),
        "EADB page": (files["ea_paged"], feats,
                      at("ea_paged", b"EADB", [24, 8220], limit=40)[-4:]),
        "attribute storage": (files["coords"], coords, at(
            "coords", b"BTLF", [5, 20]) + at("coords", b"FHDB", [5, 40])),
    }


KINDS = ["superblock", "OHDR", "OCHK", "FRHP", "FHIB", "FHDB", "BTHD",
         "BTIN", "BTLF", "FAHD", "FADB", "FADB page", "EAHD", "EAIB",
         "EASB", "EADB", "EADB page", "attribute storage"]


@pytest.mark.parametrize("kind", KINDS)
def test_flipped_byte_raises_what_h5py_raises(tmp_path, corrupt_cases,
                                              kind):
    """One flipped byte at a time in each block of a kind: the port's read
    (the radiology loader, or stage 1's read of the coordinates) ends as
    the JAX package's ends through h5py -- the same values, or the same
    exception class; at least one flip of each kind is caught."""
    path, port_read, offsets = corrupt_cases[kind]
    jax_read = (jio.load_features_h5 if port_read is tio.load_features_h5
                else _jax_coords)
    raw = open(path, "rb").read()
    assert offsets
    caught = 0
    for off in offsets:
        bad = bytearray(raw)
        bad[off] ^= 0x24
        flipped = str(tmp_path / "flipped.h5")
        with open(flipped, "wb") as fh:
            fh.write(bytes(bad))
        want = _outcome(jax_read, flipped)
        _same_outcome(want, _outcome(port_read, flipped))
        caught += want[0] != "ok"
    if kind == "attribute storage":
        # h5py's attrs.get gives the default when the attribute cannot be
        # opened: so does the port
        assert caught == 0
    else:
        assert caught >= 1


@pytest.mark.parametrize("fraction", [0.02, 0.3, 0.5, 0.9, 0.999])
@pytest.mark.parametrize("layout", ["extensible", "btree"])
def test_truncated_file_raises_oserror_like_h5py(tmp_path, layout,
                                                 fraction):
    path = str(tmp_path / "bag.h5")
    _write_case(path, "latest", False, layout, "lzf")
    raw = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(raw[:int(len(raw) * fraction)])
    assert _outcome(jio.load_features_h5, path)[0] == "OSError"
    assert _outcome(tio.load_features_h5, path)[0] == "OSError"


def _cohort_copy(tmp_path):
    root = str(tmp_path / "h5")
    shutil.copytree(FIXTURES, root)
    return root


def _radio_bags(root):
    csv = os.path.join(root, "cohort.csv")
    data = os.path.join(root, "cohort")
    kw = dict(mode="radio", data_dir=data, n_bins=2)
    jax, port = (JaxDataset(csv, **kw).whole_split(),
                 PortDataset(csv, **kw).whole_split())
    assert len(jax) == len(port) == 2
    out = []
    for i in range(2):
        js, ts = jax.get_sample(i), port.get_sample(i)
        assert js.subject_id == ts.subject_id
        out.append((js.radio, ts.radio))
    return out


def test_committed_cohort_same_bags_in_both_datasets(tmp_path):
    for want, got in _radio_bags(_cohort_copy(tmp_path)):
        assert want is not None and 5 <= len(want) < 12
        assert want.shape[1] == 4 * 1024
        _same(got, want)


def test_corrupt_bags_count_missing_in_both_datasets(tmp_path):
    """A flipped byte in one subject's dataset header (h5py: KeyError) and
    in the other's chunk index (OSError): both packages count both bags
    missing."""
    root = _cohort_copy(tmp_path)
    for rel, sig, off in (("T2/TCGA-H5-A001.h5", b"OHDR", -1),
                          ("T2/TCGA-H5-A002.h5", b"BTHD", 0)):
        path = os.path.join(root, "cohort", "radio_h5_files", rel)
        raw = bytearray(open(path, "rb").read())
        at = raw.rfind(sig) if off < 0 else raw.find(sig)
        raw[at + 8] ^= 0x11
        with open(path, "wb") as fh:
            fh.write(bytes(raw))
    for want, got in _radio_bags(root):
        assert want is None and got is None


# -- what stays refused -------------------------------------------------

def _v2_messages(raw, addr):
    """(position, type, flags) of each message of the version-2 object
    header at ``addr``, and where its checksum sits."""
    flags = raw[addr + 5]
    pos = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    width = 1 << (flags & 3)
    end = pos + width + int.from_bytes(raw[pos:pos + width], "little")
    pos += width
    head = 6 if flags & 0x04 else 4
    out = []
    while pos + head <= end:
        mtype, size, mflags = struct.unpack_from("<BHB", raw, pos)
        out.append((pos, mtype, mflags))
        pos += head + size
    return out, end


def _patch_message(path, mtype, patch):
    """Apply ``patch(raw, position)`` to the first message of type
    ``mtype`` in any version-2 object header of the file for which it
    returns True, and seal the header's checksum again."""
    raw = bytearray(open(path, "rb").read())
    i = raw.find(b"OHDR")
    while i >= 0:
        msgs, end = _v2_messages(raw, i)
        for pos, t, _ in msgs:
            if t == mtype and patch(raw, pos):
                raw[end:end + 4] = struct.pack("<I", hashlittle(
                    bytes(raw[i:end])))
                with open(path, "wb") as fh:
                    fh.write(bytes(raw))
                return
        i = raw.find(b"OHDR", i + 1)
    raise AssertionError(f"no message of type {mtype}")


def _refused(tmp_path, kind):
    path = str(tmp_path / f"{kind}.h5")
    x = np.arange(40, dtype=np.float32).reshape(4, 10)
    if kind in ("soft link", "external link", "user-defined link"):
        with fx.new_file(path, "latest") as f:
            f["x"] = x
            f["features"] = (h5py.SoftLink("/x") if kind != "external link"
                             else h5py.ExternalLink("other.h5", "/x"))
        if kind == "user-defined link":
            def ud(raw, pos):  # the soft link's type byte, 1 -> 65
                if not raw[pos + 4 + 1] & 0x08:
                    return False  # the hard link to "x"
                assert raw[pos + 4 + 2] == 1
                raw[pos + 4 + 2] = 65
                return True
            _patch_message(path, 0x06, ud)
    elif kind == "soft link in a symbol table":
        with h5py.File(path, "w") as f:
            f["x"] = x
            f["features"] = h5py.SoftLink("/x")
    elif kind == "virtual dataset":
        with fx.new_file(path, "latest") as f:
            f["x"] = x
            layout = h5py.VirtualLayout(shape=x.shape, dtype=x.dtype)
            layout[:] = h5py.VirtualSource(f["x"])
            f.create_virtual_dataset("features", layout)
    elif kind == "external files":
        x.tofile(str(tmp_path / "raw.bin"))
        with fx.new_file(path, "latest") as f:
            f.create_dataset("features", shape=x.shape, dtype=x.dtype,
                             external=[(str(tmp_path / "raw.bin"), 0,
                                        x.nbytes)])
    elif kind == "shared message":
        with fx.new_file(path, "latest") as f:
            fx.put(f, "features", x, "contiguous")

        def shared(raw, pos):  # the datatype message, flagged as shared
            raw[pos + 3] |= 0x02
            return True
        _patch_message(path, 0x03, shared)
    elif kind == "shared-message table":
        with h5py.File(path, "w", libver="latest", fs_strategy="page") as f:
            f["features"] = x
        with open(path, "rb") as fh:
            ext = int.from_bytes(fh.read(28)[20:28], "little")

        def table(raw, pos):  # the file space info, as a SOHM table
            raw[pos] = 0x0F
            return True
        raw = open(path, "rb").read()
        assert raw[ext:ext + 4] == b"OHDR"
        _patch_message(path, 0x17, table)
    elif kind == "huge fractal-heap object":
        with fx.new_file(path, "latest") as f:
            ds = fx.put(f, "features", x, "contiguous")
            for i in range(9):
                ds.attrs[f"a{i}"] = i
            ds.attrs["big"] = np.arange(2000, dtype=np.float64)
        return path, lambda: hdf5.File(path).attrs("features")
    elif kind in ("scale-offset", "nbit", "szip", "blosc"):
        with h5py.File(path, "w") as f:
            f.create_dataset("features", data=x.astype(np.int32),
                             chunks=(2, 10), scaleoffset=0)
        fid = {"scale-offset": 6, "nbit": 5, "szip": 4, "blosc": 32001}[kind]
        raw = bytearray(open(path, "rb").read())
        # the version-1 pipeline message of one filter: id 6, patched
        at = raw.find(b"\x01\x01\x00\x00\x00\x00\x00\x00\x06\x00")
        raw[at + 8:at + 10] = struct.pack("<H", fid)
        with open(path, "wb") as fh:
            fh.write(bytes(raw))
    elif kind == "unfiltered edge chunks":
        with fx.new_file(path, "latest") as f:
            fx.put(f, "features", x, "fixed", "gzip", chunks=(3, 4))

        def edges(raw, pos):  # the layout's flag 0x01, which h5py never sets
            assert raw[pos + 4] == 4 and raw[pos + 5] == 2
            raw[pos + 6] |= 0x01
            return True
        _patch_message(path, 0x08, edges)
    elif kind == "big-endian":
        with fx.new_file(path, "latest") as f:
            f.create_dataset("features", data=x.astype(">f4"))
    return path, lambda: tio.load_features_h5(path)


REFUSED = {"soft link": "soft link", "external link": "external link",
           "user-defined link": "user-defined 65 link",
           "soft link in a symbol table": "soft link",
           "virtual dataset": "virtual dataset",
           "external files": "external files",
           "shared message": "shared message",
           "shared-message table": "shared-message table",
           "huge fractal-heap object": "huge fractal-heap object",
           "scale-offset": "filter 6 .scale-offset",
           "nbit": "filter 5 .nbit", "szip": "filter 4 .szip",
           "blosc": "filter 32001 .blosc", "big-endian": "big-endian",
           "unfiltered edge chunks": "partial edge chunks unfiltered"}


@pytest.mark.parametrize("kind", list(REFUSED))
def test_refused_structures_raise_naming_them(tmp_path, kind):
    _, read = _refused(tmp_path, kind)
    with pytest.raises(NotImplementedError, match=REFUSED[kind]):
        read()


class _Bytes:
    """The part of ``hdf5.File`` the blocks read, over a byte string."""
    path, _so, _sl = "forged.h5", 8, 8

    def __init__(self, raw):
        self.raw = raw

    def _bytes(self, addr, n):
        return self.raw[addr:addr + n]

    def _undefined(self, addr):
        return addr == (1 << 64) - 1


def _heap_header(filter_len):
    """A fractal heap header (table width 4, blocks of 512 to 64 KiB, 32
    bits of heap) with ``filter_len`` bytes of I/O filter information."""
    body = (b"FRHP" + struct.pack("<BHHBI", 0, 7, filter_len, 2, 4096)
            + struct.pack("<QQQQ", 0, (1 << 64) - 1, 0, (1 << 64) - 1)
            + struct.pack("<8Q", *([0] * 8))
            + struct.pack("<HQQHHQH", 4, 512, 65536, 32, 1, 4096, 0))
    if filter_len:
        body += struct.pack("<QI", 0, 0) + b"\0" * filter_len
    return body + struct.pack("<I", hashlittle(body))


def test_filtered_and_tiny_heap_objects_are_refused():
    with pytest.raises(NotImplementedError, match="filtered fractal heap"):
        blocks.FractalHeap(_Bytes(_heap_header(12)), 0)
    heap = blocks.FractalHeap(_Bytes(_heap_header(0)), 0)
    with pytest.raises(NotImplementedError, match="tiny fractal-heap"):
        heap.get(b"\x20abcdef")
    with pytest.raises(NotImplementedError, match="huge fractal-heap"):
        heap.get(b"\x10" + b"\0" * 6)


def test_lookup3_known_values():
    """Bob Jenkins' published hashlittle values ("Four score and seven
    years ago", seeds 0 and 1) and the empty string."""
    text = b"Four score and seven years ago"
    assert hashlittle(text, 0) == 0x17770551
    assert hashlittle(text, 1) == 0xCD628161
    assert hashlittle(b"", 0) == 0xDEADBEEF


# -- superblock variants ------------------------------------------------

def test_superblock_extension_user_block_and_swmr(tmp_path):
    x = _features(np.random.default_rng(3), 9, 16)
    paged = str(tmp_path / "paged.h5")
    with h5py.File(paged, "w", libver="latest", fs_strategy="page") as f:
        f.create_dataset("features", data=x, chunks=(3, 16))
    ub = str(tmp_path / "userblock.h5")
    with h5py.File(ub, "w", libver="latest", userblock_size=512) as f:
        f.create_dataset("features", data=x, chunks=(3, 16),
                         maxshape=(None, 16))
    swmr = str(tmp_path / "swmr.h5")
    with h5py.File(swmr, "w", libver="latest") as f:
        ds = f.create_dataset("features", data=x, chunks=(1, 16),
                              maxshape=(None, 16))
        f.swmr_mode = True
        ds.resize((12, 16))
        ds[9:] = 2.0
        ds.flush()
    for path in (paged, ub, swmr):
        want, _ = jio.load_features_h5(path)
        got, _ = tio.load_features_h5(path)
        _same(got, want)
    # a file a writer holds open (its consistency flags set): HDF5
    # refuses it to a reader that is not SWMR, and so does the port
    raw = bytearray(open(swmr, "rb").read())
    for flags in (0x01, 0x04, 0x05):
        raw[11] = flags
        raw[44:48] = struct.pack("<I", hashlittle(bytes(raw[:44])))
        with open(swmr, "wb") as fh:
            fh.write(bytes(raw))
        assert _outcome(jio.load_features_h5, swmr)[0] == "OSError"
        with pytest.raises(OSError, match="open for write"):
            tio.load_features_h5(swmr)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_family_driver_files_raise_oserror_like_h5py(tmp_path, libver):
    """A member of a family-driver file names its driver in the superblock
    (version 0) or its extension (version 2 and later): h5py opens it only
    with that driver."""
    with h5py.File(str(tmp_path / "fam_%d.h5"), "w", driver="family",
                   memb_size=1 << 20, libver=libver) as f:
        f["features"] = np.ones((3, 4), np.float32)
    path = str(tmp_path / "fam_0.h5")
    assert _outcome(jio.load_features_h5, path)[0] == "OSError"
    with pytest.raises(OSError, match="driver information"):
        tio.load_features_h5(path)


# -- the committed fixtures ---------------------------------------------

with open(os.path.join(FIXTURES, "MANIFEST.json")) as _fh:
    MANIFEST = json.load(_fh)


def _manifest_attrs(entry):
    out = {}
    for k, v in entry.items():
        out[k] = v["value"] if v["dtype"] == "str" else np.asarray(
            v["value"], dtype=np.dtype(v["dtype"]))
    return out


@pytest.mark.parametrize("reader", ["h5py", "port", "port_plain"])
@pytest.mark.parametrize("entry", MANIFEST["files"],
                         ids=[e["file"] for e in MANIFEST["files"]])
def test_committed_fixtures_match_manifest(entry, reader):
    path = os.path.join(FIXTURES, entry["file"])
    assert fx.signatures(path) == entry["signatures"]
    assert fx.superblock(path) == entry["superblock"]
    if reader == "h5py":
        f = h5py.File(path, "r")
        read = lambda name: (f[name][()], dict(f[name].attrs))  # noqa
    else:
        f = hdf5.File(path, plain=reader == "port_plain")
        read = lambda name: (f[name], f.attrs(name))  # noqa
    with f:
        for name, want in entry["datasets"].items():
            arr, attrs = read(name)
            assert list(arr.shape) == want["shape"]
            assert arr.dtype.str == want["dtype"]
            assert hashlib.sha256(arr.tobytes()).hexdigest() == \
                want["sha256"]
            _same_attrs(attrs, _manifest_attrs(want["attrs"]))
            if "lzf" in entry["covers"]:
                assert want["lzf_chunks"] >= 1


@pytest.mark.parametrize("name", ["coords_extensible.h5",
                                  "coords_fixed_paged.h5"])
def test_committed_coords_read_like_the_jax_cli(name):
    path = os.path.join(FIXTURES, name)
    want, got = _jax_coords(path), tfp.read_coords(path)
    _same(got[0], want[0])
    assert got[1:] == want[1:]
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        _same_attrs(g.attrs("coords"), dict(f["coords"].attrs))
