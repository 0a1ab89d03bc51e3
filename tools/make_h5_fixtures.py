"""Writes the HDF5 fixtures of ``multimodalfusion_tpu_torch/testdata/h5/``
and their ``MANIFEST.json``: files h5py writes outside its default format,
which the port's reader (``data/hdf5.py``) must read as h5py reads them.

- ``cohort/radio_h5_files/{T1,T2,T1Gd,FLAIR}/{subject}.h5``: a two-subject
  glioma cohort in the layout the radiology loader reads (``cohort.csv``
  beside it), each file ``features`` [S, 1024] float32 (post-ReLU: about
  half zeros) with S of 12-16, and ``slice_index`` int64, whose ids
  overlap only in part across the sequences; each of the 8 files in
  another layout (``COHORT_LAYOUTS``): the default format with
  ``track_order`` (version-2 object headers under superblock 0),
  ``libver="v108"`` with lzf over a version-1 B-tree, and under
  ``libver="latest"`` a single gzip chunk, a fixed array with shuffle and
  lzf, an extensible array as the JAX package's ``save_hdf5`` lays it out
  (chunks of one row, the first axis unlimited), a version-2 B-tree (two
  unlimited axes) with lzf and fletcher32, an implicit index (early
  allocation, no filter), and ``track_order`` with 12 root members and 10
  attributes on ``features`` (dense links and dense attributes);
- ``coords_extensible.h5`` and ``coords_fixed_paged.h5``: WSI patch
  coordinates as the JAX patcher writes them (``coords`` [n, 2] int64 and
  its attributes) under ``libver="latest"``: the JAX writer's layout over
  4,500 rows (an extensible array with super blocks), and a fixed array
  of 1,050 chunks (paged).

Every file is written from a fixed seed with no stored times, so the same
h5py and HDF5 write the same bytes.  The script checks that each file
holds the structures it is named for (signature counts, the superblock
version, and for lzf that at least one chunk went through the filter:
h5py stores a chunk that does not shrink raw, its lzf bit set in the
filter mask), then records in the manifest h5py's and HDF5's versions,
and for each file its signature counts and, for each dataset, its shape,
dtype, the SHA-256 of its bytes as h5py reads them and its attributes.
``tests/test_torch_hdf5_latest.py`` holds h5py and the port's reader (its
C++ and plain lzf decoders) to the manifest; ``chip_smoke.py``'s ``[h5]``
phase holds the port to it on a machine without h5py and serves the
cohort.  Tests load this file by path for ``new_file`` and ``put``.

    python tools/make_h5_fixtures.py
"""
import hashlib
import json
import os
import sys

import h5py
import numpy as np
from h5py import h5d, h5f, h5p, h5s, h5t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata", "h5")
SEED = 27
SUBJECTS = ("TCGA-H5-A001", "TCGA-H5-A002")
SEQS = ("T1", "T2", "T1Gd", "FLAIR")
# (subject, sequence) -> (libver, track_order, layout, filters, what)
COHORT_LAYOUTS = {
    (0, "T1"): ("earliest", True, "contiguous", None,
                "track_order at the default libver, contiguous"),
    (0, "T2"): ("v108", False, "fixed", "lzf",
                "libver v108, chunked, lzf (layout v3, version-1 B-tree)"),
    (0, "T1Gd"): ("latest", False, "single", "gzip",
                  "latest, one chunk, gzip and shuffle"),
    (0, "FLAIR"): ("latest", False, "fixed", "shuffle_lzf",
                   "latest, fixed array, shuffle and lzf"),
    (1, "T1"): ("latest", False, "extensible", None,
                "latest, extensible array as save_hdf5 lays it out"),
    (1, "T2"): ("latest", False, "btree", "lzf_fletcher32",
                "latest, two unlimited axes, lzf and fletcher32 "
                "(B-tree type 11)"),
    (1, "T1Gd"): ("latest", False, "implicit", None,
                  "latest, implicit index (early allocation, no filter)"),
    (1, "FLAIR"): ("latest", True, "contiguous", None,
                   "latest with track_order, 12 root members, 10 "
                   "attributes on features (dense links and attributes)"),
}
SIGS = (b"OHDR", b"OCHK", b"FRHP", b"FHIB", b"FHDB", b"BTHD", b"BTIN",
        b"BTLF", b"FAHD", b"FADB", b"EAHD", b"EAIB", b"EASB", b"EADB",
        b"TREE", b"SNOD", b"HEAP", b"GCOL")
LIBVER = {"earliest": (h5f.LIBVER_EARLIEST, h5f.LIBVER_LATEST),
          "v108": (h5f.LIBVER_V18, h5f.LIBVER_LATEST),
          "v110": (h5f.LIBVER_V110, h5f.LIBVER_LATEST),
          "latest": (h5f.LIBVER_LATEST, h5f.LIBVER_LATEST)}
FILTERS = {None: {}, "gzip": {"compression": "gzip", "shuffle": True},
           "lzf": {"compression": "lzf"},
           "shuffle_lzf": {"compression": "lzf", "shuffle": True},
           "lzf_fletcher32": {"compression": "lzf", "fletcher32": True}}
TRACKED = h5p.CRT_ORDER_TRACKED | h5p.CRT_ORDER_INDEXED


def new_file(path: str, libver: str = "earliest",
             track_order: bool = False) -> h5py.File:
    """A new file at ``path`` as ``h5py.File(path, "w", libver=libver,
    track_order=track_order)`` makes it, without stored times."""
    fapl = h5p.create(h5p.FILE_ACCESS)
    fapl.set_libver_bounds(*LIBVER[libver])
    fcpl = h5p.create(h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    if track_order:
        fcpl.set_link_creation_order(TRACKED)
        fcpl.set_attr_creation_order(TRACKED)
    return h5py.File(h5f.create(path.encode(), h5f.ACC_TRUNC, fapl=fapl,
                                fcpl=fcpl))


def put(f: h5py.File, name: str, data: np.ndarray, layout: str,
        filters=None, chunks=None, track_order: bool = False):
    """Dataset ``name`` of ``f`` holding ``data``, in ``layout``:
    "contiguous", "compact", "single" (one chunk), "implicit" (early
    allocation, no filter), "fixed" (a fixed maximum shape), "extensible"
    (the first axis unlimited, chunks of one row: the JAX writer's
    layout) or "btree" (every axis unlimited), with ``filters`` (a key of
    ``FILTERS``) and ``chunks`` (default: up to 4 rows)."""
    data = np.ascontiguousarray(data)
    if chunks is None and layout not in ("contiguous", "compact"):
        chunks = {"single": data.shape,
                  "extensible": (1,) + data.shape[1:]}.get(
                      layout, (min(4, len(data)),) + data.shape[1:])
    if layout in ("compact", "implicit"):
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_obj_track_times(False)
        if layout == "compact":
            dcpl.set_layout(h5d.COMPACT)
        else:
            dcpl.set_chunk(chunks)
            dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
        if track_order:
            dcpl.set_attr_creation_order(TRACKED)
        ds = h5d.create(f.id, name.encode(), h5t.py_create(data.dtype),
                        h5s.create_simple(data.shape), dcpl=dcpl)
        ds.write(h5s.ALL, h5s.ALL, data)
        return f[name]
    maxshape = {"extensible": (None,) + data.shape[1:],
                "btree": (None,) * data.ndim}.get(layout)
    return f.create_dataset(name, data=data, chunks=chunks,
                            maxshape=maxshape, track_times=False,
                            track_order=track_order, **FILTERS[filters])


def signatures(path: str) -> dict:
    with open(path, "rb") as fh:
        raw = fh.read()
    return {s.decode(): raw.count(s) for s in SIGS if raw.count(s)}


def superblock(path: str) -> int:
    with open(path, "rb") as fh:
        return fh.read(9)[8]


def lzf_chunks(ds) -> int:
    """How many of ``ds``'s chunks went through the lzf filter (its bit
    clear in the chunk's filter mask)."""
    pipeline = ds.id.get_create_plist()
    ids = [pipeline.get_filter(i)[0]
           for i in range(pipeline.get_nfilters())]
    if 32000 not in ids:
        return 0
    bit = 1 << ids.index(32000)
    return sum(not ds.id.get_chunk_info(i).filter_mask & bit
               for i in range(ds.id.get_num_chunks()))


def _features(rng, n):
    return np.maximum(rng.standard_normal((n, 1024), dtype=np.float32), 0)


def _slice_ids(rng, core, pool, n):
    """``n`` slice ids: the subject's ``core`` and others of ``pool``,
    shuffled."""
    extra = rng.choice(np.setdiff1d(pool, core), n - len(core),
                       replace=False)
    return rng.permutation(np.concatenate([core, extra])).astype(np.int64)


def _coords(rng, n, step=256):
    """``n`` patch corners of a tissue grid, row by row, as the patcher
    stores them."""
    cols = 75
    idx = np.sort(rng.choice(cols * (n // cols + 8), n, replace=False))
    return np.stack([idx % cols, idx // cols], 1).astype(np.int64) * step \
        + np.array([512, 1024], np.int64)


def _coord_attrs(name, dims):
    return {"patch_size": 256, "patch_level": 0,
            "downsample": np.array([1.0, 1.0]),
            "downsampled_level_dim": np.array(dims, np.int64),
            "level_dim": np.array(dims, np.int64), "name": name}


def write_cohort(root: str, rng) -> dict:
    """The 8 files of the cohort under ``root``; {relative path: (what,
    the structures it must hold)}."""
    out = {}
    for s, sid in enumerate(SUBJECTS):
        core = rng.choice(24, 8, replace=False)
        for seq in SEQS:
            libver, track, layout, filters, what = COHORT_LAYOUTS[(s, seq)]
            rel = os.path.join("cohort", "radio_h5_files", seq, f"{sid}.h5")
            path = os.path.join(root, rel)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            n = int(rng.integers(12, 17))
            feats = _features(rng, n)
            ids = _slice_ids(rng, core, np.arange(24), n)
            with new_file(path, libver, track) as f:
                ds = put(f, "features", feats, layout, filters,
                         track_order=track)
                put(f, "slice_index", ids, layout, filters,
                    track_order=track)
                if track and libver == "latest":
                    for i in range(10):
                        put(f, f"member_{i:02d}",
                            rng.integers(0, 9, 3 + i, dtype=np.int64),
                            "contiguous")
                    for i in range(9):
                        ds.attrs[f"stat_{i}"] = (
                            np.float64(rng.uniform()) if i % 2 else i)
                    ds.attrs["sequence"] = seq
            kinds = [libver, layout] + (["dense"] if track and libver ==
                                        "latest" else [])
            out[rel] = what, kinds + (["lzf"] if filters and "lzf" in
                                      filters else [])
    return out


def _check(rel, path, sigs, lzf, kinds):
    """The file holds the structures each of ``kinds`` names, and where it
    is filtered by lzf, at least one chunk of each dataset went through
    the filter."""
    none = not {"FAHD", "EAHD", "BTHD", "TREE"} & set(sigs)
    need = {
        "earliest": superblock(path) == 0 and sigs.get("OHDR", 0) >= 1,
        "v108": superblock(path) == 2 and sigs.get("TREE", 0) >= 2,
        "latest": superblock(path) == 3,
        "contiguous": True, "single": none, "implicit": none,
        "fixed": sigs.get("FAHD") == 2 or sigs.get("TREE", 0) >= 2,
        "extensible": sigs.get("EAHD") == 2,
        "btree": sigs.get("BTHD") == 1 and sigs.get("EAHD") == 1,
        "dense": (sigs.get("FRHP") == 2 and sigs.get("BTHD") == 4
                  and sigs.get("FHDB") == 2),
        "super_blocks": sigs.get("EASB", 0) >= 2,
        "paged": sigs.get("FAHD") == 1,
        "lzf": bool(lzf) and all(lzf.values()),
    }
    for k in kinds:
        if not need[k]:
            raise AssertionError(f"{rel}: not a {k} file: signatures "
                                 f"{sigs}, superblock {superblock(path)}, "
                                 f"lzf chunks {lzf}")


def _json_value(v):
    if isinstance(v, (str, bytes)):
        return {"dtype": "str", "value": v if isinstance(v, str)
                else v.decode()}
    a = np.asarray(v)
    return {"dtype": a.dtype.str, "value": a.tolist()}


def main() -> int:
    rng = np.random.default_rng(SEED)
    os.makedirs(OUT, exist_ok=True)
    files = write_cohort(OUT, rng)
    with open(os.path.join(OUT, "cohort.csv"), "w") as fh:
        fh.write("subject_id,slide_id," + ",".join(SEQS)
                 + ",survival_months,censorship,train\n")
        for i, sid in enumerate(SUBJECTS):
            fh.write(f"{sid},{sid}-01.svs," + ",".join(
                f"{sid}_{m}.nii.gz" for m in SEQS)
                + f",{[14.5, 31.0][i]},0.0,1\n")
    for rel, n, chunks, layout, what, kind in (
            ("coords_extensible.h5", 4500, None, "extensible",
             "latest, the JAX writer's layout over 4,500 rows: an "
             "extensible array with super blocks", "super_blocks"),
            ("coords_fixed_paged.h5", 2100, (2, 2), "fixed",
             "latest, a fixed array of 1,050 chunks (paged)", "paged")):
        name = rel[:-3]
        with new_file(os.path.join(OUT, rel), "latest") as f:
            ds = put(f, "coords", _coords(rng, n), layout, chunks=chunks)
            ds.attrs.update(_coord_attrs(name, [19200 + n, 14336]))
        files[rel] = what, ["latest", kind]
    entries = []
    total = 0
    for rel, (what, kinds) in sorted(files.items()):
        path = os.path.join(OUT, rel)
        total += os.path.getsize(path)
        datasets, lzf = {}, {}
        with h5py.File(path, "r") as f:
            for name in ("features", "slice_index", "coords"):
                if name not in f:
                    continue
                ds = f[name]
                arr = ds[()]
                lzf[name] = lzf_chunks(ds)
                datasets[name] = {
                    "shape": list(arr.shape), "dtype": arr.dtype.str,
                    "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                    "lzf_chunks": lzf[name],
                    "attrs": {k: _json_value(v)
                              for k, v in sorted(ds.attrs.items())}}
        sigs = signatures(path)
        _check(rel, path, sigs, lzf, kinds)
        entries.append({"file": rel, "covers": what,
                        "superblock": superblock(path),
                        "signatures": sigs, "bytes": os.path.getsize(path),
                        "datasets": datasets})
    if total > 1 << 20:
        raise AssertionError(f"the fixtures take {total} bytes, over 1 MB")
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as fh:
        json.dump({"h5py": h5py.version.version,
                   "hdf5": h5py.version.hdf5_version, "seed": SEED,
                   "subjects": list(SUBJECTS), "sequences": list(SEQS),
                   "files": entries}, fh, indent=1)
        fh.write("\n")
    print(f"wrote {len(entries)} files, {total} bytes, to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
