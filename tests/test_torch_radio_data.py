"""Radiology data in the port against the JAX package: ``intersect_slices``
(JAX data/bags.py:55-89), the radiology mode of ``SurvivalDataset``
(presence by CSV cells and files, the per-sequence h5 reads, the slice
intersection and its failure modes) and the loader's ``radio_bags`` /
``radio_mask``, on one cohort read by both packages."""
import os

import numpy as np
import pandas as pd
import pytest

from fixtures import make_cohort_csv, make_feature_store, make_splits

from multimodalfusion_tpu.data import bags as jbags
from multimodalfusion_tpu.data import loaders as jloaders
from multimodalfusion_tpu.data.io import save_hdf5 as jax_save_hdf5
from multimodalfusion_tpu.data.survival_dataset import \
    SurvivalDataset as JaxDataset
from multimodalfusion_tpu_torch.data import bags as tbags
from multimodalfusion_tpu_torch.data import loaders as tloaders
from multimodalfusion_tpu_torch.data.io import save_hdf5 as port_save_hdf5
from multimodalfusion_tpu_torch.data.survival_dataset import \
    SurvivalDataset as PortDataset

MODALITIES = ["T1", "T2", "T1Gd", "FLAIR"]


def _ids_case(kind, rng):
    """Per-modality (features, slice ids) of one intersect_slices case."""
    n = 30
    feats, ids = [], []
    for m in range(3):
        s = np.arange(n)
        if kind in ("shuffled", "both"):
            s = rng.permutation(s)
        if kind in ("missing", "both"):
            s = np.delete(s, rng.choice(n, size=4 + m, replace=False))
        if kind == "disjoint" and m == 2:
            s = s + 100
        if kind == "duplicate" and m == 1:
            s = s.copy()
            s[3] = s[7]
        ids.append(s.astype(np.int64))
        feats.append(rng.standard_normal((len(s), 8)).astype(np.float32))
    return feats, ids


@pytest.mark.parametrize("kind", ["aligned", "shuffled", "missing", "both",
                                  "disjoint", "duplicate"])
def test_intersect_slices_matches_jax(kind):
    feats, ids = _ids_case(kind, np.random.default_rng(len(kind)))
    if kind == "duplicate":
        for fn in (jbags.intersect_slices, tbags.intersect_slices):
            with pytest.raises(ValueError, match="duplicate slice ids"):
                fn(feats, ids)
        return
    want, want_ids = jbags.intersect_slices(feats, ids, return_ids=True)
    got, got_ids = tbags.intersect_slices(feats, ids, return_ids=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert np.array_equal(got_ids, want_ids)
    assert np.array_equal(tbags.intersect_slices(feats, ids), want)
    if kind != "disjoint":
        # id-exact: row i of every block is slice common[i]
        for m, (f, s) in enumerate(zip(feats, ids)):
            pos = {v: i for i, v in enumerate(s.tolist())}
            block = got[:, 8 * m:8 * (m + 1)]
            assert np.array_equal(block, f[[pos[v] for v in got_ids]])


def _write_radio(root, subject, per_mod, write):
    for m, (f, s) in zip(MODALITIES, per_mod):
        write(os.path.join(root, "radio_h5_files", m, f"{subject}.h5"),
              {"features": f, "slice_index": s}, mode="w")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """tests/fixtures.py's cohort of 16 subjects (4 sequences, 6-30 slices
    each, 12 genomic columns, two folds), with, built here: subjects whose
    sequences store their slices shuffled and with some missing (one
    written by the port's writer), one with a blank FLAIR cell, one with
    a missing T2 file, one with a NaN genomic cell, one with duplicate
    slice ids in a sequence and one with a truncated h5."""
    base = tmp_path_factory.mktemp("torch_radio_data")
    root = str(base / "dataset_csv" / "brain")
    csv_path, df, latent = make_cohort_csv(root, n=16, seed=3)
    data = str(base / "features" / "brain")
    make_feature_store(data, df, latent, seed=3, bag_range=(6, 30))
    rng = np.random.default_rng(5)
    for i, writer in ((0, jax_save_hdf5), (1, jax_save_hdf5),
                      (4, port_save_hdf5)):
        n = 25
        per_mod = []
        for m in range(4):
            s = rng.permutation(n + 3)[:n - m].astype(np.int64)
            per_mod.append((rng.standard_normal((len(s), 1024))
                            .astype(np.float32), s))
        _write_radio(data, df.subject_id[i], per_mod, writer)
    df.loc[2, "FLAIR"] = np.nan
    df.loc[6, "G1_mut"] = np.nan
    df.to_csv(csv_path, index=False)
    os.remove(os.path.join(data, "radio_h5_files", "T2",
                           f"{df.subject_id[5]}.h5"))
    s = np.arange(10, dtype=np.int64)
    s[4] = 2
    jax_save_hdf5(os.path.join(data, "radio_h5_files", "T1Gd",
                               f"{df.subject_id[8]}.h5"),
                  {"features": np.ones((10, 1024), np.float32),
                   "slice_index": s}, mode="w")
    bad = os.path.join(data, "radio_h5_files", "T1", f"{df.subject_id[9]}.h5")
    raw = open(bad, "rb").read()
    with open(bad, "wb") as f:
        f.write(raw[:len(raw) // 2])
    make_splits(str(base / "splits"), df, k=2, val_frac=0.5, seed=3)
    return base


def _datasets(cohort, mode, **kw):
    path = str(cohort / "dataset_csv" / "brain" / "survival.csv")
    data = str(cohort / "features" / "brain")
    return (JaxDataset(path, mode=mode, data_dir=data, modalities=MODALITIES,
                       n_bins=4, **kw),
            PortDataset(path, mode=mode, data_dir=data,
                        modalities=MODALITIES, n_bins=4, **kw))


def _splits(cohort, mode):
    jds, tds = _datasets(cohort, mode)
    split = str(cohort / "splits" / "splits_0.csv")
    return jds.load_splits(split), tds.load_splits(split)


MODES = ["radio", "radio_omic", "radio_path_omic"]


@pytest.mark.parametrize("mode", MODES)
def test_radio_samples_and_presence_match_jax(cohort, mode, capsys):
    """Presence flags (probe and loader), usable subjects and every
    sample's bags and genomic row, bit for bit; the warnings JAX prints
    for the duplicate slice ids."""
    jsplits, tsplits = _splits(cohort, mode)
    needed = [m for m in ("radio", "path", "omic") if m in mode]
    absent = set()
    for j, t in zip(jsplits, tsplits):
        assert [j.probe_present(i) for i in range(len(j))] == [
            t.probe_present(i) for i in range(len(t))]
        assert jloaders.usable_indices(j) == tloaders.usable_indices(t)
        for i in range(len(t)):
            js = j.get_sample(i)
            jout = capsys.readouterr().out
            ts = t.get_sample(i)
            assert capsys.readouterr().out == jout
            assert ts.subject_id == js.subject_id
            assert {m: ts.present[m] for m in needed} == {
                m: js.present[m] for m in needed}
            for m in needed:
                a, b = getattr(js, m), getattr(ts, m)
                assert (a is None) == (b is None), (m, ts.subject_id)
                if a is not None:
                    assert b.dtype == a.dtype and b.shape == a.shape
                    assert b.tobytes() == a.tobytes(), (m, ts.subject_id)
            if not ts.present["radio"]:
                absent.add(ts.subject_id)
    # the blank cell, the missing file, the duplicate ids and the
    # truncated file
    assert {"SUBJ002", "SUBJ005", "SUBJ008", "SUBJ009"} <= absent


def test_intersection_reorders_shuffled_sequences(cohort):
    """A subject whose sequences store shuffled, partly missing slices gets
    JAX's id-aligned bag, [common, 4 * 1024]."""
    _, tds = _datasets(cohort, "radio")
    s = tds.get_sample(tds.patients.index("SUBJ004"))
    assert s.radio.shape[1] == 4096 and 0 < s.radio.shape[0] < 25


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("weighted", [False, True])
def test_radio_batch_order_matches_jax(cohort, mode, weighted, capsys):
    """For the same seed the batches hold the same subjects in the same
    order with the same labels, masks, radiology (and pathology) bags and
    genomic rows, bit for bit, and drop the truncated file's subject with
    the same warning."""
    (jtr, jva), (ttr, tva) = _splits(cohort, mode)
    for j, t, kw in ((jtr, ttr, dict(shuffle=True, weighted=weighted,
                                     seed=11)),
                     (jva, tva, dict(shuffle=False))):
        jb = list(jloaders.iter_batches(j, batch_size=4,
                                        reuse_collation_buffers=False, **kw))
        jout = capsys.readouterr().out
        tb = list(tloaders.prefetch(tloaders.iter_batches(
            t, batch_size=4, **kw)))
        tout = capsys.readouterr().out
        assert tout == jout
        assert len(jb) == len(tb) >= 1
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            assert "radio_bags" in b and b["radio_bags"].shape[2] == 4096
            assert list(a["subject_ids"]) == list(b["subject_ids"])
            for k in a:
                if k != "subject_ids":
                    assert a[k].dtype == b[k].dtype, k
                    assert a[k].tobytes() == b[k].tobytes(), k


def test_single_sequence_cohort_and_label_free_reading(cohort):
    """One CT-like sequence (``--modality T1``, on a copy of the CSV
    without the other sequences' columns, which would otherwise be read as
    genomic): 1024-wide bags; a cohort read without labels keeps the same
    presence."""
    path = str(cohort / "dataset_csv" / "brain" / "survival.csv")
    data = str(cohort / "features" / "brain")
    ct = str(cohort / "ct.csv")
    pd.read_csv(path).drop(columns=MODALITIES[1:]).to_csv(ct, index=False)
    jds = JaxDataset(ct, mode="radio", data_dir=data, modalities=["T1"])
    tds = PortDataset(ct, mode="radio", data_dir=data, modalities=["T1"])
    jw, tw = jds.whole_split(), tds.whole_split()
    assert jloaders.usable_indices(jw) == tloaders.usable_indices(tw)
    jb = list(jloaders.iter_batches(jw, batch_size=8,
                                    reuse_collation_buffers=False))
    tb = list(tloaders.iter_batches(tw, batch_size=8))
    for a, b in zip(jb, tb):
        assert b["radio_bags"].shape[2] == 1024
        assert a["radio_bags"].tobytes() == b["radio_bags"].tobytes()
    free = PortDataset(path, mode="radio", data_dir=data,
                       modalities=MODALITIES)
    labelled = PortDataset(path, mode="radio", data_dir=data,
                           modalities=MODALITIES, n_bins=4)
    assert not free.labelled and len(free) == pd.read_csv(path).shape[0]
    assert [free.probe_present(i) for i in range(len(free))] == [
        labelled.probe_present(i) for i in range(len(labelled))]
