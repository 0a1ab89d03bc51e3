"""The port's last host functions against the JAX package's, on the CPU:
``native.f32_to_bf16`` and ``native.read_files`` (the port's
csrc/bagio.cpp), ``metrics.survival_probs_at_times`` and
``utils.experiment.find_settings``.

The bf16 cast is held bit for bit to its plain version, to ml_dtypes and
to JAX's native library; the reads byte for byte; the survival lookup and
the settings path exactly.  Comparisons with JAX's native library skip,
as tests/test_native.py does, when g++ cannot build it."""
import os
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

from multimodalfusion_tpu import metrics as jmetrics
from multimodalfusion_tpu import native as jnative
from multimodalfusion_tpu.utils import experiment as jexperiment
from multimodalfusion_tpu_torch import metrics as tmetrics
from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.utils import experiment as texperiment


@pytest.fixture(scope="module")
def jax_lib():
    lib = jnative.get_lib()
    if lib is None:
        pytest.skip("g++ unavailable; JAX's native runtime not built")
    return lib


def _f32(bits):
    return np.array(bits, np.uint32).view(np.float32)


# the cast's inputs, by case; bit patterns where the value matters
CAST_CASES = {
    # tests/test_native.py:46
    "jax_values": lambda: np.array(
        [1.0, -2.5, 3.1415927, 65504.0, 1e-8, 0.0], np.float32),
    "normals": lambda: np.random.default_rng(20).normal(
        size=100_000).astype(np.float32),
    "signed_nans": lambda: np.array([np.nan, -np.nan], np.float32),
    # payloads the rounding add would carry into Inf or 0
    "payload_nans": lambda: _f32([0x7F800001, 0xFFFFFFFF, 0xFF800001,
                                  0x7FFFFFFF, 0x7FC00000, 0xFFBFFFFF]),
    "infinities": lambda: np.array([np.inf, -np.inf], np.float32),
    "zeros_and_subnormals": lambda: _f32([0x00000000, 0x80000000,
                                          0x00000001, 0x80000001,
                                          0x00008000, 0x00018000,
                                          0x007FFFFF, 0x807F8000]),
    # exact ties round to the even neighbour; one above or below does not
    "ties": lambda: _f32([0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,
                          0xBF808000, 0xBF818000, 0x3F80C000]),
    # the largest float32 rounds up to Inf, as JAX's library rounds it
    "max_finite": lambda: _f32([0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF]),
}


def _bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def _want_nan_bits(x):
    """sign | 0x7FC0 where x is a NaN, else 0."""
    b = x.view(np.uint32)
    return np.where(np.isnan(x), ((b >> 16) & 0x8000) | 0x7FC0, 0)


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("case", list(CAST_CASES))
def test_f32_to_bf16_matches_plain_and_ml_dtypes(case, kind):
    x = CAST_CASES[case]()
    got = native.f32_to_bf16(x if kind == "numpy" else torch.from_numpy(x))
    assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
    assert tuple(got.shape) == x.shape
    np.testing.assert_array_equal(_bits(got),
                                  _bits(native.f32_to_bf16_plain(x)))
    with np.errstate(invalid="ignore"):
        oracle = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(_bits(got), oracle)
    nan = np.isnan(x)
    np.testing.assert_array_equal(_bits(got)[nan], _want_nan_bits(x)[nan])


@pytest.mark.parametrize("case", list(CAST_CASES))
def test_f32_to_bf16_matches_jax(jax_lib, case):
    x = CAST_CASES[case]()
    want = jnative.f32_to_bf16(x)
    np.testing.assert_array_equal(_bits(native.f32_to_bf16(x)),
                                  want.view(np.uint16))


def test_nan_rule_is_jaxs_not_torchs_cast():
    """A NaN becomes sign | 0x7FC0 whatever its payload.  PyTorch's own
    CPU cast keeps payload bits (-NaN gives 0xFFFF), so the port's
    function cannot be ``.to(torch.bfloat16)``."""
    x = _f32([0xFFC00000, 0xFFFFFFFF, 0x7FFFFFFF, 0xFFC00001, 0x7F800001])
    want = [0xFFC0, 0xFFC0, 0x7FC0, 0xFFC0, 0x7FC0]
    assert _bits(native.f32_to_bf16(x)).tolist() == want
    assert _bits(native.f32_to_bf16_plain(x)).tolist() == want


@pytest.mark.parametrize("shape", [(0,), (3, 5), (2, 3, 7), (1, 1, 1, 4)])
def test_f32_to_bf16_keeps_the_shape(shape):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    got = native.f32_to_bf16(x)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got),
                                  _bits(native.f32_to_bf16_plain(x)))


@pytest.fixture(scope="module")
def threaded_input():
    """3 * 2**20 elements, which the library splits over threads, with
    NaNs, ties and overflow planted."""
    x = np.random.default_rng(7).normal(size=3 << 20).astype(np.float32)
    b = x.view(np.uint32)
    b[::4099] = 0x7F800001
    b[1::4099] = 0xFFFFFFFF
    b[2::5003] = 0x3F808000
    b[3::5003] = 0x7F7FFFFF
    return x


@pytest.mark.parametrize("n_threads", [1, 4, 0])
def test_f32_to_bf16_threaded_matches_plain(threaded_input, n_threads):
    got = native.f32_to_bf16(threaded_input, n_threads=n_threads)
    np.testing.assert_array_equal(
        _bits(got), _bits(native.f32_to_bf16_plain(threaded_input)))


def test_f32_to_bf16_threaded_matches_jax(jax_lib, threaded_input):
    want = jnative.f32_to_bf16(threaded_input, n_threads=4).view(np.uint16)
    for n_threads in (1, 4, 0):
        np.testing.assert_array_equal(
            _bits(native.f32_to_bf16(threaded_input, n_threads=n_threads)),
            want)


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, as a card's tensor would."""

    @property
    def device(self):
        return torch.device("cuda", 0)


BAD_INPUTS = {
    "float64": lambda: np.zeros(8, np.float64),
    "float64_tensor": lambda: torch.zeros(8, dtype=torch.float64),
    "bfloat16_tensor": lambda: torch.zeros(8, dtype=torch.bfloat16),
    "non_contiguous": lambda: np.zeros((4, 8), np.float32)[:, ::2],
    "non_contiguous_tensor": lambda: torch.zeros(4, 8).t(),
    "cuda_tensor": lambda: torch.zeros(8).as_subclass(_OnCuda),
    "meta_tensor": lambda: torch.zeros(8, device="meta"),
    "list": lambda: [1.0, 2.0],
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_f32_to_bf16_raises_on_unusable_input(case):
    """The port raises where JAX returns None."""
    x = BAD_INPUTS[case]()
    with pytest.raises((ValueError, TypeError)):
        native.f32_to_bf16(x)
    with pytest.raises((ValueError, TypeError)):
        native.f32_to_bf16_plain(x)


def test_jax_returns_none_where_the_port_raises(jax_lib):
    for case in ("float64", "non_contiguous"):
        assert jnative.f32_to_bf16(BAD_INPUTS[case]()) is None


@pytest.fixture
def seeded_files(tmp_path):
    rng = np.random.default_rng(11)
    paths, datas = [], []
    for i, n in enumerate([1000, 1, 0, 65536 + 3, 4097, 12]):
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(data.tobytes())
        paths.append(str(p))
        datas.append(data)
    return paths, datas


@pytest.mark.parametrize("n_threads", [0, 1, 3, 64])
def test_read_files_matches_bytes_and_plain(seeded_files, n_threads):
    paths, datas = seeded_files
    sizes = [len(d) for d in datas]
    got = native.read_files(paths, sizes, n_threads=n_threads)
    plain = native.read_files_plain(paths, sizes)
    assert len(got) == len(plain) == len(datas)
    for g, p, d in zip(got, plain, datas):
        assert g.dtype == np.uint8 and g.tobytes() == d.tobytes()
        assert p.tobytes() == d.tobytes()


@pytest.mark.parametrize("n_threads", [0, 1, 64])
def test_read_files_matches_jax(jax_lib, seeded_files, n_threads):
    paths, datas = seeded_files
    sizes = [len(d) for d in datas]
    got = native.read_files(paths, sizes, n_threads=n_threads)
    want = jnative.read_files(paths, sizes, n_threads=n_threads)
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_read_files_reads_a_prefix_and_takes_paths(seeded_files):
    """A size below the file's reads its first bytes; os.PathLike works."""
    paths, datas = seeded_files
    got = native.read_files([pathlib.Path(paths[0])], [10])
    assert got[0].tobytes() == datas[0][:10].tobytes()
    assert native.read_files_plain([pathlib.Path(paths[0])], [10])[
        0].tobytes() == datas[0][:10].tobytes()


def _unreadable(paths, datas, how):
    paths, sizes = list(paths), [len(d) for d in datas]
    if how == "missing":
        paths[3] = paths[3] + ".missing"
    else:  # one byte more than the file holds
        sizes[3] += 1
    return paths, sizes


@pytest.mark.parametrize("how", ["missing", "short"])
def test_read_files_none_when_a_file_is_missing_or_short(seeded_files, how):
    paths, sizes = _unreadable(*seeded_files, how)
    assert native.read_files(paths, sizes) is None
    assert native.read_files(paths, sizes, n_threads=1) is None
    assert native.read_files_plain(paths, sizes) is None


@pytest.mark.parametrize("how", ["missing", "short"])
def test_read_files_none_as_jax(jax_lib, seeded_files, how):
    paths, sizes = _unreadable(*seeded_files, how)
    assert jnative.read_files(paths, sizes) is None
    assert native.read_files(paths, sizes) is None


def test_read_files_empty_list(jax_lib):
    assert native.read_files([], []) == [] == jnative.read_files([], [])
    assert native.read_files_plain([], []) == []


def test_read_files_more_threads_than_files(seeded_files):
    paths, datas = seeded_files
    got = native.read_files(paths[:2], [len(d) for d in datas[:2]],
                            n_threads=128)
    assert [g.tobytes() for g in got] == [d.tobytes() for d in datas[:2]]


def test_read_files_refuses_mismatched_lists(seeded_files):
    paths, _ = seeded_files
    with pytest.raises(ValueError):
        native.read_files(paths, [1])
    with pytest.raises(ValueError):
        native.read_files_plain(paths, [1])


# (per-bin survival [B, K], bin edges, query times)
SURVIVAL_CASES = ["edges", "around_edges", "fewer_columns",
                  "float32_inputs", "random"]


def _survival_case(name):
    rng = np.random.default_rng(SURVIVAL_CASES.index(name))
    if name == "edges":  # the reference's use: times = edges[1:]
        edges = np.array([0.0, 3.5, 10.0, 24.0, 120.0])
        S = np.cumprod(rng.uniform(0.6, 1.0, size=(6, 4)), axis=1)
        return S, edges, edges[1:]
    if name == "around_edges":
        edges = np.array([0.0, 2.0, 5.0, 9.0, 30.0])
        S = np.cumprod(rng.uniform(0.5, 1.0, size=(3, 4)), axis=1)
        t = np.concatenate([[-1.0, 0.0, 1.999], edges, edges + 1e-9,
                            edges - 1e-9, [30.5, 1e6]])
        return S, edges, t
    if name == "fewer_columns":  # more bins than S's columns: clipped
        edges = np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0])
        return rng.uniform(size=(4, 2)), edges, np.linspace(-1, 7, 33)
    if name == "float32_inputs":
        edges = np.array([0, 1.5, 4.25, 8], np.float32)
        return (rng.uniform(size=(5, 3)).astype(np.float32), edges,
                rng.uniform(-1, 10, size=40).astype(np.float32))
    edges = np.sort(rng.uniform(0, 100, size=9))  # "random"
    return rng.uniform(size=(7, 8)), edges, rng.uniform(-5, 110, size=200)


@pytest.mark.parametrize("name", SURVIVAL_CASES)
def test_survival_probs_at_times_equals_jax(name):
    S, edges, times = _survival_case(name)
    got = tmetrics.survival_probs_at_times(S, edges, times)
    want = jmetrics.survival_probs_at_times(S, edges, times)
    assert got.dtype == want.dtype == np.float64
    assert got.shape == want.shape == (S.shape[0], len(times))
    assert got.tobytes() == want.tobytes()
    if name == "edges":
        np.testing.assert_array_equal(got, S)


def test_survival_probs_before_first_edge_is_one():
    S = np.full((2, 3), 0.25)
    got = tmetrics.survival_probs_at_times(S, [0, 1, 2, 3], [0.0, 0.999])
    np.testing.assert_array_equal(got, np.ones((2, 2)))


FILE_SETS = {
    "several": ["experiment_b.txt", "experiment_a.txt", "notes.txt",
                "xexperiment_0.txt", "experiment_c.txt.bak", "s_0.pt"],
    "one": ["experiment_PATH_s1.txt", "summary.csv"],
    "none": ["summary.csv", "experiment.txt", "experiment_a.json"],
    "empty": [],
}


@pytest.mark.parametrize("case", list(FILE_SETS))
def test_find_settings_equals_jax(tmp_path, case):
    for name in FILE_SETS[case]:
        (tmp_path / name).write_text("{}\n")
    got = texperiment.find_settings(str(tmp_path))
    assert got == jexperiment.find_settings(str(tmp_path))
    if case in ("none", "empty"):
        assert got is None
    else:
        assert os.path.basename(got) == min(
            n for n in FILE_SETS[case]
            if n.startswith("experiment_") and n.endswith(".txt"))
