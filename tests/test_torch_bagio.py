"""The port's host input layer (multimodalfusion_tpu_torch.native, its
csrc/bagio.cpp, data/bags.py's pad_bags and PinnedPool, get_sample and
the engine's copies) on the CPU, and the kernel wrappers' device
context.

Padding is bit for bit: the native library against ``pad_bags_plain``
and the JAX package's ``pad_bags``.  The pool is driven with host
stand-ins for page-locked arrays and CUDA events."""
import contextlib
import os
import shutil
import threading
import time
import types

import numpy as np
import pytest
import torch

from multimodalfusion_tpu.data import bags as jbags
from multimodalfusion_tpu_torch import native
from multimodalfusion_tpu_torch.data import bags as tbags
from multimodalfusion_tpu_torch.data import survival_dataset as tsd
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.ops import mil_attention as mil

D = 64


def ragged(seed, lens):
    rng = np.random.default_rng(seed)
    return [None if n is None else
            rng.normal(size=(n, D)).astype(np.float32) for n in lens]


PAD_CASES = {
    "ragged": [3, 130, 1, 127],
    "none_and_empty": [5, None, 0, 128],
    "all_missing": [None, None],
    "all_empty": [0, 0, 0],
    "one_bag": [129],
    "bucket_edge": [256, 255, None, 1],
    "batch_of_nine": [7, 300, 2, None, 0, 64, 513, 1, 17],
}


@pytest.mark.parametrize("case", list(PAD_CASES))
def test_native_padding_is_bit_for_bit(case):
    """Native collation == pad_bags_plain == JAX pad_bags, bags, mask,
    shapes and dtypes, with ragged, missing (None) and empty bags."""
    bags = ragged(len(case), PAD_CASES[case])
    got, got_mask = tbags.pad_bags(bags, D)
    plain, plain_mask = tbags.pad_bags_plain(bags, D)
    want, want_mask = jbags.pad_bags(bags, D)
    for g, w in ((got, plain), (got, want), (got_mask, plain_mask),
                 (got_mask, want_mask)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_native_padding_writes_every_element_and_converts():
    """The output buffers need not be zeroed: stale contents are
    overwritten.  A float64 or non-contiguous bag is converted first;
    rows past n_pad are dropped."""
    bags = ragged(1, [10, 3])
    out = np.full((2, 128, D), np.nan, np.float32)
    mask = np.full((2, 128), 7.0, np.float32)
    native.pad_bags_into(bags, out, mask)
    want, want_mask = tbags.pad_bags_plain(bags, D)
    assert out.tobytes() == want.tobytes()
    assert mask.tobytes() == want_mask.tobytes()
    wide = np.random.default_rng(2).normal(size=(D, 20))  # f64, .T strided
    got, _ = tbags.pad_bags([wide.T], D)
    np.testing.assert_array_equal(got[0, :20], wide.T.astype(np.float32))
    short = np.zeros((1, 4, D), np.float32)
    native.pad_bags_into(ragged(3, [9]), short, np.zeros((1, 4), np.float32))
    assert short.tobytes() == ragged(3, [9])[0][:4].tobytes()


@pytest.mark.parametrize("bad", ["width", "dtype", "mask_shape"])
def test_native_padding_validates_before_passing_pointers(bad):
    bags = ragged(4, [5])
    out = np.zeros((1, 128, D), np.float32)
    mask = np.zeros((1, 128), np.float32)
    if bad == "width":
        bags = [np.zeros((5, D + 1), np.float32)]
    elif bad == "dtype":
        out = out.astype(np.float64)
    else:
        mask = np.zeros((1, 64), np.float32)
    with pytest.raises(ValueError):
        native.pad_bags_into(bags, out, mask)


def test_native_build_is_keyed_on_the_source_and_raises_on_failure(
        tmp_path):
    """The library is built into the build directory under a name that
    hashes the source and flags; the same source reuses it, another
    builds anew, and a failed build raises with g++'s stderr."""
    src = tmp_path / "bagio.cpp"
    shutil.copy(native.SRC, src)
    out = tmp_path / "build"
    a = native.build(str(src), str(out))
    assert os.path.dirname(a) == str(out) and os.path.exists(a)
    assert native.build(str(src), str(out)) == a
    src.write_text(src.read_text() + "\n// another version\n")
    b = native.build(str(src), str(out))
    assert b != a and os.path.exists(b)
    src.write_text("this is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build(str(src), str(out))
    assert "error" in str(err.value)  # the compiler's own message
    assert sorted(os.listdir(out)) == sorted(
        os.path.basename(p) for p in (a, b))  # no partial library left


def test_the_port_builds_its_own_library():
    """The port loads its build of csrc/bagio.cpp under build/native,
    never the JAX package's native/libbagio.so."""
    path = native.build()
    assert path.startswith(native.BUILD_DIR)
    assert os.path.realpath(native.SRC).endswith(
        os.path.join("multimodalfusion_tpu_torch", "csrc", "bagio.cpp"))
    assert "libbagio" not in os.path.basename(path)


# ---------------------------------------------------------------------------
# PinnedPool with host stand-ins
# ---------------------------------------------------------------------------

# thread id -> the FakeEvent that thread recorded last
last_recorded = {}


class FakeEvent:
    """A CUDA event stand-in: pending until ``complete`` or
    ``synchronize``."""

    def __init__(self):
        self.done = threading.Event()
        self.recorded_on = "unrecorded"

    def record(self, stream=None):
        self.recorded_on = stream
        last_recorded[threading.get_ident()] = self

    def query(self):
        return self.done.is_set()

    def synchronize(self):
        self.done.set()

    def complete(self):
        self.done.set()


def fake_pool(max_bytes=1 << 30):
    events, allocs = [], []

    def new_event():
        events.append(FakeEvent())
        return events[-1]

    def alloc(shape):
        allocs.append(np.empty(shape, np.float32))
        return allocs[-1]
    pool = tbags.PinnedPool(max_bytes, alloc=alloc, new_event=new_event)
    return pool, events, allocs


def test_pool_never_hands_out_a_buffer_whose_copy_is_pending():
    pool, events, allocs = fake_pool()
    a = pool.take((2, 128, D))
    pool.release([a], stream="s0")
    assert events[-1].recorded_on == "s0"
    b = pool.take((2, 128, D))        # a's copy is still pending
    assert b is not a and len(allocs) == 2
    events[-1].complete()
    assert pool.take((2, 128, D)) is a
    pool.release([b])
    assert pool.take((3, 128, D)) is not b   # another shape, a new buffer


def test_pool_is_bounded_in_bytes():
    """Past max_bytes the pool waits for the oldest released buffer of the
    shape (its event synchronized first), drops completed idle buffers of
    other shapes to make room, and otherwise hands out ordinary memory
    that it does not take back."""
    nbytes = 2 * 128 * D * 4
    pool, events, allocs = fake_pool(max_bytes=nbytes)
    a = pool.take((2, 128, D))
    pool.release([a])
    assert not events[0].query()
    assert pool.take((2, 128, D)) is a       # waited for a's copy
    assert events[0].query() and len(allocs) == 1
    outside = pool.take((1, 128, D))         # no room, nothing idle
    assert len(allocs) == 1 and pool.held_bytes == nbytes
    pool.release([outside])                  # not the pool's: ignored
    pool.release([a])
    events[-1].complete()
    c = pool.take((1, 128, D))               # a dropped to make room
    assert c is allocs[-1] and len(allocs) == 2
    assert pool.held_bytes == nbytes // 2


def test_pool_under_threads_never_shares_a_buffer():
    """Four loader threads take and fill buffers while four consumers
    check and release them, with events completing late; no buffer is
    handed out while a consumer holds it or before its event completed."""
    pool, events, allocs = fake_pool(max_bytes=6 * 128 * D * 4)
    lock = threading.Lock()
    busy, errors = set(), []
    handed = []
    stop = time.monotonic() + 2.0
    old = os.sys.getswitchinterval()
    os.sys.setswitchinterval(1e-5)

    def loader(k):
        rng = np.random.default_rng(k)
        while time.monotonic() < stop:
            arr = pool.take((1, 128, D))
            with lock:
                if id(arr) in busy:
                    errors.append("shared")
                busy.add(id(arr))
            for ev in [e for e in events if getattr(e, "arr", None) is arr]:
                if not ev.query():
                    errors.append("pending")
            arr[:] = rng.integers(1 << 20)
            handed.append(arr)

    def consumer():
        while time.monotonic() < stop or handed:
            try:
                arr = handed.pop()
            except IndexError:
                time.sleep(1e-4)
                continue
            if len(np.unique(arr)) != 1:
                errors.append("torn")
            with lock:
                busy.discard(id(arr))
            pool.release([arr])
            ev = last_recorded.pop(threading.get_ident(), None)
            if ev is None:   # ordinary memory outside the pool
                continue
            ev.arr = arr
            threading.Timer(1e-3, ev.complete).start()

    threads = [threading.Thread(target=loader, args=(k,)) for k in range(4)]
    threads += [threading.Thread(target=consumer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        os.sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert pool.held_bytes <= pool.max_bytes


# ---------------------------------------------------------------------------
# get_sample and the engine's copies
# ---------------------------------------------------------------------------

def test_get_sample_copies_a_bag_at_most_once(tmp_path, monkeypatch):
    """One float32 slide is used as loaded; several slides are
    concatenated into float32 in one copy, other dtypes converted."""
    csv = tmp_path / "c.csv"
    csv.write_text("subject_id,slide_id\nA,a1.svs\nB,b1.svs\nB,b2.svs\n"
                   "C,c1.svs\n")
    rng = np.random.default_rng(0)
    loaded = {"a1": rng.normal(size=(5, D)).astype(np.float32),
              "b1": rng.normal(size=(3, D)).astype(np.float32),
              "b2": rng.normal(size=(4, D)),
              "c1": rng.normal(size=(2, D))}
    monkeypatch.setattr(tsd.io, "load_pt",
                        lambda p: loaded[os.path.basename(p)[:-3]])
    ds = tsd.SurvivalDataset(str(csv), "path", data_dir=str(tmp_path))
    a, b, c = (ds.get_sample(i).path for i in range(3))
    assert a is loaded["a1"]
    want = np.concatenate([loaded["b1"], loaded["b2"]]).astype(np.float32)
    assert b.dtype == np.float32 and b.tobytes() == want.tobytes()
    assert c.dtype == np.float32 and c.tobytes() == loaded["c1"].astype(
        np.float32).tobytes()


class RecordingPool:
    def __init__(self):
        self.released = []

    def release(self, arrays, stream=None):
        self.released.append([a.ctypes.data for a in arrays])


@pytest.mark.parametrize("model_type,mode", [
    ("path_attention_mil", "path"), ("mm_attention_mil", "path_omic"),
    ("max_net", "omic")])
def test_model_inputs_copy_bit_for_bit_and_release_the_bags(model_type,
                                                            mode):
    """The tensors hold the batch's bytes; the bag buffers (and only
    they) go back to the pool after their copies."""
    rng = np.random.default_rng(1)
    bags, mask = tbags.pad_bags(ragged(5, [3, 40, None]), 1024 // 16)
    batch = {"path_bags": bags, "path_mask": mask,
             "genomic": rng.normal(size=(3, 12)).astype(np.float32)}
    cfg = ttrain.TrainConfig(model_type=model_type, mode=mode,
                             device="cpu")
    pool = RecordingPool()
    kw = ttrain.model_inputs(cfg, batch, torch.device("cpu"), pool)
    src = {"bags": "path_bags", "mask": "path_mask",
           "genomic_features": "genomic"}
    for k, t in kw.items():
        assert t.numpy().tobytes() == batch[src.get(k, k)].tobytes()
    if "path" in mode:
        assert pool.released == [[bags.ctypes.data, mask.ctypes.data]]
    else:
        assert pool.released == []


# ---------------------------------------------------------------------------
# the kernel wrappers launch under the bag's device
# ---------------------------------------------------------------------------

def test_kernel_launches_run_under_the_bags_device(monkeypatch):
    """Both wrappers call their library with the bag's device current (a
    stub library records the device that a patched torch.cuda.device made
    current), so a launch reaches the stream passed in on any card."""
    current, seen = [], []

    @contextlib.contextmanager
    def device(dev):
        current.append(torch.device(dev))
        try:
            yield
        finally:
            current.pop()

    class Lib:
        def mil_pool_fwd(self, *args):
            seen.append(("fwd", current[-1] if current else None))
            return 0

        def mil_pool_bwd(self, *args):
            seen.append(("bwd", current[-1] if current else None))
            return 0

    def no_cuda_check(h, mask, params, gated, da, db):
        return (mask.float(), params.ba, params.bb,
                params.wc.reshape(-1), params.cc, da, db)

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=0))
    monkeypatch.setattr(mil, "_fwd_lib", Lib)
    monkeypatch.setattr(mil, "_bwd_lib", Lib)
    monkeypatch.setattr(mil, "_sms", lambda dev: 132)
    monkeypatch.setattr(mil, "_fwd_ctas_per_sm", lambda *a: 2)
    monkeypatch.setattr(mil, "_dw_ctas_per_sm", lambda *a: 2)
    monkeypatch.setattr(mil, "_check_inputs", no_cuda_check)
    for fn in (mil._fused_pool_cuda, mil._fused_pool_bwd_cuda):
        monkeypatch.setattr(fn, "launches", 0)
    B, N, Dm, Da = 2, 128, 64, 64
    h = torch.zeros(B, N, Dm)
    mask = torch.ones(B, N)
    params = mil.AttnParams(torch.zeros(Dm, Da), torch.zeros(Da),
                            torch.zeros(Dm, Da), torch.zeros(Da),
                            torch.zeros(Da, 1), torch.zeros(1))
    out, ml = mil._fused_pool_cuda(h, mask, params, True)
    mil._fused_pool_bwd_cuda(h, mask, params, out, ml, torch.zeros(B, Dm),
                             True)
    assert seen == [("fwd", h.device), ("bwd", h.device)]
    assert mil._fused_pool_cuda.launches == 1
    assert mil._fused_pool_bwd_cuda.launches == 1
