"""The port's msgpack reader and writer (multimodalfusion_tpu_torch/utils/
msgpack_io.py) against flax's serialization: a checkpoint the JAX
package's training writer makes reads back as ``msgpack_restore`` reads
it; hypothesis trees of ints, floats, strings and f32 / int32 / bf16
arrays read back the same and are written to the same bytes; what flax
writes and the reader does not take raises, naming it."""
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings, strategies as st
from hypothesis.extra import numpy as hnp

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu_torch.utils import msgpack_io


def same(got, want, where="tree"):
    """got (the port's reader) is want (flax's): the same containers,
    keys, scalar types and array bytes; a bf16 array arrives as a
    torch.bfloat16 tensor of the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), where
        for k in want:
            same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor), where
        assert got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), where
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want), (where, type(got), type(want))
        if isinstance(want, (float, np.floating)) and np.isnan(want):
            assert np.isnan(got), where
        else:
            assert got == want, where


def test_reads_a_jax_training_checkpoint(tmp_path):
    """A 2-sequence tensor-fusion radio AMIL's variables, written by the
    JAX package's checkpoint writer: the tree msgpack_restore gives,
    radio_xfusion included."""
    jcfg = jtrain.TrainConfig(model_type="radio_attention_mil", mode="radio",
                              modalities=("T1", "T2"), radio_fusion="tensor",
                              gate_radio=True)
    jm = jtrain.build_model(jcfg)
    b = {"radio_bags": jnp.ones((2, 5, 2048)), "radio_mask": jnp.ones((2, 5))}
    variables = jm.init(jax.random.PRNGKey(0), **jtrain.model_inputs(jcfg, b))
    path = str(tmp_path / "s_0_minloss_checkpoint.msgpack")
    jtrain.save_checkpoint(path, variables)
    with open(path, "rb") as f:
        data = f.read()
    got = msgpack_io.read(path)
    same(got, serialization.msgpack_restore(data))
    assert "radio_xfusion" in got["params"]
    assert msgpack_io.packb(got) == data


_leaf = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1),
    st.floats(allow_nan=True, allow_infinity=True),
    st.text(max_size=40),
    st.booleans(), st.none(), st.binary(max_size=20),
    hnp.arrays(np.float32, hnp.array_shapes(min_dims=0, max_dims=3,
                                             max_side=5)),
    hnp.arrays(np.int32, hnp.array_shapes(min_dims=1, max_dims=1,
                                           max_side=300)),
    hnp.arrays(np.float32, hnp.array_shapes(min_dims=0, max_dims=2,
                                             max_side=4)).map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))),
    st.floats(width=32).map(np.float32),
    st.integers(-2 ** 31, 2 ** 31 - 1).map(np.int32))
_tree = st.recursive(
    _leaf, lambda kids: st.one_of(
        st.lists(kids, max_size=20),
        st.dictionaries(st.text(max_size=12), kids, max_size=20)),
    max_leaves=40)


@settings(max_examples=50, deadline=None)
@given(_tree)
def test_hypothesis_trees_read_and_write_like_flax(tree):
    """Read: msgpack_restore's tree.  Written: the bytes of to_bytes's
    serializer (in place, keys in the dicts' order)."""
    data = serialization.msgpack_serialize(tree)
    same(msgpack_io.unpackb(data), serialization.msgpack_restore(data))
    mine = msgpack_io.packb(tree)
    assert mine == serialization.msgpack_serialize(tree, in_place=True)


def test_refuses_what_it_does_not_read(monkeypatch):
    """Flax's chunked arrays and native complex numbers, another ext type
    and bytes that are not msgpack."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 8)
    chunked = serialization.msgpack_serialize(
        {"w": np.arange(16, dtype=np.float32)})
    assert np.array_equal(serialization.msgpack_restore(chunked)["w"],
                          np.arange(16, dtype=np.float32))
    with pytest.raises(NotImplementedError, match="chunked"):
        msgpack_io.unpackb(chunked)
    with pytest.raises(NotImplementedError, match="complex"):
        msgpack_io.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(NotImplementedError, match="ext type 7"):
        msgpack_io.unpackb(b"\xd4\x07\x00")
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.unpackb(serialization.msgpack_serialize(
            {"a": np.ones(4, np.float32)})[:-3])
    with pytest.raises(ValueError, match="not a msgpack type"):
        msgpack_io.unpackb(b"\xc1")
    with pytest.raises(ValueError, match="after the value"):
        msgpack_io.unpackb(b"\x01\x02")
