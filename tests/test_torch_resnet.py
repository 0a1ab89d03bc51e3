"""The port's truncated ResNet50 and embedder (multimodalfusion_tpu_torch.
models.resnet, extract.features) against the JAX package's on the CPU:
one torchvision-layout state_dict made from a numpy seed (BatchNorm
running statistics randomised as tests/test_resnet.py does) is given to
both, and JAX's own random init is carried across through
resnet_state_dict_from_flax.  Features and layer3 maps agree at rtol 2e-3
/ atol 2e-4 (tests/test_resnet.py:91); the preprocessing is bit for bit
JAX's."""
import math
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multimodalfusion_tpu.data.radiology import slices_to_rgb
from multimodalfusion_tpu.extract import features as jfeat
from multimodalfusion_tpu.models import resnet as jres
from multimodalfusion_tpu_torch.extract.features import Embedder, _fit_spatial
from multimodalfusion_tpu_torch.models import resnet as tres
from multimodalfusion_tpu_torch.utils.params import \
    resnet_state_dict_from_flax

RTOL, ATOL = 2e-3, 2e-4


def seeded_state_dict(seed=0, extras=True):
    """A torchvision ResNet50 state_dict from a numpy seed: normal convs
    at the scale of torch's default init (std 1 / sqrt(3 fan_in)),
    BatchNorm weights near 1, biases and running means near 0, running
    variances in [0.5, 1.5]; with ``extras`` also layer4, fc and
    num_batches_tracked keys, which the trunk ignores."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in tres.ResNet50Trunc().state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            if extras:
                sd[k] = torch.tensor(7)
            continue
        if len(shape) == 4:
            a = rng.normal(size=shape) / math.sqrt(
                3.0 * shape[1] * shape[2] * shape[3])
        elif k.endswith("running_mean"):
            a = rng.normal(0, 0.05, shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, shape)
        elif k.endswith("weight"):
            a = rng.uniform(0.8, 1.2, shape)
        else:
            a = rng.normal(0, 0.05, shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    if extras:
        sd["layer4.0.conv1.weight"] = torch.zeros(512, 1024, 1, 1)
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), \
            torch.zeros(1000)
    return sd


@pytest.fixture(scope="module")
def state_dict():
    return seeded_state_dict(0)


@pytest.fixture(scope="module")
def port_model(state_dict):
    return tres.load_trunk_state_dict(tres.ResNet50Trunc(),
                                      state_dict).eval()


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("spatial", [False, True], ids=["pooled", "layer3"])
def test_forward_matches_jax(state_dict, port_model, s2d, spatial):
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jres.ResNet50Trunc(s2d_stem=s2d).apply(
        jres.port_torch_state_dict(state_dict), jnp.asarray(x),
        return_spatial=spatial))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x).permute(0, 3, 1, 2),
                         return_spatial=spatial)
    if spatial:
        got = got.permute(0, 2, 3, 1)
        assert want.shape == (2, 4, 4, 1024)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
def test_jax_random_init_carried_across(s2d):
    """JAX's Embedder(allow_random=True) init (PRNGKey(0)) through
    resnet_state_dict_from_flax: the same features on uint8 images that
    both embedders centre-crop."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jemb = jfeat.Embedder(batch_size=4, image_size=64,
                              dtype=jnp.float32, allow_random=True,
                              s2d_stem=s2d)
    temb = Embedder(state_dict=resnet_state_dict_from_flax(jemb.variables),
                    batch_size=4, image_size=64, dtype="float32",
                    device="cpu")
    imgs = np.random.default_rng(4).integers(0, 256, (5, 70, 67, 3),
                                             dtype=np.uint8)
    want = jemb.embed_images(imgs)
    got = temb.embed_images(imgs)
    assert got.shape == (5, 1024)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_random_init_is_seeded_and_warns():
    with pytest.warns(UserWarning, match="RANDOMLY initialized"):
        a = Embedder(allow_random=True, device="cpu")
    with pytest.warns(UserWarning):
        b = Embedder(allow_random=True, device="cpu")
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k


@pytest.mark.parametrize("case", ["ignored", "missing", "unknown", "shape"])
def test_trunk_load_is_strict_on_trunk_keys(state_dict, case, tmp_path):
    sd = dict(state_dict)
    if case == "missing":
        del sd["layer2.0.downsample.1.running_var"]
    elif case == "unknown":
        sd["layer1.1.downsample.0.weight"] = torch.zeros(256, 256, 1, 1)
    elif case == "shape":
        sd["layer3.5.conv2.weight"] = torch.zeros(256, 256, 1, 1)
    model = tres.ResNet50Trunc()
    if case == "ignored":
        torch.save(sd, tmp_path / "w.pt")
        tres.load_trunk_state_dict(
            model, tres.load_torch_checkpoint(str(tmp_path / "w.pt")))
        got = model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in state_dict.items()
                   if k in got and not k.endswith("num_batches_tracked"))
        return
    error = RuntimeError if case == "shape" else KeyError
    with pytest.raises(error, match={
            "missing": "layer2.0.downsample.1.running_var",
            "unknown": "layer1.1.downsample.0.weight",
            "shape": "layer3.5.conv2.weight"}[case]):
        tres.load_trunk_state_dict(model, sd)


@pytest.mark.parametrize("dtype,h,w", [("uint8", 250, 231),
                                       ("float32", 224, 224),
                                       ("float32", 231, 300),
                                       ("uint8", 200, 240)])
def test_preprocess_images_bit_for_bit(dtype, h, w):
    """uint8 / 255, the centre crop at JAX's floor offsets (odd margins),
    a side shorter than the crop kept whole, the ImageNet normalisation."""
    rng = np.random.default_rng(h + w)
    x = (rng.integers(0, 256, (3, h, w, 3)).astype(np.uint8)
         if dtype == "uint8" else rng.uniform(size=(3, h, w, 3)).astype(
             np.float32))
    want = np.asarray(jres.preprocess_images(x, 224))
    got = tres.preprocess_images(torch.from_numpy(x), 224)
    assert got.dtype == torch.float32
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("h,w", [(100, 300), (224, 224), (231, 250),
                                 (17, 500), (225, 223)])
def test_fit_spatial_and_slice_inputs_bit_for_bit(h, w):
    """_fit_spatial, and the embedder's slice inputs (grayscale fitted on
    the host, channel repeated and normalised on the device) against
    JAX's host path: slices_to_rgb, _fit_spatial, preprocess_images."""
    slices = np.random.default_rng(h * w).uniform(size=(3, h, w)).astype(
        np.float32)
    rgb = slices_to_rgb(slices)
    assert np.array_equal(_fit_spatial(rgb, 224),
                          jfeat._fit_spatial(rgb, 224))
    want = np.asarray(jres.preprocess_images(
        jfeat._fit_spatial(rgb, 224), 224))
    got = Embedder(state_dict=seeded_state_dict(1, extras=False),
                   device="cpu").slice_inputs(slices)
    assert got.shape == (3, 3, 224, 224)
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("batch_size", [4, 11])
def test_embedder_chunks_equal_one_forward(state_dict, port_model,
                                           batch_size):
    """11 images in chunks of 4 (a short last one) or in one chunk: the
    features of one forward of all 11."""
    imgs = np.random.default_rng(5).normal(size=(11, 64, 64, 3)).astype(
        np.float32)
    emb = Embedder(state_dict=state_dict, batch_size=batch_size,
                   image_size=64, dtype="float32", device="cpu")
    with torch.no_grad():
        want = port_model(tres.preprocess_images(torch.from_numpy(imgs),
                                                 64)).numpy()
    got = emb.embed_images(imgs)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert emb.embed_images(imgs[:0]).shape == (0, 1024)
    assert emb.embed_slices(np.zeros((0, 8, 8))).shape == (0, 1024)


def test_bfloat16_autocast_near_float32(state_dict):
    """The default dtype runs the convolutions in bf16 (autocast; on the
    CPU here): relative (Frobenius) error to f32 within 2e-2."""
    slices = np.random.default_rng(6).uniform(size=(4, 60, 50))
    f32, bf16 = (Embedder(state_dict=state_dict, image_size=64,
                          dtype=d, device="cpu").embed_slices(slices)
                 for d in ("float32", "bfloat16"))
    rel = np.linalg.norm(bf16 - f32) / np.linalg.norm(f32)
    assert 0 < rel <= 2e-2


@pytest.mark.parametrize("kwargs,error,match", [
    ({}, ValueError, "ResNet50 weights"),
    ({"allow_random": True, "batch_size": 0}, ValueError, "batch_size"),
    ({"allow_random": True, "dtype": "float16"}, KeyError, "float16"),
    ({"allow_random": True, "device": "cuda"}, RuntimeError, "CUDA"),
])
def test_embedder_refusals(kwargs, error, match, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs.setdefault("device", "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(error, match=match):
            Embedder(**kwargs)


def test_conv_flops_at_224():
    """The trunk's convolutions at 224 x 224: 6.556 GFLOP per image (the
    bound chip_smoke.py divides by the card's peak)."""
    flops = tres.conv_flops(tres.ResNet50Trunc())
    assert abs(flops / 6.556e9 - 1) < 5e-4, flops
