"""The port's GradCAM++ and image helpers (multimodalfusion_tpu_torch.
interpret.gradcam, utils.image_ops, utils.png, cli.gradcam.CamRunner)
against the JAX package and the libraries it calls, on the CPU: jet's
table and colours equal matplotlib's, add_weighted and the PNG files
equal OpenCV's bit for bit, resize and blur at atol 1e-5 and 1e-6, the
CAM overlay of JAX's cam_overlay with at most 0.1% of pixels off by at
most 4 levels, gradcam_pp at rtol 1e-5 / atol 1e-6, and the CAM runner
against JAX's CamRunner and _scan_cams (tests/test_gradcam_cli.py:234):
CAMs at atol 1e-4, scores at atol 1e-5."""
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from matplotlib import cm

import jax
import jax.numpy as jnp

from multimodalfusion_tpu.cli import gradcam as jcli
from multimodalfusion_tpu.engine import train as jtrain
from multimodalfusion_tpu.interpret import gradcam as jgc
from multimodalfusion_tpu.models.resnet import ResNet50Trunc as JaxTrunk
from multimodalfusion_tpu_torch.cli.gradcam import CamRunner
from multimodalfusion_tpu_torch.engine import train as ttrain
from multimodalfusion_tpu_torch.extract.features import Embedder
from multimodalfusion_tpu_torch.interpret import gradcam as tgc
from multimodalfusion_tpu_torch.ops import mil_attention as mil
from multimodalfusion_tpu_torch.utils import image_ops, png
from multimodalfusion_tpu_torch.utils import params as tparams


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_jet_table_is_matplotlibs():
    np.testing.assert_array_equal(image_ops.colormap_table("jet"),
                                  cm.jet(np.arange(256))[:, :3])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jet_matches_matplotlib(dtype):
    """0, 1, every bin edge and its neighbours, values outside [0, 1], NaN
    and the infinities."""
    edges = np.arange(257) / 256
    x = np.concatenate([
        edges, np.nextafter(edges, -1), np.nextafter(edges, 2),
        np.random.default_rng(0).uniform(-0.3, 1.3, 5000),
        [0.0, 1.0, -1e-9, 1 + 1e-7, 2.0, -5.0, np.nan, np.inf, -np.inf]])
    x = x.astype(dtype).reshape(2, -1)
    want = (cm.jet(x)[..., :3] * 255).astype(np.uint8)
    got = image_ops.colormap("jet")(t(x))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("alpha", [0.5, 0.3, 0.7, 0.123])
def test_add_weighted_matches_cv2(alpha):
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)
            for _ in range(2))
    got = image_ops.add_weighted(t(a), 1 - alpha, t(b), alpha)
    np.testing.assert_array_equal(
        got.numpy(), cv2.addWeighted(a, 1 - alpha, b, alpha, 0))


@pytest.mark.parametrize("src,dst", [((14, 14), (240, 240)),
                                     ((4, 4), (64, 64)),
                                     ((6, 9), (155, 201)),
                                     ((100, 90), (31, 47))])
def test_resize_bilinear_matches_cv2(src, dst):
    c = np.random.default_rng(2).uniform(0, 1, (3,) + src).astype(np.float32)
    got = image_ops.resize_bilinear(t(c), dst).numpy()
    want = np.stack([cv2.resize(x, (dst[1], dst[0])) for x in c])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tgc.upsample_cams(t(c), dst).numpy(), got)


@pytest.mark.parametrize("shape", [(64, 64), (37, 91), (5, 3), (1, 7),
                                   (240, 200)])
def test_gaussian_blur_matches_cv2(shape):
    img = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    np.testing.assert_array_equal(image_ops.gaussian_kernel(11).numpy(),
                                  cv2.getGaussianKernel(11, 0,
                                                        cv2.CV_32F).ravel())
    got = image_ops.gaussian_blur(t(img), 11).numpy()
    np.testing.assert_allclose(got, cv2.GaussianBlur(img, (11, 11), 0),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(37, 51), (37, 51, 3), (1, 1),
                                   (1, 1, 3), (96, 200, 3)])
def test_png_round_trip_and_cv2_reads_it(tmp_path, shape):
    x = np.random.default_rng(4).integers(0, 256, shape, dtype=np.uint8)
    x[0, 0] = 0
    path = png.write_png(str(tmp_path / "x.png"), x)
    np.testing.assert_array_equal(png.read_png(path), x)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if x.ndim == 3:
        back = cv2.cvtColor(back, cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, x)


def test_png_refusals(tmp_path):
    x = np.random.default_rng(5).integers(0, 256, (20, 30, 3),
                                          dtype=np.uint8)
    data = bytearray(png.encode_png(x))
    data[40] ^= 1  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="bad PNG chunk"):
        png.decode_png(bytes(data))
    # OpenCV filters its rows, which the reader undoes; a filter type
    # past 4 raises
    cv2.imwrite(str(tmp_path / "cv.png"), x)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "cv.png")),
                                  x[..., ::-1])  # cv2 writes BGR arrays
    raw = np.zeros((20, 1 + 90), np.uint8)
    raw[7, 0] = 5
    bad = png.SIGNATURE + b"".join(png._chunk(k, v) for k, v in (
        (b"IHDR", struct.pack(">IIBBBBB", 30, 20, 8, 2, 0, 0, 0)),
        (b"IDAT", zlib.compress(raw.tobytes())), (b"IEND", b"")))
    for plain in (False, True):
        with pytest.raises(ValueError, match="row 7 has filter type 5"):
            png.decode_png(bad, plain=plain)
    for bad in (x.astype(np.float32), x[..., :2], np.zeros((0, 3),
                                                           np.uint8)):
        with pytest.raises(ValueError):
            png.encode_png(bad)


@pytest.mark.parametrize("masked", [False, True])
def test_cam_overlay_matches_jax(masked):
    """The same CAM and slice through both overlays: a pixel may differ
    where the blurred CAM sits on a jet bin edge (4 levels a bin)."""
    rng = np.random.default_rng(6)
    gray = rng.uniform(-0.1, 1.1, (120, 96)).astype(np.float32)
    cam = tgc.upsample_cams(t(rng.uniform(0, 1, (1, 8, 6)).astype(
        np.float32)), (120, 96))[0].numpy()
    mask = (rng.uniform(size=(120, 96)) > 0.3) if masked else None
    want = jgc.cam_overlay(gray, cam, mask)
    got = tgc.cam_overlay(t(gray), t(cam),
                          None if mask is None else t(mask)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape == (120, 96, 3)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 0).mean() <= 1e-3 and diff.max() <= 4


def test_gradcam_pp_matches_jax():
    rng = np.random.default_rng(7)
    act = np.maximum(rng.normal(size=(3, 5, 4, 64)), 0).astype(np.float32)
    grads = (rng.normal(size=(3, 5, 4, 64)) * 1e-2).astype(np.float32)
    grads[..., 3] = 0.0          # a channel whose gradient is exactly 0
    grads[1, 2, 1, :] = 0.0      # and a pixel of every channel
    want = np.asarray(jgc.gradcam_pp(jnp.asarray(act), jnp.asarray(grads)))
    got = tgc.gradcam_pp(t(act).permute(0, 3, 1, 2),
                         t(grads).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (3, 5, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """JAX's random ResNet50 (PRNGKey(0)) and a 2-sequence concat radio
    AMIL, each with its port holding the same parameters."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 64, 64, 3)).astype(np.float32)
    resnet = JaxTrunk()
    res_vars = resnet.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))
    kw = dict(model_type="radio_attention_mil", mode="radio",
              modalities=("T1", "T2"), n_classes=4, bag_loss="nll_surv",
              radio_fusion="concat", batch_size=1, seed=0)
    amil = jtrain.build_model(jtrain.TrainConfig(**kw))
    amil_vars = dict(amil.init(
        {"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
        bags=jnp.zeros((1, 16, 2048), jnp.float32),
        mask=jnp.ones((1, 16), jnp.float32), deterministic=True))
    tcfg = ttrain.TrainConfig(device="cpu", **kw)
    port_amil = ttrain.build_model(tcfg)
    port_amil.load_state_dict(tparams.state_dict_from_jax(
        tparams.spec_from_config(tcfg), amil_vars["params"]))
    embedder = Embedder(
        state_dict=tparams.resnet_state_dict_from_flax(res_vars),
        dtype="float32", image_size=64, batch_size=3, device="cpu")
    return x, (resnet, res_vars, amil, amil_vars), (embedder,
                                                   port_amil.eval())


@pytest.mark.parametrize("aug", [False, True], ids=["plain", "aug_smooth"])
@pytest.mark.parametrize("slot", [0, 1])
def test_cam_runner_matches_jax(models, aug, slot):
    """5 normalised 64 x 64 images in bag slot 0 or 1: the port's runner
    (no padding, the trunk in chunks of 3) against JAX's bucket-padded
    CamRunner and its per-scan _scan_cams."""
    x, (resnet, res_vars, amil, amil_vars), (embedder, port_amil) = models
    runner = jcli.CamRunner(resnet, res_vars, amil, amil_vars, 2, aug)
    want = {"runner": runner(jnp.asarray(x), slot),
            "scan_cams": jcli._scan_cams(resnet, res_vars, amil, amil_vars,
                                         2, slot, jnp.asarray(x), aug)}
    got_c, got_s = CamRunner(embedder, port_amil, 2, aug)(
        t(x).permute(0, 3, 1, 2), slot)
    assert got_c.dtype == got_s.dtype == np.float32
    for want_c, want_s in want.values():
        assert got_c.shape == want_c.shape == (5, 4, 4)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-4)


@pytest.mark.parametrize("aug,passes", [(False, 1), (True, 6)])
def test_cam_runner_pools_once_per_variant(models, monkeypatch, aug,
                                           passes):
    """One trunk pass and one pooling forward and backward (the kernels'
    plain versions here, the CUDA kernels on the card) per augmentation
    variant; the attention read-out pools through neither."""
    x, _, (embedder, port_amil) = models
    calls = {"trunk": 0, "fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(embedder, "spatial_maps",
                        counted("trunk", embedder.spatial_maps))
    monkeypatch.setattr(mil, "_pool_plain", counted("fwd", mil._pool_plain))
    monkeypatch.setattr(mil, "_pool_bwd_plain",
                        counted("bwd", mil._pool_bwd_plain))
    cams, scores = CamRunner(embedder, port_amil, 2, aug)(
        t(x).permute(0, 3, 1, 2), 1)
    assert calls == {"trunk": passes, "fwd": passes, "bwd": passes}
    assert cams.shape == (5, 4, 4) and scores.shape == (5,)
    assert np.isfinite(cams).all() and 0 <= cams.min() <= cams.max() <= 1
