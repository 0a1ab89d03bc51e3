"""The heatmap path's stand-ins in multimodalfusion_tpu_torch.utils.
image_ops, each held bit for bit to the library call it replaces on
seeded fuzz: gaussian_blur_u8 to cv2.GaussianBlur on uint8 (odd kx != ky
from 1 to 65, images narrower than the kernel, 1 and 3 channels, and the
taps of every odd size to 129), fill_contours to cv2.drawContours filled
(concave polygons, holes, contours partly outside the image, negative
offsets, and findContours' own contours), resize_bicubic_pil to PIL's
default Image.resize (down and up factors, odd sizes, the shapes
max_size gives), colormap to matplotlib's colormaps (RdYlBu_r, coolwarm,
jet and the other reversals, at 0, 1 and every bin edge)."""
import matplotlib
import numpy as np
import pytest
import torch
import cv2
from PIL import Image

from multimodalfusion_tpu_torch.utils import contours as cts
from multimodalfusion_tpu_torch.utils import image_ops


def _image(rng, h, w, c, binary=False):
    shape = (h, w) if c == 1 else (h, w, c)
    if binary:
        return np.where(rng.random(shape) < 0.5, 0, 255).astype(np.uint8)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("seed", range(4))
def test_gaussian_blur_u8_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for trial in range(60):
        kx = int(rng.integers(0, 33)) * 2 + 1
        ky = int(rng.integers(0, 33)) * 2 + 1
        # narrow images: the reflected border wraps more than once
        h = int(rng.integers(1, 70 if trial % 4 else 6))
        w = int(rng.integers(1, 70 if trial % 5 else 6))
        img = _image(rng, h, w, (1, 3)[trial % 2], binary=trial % 3 == 0)
        got = image_ops.gaussian_blur_u8(torch.from_numpy(img), (kx, ky))
        np.testing.assert_array_equal(got.numpy(), cv2.GaussianBlur(
            img, (kx, ky), 0), err_msg=f"{(kx, ky)} {img.shape}")


def test_gaussian_taps_u8_are_opencvs():
    """A delta of 255 on one row blurred by (n, 1) gives back each tap
    below 128 exactly: every odd size to 129 (sizes up to 9 have fixed
    taps, checked by the fuzz above)."""
    for n in range(11, 131, 2):
        img = np.zeros((1, 3 * n), np.uint8)
        img[0, 3 * n // 2] = 255
        out = cv2.GaussianBlur(img, (n, 1), 0)[0].astype(int)
        c = 3 * n // 2
        taps = image_ops.gaussian_taps_u8(n)
        assert sum(taps) == 256 and max(taps) < 128
        assert out[c - n // 2:c + n // 2 + 1].tolist() == list(taps), n
    with pytest.raises(ValueError, match="odd"):
        image_ops.gaussian_blur_u8(torch.zeros(4, 4, dtype=torch.uint8),
                                   (4, 3))


def _polygon(rng, n, cx, cy, r):
    """A star-shaped polygon, concave where its radii vary."""
    ang = np.sort(rng.uniform(0, 2 * np.pi, n))
    rad = r * rng.uniform(0.3, 1.0, n)
    return np.stack([cx + rad * np.cos(ang), cy + rad * np.sin(ang)],
                    1).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_fill_contours_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for trial in range(80):
        h, w = int(rng.integers(5, 90)), int(rng.integers(5, 90))
        cs = [_polygon(rng, int(rng.integers(1, 30)),
                       rng.integers(-20, w + 20), rng.integers(-20, h + 20),
                       rng.integers(2, 60))
              for _ in range(int(rng.integers(1, 4)))]
        idx = int(rng.integers(-1, len(cs)))
        off = (int(rng.integers(-15, 15)), int(rng.integers(-15, 15)))
        color = int(rng.integers(1, 256))
        want = np.zeros((h, w), np.uint8)
        cv2.drawContours(want, cs, contourIdx=idx, color=color, offset=off,
                         thickness=-1)
        got = np.zeros((h, w), np.uint8)
        image_ops.fill_contours(got, cs, idx, color, off)
        np.testing.assert_array_equal(got, want, err_msg=f"{trial}")


def test_fill_contours_of_traced_tissue_with_holes():
    """findContours' contours of blobs with holes, drawn as get_seg_mask
    draws them: each outer contour filled, then its holes with 0."""
    rng = np.random.default_rng(3)
    for trial in range(6):
        mask = np.zeros((120, 160), np.uint8)
        for _ in range(3):
            cv2.ellipse(mask, (int(rng.integers(20, 140)),
                               int(rng.integers(20, 100))),
                        (int(rng.integers(8, 40)), int(rng.integers(8, 30))),
                        float(rng.uniform(0, 180)), 0, 360, 1, -1)
        for _ in range(4):
            cv2.circle(mask, (int(rng.integers(0, 160)),
                              int(rng.integers(0, 120))),
                       int(rng.integers(2, 9)), 0, -1)
        contours, hier = cts.find_contours(mask)
        outer = [c for c, hh in zip(contours, hier[0]) if hh[3] == -1]
        holes = [c for c, hh in zip(contours, hier[0]) if hh[3] != -1]
        off = (int(rng.integers(-20, 5)), int(rng.integers(-20, 5)))
        want = np.zeros_like(mask)
        got = np.zeros_like(mask)
        for i in range(len(outer)):
            cv2.drawContours(want, outer, i, 1, offset=off, thickness=-1)
            image_ops.fill_contours(got, outer, i, 1, off)
        if holes:
            cv2.drawContours(want, holes, -1, 0, offset=off, thickness=-1)
            image_ops.fill_contours(got, holes, -1, 0, off)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_resize_bicubic_pil_equals_pil(seed):
    rng = np.random.default_rng(seed)
    for trial in range(50):
        H, W = int(rng.integers(1, 100)), int(rng.integers(1, 100))
        if trial % 3 == 0:      # custom_downsample: an integer factor
            f = int(rng.integers(1, 9))
            h, w = max(H // f, 1), max(W // f, 1)
        elif trial % 3 == 1:    # max_size: the longer side to max_size
            m = int(rng.integers(1, 100))
            f = m / max(H, W)
            h, w = max(int(H * f), 1), max(int(W * f), 1)
        else:                   # any size, up or down
            h, w = int(rng.integers(1, 140)), int(rng.integers(1, 140))
        img = _image(rng, H, W, (1, 3)[trial % 2], binary=trial % 4 == 0)
        want = np.asarray(Image.fromarray(img).resize((w, h)))
        got = image_ops.resize_bicubic_pil(torch.from_numpy(img), (h, w),
                                           rows=int(rng.integers(1, 64)))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{(H, W)} -> {(h, w)}")


@pytest.mark.parametrize("name", ["RdYlBu_r", "RdYlBu", "coolwarm",
                                  "coolwarm_r", "jet", "jet_r"])
def test_colormap_equals_matplotlib(name):
    cmap = matplotlib.colormaps[name]
    np.testing.assert_array_equal(image_ops.colormap_table(name),
                                  cmap(np.arange(256))[:, :3])
    rng = np.random.default_rng(0)
    edges = np.arange(257) / 256
    x = np.concatenate([rng.random(2000), edges,
                        np.nextafter(edges, -1), np.nextafter(edges, 2),
                        [0.0, 1.0, -0.5, 1.5]])
    want = (cmap(x)[..., :3] * 255).astype(np.uint8)
    for dtype in (np.float64, np.float32):
        got = image_ops.colormap(name)(torch.from_numpy(x.astype(dtype)))
        want = (cmap(x.astype(dtype))[..., :3] * 255).astype(np.uint8)
        np.testing.assert_array_equal(got.numpy(), want)


def test_unsupported_colormap_raises_naming_it():
    with pytest.raises(ValueError, match="'viridis' is not supported"):
        image_ops.colormap("viridis")
