"""The port's OpenCV stand-ins of the WSI stages (multimodalfusion_tpu_
torch/utils/image_ops.py, utils/contours.py) against cv2 itself by
seeded fuzz: HSV saturation, median blur, threshold and Otsu, the
morphological close, the uint8 resize, rectangle, the filled ellipse,
findContours (RETR_CCOMP, CHAIN_APPROX_NONE) with its hierarchy,
contourArea, boundingRect and pointPolygonTest equal cv2 exactly;
drawContours of thickness 2 equals cv2 exactly on find_contours'
contours and on polygons inside and leaving the image."""
import cv2
import numpy as np
import pytest
import torch

from multimodalfusion_tpu_torch.utils import contours as cts
from multimodalfusion_tpu_torch.utils import image_ops as iops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _odd_sizes(rng, n, lo=1, hi=70):
    return [(int(rng.integers(lo, hi)), int(rng.integers(lo, hi)))
            for _ in range(n)]


def test_hsv_saturation_equals_cv2():
    rng = np.random.default_rng(0)
    for h, w in _odd_sizes(rng, 6) + [(256, 781)]:
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)[..., 1]
        np.testing.assert_array_equal(iops.hsv_saturation(_t(img)).numpy(),
                                      want)
    # every (max, min) pair of one pixel
    v = np.arange(256, dtype=np.uint8)
    img = np.stack(np.broadcast_arrays(v[:, None], v[None, :],
                                       np.uint8(0)), -1).astype(np.uint8)
    np.testing.assert_array_equal(iops.hsv_saturation(_t(img)).numpy(),
                                  cv2.cvtColor(img, cv2.COLOR_RGB2HSV)[..., 1])


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
def test_median_blur_equals_cv2(k):
    rng = np.random.default_rng(k)
    for h, w in _odd_sizes(rng, 5) + [(3, 2), (1, 1)]:
        g = rng.integers(0, 256, (h, w), dtype=np.uint8)
        np.testing.assert_array_equal(
            iops.median_blur(_t(g), k, rows=7).numpy(), cv2.medianBlur(g, k),
            err_msg=f"{h}x{w}")


def test_threshold_and_otsu_equal_cv2():
    rng = np.random.default_rng(1)
    for trial in range(24):
        h, w = _odd_sizes(rng, 1, 2)[0]
        mean = rng.uniform(20, 230)
        g = np.clip(rng.normal(mean, rng.uniform(5, 60), (h, w)), 0,
                    255).astype(np.uint8)
        if trial % 3 == 0:
            g[: h // 2] = rng.integers(0, 256)
        if trial == 5:
            g[:] = 77  # one level: Otsu finds none
        for maxval in (255, 200):
            t, want = cv2.threshold(g, 0, maxval,
                                    cv2.THRESH_OTSU + cv2.THRESH_BINARY)
            got_t, got = iops.threshold(_t(g), 0, maxval, otsu=True)
            assert got_t == t
            np.testing.assert_array_equal(got.numpy(), want)
        for thresh in (0, 8, 20.7, 254, 255):
            _, want = cv2.threshold(g, thresh, 255, cv2.THRESH_BINARY)
            np.testing.assert_array_equal(
                iops.threshold(_t(g), thresh, 255)[1].numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
def test_morph_close_equals_cv2(k):
    rng = np.random.default_rng(10 + k)
    for h, w in _odd_sizes(rng, 6):
        b = (rng.uniform(size=(h, w)) < rng.uniform(0.1, 0.9)).astype(
            np.uint8) * 255
        want = cv2.morphologyEx(b, cv2.MORPH_CLOSE, np.ones((k, k), np.uint8))
        np.testing.assert_array_equal(iops.morph_close(_t(b), k).numpy(),
                                      want, err_msg=f"{h}x{w}")


def test_even_close_shifts_the_square():
    """cv2's anchor at (k/2, k/2) without reflecting the kernel: the even
    close of a 6 x 6 square at rows/cols 3..8 lands at 4..9."""
    sq = np.zeros((12, 12), np.uint8)
    sq[3:9, 3:9] = 255
    got = iops.morph_close(_t(sq), 4).numpy()
    np.testing.assert_array_equal(
        got, cv2.morphologyEx(sq, cv2.MORPH_CLOSE, np.ones((4, 4), np.uint8)))
    assert np.flatnonzero(got.any(1)).tolist() == list(range(4, 10))


def test_resize_u8_equals_cv2():
    rng = np.random.default_rng(2)
    shapes = [(256, 256, 224, 224), (256, 256, 16, 16), (768, 1024, 384, 512),
              (100, 90, 37, 53), (7, 5, 11, 13), (1, 5, 3, 2), (33, 17, 64, 9),
              (1536, 2048, 768, 1024)]
    shapes += [(h, w, hh, ww) for (h, w), (hh, ww) in
               zip(_odd_sizes(rng, 8), _odd_sizes(rng, 8))]
    for H, W, h, w in shapes:
        for rgb in (True, False):
            img = rng.integers(0, 256, (H, W, 3) if rgb else (H, W),
                               dtype=np.uint8)
            want = cv2.resize(img, (w, h))
            got = iops.resize_u8(_t(img), (h, w), rows=5).numpy()
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{(H, W, h, w, rgb)}")
    batch = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    got = iops.resize_u8(_t(batch), (224, 224)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], cv2.resize(batch[i],
                                                         (224, 224)))


def test_rectangle_equals_cv2():
    rng = np.random.default_rng(3)
    for _ in range(40):
        a = rng.integers(0, 256, (23, 31, 3), dtype=np.uint8)
        b = a.copy()
        p1 = (int(rng.integers(-5, 36)), int(rng.integers(-5, 28)))
        p2 = (int(rng.integers(-5, 36)), int(rng.integers(-5, 28)))
        cv2.rectangle(a, p1, p2, (0, 0, 0), 1)
        iops.rectangle(b, p1, p2, (0, 0, 0))
        np.testing.assert_array_equal(b, a, err_msg=f"{p1} {p2}")


def test_filled_ellipse_equals_cv2():
    rng = np.random.default_rng(4)
    for trial in range(80):
        h, w = int(rng.integers(10, 300)), int(rng.integers(10, 300))
        a = np.full((h, w, 3), 245, np.uint8)
        b = a.copy()
        center = (int(rng.integers(-20, w + 20)), int(rng.integers(-20,
                                                                  h + 20)))
        axes = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        angle = (float(rng.uniform(0, 180)) if trial % 4 else
                 float(rng.integers(-400, 400)) + 0.5 * (trial % 8 == 0))
        color = (int(rng.integers(150, 220)), int(rng.integers(60, 120)),
                 int(rng.integers(140, 200)))
        cv2.ellipse(a, center, axes, angle, 0, 360, color, -1)
        iops.ellipse(b, center, axes, angle, color)
        np.testing.assert_array_equal(b, a, err_msg=f"{center} {axes} "
                                                    f"{angle}")


def _masks(rng, n):
    """Masks with nested components, holes, speckle and foreground on the
    image's edge."""
    for trial in range(n):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        kind = trial % 4
        if kind == 0:
            m = (rng.uniform(size=(h, w)) < rng.uniform(0.1, 0.9)).astype(
                np.uint8) * 255
        else:
            m = np.zeros((h, w), np.uint8)

            def disc(radii, value):
                center = (int(rng.integers(0, w)), int(rng.integers(0, h)))
                cv2.circle(m, center, int(rng.integers(*radii)), value, -1)
            for _ in range(int(rng.integers(1, 6))):
                disc((1, 25), 255)
            for _ in range(int(rng.integers(0, 6))):  # holes
                disc((1, 8), 0)
            for _ in range(int(rng.integers(0, 3))):  # islands in holes
                disc((0, 3), 255)
            if kind == 2:
                m[rng.uniform(size=m.shape) < 0.05] ^= 255
            if kind == 3:
                m[0, :] = 255
        yield m


def test_find_contours_equals_cv2():
    rng = np.random.default_rng(5)
    n_with_holes = 0
    for m in _masks(rng, 240):
        want, want_h = cv2.findContours(m.copy(), cv2.RETR_CCOMP,
                                        cv2.CHAIN_APPROX_NONE)
        got, got_h = cts.find_contours(m)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        if want_h is None:
            assert got_h is None
        else:
            np.testing.assert_array_equal(got_h, want_h)
            n_with_holes += int((want_h[0, :, 3] >= 0).any())
    assert n_with_holes > 20
    assert cts.find_contours(np.zeros((5, 4), np.uint8)) == ([], None)


def test_contour_area_and_bounding_rect_equal_cv2():
    rng = np.random.default_rng(6)
    for m in _masks(rng, 60):
        for c in cv2.findContours(m, cv2.RETR_CCOMP,
                                  cv2.CHAIN_APPROX_NONE)[0]:
            assert cts.contour_area(c) == cv2.contourArea(c)
            assert cts.bounding_rect(c) == cv2.boundingRect(c)
    for n in (1, 2, 3, 7):
        v = rng.integers(-50, 50, (n, 1, 2)).astype(np.int32)
        assert cts.contour_area(v) == cv2.contourArea(v)
        assert cts.bounding_rect(v) == cv2.boundingRect(v)


def test_point_polygon_test_equals_cv2():
    rng = np.random.default_rng(7)
    for trial in range(300):
        n = int(rng.integers(1, 10))
        v = rng.integers(0, 30, (n, 1, 2)).astype(np.int32)
        if trial % 3 == 0 and n > 1:
            v[1, 0, 1] = v[0, 0, 1]  # a horizontal edge
        for _ in range(20):
            p = (float(rng.integers(-2, 32) + rng.choice([0, 0.5, 0.25])),
                 float(rng.integers(-2, 32) + rng.choice([0, 0.5])))
            assert cts.point_polygon_test(v, p) == cv2.pointPolygonTest(
                v, p, False), (v.reshape(-1, 2).tolist(), p)


def test_draw_contours_equals_cv2():
    rng = np.random.default_rng(8)
    for m in _masks(rng, 60):
        cs = cv2.findContours(m, cv2.RETR_CCOMP, cv2.CHAIN_APPROX_NONE)[0]
        a = rng.integers(0, 256, m.shape + (3,), dtype=np.uint8)
        b = a.copy()
        cv2.drawContours(a, cs, -1, (0, 255, 0), 2)
        iops.draw_contours(b, cs, (0, 255, 0))
        np.testing.assert_array_equal(b, a)
    # polygons of long segments, inside the image and leaving it
    for inside in (True, False):
        for _ in range(120):
            lo, hi = (0, 40) if inside else (-15, 60)
            pts = rng.integers(lo, hi, (int(rng.integers(1, 6)), 1, 2)
                               ).astype(np.int32)
            a = np.zeros((40, 50, 3), np.uint8)
            b = a.copy()
            cv2.drawContours(a, [pts], -1, (255, 0, 0), 2)
            iops.draw_contours(b, [pts], (255, 0, 0))
            np.testing.assert_array_equal(b, a, err_msg=str(pts.tolist()))
