"""multimodalfusion_tpu_torch.interpret.heatmaps against the JAX package's
interpret/heatmaps.py on the CPU, on the same seeded slides, contours and
scores: every helper equal exactly; draw_heatmap uint8 for uint8 over the
option sets of tests/test_interpret.py:145-340 and the sweep of
tools/parity_heatmap.py (percentiles or raw, blur, binarize with a fixed
or dynamic threshold, blank canvas, no segmentation, custom_downsample,
no blending, small blend blocks, max_size, adjust, an ROI, overlapping
patches, each colormap); compute_fine_scores with the JAX trunk's random
init carried across (resnet_state_dict_from_flax): coordinates equal,
features and scores at the ResNet tolerance."""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_resnet import ATOL, RTOL

from multimodalfusion_tpu.data import wsi as jw
from multimodalfusion_tpu.extract import features as jfeat
from multimodalfusion_tpu.interpret import heatmaps as jh
from multimodalfusion_tpu_torch.data import wsi as tw
from multimodalfusion_tpu_torch.extract.features import Embedder
from multimodalfusion_tpu_torch.interpret import heatmaps as th
from multimodalfusion_tpu_torch.utils.params import \
    resnet_state_dict_from_flax


@pytest.fixture(scope="module")
def slide():
    """A 1024 x 768 slide with a carved hole (3 levels), its tissue and
    holes, a 128-px grid over the tissue, and seeded scores with ties."""
    s = jw.synthetic_slide(1024, 768, n_blobs=2, seed=7)
    img = s.levels[0].copy()
    img[300:380, 420:520] = 245
    levels = [img, s.levels[1], s.levels[2]]
    levels[1] = img[::2, ::2].copy()
    levels[2] = img[::4, ::4].copy()
    jslide, tslide = jw.ArraySlide(levels), tw.ArraySlide(levels)
    tissue, holes = jw.segment_tissue(jslide, a_t=0.05, a_h=0.01)
    assert tissue
    coords, _ = jw.process_contours(jslide, tissue, holes, patch_size=128,
                                    step_size=128)
    rng = np.random.default_rng(1)
    scores = np.round(rng.uniform(size=len(coords)), 2)  # ties
    return jslide, tslide, tissue, holes, np.asarray(coords), scores


def test_percentiles_and_screening_equal_jax(slide):
    *_, coords, scores = slide
    np.testing.assert_array_equal(th.to_percentiles(scores),
                                  jh.to_percentiles(scores))
    ref = np.concatenate([scores[:5], [0.5, 0.5]])
    for qs in (scores, np.array([]), np.array([-1.0, 2.0, 0.5])):
        np.testing.assert_array_equal(th.score_to_percentile(qs, ref),
                                      jh.score_to_percentile(qs, ref))
    np.testing.assert_array_equal(th.score_to_percentile(scores, []),
                                  jh.score_to_percentile(scores, []))
    for tl, br in (((128, 128), (640, 512)), ((0, 0), (10, 10))):
        for g, w in zip(th.screen_coords(scores, coords, tl, br),
                        jh.screen_coords(scores, coords, tl, br)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("offset", [(0, 0), (128, 64), (-40, 300)])
@pytest.mark.parametrize("use_holes", [True, False])
def test_seg_mask_equals_jax(slide, offset, use_holes):
    _, _, tissue, holes, _, _ = slide
    for size, scale in (((256, 192), (0.25, 0.25)), ((512, 384),
                                                     (0.5, 0.5))):
        np.testing.assert_array_equal(
            th.get_seg_mask(size, scale, tissue, holes, use_holes, offset),
            jh.get_seg_mask(size, scale, tissue, holes, use_holes, offset))


def test_block_blend_equals_jax(slide):
    jslide, tslide, *_ = slide
    rng = np.random.default_rng(2)
    for blank, block in ((False, 40), (True, 100), (False, 1024)):
        img = rng.integers(0, 256, (192, 256, 3), dtype=np.uint8)
        want = jh.block_blend(jslide, img.copy(), 2, (0, 0), (1024, 768),
                              0.3, blank_canvas=blank, block_size=block)
        got = th.block_blend(tslide, torch.from_numpy(img.copy()), 2,
                             (0, 0), (1024, 768), 0.3, blank_canvas=blank,
                             block_size=block)
        np.testing.assert_array_equal(got.numpy(), want)


# (name, options) of tools/parity_heatmap.py's sweep and tests/
# test_interpret.py's draws
BASE = dict(vis_level=1, alpha=0.4, blur=False, segment=True,
            use_holes=True, binarize=False, cmap="RdYlBu_r",
            use_percentiles=True)
VARIANTS = {
    "base": {},
    "raw_scores": {"use_percentiles": False},
    "blurred": {"blur": True},
    "binarized": {"binarize": True, "threshold": 0.35},
    "binarized_dynamic": {"binarize": True, "threshold": -1.0,
                          "use_percentiles": False},
    "blank_canvas": {"blank_canvas": True},
    "no_segment": {"segment": False, "use_holes": False},
    "no_holes": {"use_holes": False},
    "downsample2": {"custom_downsample": 2},
    "no_blend": {"alpha": 1.0},
    "small_blocks": {"block_size": 40},
    "max_size": {"max_size": 100},
    "adjust": {"adjust": 0.1, "use_percentiles": False},
    "roi": {"top_left": (128, 128), "bot_right": (768, 640)},
    "level2_coolwarm_blur": {"vis_level": 2, "cmap": "coolwarm",
                             "blur": True, "overlap": 0.5},
    "jet_r_blank_binarized": {"cmap": "jet_r", "blank_canvas": True,
                              "binarize": True, "threshold": 0.5,
                              "alpha": 1.0},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_draw_heatmap_equals_jax(slide, variant):
    jslide, tslide, tissue, holes, coords, scores = slide
    opts = dict(BASE, **VARIANTS[variant])
    seg = dict(tissue=tissue, holes=holes) if opts["segment"] else {}
    want = jh.draw_heatmap(jslide, scores, coords, patch_size=128,
                           **opts, **seg)
    wall = {}
    got = th.draw_heatmap(tslide, scores, coords, patch_size=128, **opts,
                          **seg, device="cpu", timings=wall)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert {"overlay", "colormap", "resize"} <= set(wall)


def test_overlapping_patches_sum_in_patch_order(slide):
    """The fine pass's overlapping grid (stride a quarter of the patch):
    each pixel's scores summed in patch order, as JAX's loop sums them."""
    jslide, tslide, tissue, holes, _, _ = slide
    coords, _ = jw.process_contours(jslide, tissue, holes, patch_size=128,
                                    step_size=32,
                                    contour_fn="four_pt_hard")
    coords = np.asarray(coords)
    scores = np.random.default_rng(3).normal(size=len(coords)) * 1e3
    for kw in ({"use_percentiles": False, "alpha": 1.0},
               {"blur": True, "overlap": 0.75, "segment": True,
                "tissue": tissue, "holes": holes}):
        want = jh.draw_heatmap(jslide, scores, coords, patch_size=128,
                               vis_level=0, **kw)
        got = th.draw_heatmap(tslide, scores, coords, patch_size=128,
                              vis_level=0, device="cpu", **kw)
        np.testing.assert_array_equal(got, want)


def test_sampling_and_mosaics_equal_jax(slide):
    jslide, _, _, _, coords, scores = slide
    for mode, kw in (("topk", {}), ("reverse_topk", {}),
                     ("range_sample", {"seed": 4,
                                       "score_range": (0.2, 0.8)}),
                     ("range_sample", {"seed": 1})):
        for k in (1, 5, 1000):
            for g, w in zip(th.sample_rois(scores, coords, k, mode, **kw),
                            jh.sample_rois(scores, coords, k, mode, **kw)):
                np.testing.assert_array_equal(g, w)
    for g, w in zip(th.sample_rois(np.array([]), coords[:0], 3),
                    jh.sample_rois(np.array([]), coords[:0], 3)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(NotImplementedError):
        th.sample_rois(scores, coords, 3, "bogus")
    for n in (0, 1000, 100000):
        assert th.dynamic_k(n) == jh.dynamic_k(n)
        assert th.dynamic_k(n, floor=4) == jh.dynamic_k(n, floor=4)
    patches = np.stack([jslide.read_region(tuple(c), 0, (128, 128))
                        for c in coords[:7]])
    for n_cols, down in ((5, 2), (3, 1), (2, 3)):
        np.testing.assert_array_equal(
            th.patch_mosaic(patches, n_cols=n_cols, downscale=down),
            jh.patch_mosaic(patches, n_cols=n_cols, downscale=down))
    np.testing.assert_array_equal(th.patch_mosaic(patches[:0]),
                                  jh.patch_mosaic(patches[:0]))
    for ov in (0.0, 0.2, 0.25, 0.5, 0.75, 0.95, 0.99):
        for shift in (True, False):
            assert th.fine_pass_center_shift(ov, shift) == \
                jh.fine_pass_center_shift(ov, shift)


def test_compute_fine_scores_equals_jax(slide):
    jslide, tslide, tissue, holes, _, _ = slide
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jemb = jfeat.Embedder(batch_size=8, image_size=64,
                              dtype=jnp.float32, allow_random=True)
    temb = Embedder(state_dict=resnet_state_dict_from_flax(jemb.variables),
                    batch_size=8, image_size=64, dtype="float32",
                    device="cpu")
    feats = {}

    def scorer(who):
        def fn(f):
            feats[who] = np.asarray(f)
            return np.asarray(f).mean(axis=1)
        return fn
    want_s, want_c = jh.compute_fine_scores(
        jslide, tissue, holes, jemb, scorer("jax"), patch_size=128,
        overlap=0.5, chunk=16)
    wall = {}
    got_s, got_c = th.compute_fine_scores(
        tslide, tissue, holes, temb, scorer("port"), patch_size=128,
        overlap=0.5, chunk=16, timings=wall)
    assert len(want_c) > 16
    np.testing.assert_array_equal(np.asarray(got_c), np.asarray(want_c))
    np.testing.assert_allclose(feats["port"], feats["jax"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_s, want_s, rtol=RTOL, atol=ATOL)
    assert {"fine_grid", "fine_read", "fine_embed"} <= set(wall)
