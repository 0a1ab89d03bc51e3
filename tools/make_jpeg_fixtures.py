"""Writes the JPEG fixtures of ``multimodalfusion_tpu_torch/testdata/jpeg/``
and their ``MANIFEST.json``: small progressive and four-component
streams, made by PIL (progressive at 4:4:4, 4:2:2, 4:2:0 and gray; CMYK
baseline and progressive) and by ``tools/jpeg_writer.py`` (successive
approximation down from Al = 3; long EOB runs with restart intervals in
every scan type; three scripts that stop early, which libjpeg-turbo
smooths; CMYK without an Adobe marker and YCCK, baseline and
progressive); arithmetic-coded and lossless streams made by
``tools/jpeg_arith.py`` (SOF9 at 4:2:0 and in gray with restarts and
non-default DAC conditioning, SOF10 at 4:4:4, from Al = 3, stopped early
and in YCCK; SOF3 in gray with predictor 7 and a point transform, in RGB
with restarts, and 4:2:0-sampled).  The manifest records how each file
was made and the
SHA-256 of the pixels PIL decodes from it (``np.asarray`` of the image),
with the Pillow and libjpeg-turbo versions.  ``chip_smoke.py`` holds the
port's C++ and plain decoders to those digests on a machine without PIL;
``tests/test_torch_jpeg_progressive.py`` makes each file again from its
recorded parameters and checks the bytes and the digest.

    python tools/make_jpeg_fixtures.py
"""
import hashlib
import importlib.util
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata", "jpeg")
_spec = importlib.util.spec_from_file_location(
    "jpeg_writer", os.path.join(ROOT, "tools", "jpeg_writer.py"))
writer = importlib.util.module_from_spec(_spec)   # the test-stream writer
_spec.loader.exec_module(writer)
_spec = importlib.util.spec_from_file_location(
    "jpeg_arith", os.path.join(ROOT, "tools", "jpeg_arith.py"))
arith = importlib.util.module_from_spec(_spec)  # arithmetic and lossless
_spec.loader.exec_module(arith)

# the scripts of the writer's fixtures, by name: (components, Ss, Se, Ah,
# Al) each
SCRIPTS = {
    # every coefficient down from Al = 3, one bit a scan
    "al3": [[[0, 1, 2], 0, 0, 0, 3], [[0, 1, 2], 0, 0, 3, 2],
            [[0, 1, 2], 0, 0, 2, 1], [[0, 1, 2], 0, 0, 1, 0]]
    + [[[c], 1, 63, ah, ah - 1] if ah else [[c], 1, 63, 0, 3]
       for c in (0, 1, 2) for ah in (0, 3, 2, 1)],
    # libjpeg's default, stopped after its DC scan: DC estimates too
    "smooth_dc": [[[0, 1, 2], 0, 0, 0, 1]],
    # stopped after the first luma AC band and the chroma AC at Al = 1
    "smooth_first4": [[[0, 1, 2], 0, 0, 0, 1], [[0], 1, 5, 0, 2],
                      [[2], 1, 63, 0, 1], [[1], 1, 63, 0, 1]],
    # every AC coefficient sent once at Al = 2, never refined
    "smooth_al2": [[[0, 1, 2], 0, 0, 0, 0], [[0], 1, 63, 0, 2],
                   [[1], 1, 63, 0, 2], [[2], 1, 63, 0, 2]],
}

SPECS = [
    dict(name="pil_prog_444.jpg", writer="pil",
         image=dict(seed=1, h=48, w=64, c=3),
         params=dict(progressive=True, quality=90, subsampling=0)),
    dict(name="pil_prog_422.jpg", writer="pil",
         image=dict(seed=2, h=57, w=70, c=3),
         params=dict(progressive=True, quality=75, subsampling=1)),
    dict(name="pil_prog_420.jpg", writer="pil",
         image=dict(seed=3, h=80, w=96, c=3),
         params=dict(progressive=True, quality=85, subsampling=2)),
    dict(name="pil_prog_gray.jpg", writer="pil",
         image=dict(seed=4, h=65, w=33, c=1),
         params=dict(progressive=True, quality=90)),
    dict(name="sa_al3.jpg", writer="transcode",
         image=dict(seed=5, h=64, w=80, c=3),
         params=dict(source=dict(quality=90, subsampling=2), script="al3")),
    dict(name="eob_runs_restarts.jpg", writer="transcode",
         image=dict(seed=6, h=96, w=96, c=3, flat=True),
         params=dict(source=dict(quality=70, subsampling=2),
                     script="default", restart=3)),
    dict(name="smooth_dc.jpg", writer="transcode",
         image=dict(seed=7, h=64, w=72, c=3),
         params=dict(source=dict(quality=80, subsampling=2),
                     script="smooth_dc")),
    dict(name="smooth_first4.jpg", writer="transcode",
         image=dict(seed=8, h=72, w=64, c=3),
         params=dict(source=dict(quality=80, subsampling=1),
                     script="smooth_first4")),
    dict(name="smooth_al2.jpg", writer="transcode",
         image=dict(seed=9, h=56, w=88, c=3),
         params=dict(source=dict(quality=85, subsampling=0),
                     script="smooth_al2")),
    dict(name="cmyk_adobe.jpg", writer="pil",
         image=dict(seed=10, h=40, w=56, c=4), params=dict(quality=90)),
    dict(name="cmyk_adobe_prog.jpg", writer="pil",
         image=dict(seed=11, h=40, w=56, c=4),
         params=dict(quality=90, progressive=True)),
    dict(name="cmyk_no_marker.jpg", writer="planes",
         image=dict(seed=12, h=40, w=56, c=4),
         params=dict(sampling=[[1, 1]] * 4, quality=85, app=None,
                     progressive=False)),
    dict(name="cmyk_no_marker_prog.jpg", writer="planes",
         image=dict(seed=13, h=40, w=56, c=4),
         params=dict(sampling=[[1, 1]] * 4, quality=85, app=None,
                     progressive=True)),
    dict(name="ycck.jpg", writer="planes",
         image=dict(seed=14, h=48, w=64, c=4),
         params=dict(sampling=[[2, 2], [1, 1], [1, 1], [2, 2]], quality=85,
                     app="adobe", adobe_transform=2, progressive=False)),
    dict(name="ycck_prog.jpg", writer="planes",
         image=dict(seed=15, h=48, w=64, c=4),
         params=dict(sampling=[[2, 2], [1, 1], [1, 1], [2, 2]], quality=85,
                     app="adobe", adobe_transform=2, progressive=True)),
    dict(name="arith_seq_420.jpg", writer="arith",
         image=dict(seed=16, h=56, w=72, c=3),
         params=dict(source=dict(quality=90, subsampling=2), script=None,
                     progressive=False)),
    dict(name="arith_seq_gray_restart_dac.jpg", writer="arith",
         image=dict(seed=17, h=45, w=61, c=1),
         params=dict(source=dict(quality=85), script=None,
                     progressive=False, restart=3,
                     dac=[["dc", 0, 2, 6], ["ac", 0, 12]])),
    dict(name="arith_prog_444.jpg", writer="arith",
         image=dict(seed=18, h=48, w=64, c=3),
         params=dict(source=dict(quality=90, subsampling=0),
                     script="default", progressive=True)),
    dict(name="arith_prog_al3_restart.jpg", writer="arith",
         image=dict(seed=19, h=64, w=80, c=3, flat=True),
         params=dict(source=dict(quality=80, subsampling=2), script="al3",
                     progressive=True, restart=2)),
    dict(name="arith_smooth_first4.jpg", writer="arith",
         image=dict(seed=20, h=72, w=64, c=3),
         params=dict(source=dict(quality=80, subsampling=1),
                     script="smooth_first4", progressive=True)),
    dict(name="arith_ycck_prog.jpg", writer="arith_planes",
         image=dict(seed=21, h=48, w=64, c=4),
         params=dict(sampling=[[2, 2], [1, 1], [1, 1], [2, 2]], quality=85,
                     app="adobe", adobe_transform=2, progressive=True)),
    dict(name="lossless_gray_p7_pt2.jpg", writer="lossless",
         image=dict(seed=22, h=37, w=53, c=1),
         params=dict(psv=7, pt=2)),
    dict(name="lossless_rgb_p4_restart.jpg", writer="lossless",
         image=dict(seed=23, h=40, w=48, c=3),
         params=dict(psv=4, restart_rows=3)),
    dict(name="lossless_420_p6.jpg", writer="lossless",
         image=dict(seed=24, h=33, w=46, c=3),
         params=dict(psv=6, sampling=[[2, 2], [1, 1], [1, 1]])),
]


def fixture_image(spec: dict) -> np.ndarray:
    """The seeded uint8 image of a fixture, [h, w] or [h, w, c]: a
    gradient, a disc and noise (``flat``: a flat field with one soft
    disc, so that most blocks have no AC coefficient)."""
    rng = np.random.default_rng(spec["seed"])
    h, w, c = spec["h"], spec["w"], spec["c"]
    yy, xx = np.mgrid[:h, :w]
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2) * 0.3
    if spec.get("flat"):
        img = np.broadcast_to((0.4 + disc)[..., None] * 255, (h, w, c))
    else:
        base = (xx * 3 + yy * 2) / (w * 3 + h * 2)
        img = (base + disc)[..., None] * 180 + np.linspace(
            0, 60, c) + rng.normal(0, 12, (h, w, c))
    img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def script(name: str):
    """A script of ``SCRIPTS`` as the writer takes it; None for
    libjpeg's default."""
    if name == "default":
        return None
    return [(tuple(c), ss, se, ah, al) for c, ss, se, ah, al in
            SCRIPTS[name]]


def _dac(entries):
    """The manifest's DAC entries, [kind, table, value(s)...] each, as
    ``jpeg_arith.encode`` takes them."""
    return {(e[0], e[1]): tuple(e[2:]) if e[0] == "dc" else e[2]
            for e in entries or ()}


def write(spec: dict) -> bytes:
    img = fixture_image(spec["image"])
    p = dict(spec["params"])
    if spec["writer"] == "lossless":
        planes = [img] if img.ndim == 2 else [img[..., c] for c in range(
            img.shape[2])]
        sampling = [tuple(x) for x in p.pop("sampling", [[1, 1]] * len(
            planes))]
        hm = max(h for h, _ in sampling)
        vm = max(v for _, v in sampling)
        planes = [pl[::vm // v, ::hm // h] for pl, (h, v) in zip(planes,
                                                                sampling)]
        return arith.encode_lossless(planes, sampling, size=(
            img.shape[1], img.shape[0]), **p)
    if spec["writer"] == "arith_planes":
        co = writer.from_planes([img[..., c] for c in range(img.shape[2])],
                                [tuple(s) for s in p.pop("sampling")],
                                p.pop("quality"))
        return arith.encode(co, **p)
    from PIL import Image
    if spec["writer"] == "pil":
        buf = io.BytesIO()
        Image.fromarray(img, "CMYK" if img.ndim == 3 and img.shape[2] == 4
                        else None).save(buf, "JPEG", **p)
        return buf.getvalue()
    if spec["writer"] in ("transcode", "arith"):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **p.pop("source"))
        name = p.pop("script")
        if spec["writer"] == "transcode":
            return writer.transcode(buf.getvalue(), script(name), **p)
        p["dac"] = _dac(p.get("dac"))
        return arith.transcode(buf.getvalue(), script(name) if name
                               else None, **p)
    co = writer.from_planes([img[..., c] for c in range(img.shape[2])],
                            [tuple(s) for s in p.pop("sampling")],
                            p.pop("quality"))
    return writer.encode(co, **p)


def pixel_digest(px: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def main() -> int:
    import PIL
    from PIL import Image, features
    os.makedirs(OUT, exist_ok=True)
    files = []
    for spec in SPECS:
        data = write(spec)
        with open(os.path.join(OUT, spec["name"]), "wb") as f:
            f.write(data)
        px = np.asarray(Image.open(io.BytesIO(data)))
        files.append(dict(spec, shape=list(px.shape), dtype=str(px.dtype),
                          sha256=pixel_digest(px)))
    manifest = dict(pillow=PIL.__version__,
                    libjpeg_turbo=features.version("libjpeg_turbo"),
                    files=files)
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(f"wrote {len(files)} fixtures to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
