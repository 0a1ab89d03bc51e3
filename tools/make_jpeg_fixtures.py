"""Writes the JPEG fixtures of ``multimodalfusion_tpu_torch/testdata/jpeg/``
and their ``MANIFEST.json``: small progressive and four-component
streams, made by PIL (progressive at 4:4:4, 4:2:2, 4:2:0 and gray; CMYK
baseline and progressive) and by ``tools/jpeg_writer.py`` (successive
approximation down from Al = 3; long EOB runs with restart intervals in
every scan type; three scripts that stop early, which libjpeg-turbo
smooths; CMYK without an Adobe marker and YCCK, baseline and
progressive).  The manifest records how each file was made and the
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


def write(spec: dict) -> bytes:
    from PIL import Image
    img = fixture_image(spec["image"])
    p = dict(spec["params"])
    if spec["writer"] == "pil":
        buf = io.BytesIO()
        Image.fromarray(img, "CMYK" if img.ndim == 3 and img.shape[2] == 4
                        else None).save(buf, "JPEG", **p)
        return buf.getvalue()
    if spec["writer"] == "transcode":
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **p.pop("source"))
        return writer.transcode(buf.getvalue(), script(p.pop("script")),
                                **p)
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
