"""Writes the JPEG 2000 fixtures of ``multimodalfusion_tpu_torch/testdata/
j2k/`` and their ``MANIFEST.json``: small codestreams with the features
PIL's openjpeg writes (9/7 in layers, RPCL precincts, tiles with an image
offset, RGB with the ICT, 16-bit RLCP) and some the port's encoder writes
for PIL to decode (signed 12-bit, every code-block style bit, packed
headers in tile-parts).  The manifest records how each file was made and
the SHA-256 of the pixels PIL decodes from it (``np.asarray`` of the
image), with the Pillow and openjpeg versions.  ``chip_smoke.py`` holds
the port's C++ and plain decoders to those digests on a machine without
PIL; ``tests/test_torch_j2k.py`` makes each file again from its recorded
parameters and checks the digest.

    python tools/make_j2k_fixtures.py
"""
import hashlib
import importlib.util
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "multimodalfusion_tpu_torch", "testdata", "j2k")
_spec = importlib.util.spec_from_file_location(
    "j2k_writer", os.path.join(ROOT, "tools", "j2k_writer.py"))
writer = importlib.util.module_from_spec(_spec)   # the test-stream writer
_spec.loader.exec_module(writer)

SPECS = [
    dict(name="irr97_2layers.jp2", writer="pil",
         image=dict(seed=1, h=48, w=64, c=1, bits=8),
         params=dict(irreversible=True, quality_mode="rates",
                     quality_layers=[20, 5])),
    dict(name="rpcl_precincts.j2k", writer="pil",
         image=dict(seed=2, h=64, w=56, c=3, bits=8),
         params=dict(irreversible=False, progression="RPCL",
                     precinct_size=[16, 16], num_resolutions=4,
                     codeblock_size=[8, 8], quality_mode="rates",
                     quality_layers=[12, 4], no_jp2=True)),
    dict(name="tiles_offset.jp2", writer="pil",
         image=dict(seed=3, h=45, w=51, c=1, bits=8),
         params=dict(irreversible=False, tile_size=[24, 20],
                     offset=[5, 3], tile_offset=[2, 1], num_resolutions=3)),
    dict(name="rgb_ict.jp2", writer="pil",
         image=dict(seed=4, h=40, w=48, c=3, bits=8),
         params=dict(irreversible=True, mct=1)),
    dict(name="i16_rlcp.jp2", writer="pil",
         image=dict(seed=5, h=33, w=40, c=1, bits=16),
         params=dict(irreversible=False, progression="RLCP",
                     quality_mode="rates", quality_layers=[8, 2, 1])),
    dict(name="signed12.j2k", writer="port",
         image=dict(seed=6, h=40, w=36, c=1, bits=12, signed=True),
         params=dict(prec=12, signed=True, jp2=False)),
    dict(name="styles_all.j2k", writer="port",
         image=dict(seed=7, h=36, w=44, c=1, bits=8),
         params=dict(style=63, layers=3, progression="PCRL",
                     precincts=[[16, 16]], sop=True, eph=True, jp2=False)),
    dict(name="ppt_tileparts.jp2", writer="port",
         image=dict(seed=8, h=30, w=34, c=3, bits=8),
         params=dict(tile_size=[20, 16], layers=2, ppt=True, tile_parts=2,
                     pocs=[[0, 0, 1, 6, 3, "RPCL"], [0, 0, 2, 6, 3, "LRCP"]])),
]


def fixture_image(spec: dict) -> np.ndarray:
    """The seeded image of a fixture: a gradient, a disc and noise, in
    ``bits`` (signed: two's complement values), [h, w] or [h, w, c]."""
    rng = np.random.default_rng(spec["seed"])
    h, w, c, bits = spec["h"], spec["w"], spec["c"], spec["bits"]
    yy, xx = np.mgrid[:h, :w]
    base = (xx * 3 + yy * 2) / (w * 3 + h * 2)
    disc = ((yy - h / 2) ** 2 + (xx - w / 3) ** 2 < (h / 4) ** 2) * 0.3
    top = (1 << bits) - 1
    img = (base + disc)[..., None] * top * 0.7 + rng.normal(
        0, top * 0.05, (h, w, c))
    img = np.clip(np.rint(img), 0, top).astype(np.int64)
    if spec.get("signed"):
        img -= 1 << (bits - 1)
    img = img[..., 0] if c == 1 else img
    return img.astype(np.uint8 if bits <= 8 and not spec.get("signed")
                      else (np.uint16 if not spec.get("signed")
                            else np.int16))


def pil_write(img: np.ndarray, params: dict) -> bytes:
    from PIL import Image
    kw = {k: (tuple(v) if isinstance(v, list) and k != "quality_layers"
              else v) for k, v in params.items()}
    im = Image.fromarray(img)
    buf = io.BytesIO()
    im.save(buf, format="JPEG2000", **kw)
    return buf.getvalue()


def port_write(img: np.ndarray, params: dict) -> bytes:
    return writer.encode_stream(img, plain=True, **params)


def write(spec: dict) -> bytes:
    img = fixture_image(spec["image"])
    return (pil_write if spec["writer"] == "pil" else port_write)(
        img, spec["params"])


def pixel_digest(px: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(px).tobytes()).hexdigest()


def main() -> int:
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
    import PIL
    manifest = dict(pillow=PIL.__version__,
                    openjpeg=features.version("jpg_2000"), files=files)
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    print(f"wrote {len(files)} fixtures to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
