"""A JPEG 2000 writer for test streams: the port's lossless encoder
(``multimodalfusion_tpu_torch.utils.j2k``) with every codestream feature
its decoder reads and PIL cannot write, so that the tests and
``tools/make_j2k_fixtures.py`` can hold the decoder to PIL on them:
tiles with image and tile offsets, levels, code-block sizes and styles,
layers, precincts, the five progression orders and POC, SOP/EPH, packed
packet headers (PPM, PPT), tile-parts, a max-shift ROI, 1-4 components
with or without the RCT, bare codestreams.  With its defaults it writes
the bytes of ``j2k.encode``.  Loaded by file path
(``importlib.util.spec_from_file_location``), as the tests load it.
"""
import os
import struct
import sys
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from multimodalfusion_tpu_torch.utils import j2k  # noqa: E402


def _n_segments(payload: bytes) -> int:
    return max(1, j2k._ceildiv(len(payload), 65532))


def _split_marker(marker: int, payload: bytes, first: int = 0) -> bytes:
    """PPM/PPT: the payload in segments of at most 65534 bytes, each led
    by its index Z, counted from ``first`` (openjpeg numbers a tile's PPT
    segments across its tile-parts)."""
    out = b""
    for z in range(_n_segments(payload)):
        if first + z > 255:
            raise ValueError("more than 256 PPM/PPT marker segments")
        out += j2k._segment(marker, bytes([first + z])
                            + payload[z * 65532:(z + 1) * 65532])
    return out


def encode_stream(img: np.ndarray, prec: Optional[int] = None,
                  signed: bool = False, levels: int = 5,
                  cblk: Tuple[int, int] = (64, 64),
                  progression: str = "LRCP", layers: int = 1,
                  precincts: Optional[Sequence[Tuple[int, int]]] = None,
                  style: int = 0, mct: Optional[bool] = None,
                  tile_size: Optional[Tuple[int, int]] = None,
                  tile_offset: Tuple[int, int] = (0, 0),
                  offset: Tuple[int, int] = (0, 0),
                  pocs: Sequence[Tuple[int, int, int, int, int, str]] = (),
                  sop: bool = False, eph: bool = False, ppm: bool = False,
                  ppt: bool = False, tile_parts: int = 1,
                  roi: Optional[Dict[int, int]] = None, jp2: bool = True,
                  plain: bool = False, n_threads: int = 0) -> bytes:
    """A lossless (5/3) JPEG 2000 file of ``img`` ([H, W] or [H, W, C],
    C <= 4; see ``j2k.encode`` for ``prec``, ``signed``, ``plain`` and
    ``n_threads``).  ``mct`` (default: three or more components) applies
    the RCT to the first three.  ``precincts``: (width, height) per
    resolution from the highest down, the last repeated.  ``pocs``:
    (first resolution, first component, end layer, end resolution, end
    component, progression).  ``roi``: component -> True to shift its
    resolution-0 coefficients above the rest (RGN, max-shift).
    ``jp2=False``: the bare codestream."""
    vals, prec = j2k.encoder_samples(img, prec, signed)
    h, w, nc = vals.shape
    if nc > 4:
        raise ValueError(f"encode_stream takes C <= 4; got {vals.shape}")
    mct = (nc >= 3 if mct is None else bool(mct)) and nc >= 3
    ox, oy = offset
    tw, th = tile_size or (w + ox, h + oy)
    siz = j2k.Siz(w + ox, h + oy, ox, oy, tw, th, tile_offset[0],
                  tile_offset[1], [prec] * nc, [signed] * nc)
    nl = levels
    cbw, cbh = (int(v).bit_length() - 1 for v in cblk)
    if 1 << cbw != cblk[0] or 1 << cbh != cblk[1] or cbw + cbh > 12 \
            or min(cbw, cbh) < 2:
        raise ValueError(f"code-block {cblk}")
    if precincts:
        pp = [(int(a).bit_length() - 1, int(b).bit_length() - 1)
              for a, b in precincts]
        pp = (pp + [pp[-1]] * (nl + 1))[:nl + 1][::-1]
    else:
        pp = [(15, 15)] * (nl + 1)
    coding = j2k.Coding(nl, cbw, cbh, style, True, pp)
    quant = j2k.lossless_quant(prec, nl)
    prog = j2k.PROGRESSIONS.index(progression)
    poc_list = [(a, b, c, d, e, j2k.PROGRESSIONS.index(f))
                for a, b, c, d, e, f in pocs]
    roi = roi or {}
    if style & j2k.LAZY and any(roi.values()):
        raise NotImplementedError("the encoder does not combine the bypass "
                                  "style with an ROI shift")

    tiles = j2k.transform_tiles(vals, siz, coding, quant, mct)
    jobs = j2k.block_jobs(tiles)
    # max-shift ROI: the resolution-0 coefficients of a component above
    # every other one, in the doubled scale openjpeg's decoder compares
    for c in [c for c in range(nc) if roi.get(c)]:
        rest = [int(np.abs(j[4]).max()) for j in jobs
                if j[1] == c and not j[5]]
        shift = max(rest, default=0).bit_length() + 1
        for j in jobs:
            if j[1] == c and j[5]:
                j[4] = j[4].astype(np.int64) << shift
        for _t, _b, comps, _p in tiles:
            comps[c].roi = shift
    j2k.tier1_encode(jobs, tiles, quant, style, layers, plain, n_threads)

    body = bytearray()
    ppm_payload = bytearray()
    for t, bounds, comps, _planes in tiles:
        packets = []
        for k, (hd, bd) in enumerate(j2k.tile_packets(
                comps, bounds, layers, prog, poc_list)):
            lead = struct.pack(">HHH", j2k.SOP, 4, k % 65536) if sop else b""
            packets.append((lead, hd + (struct.pack(">H", j2k.EPH)
                                        if eph else b""), bd))
        nparts = max(1, tile_parts)
        z_ppt = 0
        cuts = [round(i * len(packets) / nparts) for i in range(nparts + 1)]
        for part in range(nparts):
            chunk = packets[cuts[part]:cuts[part + 1]]
            hdrs = b"".join(hd for _, hd, _ in chunk)
            data = b"".join(sp + bd for sp, _, bd in chunk)
            markers = b""
            if ppm:
                ppm_payload += struct.pack(">I", len(hdrs)) + hdrs
            elif ppt:
                markers = _split_marker(j2k.PPT, hdrs, z_ppt)
                z_ppt += len(markers) and _n_segments(hdrs)
            else:
                data = b"".join(sp + hd + bd for sp, hd, bd in chunk)
            tp = markers + struct.pack(">H", j2k.SOD) + data
            body += struct.pack(">HHHIBB", j2k.SOT, 10, t, 12 + len(tp),
                                part, nparts) + tp

    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    main = j2k.main_header(siz, coding, quant, prog, layers, mct, scod)
    shifts = {}
    for _t, _b, comps, _p in tiles:
        for c, tc in enumerate(comps):
            if tc.roi:
                shifts[c] = max(shifts.get(c, 0), tc.roi)
    for c in sorted(shifts):
        main += j2k._segment(j2k.RGN, bytes([c, 0, shifts[c]]))
    if poc_list:
        main += j2k._segment(j2k.POC, b"".join(
            bytes([a, b]) + struct.pack(">H", c) + bytes([d, e % 256, f])
            for a, b, c, d, e, f in poc_list))
    if ppm:
        main += _split_marker(j2k.PPM, bytes(ppm_payload))
    cs = (struct.pack(">H", j2k.SOC) + main + bytes(body)
          + struct.pack(">H", j2k.EOC))
    return j2k.jp2_file(cs, siz) if jp2 else cs
