"""JPEG 2000 (ISO/IEC 15444-1) decoder and lossless encoder: the port's
stand-in for the openjpeg that PIL hands ``.jp2`` / ``.j2k`` files and
DICOM JPEG 2000 frames (…1.2.4.90 / .91) to in the JAX package.  Numpy
and Python only, like ``utils/jpeg.py``; the hot loops (tier-1 decode of
the code-blocks, the inverse wavelets, tier-1 encode) also run in C++
(``csrc/j2k.cpp``, bound in ``native.py``), and the functions here are
the plain versions the tests and ``chip_smoke.py`` hold them to.

Decoding gives what ``np.asarray(PIL.Image.open(...))`` gives, bit for
bit on reversible (5/3) streams: openjpeg 2.5's packet parsing, MQ
decoder and coding passes (every code-block style bit), its float32 9/7
lifting order and constants, its DC shift and clipping, and PIL's
mapping of components to modes (L, LA, RGB, RGBA, I;16), which shifts a
precision below the mode's 8 or 16 bits up and offsets a signed
component by 2**(prec - 1).  Every layer is decoded, at full resolution
(PIL's ``layers=0``, ``reduce=0``).  Refused, naming the marker or box:
Part-15 (HTJ2K) code-blocks and the CAP marker, component subsampling,
palettes (``pclr``) and colour spaces other than sRGB and greyscale.

``encode`` writes what PIL writes for ``write_ct_slice`` (a JP2 box
around a lossless 5/3 codestream with openjpeg's default COD and QCD:
LRCP, one layer, 5 levels, 64 x 64 code-blocks) of one grey component
or of three through the RCT, signed or unsigned, up to 16 bits.  Its
building blocks (``transform_tiles``, ``block_jobs``, ``tier1_encode``,
``tile_packets``, ``main_header``, ``jp2_file``) also serve
``tools/j2k_writer.py``, which writes the other codestream features the
decoder's tests need.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
SOC, SIZ, COD, COC, TLM, PLM, PLT, QCD, QCC, RGN, POC, PPM, PPT, CRG, COM = (
    0xFF4F, 0xFF51, 0xFF52, 0xFF53, 0xFF55, 0xFF57, 0xFF58, 0xFF5C, 0xFF5D,
    0xFF5E, 0xFF5F, 0xFF60, 0xFF61, 0xFF63, 0xFF64)
CAP, CPF = 0xFF50, 0xFF59
SOT, SOP, EPH, SOD, EOC = 0xFF90, 0xFF91, 0xFF92, 0xFF93, 0xFFD9
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")

# code-block style bits (COD/COC SPcod)
LAZY, RESET, TERMALL, VSC, PTERM, SEGSYM, HT = 1, 2, 4, 8, 16, 32, 64

# MQ coder states (ISO 15444-1 Table C.2): Qe, NMPS, NLPS, SWITCH
_MQ = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0))
_QE = [s[0] for s in _MQ]
_NMPS = [s[1] for s in _MQ]
_NLPS = [s[2] for s in _MQ]
_SWITCH = [s[3] for s in _MQ]
CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI, N_CTX = 9, 14, 17, 18, 19


def _initial_contexts() -> Tuple[List[int], List[int]]:
    """(state, mps) of the 19 contexts at the start of a code-block and
    after a RESET: uniform in state 46, run-length in 3, the first
    zero-coding context in 4, the rest in 0."""
    state = [0] * N_CTX
    state[CTX_UNI], state[CTX_AGG], state[0] = 46, 3, 4
    return state, [0] * N_CTX


def _zc_table() -> List[List[int]]:
    """Zero-coding context (Table D.1) of each band orientation (0 LL,
    1 HL, 2 LH, 3 HH, openjpeg's band numbers) for each neighbour state
    h + 3 v + 9 d (significant horizontal, vertical, diagonal
    neighbours)."""
    tables = []
    for orient in range(4):
        t = []
        for s in range(45):
            h, v, d = s % 3, (s // 3) % 3, s // 9
            if orient == 1:
                h, v = v, h
            if orient == 3:
                hv = h + v
                if d >= 3:
                    n = 8
                elif d == 2:
                    n = 7 if hv >= 1 else 6
                elif d == 1:
                    n = 5 if hv >= 2 else (4 if hv == 1 else 3)
                else:
                    n = 2 if hv >= 2 else hv
            elif h == 2:
                n = 8
            elif h == 1:
                n = 7 if v else (6 if d else 5)
            elif v:
                n = 4 if v == 2 else 3
            else:
                n = 2 if d >= 2 else d
            t.append(n)
        tables.append(t)
    return tables


ZC = _zc_table()
# sign context and xor bit (Table D.3) by (h + 1) * 3 + (v + 1), where h
# and v are the clipped sums of the neighbours' sign contributions
SC = [(13, 1), (12, 1), (11, 1), (10, 1), (9, 0), (10, 0), (11, 0), (12, 0),
      (13, 0)]


def _ceildiv(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------- headers

@dataclass
class Siz:
    width: int          # Xsiz
    height: int         # Ysiz
    x0: int             # XOsiz
    y0: int             # YOsiz
    tw: int             # XTsiz
    th: int             # YTsiz
    tx0: int            # XTOsiz
    ty0: int            # YTOsiz
    prec: List[int]
    signed: List[bool]

    @property
    def ncomp(self) -> int:
        return len(self.prec)

    @property
    def ntiles(self) -> Tuple[int, int]:
        return (_ceildiv(self.width - self.tx0, self.tw),
                _ceildiv(self.height - self.ty0, self.th))


@dataclass
class Coding:
    """The per-component part of COD/COC."""
    levels: int
    cbw: int            # code-block width exponent
    cbh: int
    style: int
    reversible: bool
    precincts: List[Tuple[int, int]]   # (PPx, PPy) per resolution


@dataclass
class Quant:
    style: int          # 0 none, 1 scalar derived, 2 scalar expounded
    guard: int
    steps: List[Tuple[int, int]]       # (exponent, mantissa) per band

    def step(self, band: int) -> Tuple[int, int]:
        if self.style == 1:
            e, m = self.steps[0]
            return max(e - (band - 1) // 3, 0) if band else e, m
        if band >= len(self.steps):
            raise ValueError(f"JPEG 2000: QCD/QCC has {len(self.steps)} "
                             f"step sizes, band {band} needs one")
        return self.steps[band]


@dataclass
class Defaults:
    """Coding parameters of the main header or of one tile."""
    progression: int = 0
    layers: int = 1
    mct: int = 0
    sop: bool = False
    eph: bool = False
    cod: Optional[Coding] = None
    coc: Dict[int, Coding] = field(default_factory=dict)
    qcd: Optional[Quant] = None
    qcc: Dict[int, Quant] = field(default_factory=dict)
    roi: Dict[int, int] = field(default_factory=dict)
    pocs: List[Tuple[int, ...]] = field(default_factory=list)


@dataclass
class TilePart:
    index: int
    part: int
    markers: List[Tuple[int, bytes]]
    data: bytes


@dataclass
class Codestream:
    siz: Siz
    main: Defaults
    ppm: Optional[bytes]
    tile_parts: List[TilePart]


def _marker_segments(cs: bytes, pos: int):
    """(marker, body, position after) of each marker segment from ``pos``
    until SOT, SOD or the end."""
    while pos + 2 <= len(cs):
        (m,) = struct.unpack_from(">H", cs, pos)
        if m in (SOD, EOC) or m < 0xFF00:
            yield m, b"", pos
            return
        if pos + 4 > len(cs):
            raise ValueError("JPEG 2000: truncated marker segment")
        (ln,) = struct.unpack_from(">H", cs, pos + 2)
        if ln < 2 or pos + 2 + ln > len(cs):
            raise ValueError(f"JPEG 2000: marker {m:04X} of length {ln} "
                             f"runs past the codestream")
        yield m, cs[pos + 4:pos + 2 + ln], pos + 2 + ln
        pos += 2 + ln
    raise ValueError("JPEG 2000: codestream ends inside its headers")


def _parse_siz(b: bytes) -> Siz:
    if len(b) < 36:
        raise ValueError("JPEG 2000: short SIZ")
    (_rsiz, xs, ys, xo, yo, xt, yt, xto, yto, nc) = struct.unpack_from(
        ">HIIIIIIIIH", b)
    if nc < 1 or len(b) < 36 + 3 * nc:
        raise ValueError(f"JPEG 2000: SIZ with {nc} components")
    prec, signed = [], []
    for c in range(nc):
        ssiz, dx, dy = b[36 + 3 * c:39 + 3 * c]
        if dx != 1 or dy != 1:
            raise NotImplementedError(
                f"JPEG 2000: SIZ subsamples component {c} by ({dx}, {dy}); "
                "PIL refuses subsampled components too")
        prec.append((ssiz & 0x7F) + 1)
        signed.append(bool(ssiz & 0x80))
    if (xt == 0 or yt == 0 or xo >= xs or yo >= ys or xto > xo or yto > yo
            or xto + xt <= xo or yto + yt <= yo):
        raise ValueError(f"JPEG 2000: SIZ image ({xo}, {yo})-({xs}, {ys}) "
                         f"and tiles {xt} x {yt} at ({xto}, {yto}) disagree")
    if max(prec) > 16:
        raise NotImplementedError(f"JPEG 2000: {max(prec)}-bit components "
                                  "(this decoder reads up to 16 bits)")
    return Siz(xs, ys, xo, yo, xt, yt, xto, yto, prec, signed)


def _parse_spcod(b: bytes, with_precincts: bool) -> Coding:
    if len(b) < 5:
        raise ValueError("JPEG 2000: short COD/COC")
    levels, cbw, cbh, style, transform = b[:5]
    if levels > 32 or cbw > 8 or cbh > 8 or cbw + cbh > 8:
        raise ValueError(f"JPEG 2000: COD/COC with {levels} levels and "
                         f"code-blocks 2^{cbw + 2} x 2^{cbh + 2}")
    if style & HT:
        raise NotImplementedError(
            "JPEG 2000: COD/COC selects Part-15 (HTJ2K) code-blocks; the "
            "JAX package does not take DICOM's HTJ2K syntaxes either")
    if transform > 1:
        raise NotImplementedError(f"JPEG 2000: COD/COC wavelet {transform} "
                                  "(Part 2)")
    if with_precincts:
        if len(b) < 6 + levels:
            raise ValueError("JPEG 2000: COD/COC lacks its precinct sizes")
        pp = [(v & 15, v >> 4) for v in b[5:6 + levels]]
        if any(x == 0 or y == 0 for x, y in pp[1:]):
            raise ValueError("JPEG 2000: a precinct exponent of 0 above "
                             "resolution 0")
    else:
        pp = [(15, 15)] * (levels + 1)
    return Coding(levels, cbw + 2, cbh + 2, style, transform == 1, pp)


def _parse_quant(b: bytes) -> Quant:
    if not b:
        raise ValueError("JPEG 2000: empty QCD/QCC")
    style, guard = b[0] & 31, b[0] >> 5
    if style == 0:
        steps = [(v >> 3, 0) for v in b[1:]]
    elif style in (1, 2):
        if len(b) < 3:
            raise ValueError("JPEG 2000: QCD/QCC without step sizes")
        steps = [(v >> 11, v & 0x7FF)
                 for v in struct.unpack(f">{(len(b) - 1) // 2}H",
                                        b[1:1 + (len(b) - 1) // 2 * 2])]
    else:
        raise ValueError(f"JPEG 2000: quantization style {style}")
    return Quant(style, guard, steps)


def _apply_marker(d: Defaults, m: int, b: bytes, nc: int) -> None:
    """Record one COD/COC/QCD/QCC/RGN/POC marker in ``d``."""
    cw = 1 if nc < 257 else 2
    comp = (lambda: b[0] if cw == 1 else struct.unpack_from(">H", b)[0])
    if m == COD:
        if len(b) < 5:
            raise ValueError("JPEG 2000: short COD")
        scod, prog, layers, mct = b[0], b[1], *struct.unpack_from(">HB", b, 2)
        if prog > 4 or layers == 0:
            raise ValueError(f"JPEG 2000: COD progression {prog}, "
                             f"{layers} layers")
        d.progression, d.layers, d.mct = prog, layers, mct
        d.sop, d.eph = bool(scod & 2), bool(scod & 4)
        d.cod = _parse_spcod(b[5:], bool(scod & 1))
        d.coc = {}
    elif m == COC:
        c = comp()
        if c >= nc or len(b) < cw + 1:
            raise ValueError(f"JPEG 2000: COC of component {c}")
        d.coc[c] = _parse_spcod(b[cw + 1:], bool(b[cw] & 1))
    elif m == QCD:
        d.qcd = _parse_quant(b)
        d.qcc = {}
    elif m == QCC:
        c = comp()
        if c >= nc:
            raise ValueError(f"JPEG 2000: QCC of component {c}")
        d.qcc[c] = _parse_quant(b[cw:])
    elif m == RGN:
        c = comp()
        if c >= nc or len(b) < cw + 2 or b[cw] != 0:
            raise ValueError("JPEG 2000: RGN other than an implicit "
                             "(max-shift) region of a component")
        d.roi[c] = b[cw + 1]
    elif m == POC:
        step = 5 + 2 * cw
        if len(b) % step:
            raise ValueError("JPEG 2000: POC length")
        d.pocs = []
        for i in range(0, len(b), step):
            rs = b[i]
            cs = b[i + 1] if cw == 1 else struct.unpack_from(">H", b, i + 1)[0]
            (lye,) = struct.unpack_from(">H", b, i + 1 + cw)
            re = b[i + 3 + cw]
            ce = (b[i + 4 + cw] if cw == 1
                  else struct.unpack_from(">H", b, i + 4 + cw)[0])
            p = b[i + 4 + 2 * cw]
            if p > 4:
                raise ValueError(f"JPEG 2000: POC progression {p}")
            d.pocs.append((rs, cs, lye, re, 256 if ce == 0 else ce, p))


def parse_codestream(cs: bytes) -> Codestream:
    """The main header and the tile-parts of a raw codestream."""
    if cs[:4] != b"\xff\x4f\xff\x51":
        raise ValueError("JPEG 2000: the codestream does not start with "
                         "SOC, SIZ")
    siz, main, ppm = None, Defaults(), {}
    pos = 2
    for m, b, nxt in _marker_segments(cs, pos):
        if m == SOT:
            break
        pos = nxt
        if m == SIZ:
            siz = _parse_siz(b)
        elif m in (COD, COC, QCD, QCC, RGN, POC):
            _apply_marker(main, m, b, siz.ncomp)
        elif m == PPM:
            ppm[b[0]] = b[1:]
        elif m in (CAP, CPF):
            raise NotImplementedError(
                f"JPEG 2000: marker {m:04X} ({'CAP' if m == CAP else 'CPF'}) "
                "of a Part-15 (HTJ2K) codestream")
        elif m in (TLM, PLM, CRG, COM) or 0xFF30 <= m <= 0xFF3F:
            continue
        elif m in (SOD, EOC) or m < 0xFF00:
            raise ValueError("JPEG 2000: no tile-part in the codestream")
        else:
            raise ValueError(f"JPEG 2000: marker {m:04X} in the main header")
    if siz is None or main.cod is None or main.qcd is None:
        raise ValueError("JPEG 2000: the main header lacks SIZ, COD or QCD")
    parts = []
    while pos + 2 <= len(cs):
        (m,) = struct.unpack_from(">H", cs, pos)
        if m == EOC:
            break
        if m != SOT or pos + 12 > len(cs):
            raise ValueError(f"JPEG 2000: expected SOT at byte {pos}, found "
                             f"{m:04X}")
        isot, psot, tpsot, _tnsot = struct.unpack_from(">HIBB", cs, pos + 4)
        start = pos
        markers = []
        p = pos + 12
        for mm, b, nxt in _marker_segments(cs, p):
            if mm == SOD:
                p = nxt + 2
                break
            if mm in (CAP, CPF):
                raise NotImplementedError(f"JPEG 2000: marker {mm:04X} of a "
                                          "Part-15 (HTJ2K) codestream")
            markers.append((mm, b))
            p = nxt
        else:
            raise ValueError("JPEG 2000: tile-part without SOD")
        # Psot 0: the last tile-part, up to EOC; a truncated one keeps
        # the bytes that are there
        end = min(start + psot, len(cs)) if psot else \
            len(cs) - (2 if cs.endswith(b"\xff\xd9") else 0)
        if end < p:
            raise ValueError("JPEG 2000: SOT length ends inside the "
                             "tile-part header")
        nt = siz.ntiles
        if isot >= nt[0] * nt[1]:
            raise ValueError(f"JPEG 2000: tile {isot} of {nt[0] * nt[1]}")
        parts.append(TilePart(isot, tpsot, markers, cs[p:end]))
        pos = end
    ppm_data = (b"".join(ppm[k] for k in sorted(ppm)) if ppm else None)
    return Codestream(siz, main, ppm_data, parts)


def _boxes(data: bytes, pos: int, end: int):
    while pos + 8 <= end:
        ln, typ = struct.unpack_from(">I4s", data, pos)
        hl = 8
        if ln == 1:
            (ln,) = struct.unpack_from(">Q", data, pos + 8)
            hl = 16
        elif ln == 0:
            ln = end - pos
        if ln < hl or pos + ln > end:
            raise ValueError(f"JPEG 2000: box {typ!r} of length {ln} runs "
                             "past the file")
        yield typ, data[pos + hl:pos + ln]
        pos += ln


@dataclass
class Container:
    codestream: bytes
    jp2: bool
    colorspace: str           # "gray", "srgb" or "unspecified"
    ihdr_nc: int = 0
    ihdr_bpc: int = 0


def parse_container(data: bytes) -> Container:
    """The codestream of a JP2 file or of a bare codestream, with what the
    JP2 header says of its colours."""
    data = bytes(data)
    if data[:4] == b"\xff\x4f\xff\x51":
        return Container(data, False, "unspecified")
    if data[:12] != JP2_SIGNATURE:
        raise ValueError("not a JPEG 2000 file (neither a JP2 signature box "
                         "nor SOC, SIZ)")
    cs, nc, bpc, enumcs = None, 0, 0, None
    for typ, body in _boxes(data, 12, len(data)):
        if typ == b"ftyp" and body[:4] not in (b"jp2 ", b"jpx "):
            raise ValueError(f"JPEG 2000: ftyp brand {body[:4]!r}")
        elif typ == b"jp2h":
            for t2, b2 in _boxes(body, 0, len(body)):
                if t2 == b"ihdr":
                    _h, _w, nc, bpc = struct.unpack_from(">IIHB", b2)
                elif t2 == b"colr" and enumcs is None:
                    if b2[0] != 1:
                        raise NotImplementedError(
                            f"JPEG 2000: colr box method {b2[0]} (an ICC "
                            "profile); this decoder reads enumerated sRGB "
                            "and greyscale")
                    (enumcs,) = struct.unpack_from(">I", b2, 3)
                elif t2 in (b"pclr", b"cmap"):
                    raise NotImplementedError(
                        f"JPEG 2000: a {t2.decode()} box (palette); this "
                        "decoder reads no palette images")
        elif typ == b"jp2c":
            cs = body
            break
    if cs is None:
        raise ValueError("JPEG 2000: no jp2c box")
    if enumcs not in (16, 17):
        raise NotImplementedError(
            f"JPEG 2000: colr enumerated colour space {enumcs} (sYCC, CMYK "
            "or other); this decoder reads sRGB (16) and greyscale (17)")
    return Container(cs, True, "srgb" if enumcs == 16 else "gray", nc, bpc)


def pil_mode(ct: Container, siz: Siz) -> str:
    """PIL's mode of the image, as its plugin reads it from the JP2 ihdr
    box or the codestream's SIZ (Pillow Jpeg2KImagePlugin)."""
    if ct.jp2:
        nc, deep = ct.ihdr_nc, (ct.ihdr_bpc & 0x7F) > 8
    else:
        nc, deep = siz.ncomp, siz.prec[0] > 8
    if nc == 1:
        return "I;16" if deep else "L"
    modes = {2: "LA", 3: "RGB", 4: "RGBA"}
    if nc not in modes:
        raise NotImplementedError(f"JPEG 2000 with {nc} components")
    return modes[nc]


def header(data: bytes) -> Tuple[Tuple[int, int], str]:
    """((width, height), PIL's mode) of a JPEG 2000 file, from its headers
    only."""
    ct = parse_container(data)
    siz = _parse_siz_only(ct.codestream)
    mode = pil_mode(ct, siz)
    _check_unpacker(mode, ct, siz)
    return (siz.width - siz.x0, siz.height - siz.y0), mode


def read_header(path: str) -> Tuple[Tuple[int, int], str]:
    """``header`` of the JPEG 2000 file at ``path``, reading only what it
    needs: the ftyp and jp2h boxes (others are skipped) and the
    codestream's SOC and SIZ, none of its code-blocks."""
    with open(path, "rb") as fh:
        out = bytearray(fh.read(12))
        if out[:4] == b"\xff\x4f\xff\x51":
            (ln,) = struct.unpack_from(">H", out, 4)
            return header(bytes(out + fh.read(max(0, 4 + ln - 12))))
        while out[:12] == JP2_SIGNATURE:
            hdr = fh.read(8)
            if len(hdr) < 8:
                break
            ln, typ = struct.unpack(">I4s", hdr)
            if ln == 1:
                hdr += fh.read(8)
                (ln,) = struct.unpack_from(">Q", hdr.ljust(16, b"\0"), 8)
            if typ == b"jp2c":
                cs = fh.read(6)
                if cs[:4] == b"\xff\x4f\xff\x51" and len(cs) == 6:
                    cs += fh.read(struct.unpack_from(">H", cs, 4)[0] - 2)
                out += struct.pack(">I4s", 8 + len(cs), typ) + cs
                break
            if ln == 0 or ln < len(hdr):
                out += hdr          # _boxes names the fault
                break
            if typ in (b"ftyp", b"jp2h"):
                out += struct.pack(">I4s", 8 + ln - len(hdr), typ) + fh.read(
                    ln - len(hdr))
            else:
                fh.seek(ln - len(hdr), 1)
    return header(bytes(out))


def _parse_siz_only(cs: bytes) -> Siz:
    if cs[:4] != b"\xff\x4f\xff\x51" or len(cs) < 6:
        raise ValueError("JPEG 2000: the codestream does not start with "
                         "SOC, SIZ")
    (ln,) = struct.unpack_from(">H", cs, 4)
    return _parse_siz(cs[6:4 + ln])


def _check_unpacker(mode: str, ct: Container, siz: Siz) -> None:
    """Raise where PIL finds no unpacker for the mode, colour space and
    component count (Pillow Jpeg2KDecode.c j2k_unpackers)."""
    cs = ct.colorspace
    if cs == "unspecified":
        cs = "gray" if siz.ncomp <= 2 else "srgb"
    ok = {("L", "gray", 1), ("I;16", "gray", 1), ("LA", "gray", 2),
          ("RGB", "srgb", 3), ("RGBA", "srgb", 4), ("RGBA", "gray", 2)}
    if (mode, cs, siz.ncomp) not in ok:
        raise NotImplementedError(
            f"JPEG 2000: {siz.ncomp} components in a {cs} colour space as "
            f"mode {mode}: PIL has no unpacker for it")


# ---------------------------------------------------------------- geometry

class TagTree:
    """A tag tree (B.10.2) over a w x h grid of leaves."""

    def __init__(self, w: int, h: int):
        self.parent: List[int] = []
        levels = []
        while True:
            levels.append((w, h))
            if w * h <= 1:
                break
            w, h = (w + 1) // 2, (h + 1) // 2
        offs, n = [], 0
        for lw, lh in levels:
            offs.append(n)
            n += lw * lh
        for li, (lw, lh) in enumerate(levels):
            for j in range(lh):
                for i in range(lw):
                    if li + 1 < len(levels):
                        pw = levels[li + 1][0]
                        self.parent.append(offs[li + 1] + (j // 2) * pw + i // 2)
                    else:
                        self.parent.append(-1)
        self.value = [999] * n
        self.low = [0] * n
        self.known = [0] * n

    def _path(self, leaf: int) -> List[int]:
        path = [leaf]
        while self.parent[path[-1]] >= 0:
            path.append(self.parent[path[-1]])
        return path[::-1]

    def decode(self, bio: "BitReader", leaf: int, threshold: int) -> bool:
        """openjpeg's opj_tgt_decode: whether the leaf's value is below
        ``threshold``, reading what bits that needs."""
        low = 0
        value, lows = self.value, self.low
        for node in self._path(leaf):
            if low > lows[node]:
                lows[node] = low
            else:
                low = lows[node]
            while low < threshold and low < value[node]:
                if bio.bit():
                    value[node] = low
                else:
                    low += 1
            lows[node] = low
        return value[leaf] < threshold

    def set_leaf(self, leaf: int, v: int) -> None:
        node = leaf
        while node >= 0 and self.value[node] > v:
            self.value[node] = v
            node = self.parent[node]

    def encode(self, bw: "BitWriter", leaf: int, threshold: int) -> None:
        """openjpeg's opj_tgt_encode."""
        low = 0
        for node in self._path(leaf):
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bw.bit(1)
                        self.known[node] = 1
                    break
                bw.bit(0)
                low += 1
            self.low[node] = low


@dataclass
class Block:
    x0: int
    y0: int
    x1: int
    y1: int
    included: bool = False
    lblock: int = 3
    numbps: int = 0
    segs: List[List[int]] = field(default_factory=list)  # [len, passes, max]
    chunks: List[bytes] = field(default_factory=list)


@dataclass
class Precinct:
    cw: int
    ch: int
    blocks: List[Block]
    incl: TagTree
    imsb: TagTree


@dataclass
class Band:
    number: int         # 0 LL, 1 HL, 2 LH, 3 HH
    x0: int
    y0: int
    x1: int
    y1: int
    step_index: int
    precincts: List[Precinct]

    @property
    def empty(self) -> bool:
        return self.x0 >= self.x1 or self.y0 >= self.y1


@dataclass
class Resolution:
    x0: int
    y0: int
    x1: int
    y1: int
    ppx: int
    ppy: int
    pw: int
    ph: int
    bands: List[Band]


@dataclass
class TileComp:
    x0: int
    y0: int
    x1: int
    y1: int
    coding: Coding
    quant: Quant
    roi: int
    resolutions: List[Resolution]


def _cdiv2(a: int, n: int) -> int:
    return -((-a) >> n)


def build_tilecomp(x0: int, y0: int, x1: int, y1: int, coding: Coding,
                   quant: Quant, roi: int) -> TileComp:
    """Resolutions, bands, precincts and code-blocks of one tile-component
    (openjpeg tcd.c opj_tcd_init_tile, B.5-B.7)."""
    nl = coding.levels
    res_list = []
    for r in range(nl + 1):
        lev = nl - r
        rx0, ry0 = _cdiv2(x0, lev), _cdiv2(y0, lev)
        rx1, ry1 = _cdiv2(x1, lev), _cdiv2(y1, lev)
        ppx, ppy = coding.precincts[r]
        tlx, tly = (rx0 >> ppx) << ppx, (ry0 >> ppy) << ppy
        brx, bry = _cdiv2(rx1, ppx) << ppx, _cdiv2(ry1, ppy) << ppy
        pw = 0 if rx0 == rx1 else (brx - tlx) >> ppx
        ph = 0 if ry0 == ry1 else (bry - tly) >> ppy
        if r == 0:
            cbgx, cbgy, ex, ey = tlx, tly, ppx, ppy
            specs = [(0, rx0, ry0, rx1, ry1)]
        else:
            cbgx, cbgy, ex, ey = _cdiv2(tlx, 1), _cdiv2(tly, 1), ppx - 1, ppy - 1
            specs = []
            for b in (1, 2, 3):
                xb, yb = b & 1, b >> 1
                specs.append((b, _cdiv2(x0 - (xb << lev), lev + 1),
                              _cdiv2(y0 - (yb << lev), lev + 1),
                              _cdiv2(x1 - (xb << lev), lev + 1),
                              _cdiv2(y1 - (yb << lev), lev + 1)))
        cbw, cbh = min(coding.cbw, ex), min(coding.cbh, ey)
        bands = []
        for b, bx0, by0, bx1, by1 in specs:
            precs = []
            for p in range(pw * ph):
                px0 = max(cbgx + (p % pw << ex), bx0)
                py0 = max(cbgy + (p // pw << ey), by0)
                px1 = min(cbgx + ((p % pw + 1) << ex), bx1)
                py1 = min(cbgy + ((p // pw + 1) << ey), by1)
                if px0 >= px1 or py0 >= py1:
                    precs.append(Precinct(0, 0, [], TagTree(0, 0),
                                          TagTree(0, 0)))
                    continue
                cx0, cy0 = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                cw = (_cdiv2(px1, cbw) << cbw) - cx0 >> cbw
                ch = (_cdiv2(py1, cbh) << cbh) - cy0 >> cbh
                blocks = []
                for k in range(cw * ch):
                    bx = cx0 + (k % cw << cbw)
                    by = cy0 + (k // cw << cbh)
                    blocks.append(Block(max(bx, px0), max(by, py0),
                                        min(bx + (1 << cbw), px1),
                                        min(by + (1 << cbh), py1)))
                precs.append(Precinct(cw, ch, blocks, TagTree(cw, ch),
                                      TagTree(cw, ch)))
            bands.append(Band(b, bx0, by0, bx1, by1,
                              0 if r == 0 else 3 * (r - 1) + b, precs))
        res_list.append(Resolution(rx0, ry0, rx1, ry1, ppx, ppy, pw, ph,
                                   bands))
    return TileComp(x0, y0, x1, y1, coding, quant, roi, res_list)


def tile_bounds(siz: Siz, t: int) -> Tuple[int, int, int, int]:
    nx = siz.ntiles[0]
    p, q = t % nx, t // nx
    return (max(siz.tx0 + p * siz.tw, siz.x0), max(siz.ty0 + q * siz.th, siz.y0),
            min(siz.tx0 + (p + 1) * siz.tw, siz.width),
            min(siz.ty0 + (q + 1) * siz.th, siz.height))


def packet_order(comps: Sequence[TileComp], bounds, layers: int,
                 progression: int, pocs) -> List[Tuple[int, int, int, int]]:
    """(layer, resolution, component, precinct) of each packet of a tile
    in the order they appear (openjpeg pi.c, B.12), POC included; a packet
    comes once, where it first appears."""
    tx0, ty0, tx1, ty1 = bounds
    nc = len(comps)
    maxres = max(c.coding.levels + 1 for c in comps)
    if pocs:
        progs = [(rs, cs, min(lye, layers), re, min(ce, nc), p)
                 for rs, cs, lye, re, ce, p in pocs]
    else:
        progs = [(0, 0, layers, maxres, nc, progression)]
    seen = set()
    out = []

    def emit(l, r, c, p):
        key = (l, r, c, p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    def positions(lo, hi, step):
        v = lo
        while v < hi:
            yield v
            v += step - v % step

    def prec_at(c, r, x, y):
        """The precinct of (c, r) that starts at (x, y), or None."""
        tc = comps[c]
        if r > tc.coding.levels:
            return None
        res = tc.resolutions[r]
        lev = tc.coding.levels - r
        rpx, rpy = res.ppx + lev, res.ppy + lev
        if rpx >= 31 or rpy >= 31:
            return None
        if not (y % (1 << rpy) == 0 or (y == ty0 and (res.y0 << lev)
                                         % (1 << rpy))):
            return None
        if not (x % (1 << rpx) == 0 or (x == tx0 and (res.x0 << lev)
                                         % (1 << rpx))):
            return None
        if res.pw == 0 or res.ph == 0 or res.x0 == res.x1 or res.y0 == res.y1:
            return None
        pi = (_ceildiv(x, 1 << lev) >> res.ppx) - (res.x0 >> res.ppx)
        pj = (_ceildiv(y, 1 << lev) >> res.ppy) - (res.y0 >> res.ppy)
        return pi + pj * res.pw

    def steps(cs):
        dx = dy = None
        for c in cs:
            tc = comps[c]
            for r, res in enumerate(tc.resolutions):
                lev = tc.coding.levels - r
                if res.ppx + lev < 32:
                    v = 1 << (res.ppx + lev)
                    dx = v if dx is None else min(dx, v)
                if res.ppy + lev < 32:
                    v = 1 << (res.ppy + lev)
                    dy = v if dy is None else min(dy, v)
        return dx, dy

    for rs, cs, le, re, ce, prog in progs:
        name = PROGRESSIONS[prog]
        if name in ("LRCP", "RLCP"):
            outer = ((l, r) for l in range(le) for r in range(rs, re)) \
                if name == "LRCP" else \
                ((l, r) for r in range(rs, re) for l in range(le))
            for l, r in outer:
                for c in range(cs, ce):
                    tc = comps[c]
                    if r > tc.coding.levels:
                        continue
                    res = tc.resolutions[r]
                    for p in range(res.pw * res.ph):
                        emit(l, r, c, p)
        elif name == "RPCL":
            dx, dy = steps(range(cs, ce))
            if dx is None:
                continue
            for r in range(rs, re):
                for y in positions(ty0, ty1, dy):
                    for x in positions(tx0, tx1, dx):
                        for c in range(cs, ce):
                            p = prec_at(c, r, x, y)
                            if p is not None:
                                for l in range(le):
                                    emit(l, r, c, p)
        elif name == "PCRL":
            dx, dy = steps(range(cs, ce))
            if dx is None:
                continue
            for y in positions(ty0, ty1, dy):
                for x in positions(tx0, tx1, dx):
                    for c in range(cs, ce):
                        for r in range(rs, min(re, comps[c].coding.levels + 1)):
                            p = prec_at(c, r, x, y)
                            if p is not None:
                                for l in range(le):
                                    emit(l, r, c, p)
        else:  # CPRL
            for c in range(cs, ce):
                dx, dy = steps([c])
                if dx is None:
                    continue
                for y in positions(ty0, ty1, dy):
                    for x in positions(tx0, tx1, dx):
                        for r in range(rs, min(re, comps[c].coding.levels + 1)):
                            p = prec_at(c, r, x, y)
                            if p is not None:
                                for l in range(le):
                                    emit(l, r, c, p)
    return out


# ---------------------------------------------------------------- tier 2

class BitReader:
    """openjpeg's opj_bio reader: bits MSB first, 7 bits in the byte after
    an 0xFF; past the end it reads zeros."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos
        self.buf = 0
        self.ct = 0

    def _bytein(self) -> None:
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < len(self.data):
            self.buf |= self.data[self.pos]
            self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> None:
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0


def _numpasses(bio: BitReader) -> int:
    if not bio.bit():
        return 1
    if not bio.bit():
        return 2
    n = bio.bits(2)
    if n != 3:
        return 3 + n
    n = bio.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bio.bits(7)


def _maxpasses(style: int, first: bool, prev: int) -> int:
    if style & TERMALL:
        return 1
    if style & LAZY:
        return 10 if first else (2 if prev in (1, 10) else 1)
    return 109


def _read_packet(tcs, c, r, p, layer, data: bytes, pos: int,
                 hdr: Optional[BitReader], sop: bool, eph: bool,
                 mb: Dict) -> int:
    """Parse one packet (B.9, B.10; openjpeg t2.c), attaching its
    code-block contributions.  ``hdr`` reads the header from PPM/PPT
    data when given.  Returns the position after its body."""
    if sop and pos + 6 <= len(data) and data[pos] == 0xFF \
            and data[pos + 1] == 0x91:
        pos += 6
    bio = hdr if hdr is not None else BitReader(data, pos)
    if hdr is not None:
        bio.buf, bio.ct = 0, 0
    tc = tcs[c]
    res = tc.resolutions[r]
    present = bio.bit()
    contrib = []
    if present:
        for band in res.bands:
            if band.empty:
                continue
            prc = band.precincts[p]
            for k, blk in enumerate(prc.blocks):
                if not blk.included:
                    inc = prc.incl.decode(bio, k, layer + 1)
                else:
                    inc = bio.bit()
                if not inc:
                    continue
                if not blk.included:
                    i = 0
                    while not prc.imsb.decode(bio, k, i):
                        i += 1
                    blk.numbps = mb[(c, band.step_index)] - (i - 1)
                    blk.lblock = 3
                    blk.included = True
                n = _numpasses(bio)
                while bio.bit():
                    blk.lblock += 1
                segs = blk.segs
                if not segs or segs[-1][1] == segs[-1][2]:
                    segs.append([0, 0, _maxpasses(tc.coding.style, not segs,
                                                  segs[-1][2] if segs else 0)])
                while n > 0:
                    seg = segs[-1]
                    take = min(seg[2] - seg[1], n)
                    nb = blk.lblock + take.bit_length() - 1
                    if nb > 32:
                        raise ValueError("JPEG 2000: a code-block length of "
                                         f"{nb} bits")
                    contrib.append((blk, seg, take, bio.bits(nb)))
                    n -= take
                    if n > 0:
                        segs.append([0, 0, _maxpasses(tc.coding.style, False,
                                                      seg[2])])
    bio.align()
    if hdr is None:
        pos = bio.pos
        hpos = None
    else:
        hpos = bio.pos
    if eph:
        if hdr is None:
            if data[pos:pos + 2] == b"\xff\x92":
                pos += 2
        elif hdr.data[hpos:hpos + 2] == b"\xff\x92":
            hdr.pos = hpos + 2
    for blk, seg, take, ln in contrib:
        if pos + ln > len(data):
            raise ValueError("JPEG 2000: a code-block contribution runs past "
                             "the tile's data")
        blk.chunks.append(data[pos:pos + ln])
        seg[0] += ln
        seg[1] += take
        pos += ln
    return pos


# ---------------------------------------------------------------- tier 1

@dataclass
class BlockJob:
    """One code-block to decode: its bytes, segments, geometry and coding
    style, and where its coefficients go."""
    data: bytes
    seg_lens: List[int]
    seg_passes: List[int]
    w: int
    h: int
    orient: int
    bpno: int           # planes to decode, ROI shift included
    numbps: int         # the code-block's own planes (openjpeg's numbps)
    roishift: int
    style: int
    reversible: bool
    stepsize: float     # half openjpeg's band step, float32
    out: np.ndarray     # int32 or float32 view [h, w]


def t1_decode_plain(job: BlockJob) -> np.ndarray:
    """The coefficients of one code-block as openjpeg's tier 1 leaves them
    (t1.c opj_t1_decode_cblk): int32 [h, w] in its "times two plus a half
    bit" scale, the ROI shift undone.  Python, sample by sample."""
    w, h = job.w, job.h
    W = w + 2
    n = W * (h + 2)
    sig = [0] * n
    neg = [0] * n
    nbr = [0] * n
    vis = [0] * n
    refd = [0] * n
    val = [0] * n
    zc = ZC[job.orient]
    vsc = bool(job.style & VSC)
    state, mps = _initial_contexts()
    data = job.data
    bpno_plus_one = job.bpno
    passtype = 2
    if bpno_plus_one >= 31:
        raise ValueError(f"JPEG 2000: {bpno_plus_one} bit-planes in a "
                         "code-block")

    # neighbour offsets and their weights in nbr (h + 3 v + 9 d)
    def make_sig(i, y, s):
        sig[i] = 1
        neg[i] = s
        north = not (vsc and (y & 3) == 0)
        nbr[i - 1] += 1
        nbr[i + 1] += 1
        nbr[i + W] += 3
        nbr[i + W - 1] += 9
        nbr[i + W + 1] += 9
        if north:
            nbr[i - W] += 3
            nbr[i - W - 1] += 9
            nbr[i - W + 1] += 9

    def sign_ctx(i, y):
        hc = (sig[i - 1] * (1 - 2 * neg[i - 1])
              + sig[i + 1] * (1 - 2 * neg[i + 1]))
        vc = sig[i - W] * (1 - 2 * neg[i - W])
        if not (vsc and (y & 3) == 3):
            vc += sig[i + W] * (1 - 2 * neg[i + W])
        hc = 1 if hc > 0 else (-1 if hc < 0 else 0)
        vc = 1 if vc > 0 else (-1 if vc < 0 else 0)
        return SC[(hc + 1) * 3 + vc + 1]

    seg_pos = 0
    for seg_len, seg_passes in zip(job.seg_lens, job.seg_passes):
        raw = (bpno_plus_one <= job.numbps - 4 and passtype < 2
               and job.style & LAZY)
        buf = data[seg_pos:seg_pos + seg_len] + b"\xff\xff"
        seg_pos += seg_len
        # decoder registers in a list: [a, c, ct, bp]
        if raw:
            reg = [0, 0, 0, 0]

            def rawbit():
                if reg[2] == 0:
                    if reg[1] == 0xFF:
                        if buf[reg[3]] > 0x8F:
                            reg[1], reg[2] = 0xFF, 8
                        else:
                            reg[1] = buf[reg[3]]
                            reg[3] += 1
                            reg[2] = 7
                    else:
                        reg[1] = buf[reg[3]]
                        reg[3] += 1
                        reg[2] = 8
                reg[2] -= 1
                return (reg[1] >> reg[2]) & 1
        else:
            reg = [0x8000, (0xFF << 16) if seg_len == 0 else (buf[0] << 16),
                   0, 0]

            def bytein():
                bp = reg[3]
                if buf[bp] == 0xFF:
                    if buf[bp + 1] > 0x8F:
                        reg[1] += 0xFF00
                        reg[2] = 8
                    else:
                        reg[3] = bp + 1
                        reg[1] += buf[bp + 1] << 9
                        reg[2] = 7
                else:
                    reg[3] = bp + 1
                    reg[1] += buf[bp + 1] << 8
                    reg[2] = 8

            if seg_len == 0:
                reg[3] = len(buf) - 2
            bytein()
            reg[1] = (reg[1] << 7) & 0xFFFFFFFF
            reg[2] -= 7

            def mq(cx):
                st = state[cx]
                qe = _QE[st]
                a = reg[0] - qe
                c = reg[1]
                if (c >> 16) < qe:
                    if a < qe:
                        a = qe
                        d = mps[cx]
                        state[cx] = _NMPS[st]
                    else:
                        a = qe
                        d = 1 - mps[cx]
                        if _SWITCH[st]:
                            mps[cx] = d
                        state[cx] = _NLPS[st]
                else:
                    c -= qe << 16
                    if a & 0x8000:
                        reg[0], reg[1] = a, c
                        return mps[cx]
                    if a < qe:
                        d = 1 - mps[cx]
                        if _SWITCH[st]:
                            mps[cx] = d
                        state[cx] = _NLPS[st]
                    else:
                        d = mps[cx]
                        state[cx] = _NMPS[st]
                ct = reg[2]
                while True:
                    if ct == 0:
                        reg[1] = c
                        bytein()
                        c, ct = reg[1], reg[2]
                    a <<= 1
                    c = (c << 1) & 0xFFFFFFFF
                    ct -= 1
                    if a >= 0x8000:
                        break
                reg[0], reg[1], reg[2] = a, c, ct
                return d

        for _ in range(seg_passes):
            if bpno_plus_one < 1:
                break
            one = 1 << bpno_plus_one
            half = one >> 1
            oph = one | half
            if passtype == 0:       # significance propagation
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if sig[i] or not nbr[i]:
                                continue
                            if raw:
                                if rawbit():
                                    s = rawbit()
                                    val[i] = -oph if s else oph
                                    make_sig(i, y, s)
                            elif mq(zc[nbr[i]]):
                                cx, xb = sign_ctx(i, y)
                                s = mq(cx) ^ xb
                                val[i] = -oph if s else oph
                                make_sig(i, y, s)
                            vis[i] = 1
            elif passtype == 1:     # magnitude refinement
                for y0 in range(0, h, 4):
                    for x in range(w):
                        for y in range(y0, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if not sig[i] or vis[i]:
                                continue
                            if raw:
                                v = rawbit()
                            else:
                                v = mq(CTX_MAG + 2 if refd[i] else
                                       (CTX_MAG + 1 if nbr[i] else CTX_MAG))
                            val[i] += half if v ^ (val[i] < 0) else -half
                            refd[i] = 1
            else:                   # cleanup
                for y0 in range(0, h, 4):
                    full = y0 + 4 <= h
                    for x in range(w):
                        i0 = (y0 + 1) * W + x + 1
                        start = y0
                        if full and not (
                                sig[i0] | vis[i0] | nbr[i0]
                                | sig[i0 + W] | vis[i0 + W] | nbr[i0 + W]
                                | sig[i0 + 2 * W] | vis[i0 + 2 * W]
                                | nbr[i0 + 2 * W] | sig[i0 + 3 * W]
                                | vis[i0 + 3 * W] | nbr[i0 + 3 * W]):
                            if not mq(CTX_AGG):
                                continue
                            r = mq(CTX_UNI) << 1
                            r |= mq(CTX_UNI)
                            y = y0 + r
                            i = i0 + r * W
                            cx, xb = sign_ctx(i, y)
                            s = mq(cx) ^ xb
                            val[i] = -oph if s else oph
                            make_sig(i, y, s)
                            start = y + 1
                        for y in range(start, min(y0 + 4, h)):
                            i = (y + 1) * W + x + 1
                            if sig[i] or vis[i]:
                                continue
                            if mq(zc[nbr[i]]):
                                cx, xb = sign_ctx(i, y)
                                s = mq(cx) ^ xb
                                val[i] = -oph if s else oph
                                make_sig(i, y, s)
                if job.style & SEGSYM:
                    for _k in range(4):
                        mq(CTX_UNI)
                vis = [0] * n
            if job.style & RESET and not raw:
                state[:], mps[:] = _initial_contexts()
            passtype += 1
            if passtype == 3:
                passtype = 0
                bpno_plus_one -= 1
    out = np.array(val, np.int64).reshape(h + 2, W)[1:-1, 1:-1]
    out = out.astype(np.int32)
    if job.roishift:
        if job.roishift >= 31:
            out[...] = 0
        else:
            mag = np.abs(out)
            big = mag >= (1 << job.roishift)
            out = np.where(big, np.sign(out) * (mag >> job.roishift), out)
            out = out.astype(np.int32)
    return out


def store_block(job: BlockJob, coef: np.ndarray) -> None:
    """Write tier 1's output into the tile-component: halved toward zero
    (5/3) or times the band's half step in float32 (9/7), as openjpeg's
    opj_t1_clbl_decode_processor does."""
    if job.reversible:
        job.out[...] = (coef + (coef < 0)) >> 1
    else:
        job.out[...] = coef.astype(np.float32) * np.float32(job.stepsize)


def decode_blocks_plain(jobs: Sequence[BlockJob]) -> None:
    for job in jobs:
        store_block(job, t1_decode_plain(job))


# ---------------------------------------------------------------- wavelets

_ALPHA, _BETA = np.float32(-1.586134342), np.float32(-0.052980118)
_GAMMA, _DELTA = np.float32(0.882911075), np.float32(0.443506852)
_K, _TWO_INV_K = np.float32(1.230174105), np.float32(1.625732422)


def _mirror(x: np.ndarray) -> np.ndarray:
    """``x`` (length >= 2 along axis 0) with one sample of whole-sample
    symmetric extension at each end."""
    return np.concatenate([x[1:2], x, x[-2:-1]])


def _idwt53_1d(a: np.ndarray, sn: int, dn: int, cas: int) -> np.ndarray:
    """Inverse 5/3 lifting (F.3.8) along axis 0 of ``a`` (the low half,
    then the high half); the low samples sit at even positions of the
    signal when ``cas`` is 0.  Returns the interleaved int32 signal."""
    n = sn + dn
    x = np.empty((n,) + a.shape[1:], np.int64)
    x[cas::2] = a[:sn]
    x[1 - cas::2] = a[sn:n]
    if n == 1:
        if cas:     # openjpeg halves a lone odd sample toward zero
            x[0] = (x[0] + (x[0] < 0)) >> 1
        return x.astype(np.int32)
    p = _mirror(x)
    x[cas::2] -= (p[cas:n:2] + p[cas + 2::2] + 2) >> 2
    p = _mirror(x)
    x[1 - cas::2] += (p[1 - cas:n:2] + p[3 - cas::2]) >> 1
    return x.astype(np.int32)


def _lift97(x: np.ndarray, a: int, b: int, sn: int, dn: int) -> None:
    """openjpeg 2.5's opj_v8dwt_decode on axis 0 of the interleaved
    float32 ``x``: the scalings, then the four lifting steps, each sample
    updated as w[-1] + (l + w) * c, the edge as w[-1] + l * (c + c)."""
    x[a::2][:sn] *= _K
    x[b::2][:dn] *= _TWO_INV_K

    def step(start_l, n_l, m, c):
        # samples t = start_l + 2 i (i < n_l) get their two neighbours
        c = np.float32(c)
        imax = min(n_l, m)
        if imax > 0:
            t = start_l + 2 * np.arange(imax)
            left = np.where(t - 1 < 0, t + 1, t - 1)
            x[t] = x[t] + (x[left] + x[t + 1]) * c
        if m < n_l:
            t = start_l + 2 * m
            x[t] = x[t] + x[t - 1] * (c + c)

    # step2(l = wavelet + b, w = wavelet + a + 1, n = sn, m): the samples
    # at a + 2 i, their neighbours at a + 2 i - 1 and a + 2 i + 1
    step(a, sn, min(sn, dn - a), -_DELTA)
    step(b, dn, min(dn, sn - b), -_GAMMA)
    step(a, sn, min(sn, dn - a), -_BETA)
    step(b, dn, min(dn, sn - b), -_ALPHA)


def _idwt97_1d(a: np.ndarray, sn: int, dn: int, cas: int) -> np.ndarray:
    n = sn + dn
    x = np.empty((n,) + a.shape[1:], np.float32)
    x[cas::2][:sn] = a[:sn]
    x[1 - cas::2][:dn] = a[sn:n]
    if cas == 0:
        if not (dn > 0 or sn > 1):
            return x
        _lift97(x, 0, 1, sn, dn)
    else:
        if not (sn > 0 or dn > 1):
            return x
        _lift97(x, 1, 0, sn, dn)
    return x


def idwt_plain(data: np.ndarray, tc: TileComp) -> None:
    """Inverse DWT of one tile-component in place (openjpeg
    opj_dwt_decode_tile / opj_dwt_decode_tile_97): ``data`` int32 (5/3) or
    float32 (9/7) [h, w] in the subband layout, each level's rows first,
    then its columns."""
    res = tc.resolutions
    f = _idwt53_1d if tc.coding.reversible else _idwt97_1d
    for r in range(1, len(res)):
        lo, cur = res[r - 1], res[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        sw, sh = lo.x1 - lo.x0, lo.y1 - lo.y0
        if rw == 0 or rh == 0:
            continue
        blk = data[:rh, :rw]
        blk[...] = f(blk.T, sw, rw - sw, cur.x0 % 2).T
        blk[...] = f(blk, sh, rh - sh, cur.y0 % 2)


# ---------------------------------------------------------------- decoding

def _copy_defaults(d: Defaults) -> Defaults:
    return Defaults(d.progression, d.layers, d.mct, d.sop, d.eph, d.cod,
                    dict(d.coc), d.qcd, dict(d.qcc), dict(d.roi),
                    list(d.pocs))


@dataclass
class Tile:
    index: int
    bounds: Tuple[int, int, int, int]
    params: Defaults
    comps: List[TileComp]
    jobs: List[BlockJob]
    planes: List[np.ndarray]


def _ppm_headers(stream: Codestream) -> Optional[List[bytes]]:
    """The packed packet headers of each tile-part, in codestream order."""
    if stream.ppm is None:
        return None
    out, pos, ppm = [], 0, stream.ppm
    for _tp in stream.tile_parts:
        if pos + 4 > len(ppm):
            raise ValueError("JPEG 2000: PPM holds fewer tile-parts than the "
                             "codestream")
        (n,) = struct.unpack_from(">I", ppm, pos)
        out.append(ppm[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def prepare_tiles(stream: Codestream) -> List[Tile]:
    """Parse every tile's packets (tier 2) into the code-block jobs of
    tier 1, with a zeroed workspace per tile-component for them."""
    siz = stream.siz
    nc = siz.ncomp
    ppm = _ppm_headers(stream)
    by_tile: Dict[int, List[Tuple[TilePart, Optional[bytes]]]] = {}
    for k, tp in enumerate(stream.tile_parts):
        by_tile.setdefault(tp.index, []).append(
            (tp, ppm[k] if ppm is not None else None))
    tiles = []
    for t in sorted(by_tile):
        parts = sorted(by_tile[t], key=lambda e: e[0].part)
        params = _copy_defaults(stream.main)
        ppt = {}
        for tp, _h in parts:
            for m, b in tp.markers:
                if m == PPT:
                    ppt[(tp.part, b[0])] = b[1:]
                elif m in (COD, COC, QCD, QCC, RGN, POC):
                    _apply_marker(params, m, b, nc)
                elif m in (PLT, COM) or 0xFF30 <= m <= 0xFF3F:
                    continue
                else:
                    raise ValueError(f"JPEG 2000: marker {m:04X} in a "
                                     "tile-part header")
        if params.mct == 2:
            raise NotImplementedError("JPEG 2000: a Part-2 multiple "
                                      "component transform")
        bounds = tile_bounds(siz, t)
        comps, mb = [], {}
        for c in range(nc):
            coding = params.coc.get(c, params.cod)
            quant = params.qcc.get(c, params.qcd)
            tc = build_tilecomp(*bounds, coding, quant, params.roi.get(c, 0))
            comps.append(tc)
            for r in tc.resolutions:
                for band in r.bands:
                    e, _m = quant.step(band.step_index)
                    mb[(c, band.step_index)] = quant.guard + e - 1
        if ppm is not None:
            headers = b"".join(h for _tp, h in parts)
        elif ppt:
            headers = b"".join(ppt[k] for k in sorted(ppt))
        else:
            headers = None
        hdr = BitReader(headers) if headers is not None else None
        data = b"".join(tp.data for tp, _h in parts)
        pos = 0
        for l, r, c, p in packet_order(comps, bounds, params.layers,
                                       params.progression, params.pocs):
            if hdr is None and pos >= len(data):
                break
            pos = _read_packet(comps, c, r, p, l, data, pos, hdr,
                               params.sop, params.eph, mb)
        tiles.append(_tile_jobs(t, bounds, params, comps, siz, mb))
    return tiles


def _tile_jobs(t, bounds, params, comps, siz, mb) -> Tile:
    jobs, planes = [], []
    for c, tc in enumerate(comps):
        w, h = tc.x1 - tc.x0, tc.y1 - tc.y0
        plane = np.zeros((h, w), np.int32 if tc.coding.reversible
                         else np.float32)
        planes.append(plane)
        for r, res in enumerate(tc.resolutions):
            low = tc.resolutions[r - 1] if r else None
            for band in res.bands:
                if band.empty:
                    continue
                e, m = tc.quant.step(band.step_index)
                step = np.float32((1.0 + m / 2048.0)
                                  * 2.0 ** (siz.prec[c] - e))
                half = float(np.float32(0.5) * step)
                ox = (low.x1 - low.x0) if band.number & 1 else 0
                oy = (low.y1 - low.y0) if band.number & 2 else 0
                for prc in band.precincts:
                    for blk in prc.blocks:
                        if not blk.segs:
                            continue
                        x = blk.x0 - band.x0 + ox
                        y = blk.y0 - band.y0 + oy
                        bpno = tc.roi + blk.numbps
                        if bpno >= 31:
                            raise ValueError(
                                f"JPEG 2000: {bpno} bit-planes in a "
                                "code-block")
                        jobs.append(BlockJob(
                            b"".join(blk.chunks), [s[0] for s in blk.segs],
                            [s[1] for s in blk.segs], blk.x1 - blk.x0,
                            blk.y1 - blk.y0, band.number, bpno, blk.numbps,
                            tc.roi, tc.coding.style, tc.coding.reversible,
                            half, plane[y:y + blk.y1 - blk.y0,
                                        x:x + blk.x1 - blk.x0]))
    return Tile(t, bounds, params, comps, jobs, planes)


def reconstruct(tile: Tile, siz: Siz, idwt=None) -> List[np.ndarray]:
    """The tile's components as int32 sample values after the inverse
    DWT (``idwt(plane, tilecomp)``, in place), the inverse multiple
    component transform, the DC level shift and the clipping (openjpeg
    tcd.c; its int32 arithmetic)."""
    idwt = idwt or idwt_plain
    for plane, tc in zip(tile.planes, tile.comps):
        idwt(plane, tc)
    planes = list(tile.planes)
    if tile.params.mct == 1 and siz.ncomp >= 3:
        revs = {tc.coding.reversible for tc in tile.comps[:3]}
        if len(revs) > 1:
            raise NotImplementedError("JPEG 2000: a component transform "
                                      "over reversible and irreversible "
                                      "components")
        y, u, v = planes[:3]
        if tile.comps[0].coding.reversible:
            g = u + v
            g >>= 2
            np.subtract(y, g, out=g)
            u += g
            v += g
            planes[:3] = [v, g, u]
        else:
            r = v * np.float32(1.402)
            r += y
            g = u * np.float32(0.34413)
            np.subtract(y, g, out=g)
            g -= v * np.float32(0.71414)
            u *= np.float32(1.772)
            u += y
            planes[:3] = [r, g, u]
    out = []
    for c, (plane, tc) in enumerate(zip(planes, tile.comps)):
        prec, sgn = siz.prec[c], siz.signed[c]
        lo, hi = ((-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if sgn
                  else (0, (1 << prec) - 1))
        dc = 0 if sgn else 1 << (prec - 1)
        if tc.coding.reversible:
            v = plane
            v += dc
        else:
            over, under = plane > np.float32(2 ** 31 - 1), ~(plane >= -2.0 ** 31)
            v = np.rint(np.where(over | under, 0, plane)).astype(np.int64)
            v += dc
            v[over], v[under] = hi, lo
        out.append(np.clip(v, lo, hi, out=v).astype(np.int32, copy=False))
    return out


def pil_pixels(comps: Sequence[np.ndarray], siz: Siz, mode: str
               ) -> np.ndarray:
    """The samples (integers within their precision) as PIL's unpackers
    store them (Pillow Jpeg2KDecode.c j2ku_*): each shifted to the mode's
    8 or 16 bits (rounding on the way down), a signed one offset by
    2**(prec - 1), wrapped to the bits."""
    bits = 16 if mode == "I;16" else 8
    dtype = np.uint16 if bits == 16 else np.uint8
    n = {"L": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    out = np.empty(comps[0].shape + ((n,) if n > 1 else ()), dtype)
    for c, v in enumerate(comps[:n]):
        shift = bits - siz.prec[c]
        off = (1 << (siz.prec[c] - 1)) if siz.signed[c] else 0
        if shift < 0:
            off += 1 << (-shift - 1)
        dst = out[..., c] if n > 1 else out
        if shift == 0 and off == 0:
            dst[...] = v        # already within the mode's bits
            continue
        v = v.astype(np.int32) + off
        if shift < 0:
            v >>= -shift
        else:
            v <<= shift
        v &= (1 << bits) - 1
        dst[...] = v
    return out


def decode(data: bytes, plain: bool = False, n_threads: int = 0
           ) -> np.ndarray:
    """The pixels ``np.asarray(PIL.Image.open(BytesIO(data)))`` gives for a
    JP2 file or a bare codestream: uint8 [H, W] (L), [H, W, 2] (LA),
    [H, W, 3] (RGB), [H, W, 4] (RGBA) or uint16 [H, W] (I;16).  Tier 1
    and the inverse DWT run in C++ (``native.j2k_decode_blocks``,
    ``native.j2k_idwt``, over ``n_threads`` host threads, <= 0: one per
    hardware thread) unless ``plain``."""
    ct = parse_container(data)
    stream = parse_codestream(ct.codestream)
    siz = stream.siz
    mode = pil_mode(ct, siz)
    _check_unpacker(mode, ct, siz)
    tiles = prepare_tiles(stream)
    jobs = [j for t in tiles for j in t.jobs]
    if plain:
        decode_blocks_plain(jobs)
        idwt = idwt_plain
    else:
        from multimodalfusion_tpu_torch import native
        native.j2k_decode_blocks(jobs, n_threads)
        idwt = (lambda plane, tc: native.j2k_idwt(plane, tc, n_threads))
    shape = (siz.height - siz.y0, siz.width - siz.x0)
    if len(tiles) == 1 and tiles[0].bounds == (siz.x0, siz.y0, siz.width,
                                               siz.height):
        return pil_pixels(reconstruct(tiles[0], siz, idwt), siz, mode)
    full = [np.zeros(shape, np.int32) for _ in range(siz.ncomp)]
    for tile in tiles:
        x0, y0, x1, y1 = tile.bounds
        for c, v in enumerate(reconstruct(tile, siz, idwt)):
            full[c][y0 - siz.y0:y1 - siz.y0, x0 - siz.x0:x1 - siz.x0] = v
    return pil_pixels(full, siz, mode)


def read_j2k(path: str, plain: bool = False, rgb: bool = False
             ) -> np.ndarray:
    """The pixels of the JPEG 2000 file at ``path`` (see ``decode``);
    ``rgb=True``: uint8 [H, W, 3] as PIL's ``convert("RGB")`` gives them
    (grey repeated, alpha dropped, I;16 clipped at 255)."""
    with open(path, "rb") as fh:
        px = decode(fh.read(), plain=plain)
    if not rgb:
        return px
    if px.dtype == np.uint16:
        px = np.minimum(px, 255).astype(np.uint8)
    if px.ndim == 2:
        px = px[..., None]
    return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2)
                                if px.shape[2] <= 2 else px[..., :3])


# ---------------------------------------------------------------- encoding

class MQEncoder:
    """The MQ encoder (C.2), with openjpeg's terminations: FLUSH
    (C.2.9) and the predictable ERTERM."""

    def __init__(self, state: List[int], mps: List[int]):
        self.state, self.mps = state, mps
        self.start()

    def start(self) -> None:
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = [0]          # out[-1] is the byte B; out[0] a dummy

    def _byteout(self) -> None:
        out = self.out
        if out[-1] == 0xFF:
            out.append(self.c >> 20)
            self.c &= 0xFFFFF
            self.ct = 7
        elif self.c < 0x8000000:
            out.append(self.c >> 19)
            self.c &= 0x7FFFF
            self.ct = 8
        else:
            out[-1] += 1
            if out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                out.append(self.c >> 20)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def encode(self, cx: int, d: int) -> None:
        st = self.state[cx]
        qe = _QE[st]
        self.a -= qe
        if d == self.mps[cx]:
            if self.a & 0x8000:
                self.c += qe
                return
            if self.a < qe:
                self.a = qe
            else:
                self.c += qe
            self.state[cx] = _NMPS[st]
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if _SWITCH[st]:
                self.mps[cx] = 1 - self.mps[cx]
            self.state[cx] = _NLPS[st]
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def flush(self, erterm: bool) -> bytes:
        """Terminate the codeword; its bytes (a final 0xFF dropped)."""
        if erterm:
            k = 11 - self.ct + 1
            while k > 0:
                self.c <<= self.ct
                self.ct = 0
                self._byteout()
                k -= self.ct
            if self.out[-1] != 0xFF:
                self._byteout()
            return bytes(self.out[1:-1])
        tempc = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        return bytes(self.out[1:] if self.out[-1] != 0xFF else self.out[1:-1])


class RawEncoder:
    """Bypass ("lazy") bits, MSB first, 7 bits in the byte after an 0xFF;
    openjpeg's termination pads with alternating 0, 1 bits."""

    def __init__(self):
        self.out: List[int] = []
        self.c, self.ct = 0, 8

    def bit(self, d: int) -> None:
        self.ct -= 1
        self.c |= d << self.ct
        if self.ct == 0:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0

    def flush(self, erterm: bool) -> bytes:
        full = 7 if self.out and self.out[-1] == 0xFF else 8
        if self.ct < full or (self.ct == 7 and erterm):
            b = 0
            while self.ct > 0:
                self.ct -= 1
                self.c |= b << self.ct
                b = 1 - b
            self.out.append(self.c)
        elif self.out and self.out[-1] == 0xFF:
            self.out.pop()
        return bytes(self.out)


def segment_ends(npasses: int, style: int) -> List[bool]:
    """Whether each coding pass ends a terminated segment (the decoder's
    segmentation, openjpeg t2.c opj_t2_init_seg)."""
    ends = []
    if style & TERMALL:
        ends = [True] * npasses
    elif style & LAZY:
        ends = [i == 9 or (i >= 10 and (i - 10) % 3 != 0)
                for i in range(npasses)]
    else:
        ends = [False] * npasses
    if npasses:
        ends[-1] = True
    return ends


@dataclass
class EncodedBlock:
    data: bytes
    rates: List[int]    # cumulative bytes at the end of each pass
    planes: int         # magnitude bit-planes (ROI shift included)


def t1_encode_plain(coef: np.ndarray, orient: int, style: int
                    ) -> EncodedBlock:
    """Tier 1 of one code-block (every pass of every bit-plane): the
    mirror of ``t1_decode_plain``.  ``coef`` int [h, w], ROI-shifted."""
    h, w = coef.shape
    W = w + 2
    n = W * (h + 2)
    mag = [0] * n
    sgn = [0] * n
    for y in range(h):
        row = coef[y].tolist()
        for x in range(w):
            v = int(row[x])
            mag[(y + 1) * W + x + 1] = -v if v < 0 else v
            sgn[(y + 1) * W + x + 1] = 1 if v < 0 else 0
    planes = max(mag).bit_length() if n else 0
    if planes == 0:
        return EncodedBlock(b"", [], 0)
    if planes >= 31:
        raise ValueError(f"JPEG 2000: {planes} bit-planes in a code-block")
    sig = [0] * n
    nbr = [0] * n
    vis = [0] * n
    refd = [0] * n
    zc = ZC[orient]
    vsc = bool(style & VSC)
    erterm = bool(style & PTERM)
    state, mps = _initial_contexts()
    mq = MQEncoder(state, mps)
    raw = None
    npasses = 3 * planes - 2
    ends = segment_ends(npasses, style)
    data = bytearray()
    rates = []

    def make_sig(i, y):
        sig[i] = 1
        nbr[i - 1] += 1
        nbr[i + 1] += 1
        nbr[i + W] += 3
        nbr[i + W - 1] += 9
        nbr[i + W + 1] += 9
        if not (vsc and (y & 3) == 0):
            nbr[i - W] += 3
            nbr[i - W - 1] += 9
            nbr[i - W + 1] += 9

    def sign_ctx(i, y):
        hc = (sig[i - 1] * (1 - 2 * sgn[i - 1])
              + sig[i + 1] * (1 - 2 * sgn[i + 1]))
        vc = sig[i - W] * (1 - 2 * sgn[i - W])
        if not (vsc and (y & 3) == 3):
            vc += sig[i + W] * (1 - 2 * sgn[i + W])
        hc = 1 if hc > 0 else (-1 if hc < 0 else 0)
        vc = 1 if vc > 0 else (-1 if vc < 0 else 0)
        return SC[(hc + 1) * 3 + vc + 1]

    def code_sign(i, y):
        cx, xb = sign_ctx(i, y)
        mq.encode(cx, sgn[i] ^ xb)

    p = planes
    passtype = 2
    for k in range(npasses):
        is_raw = bool(style & LAZY) and passtype < 2 and p <= planes - 4
        if is_raw and raw is None:
            raw = RawEncoder()
        b = p - 1
        if passtype == 0:
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if sig[i] or not nbr[i]:
                            continue
                        bit = (mag[i] >> b) & 1
                        if is_raw:
                            raw.bit(bit)
                            if bit:
                                raw.bit(sgn[i])
                                make_sig(i, y)
                        else:
                            mq.encode(zc[nbr[i]], bit)
                            if bit:
                                code_sign(i, y)
                                make_sig(i, y)
                        vis[i] = 1
        elif passtype == 1:
            for y0 in range(0, h, 4):
                for x in range(w):
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if not sig[i] or vis[i]:
                            continue
                        bit = (mag[i] >> b) & 1
                        if is_raw:
                            raw.bit(bit)
                        else:
                            mq.encode(CTX_MAG + 2 if refd[i] else
                                      (CTX_MAG + 1 if nbr[i] else CTX_MAG),
                                      bit)
                        refd[i] = 1
        else:
            for y0 in range(0, h, 4):
                full = y0 + 4 <= h
                for x in range(w):
                    i0 = (y0 + 1) * W + x + 1
                    start = y0
                    if full and not any(sig[i0 + r * W] | vis[i0 + r * W]
                                        | nbr[i0 + r * W] for r in range(4)):
                        bits = [(mag[i0 + r * W] >> b) & 1 for r in range(4)]
                        if not any(bits):
                            mq.encode(CTX_AGG, 0)
                            continue
                        mq.encode(CTX_AGG, 1)
                        r = bits.index(1)
                        mq.encode(CTX_UNI, r >> 1)
                        mq.encode(CTX_UNI, r & 1)
                        i = i0 + r * W
                        code_sign(i, y0 + r)
                        make_sig(i, y0 + r)
                        start = y0 + r + 1
                    for y in range(start, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if sig[i] or vis[i]:
                            continue
                        bit = (mag[i] >> b) & 1
                        mq.encode(zc[nbr[i]], bit)
                        if bit:
                            code_sign(i, y)
                            make_sig(i, y)
            if style & SEGSYM:
                for bit in (1, 0, 1, 0):
                    mq.encode(CTX_UNI, bit)
            vis = [0] * n
        if style & RESET and not is_raw:
            state[:], mps[:] = _initial_contexts()
        if ends[k]:
            if is_raw:
                data += raw.flush(erterm)
                raw = None
            else:
                data += mq.flush(erterm)
                mq.start()
            rates.append(len(data))
        else:
            pending = len(raw.out) if is_raw else len(mq.out) - 1
            rates.append(len(data) + pending + (0 if is_raw else 2))
        passtype += 1
        if passtype == 3:
            passtype = 0
            p -= 1
    return EncodedBlock(bytes(data), clip_rates(rates, ends), planes)


def clip_rates(rates: List[int], ends: List[bool]) -> List[int]:
    """Truncation points no later than their segment's end, and
    non-decreasing."""
    out = list(rates)
    seg_end = out[-1] if out else 0
    for k in range(len(out) - 1, -1, -1):
        if ends[k]:
            seg_end = out[k]
        out[k] = min(out[k], seg_end)
    for k in range(1, len(out)):
        out[k] = max(out[k], out[k - 1])
    return out


def _fdwt53_1d(x: np.ndarray, cas: int) -> np.ndarray:
    """Forward 5/3 lifting (F.4.8.2) along axis 0; returns the low samples
    followed by the high ones."""
    n = x.shape[0]
    x = x.astype(np.int32)
    if n == 1:
        return x * 2 if cas else x
    p = _mirror(x)
    x[1 - cas::2] -= (p[1 - cas:n:2] + p[3 - cas::2]) >> 1
    p = _mirror(x)
    x[cas::2] += (p[cas:n:2] + p[cas + 2::2] + 2) >> 2
    return np.concatenate([x[cas::2], x[1 - cas::2]])


def fdwt_53(data: np.ndarray, tc: TileComp) -> None:
    """Forward 5/3 DWT of one tile-component in place (int32 [h, w] to the
    subband layout): each level's columns, then its rows."""
    res = tc.resolutions
    for r in range(len(res) - 1, 0, -1):
        cur = res[r]
        rw, rh = cur.x1 - cur.x0, cur.y1 - cur.y0
        if rw == 0 or rh == 0:
            continue
        blk = data[:rh, :rw]
        blk[...] = _fdwt53_1d(blk, cur.y0 % 2)
        blk[...] = _fdwt53_1d(blk.T, cur.x0 % 2).T


class BitWriter:
    """openjpeg's opj_bio writer: a 0 bit stuffed after each 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.ct = 0, 8

    def bit(self, b: int) -> None:
        if self.ct == 0:
            self.out.append(self.c)
            self.ct = 7 if self.c == 0xFF else 8
            self.c = 0
        self.ct -= 1
        self.c |= b << self.ct

    def bits(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1)

    def flush(self) -> bytes:
        self.out.append(self.c)
        if self.c == 0xFF:
            self.out.append(0)
        return bytes(self.out)


def _put_numpasses(bw: BitWriter, n: int) -> None:
    if n == 1:
        bw.bit(0)
    elif n == 2:
        bw.bits(2, 2)
    elif n <= 5:
        bw.bits(0xC | (n - 3), 4)
    elif n <= 36:
        bw.bits(0x1E0 | (n - 6), 9)
    else:
        bw.bits(0xFF80 | (n - 37), 16)


def _box(typ: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), typ) + body


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">HH", marker, len(body) + 2) + body


def encoder_samples(img: np.ndarray, prec: Optional[int], signed: bool
                    ) -> Tuple[np.ndarray, int]:
    """int32 [H, W, C] samples of ``img`` ([H, W] or [H, W, C]) and their
    precision (uint8: 8, otherwise 16 unless ``prec``), checked against
    the ``prec``-bit range, unsigned or two's-complement ``signed``."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or 0 in img.shape:
        raise ValueError(f"the encoder takes [H, W] or [H, W, C]; got "
                         f"{img.shape}")
    if prec is None:
        prec = 8 if img.dtype == np.uint8 else 16
    if not 1 <= prec <= 16:
        raise ValueError(f"precision {prec}")
    lo, hi = ((-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed
              else (0, (1 << prec) - 1))
    if int(img.min()) < lo or int(img.max()) > hi:
        raise ValueError(f"samples outside {prec}-bit "
                         f"{'signed' if signed else 'unsigned'} range")
    return img.astype(np.int32), prec


def lossless_quant(prec: int, levels: int) -> Quant:
    """QCD of a 5/3 codestream: no quantization, two guard bits, each
    band's exponent its nominal range (openjpeg's default)."""
    gains = [0] + [1, 1, 2] * levels
    return Quant(0, 2, [(prec + gains[b], 0) for b in range(3 * levels + 1)])


def transform_tiles(vals: np.ndarray, siz: Siz, coding: Coding,
                    quant: Quant, mct: bool) -> list:
    """(index, bounds, components, planes) of each tile: its samples
    DC-shifted, the RCT on the first three components when ``mct``, and
    each component's forward 5/3 DWT in the subband layout."""
    tiles = []
    ntx, nty = siz.ntiles
    prec, signed = siz.prec[0], siz.signed[0]
    for t in range(ntx * nty):
        x0, y0, x1, y1 = tile_bounds(siz, t)
        smp = vals[y0 - siz.y0:y1 - siz.y0, x0 - siz.x0:x1 - siz.x0]
        if not signed:
            smp = smp - (1 << (prec - 1))
        planes = [smp[..., c].copy() for c in range(siz.ncomp)]
        if mct:
            r_, g_, b_ = planes[:3]
            planes[:3] = [(r_ + 2 * g_ + b_) >> 2, b_ - g_, r_ - g_]
        comps = []
        for c in range(siz.ncomp):
            tc = build_tilecomp(x0, y0, x1, y1, coding, quant, 0)
            fdwt_53(planes[c], tc)
            comps.append(tc)
        tiles.append((t, (x0, y0, x1, y1), comps, planes))
    return tiles


def block_jobs(tiles: list) -> list:
    """[tile, component, band, block, coefficients, in resolution 0] of
    each code-block of ``transform_tiles``' output, in codestream order."""
    jobs = []
    for t, _bounds, comps, planes in tiles:
        for c, tc in enumerate(comps):
            for r, res in enumerate(tc.resolutions):
                low = tc.resolutions[r - 1] if r else None
                for band in res.bands:
                    if band.empty:
                        continue
                    oxb = (low.x1 - low.x0) if band.number & 1 else 0
                    oyb = (low.y1 - low.y0) if band.number & 2 else 0
                    for prc in band.precincts:
                        for blk in prc.blocks:
                            x = blk.x0 - band.x0 + oxb
                            y = blk.y0 - band.y0 + oyb
                            coef = planes[c][y:y + blk.y1 - blk.y0,
                                             x:x + blk.x1 - blk.x0]
                            jobs.append([t, c, band, blk, coef, r == 0])
    return jobs


def tier1_encode(jobs: list, tiles: list, quant: Quant, style: int,
                 layers: int, plain: bool = False, n_threads: int = 0
                 ) -> None:
    """Tier 1 of every code-block of ``block_jobs`` (in C++ through
    ``native.j2k_encode_blocks`` unless ``plain``), each block's passes
    shared evenly among ``layers``."""
    coefs = [np.ascontiguousarray(j[4], np.int32) for j in jobs]
    orients = [j[2].number for j in jobs]
    if plain:
        enc = [t1_encode_plain(cf, o, style) for cf, o in zip(coefs, orients)]
    else:
        from multimodalfusion_tpu_torch import native
        enc = native.j2k_encode_blocks(coefs, orients, style, n_threads)
    for j, e in zip(jobs, enc):
        blk = j[3]
        blk.enc = e
        mb = quant.guard + quant.steps[j[2].step_index][0] - 1
        roishift = tiles[j[0]][2][j[1]].roi
        blk.zero_planes = mb + roishift - e.planes
        if blk.zero_planes < 0:
            raise ValueError("a code-block has more bit-planes than its "
                             "band's quantization allows")
        n = len(e.rates)
        blk.layer_end = [round((l + 1) * n / layers) for l in range(layers)]


def tile_packets(comps: Sequence[TileComp], bounds, layers: int,
                 progression: int, pocs=()) -> List[Tuple[bytes, bytes]]:
    """(header, body) of each packet of one tile, in its progression
    order (POC included), after ``tier1_encode``."""
    for tc in comps:
        for res in tc.resolutions:
            for band in res.bands:
                for prc in band.precincts:
                    for k, blk in enumerate(prc.blocks):
                        first = next((l for l, e in enumerate(blk.layer_end)
                                      if e > 0), 999)
                        prc.incl.set_leaf(k, first)
                        prc.imsb.set_leaf(k, blk.zero_planes)
                        blk.done = 0
    return [_write_packet(comps[c], r, p, l)
            for l, r, c, p in packet_order(comps, bounds, layers,
                                           progression, pocs)]


def main_header(siz: Siz, coding: Coding, quant: Quant, progression: int,
                layers: int, mct: bool, scod: int = 0) -> bytes:
    """SIZ, COD and QCD of a lossless codestream (``scod`` & 1: the
    precinct sizes of ``coding`` follow)."""
    nc = siz.ncomp
    ssiz = (siz.prec[0] - 1) | (0x80 if siz.signed[0] else 0)
    out = _segment(SIZ, struct.pack(">HIIIIIIIIH", 0, siz.width, siz.height,
                                    siz.x0, siz.y0, siz.tw, siz.th, siz.tx0,
                                    siz.ty0, nc)
                   + bytes([ssiz, 1, 1]) * nc)
    out += _segment(COD, bytes([scod, progression])
                    + struct.pack(">HB", layers, int(mct))
                    + bytes([coding.levels, coding.cbw - 2, coding.cbh - 2,
                             coding.style, 1])
                    + (bytes(x | (y << 4) for x, y in coding.precincts)
                       if scod & 1 else b""))
    return out + _segment(QCD, bytes([quant.guard << 5])
                          + bytes(e << 3 for e, _ in quant.steps))


def jp2_file(cs: bytes, siz: Siz) -> bytes:
    """The JP2 boxes openjpeg writes around a codestream: signature,
    ftyp, jp2h (ihdr, colr: sRGB from three components, else grey),
    jp2c."""
    nc = siz.ncomp
    ihdr = struct.pack(">IIHBBBB", siz.height - siz.y0, siz.width - siz.x0,
                       nc, (siz.prec[0] - 1) | (0x80 if siz.signed[0] else 0),
                       7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, 16 if nc >= 3 else 17)
    return (JP2_SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", _box(b"ihdr", ihdr) + _box(b"colr", colr))
            + _box(b"jp2c", cs))


def encode(img: np.ndarray, prec: Optional[int] = None, signed: bool = False,
           plain: bool = False, n_threads: int = 0) -> bytes:
    """A lossless (5/3) JP2 file of ``img``: [H, W] (grey) or [H, W, 3]
    (RGB, through the RCT) integer samples of ``prec`` bits (uint8: 8,
    otherwise 16 by default), unsigned or two's-complement ``signed``.
    The settings are openjpeg's defaults, which PIL's ``write_ct_slice``
    write gets: one tile, one layer, LRCP, 5 levels, 64 x 64 code-blocks,
    style 0, two guard bits.  Tier 1 runs in C++
    (``native.j2k_encode_blocks``, over ``n_threads`` host threads, <= 0:
    one per hardware thread) unless ``plain``."""
    vals, prec = encoder_samples(img, prec, signed)
    h, w, nc = vals.shape
    if nc not in (1, 3):
        raise ValueError(f"encode takes [H, W] or [H, W, 3]; got "
                         f"{np.shape(img)}")
    siz = Siz(w, h, 0, 0, w, h, 0, 0, [prec] * nc, [signed] * nc)
    coding = Coding(5, 6, 6, 0, True, [(15, 15)] * 6)
    quant = lossless_quant(prec, coding.levels)
    tiles = transform_tiles(vals, siz, coding, quant, nc == 3)
    tier1_encode(block_jobs(tiles), tiles, quant, 0, 1, plain, n_threads)
    (_t, bounds, comps, _planes), = tiles
    tp = struct.pack(">H", SOD) + b"".join(
        hd + bd for hd, bd in tile_packets(comps, bounds, 1, 0))
    cs = (struct.pack(">H", SOC)
          + main_header(siz, coding, quant, 0, 1, nc == 3)
          + struct.pack(">HHHIBB", SOT, 10, 0, 12 + len(tp), 0, 1) + tp
          + struct.pack(">H", EOC))
    return jp2_file(cs, siz)


def _write_packet(tc: TileComp, r: int, p: int, layer: int
                  ) -> Tuple[bytes, bytes]:
    """(header, body) of one packet, the mirror of ``_read_packet``."""
    res = tc.resolutions[r]
    bw = BitWriter()
    body = bytearray()
    todo = []
    for band in res.bands:
        if band.empty:
            continue
        prc = band.precincts[p]
        for k, blk in enumerate(prc.blocks):
            todo.append((prc, k, blk, blk.layer_end[layer] - blk.done))
    if not any(n for *_, n in todo):
        bw.bit(0)
    else:
        bw.bit(1)
        for prc, k, blk, n in todo:
            if not blk.included:
                prc.incl.encode(bw, k, layer + 1)
                if not n:
                    continue
                prc.imsb.encode(bw, k, 999)
                blk.included = True
                blk.lblock = 3
            else:
                bw.bit(1 if n else 0)
                if not n:
                    continue
            _put_numpasses(bw, n)
            e = blk.enc
            ends = segment_ends(len(e.rates), tc.coding.style)
            pieces = []         # (passes, bytes) per segment touched
            a = blk.done
            while a < blk.done + n:
                b = a
                while b < blk.done + n - 1 and not ends[b]:
                    b += 1
                start = e.rates[a - 1] if a else 0
                pieces.append((b - a + 1, start, e.rates[b]))
                a = b + 1
            need = max(max(end - st, 1).bit_length() - (np_.bit_length() - 1)
                       for np_, st, end in pieces)
            inc = max(0, need - blk.lblock)
            for _ in range(inc):
                bw.bit(1)
            bw.bit(0)
            blk.lblock += inc
            for np_, st, end in pieces:
                bw.bits(end - st, blk.lblock + np_.bit_length() - 1)
                body += e.data[st:end]
            blk.done += n
    return bw.flush(), bytes(body)
