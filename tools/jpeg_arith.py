"""Arithmetic-coded and lossless JPEG for test streams: what the port's
decoder (``multimodalfusion_tpu_torch.utils.jpeg``) reads and PIL cannot
be asked to write, so that the tests, ``tools/make_jpeg_fixtures.py``
and ``chip_smoke.py`` can hold the decoder to PIL (or, on a machine
without PIL, to the Huffman stream of the same coefficients).

``encode`` codes quantised DCT coefficients (``jpeg_writer``'s
``Coefficients``: read from a stream, made from planes, or a whole
slide's) with T.81's arithmetic coder, as ``jpegtran -arithmetic`` does
(libjpeg-turbo's jcarith.c): SOF9 (one sequential scan) or SOF10 (any of
``jpeg_writer``'s progressive scan scripts: DC first and refinement, AC
spectral selection and successive approximation), a DAC segment before
each scan (T.81's default conditioning, or the caller's), restart
intervals, 1, 3 or 4 components (CMYK, or YCCK under an Adobe marker).
The statistics bins belong to the table numbers, as in libjpeg: the
first and fourth components use table 0, the others table 1.
``processes`` codes the restart intervals at once in forked worker
processes (no CUDA in them), as ``chip_smoke.py`` does for a slide.

``encode_lossless`` writes Huffman-coded lossless frames (SOF3) of 1, 3
or 4 components of 2..16-bit samples (PIL reads only 8): any predictor
1..7, a point transform, interleaved or one scan a component, restart
intervals of whole MCU rows, optimal Huffman tables.

Loaded by file path (``importlib.util.spec_from_file_location``); the
package never imports it.  As a script it codes a stream's
coefficients, or those ``jpeg.encode_jpeg`` gives a uint8 RGB image
saved with ``numpy.save`` (``--rgb``), in arithmetic coding:

    python tools/jpeg_arith.py IN.jpg|IN.npy OUT.jpg [--rgb] \
        [--progressive] [--restart N] [--processes N]
"""
import argparse
import concurrent.futures
import importlib.util
import multiprocessing
import os
import struct
import sys
import types
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from multimodalfusion_tpu_torch.utils import jpeg  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jpeg_writer", os.path.join(ROOT, "tools", "jpeg_writer.py"))
writer = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(writer)

Coefficients = writer.Coefficients
ARITAB = jpeg._ARITAB


class _Coder:
    """jcarith.c's arith_encode and finish_pass: the QM coder's C and A
    registers, the stacked 0xFF bytes (sc) and the pending zero bytes
    (zc), dropped at the end ("Pacman" termination)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _flush_zeros(self):
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0

    def _byte(self, b):
        self.out.append(b)
        if b == 0xFF:
            self.out.append(0)

    def encode(self, st, i, val):
        sv = st[i]
        e = ARITAB[sv & 0x7F]
        qe = e >> 16
        a = self.a - qe
        if val != sv >> 7:
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ (e & 0xFF)
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ ((e >> 8) & 0xFF)
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._byte(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._settle()
                    self.buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def _settle(self):
        """The buffered byte and the stacked 0xFF bytes, which can no
        longer overflow."""
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._flush_zeros()
            self._byte(self.buffer)
        if self.sc:
            self._flush_zeros()
            self.out += b"\xff\x00" * self.sc
            self.sc = 0

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._byte(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            self._settle()
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._byte((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._byte((self.c >> 11) & 0xFF)
        return bytes(self.out)


def _magnitude(enc, st, at, v, k_low, k_high):
    """Figures F.8 and F.9: the category of v (the magnitude less one)
    and its bits, from bin ``at``; AC (``k_low`` set) takes its second
    decision at ``at`` too and then bins 189 or 217, DC bins 20."""
    m = 0
    if v:
        enc.encode(st, at, 1)
        m = 1
        v2 = v >> 1
        if k_low is None:
            at = 20
            while v2:
                enc.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        elif v2:
            enc.encode(st, at, 1)
            m = 2
            at = 189 if k_low <= k_high else 217
            v2 >>= 1
            while v2:
                enc.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
    enc.encode(st, at, 0)
    at += 14
    m >>= 1
    while m:
        enc.encode(st, at, 1 if m & v else 0)
        m >>= 1


def _dc(enc, stats, ctx, last, k, value, L, U):
    """Figure F.4 with the conditioning of F.1.4.4.1.2: the difference of
    ``value`` from the component's last DC."""
    st = stats
    at = ctx[k]
    v = value - last[k]
    if v == 0:
        enc.encode(st, at, 0)
        ctx[k] = 0
        return
    last[k] = value
    enc.encode(st, at, 1)
    sign = v < 0
    enc.encode(st, at + 1, int(sign))
    v = -v if sign else v
    at += 3 if sign else 2
    # the category, for the context
    m = 0
    if v - 1:
        m = 1 << ((v - 1).bit_length() - 1)
    _magnitude(enc, st, at, v - 1, None, 0)
    if m < (1 << L) >> 1:
        ctx[k] = 0
    elif m > (1 << U) >> 1:
        ctx[k] = 12 + 4 * sign
    else:
        ctx[k] = 4 + 4 * sign


def _ac(enc, st, fixed, zz, ss, se, al, K):
    """Figure F.5 over zigzag ss..se of one block (``zz``, point
    transform al): EOB decisions, zero runs, signs and magnitudes."""
    ke = se
    while ke > 0 and (abs(zz[ke]) >> al) == 0:
        ke -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        enc.encode(st, at, 0)
        while True:
            c = zz[k]
            m = (c if c >= 0 else -c) >> al
            if m:
                enc.encode(st, at + 1, 1)
                enc.encode(fixed, 0, int(c < 0))
                break
            enc.encode(st, at + 1, 0)
            at += 3
            k += 1
        _magnitude(enc, st, at + 2, m - 1, k, K)
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _ac_refine(enc, st, fixed, zz, ss, se, al):
    """Figure G.10 (jcarith.c's encode_mcu_AC_refine): bit al of zigzag
    ss..se of one block."""
    ke = se
    while ke > 0 and (abs(zz[ke]) >> al) == 0:
        ke -= 1
    kex = ke
    while kex > 0 and (abs(zz[kex]) >> (al + 1)) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        at = 3 * (k - 1)
        if k > kex:
            enc.encode(st, at, 0)
        while True:
            c = zz[k]
            m = (c if c >= 0 else -c) >> al
            if m:
                if m >> 1:
                    enc.encode(st, at + 2, m & 1)
                else:
                    enc.encode(st, at + 1, 1)
                    enc.encode(fixed, 0, int(c < 0))
                break
            enc.encode(st, at + 1, 0)
            at += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(st, 3 * (k - 1), 1)


def _interval(job) -> bytes:
    """One restart interval of a scan: the blocks [n, 64] (zigzag) in
    coding order, each block's scan component, the scan's parameters and
    each scan component's (DC table, AC table) and (L, U, K)."""
    blocks, comp, progressive, ss, se, ah, al, tbl, cond = job
    enc = _Coder()
    dc_stats = {t: bytearray(64) for t, _ in tbl}
    ac_stats = {t: bytearray(256) for _, t in tbl}
    fixed = bytearray([113])
    ncomp = len(tbl)
    last, ctx = [0] * ncomp, [0] * ncomp
    for zz, k in zip(blocks.tolist(), comp.tolist()):
        dt, at = tbl[k]
        L, U, K = cond[k]
        if not progressive:
            _dc(enc, dc_stats[dt], ctx, last, k, zz[0], L, U)
            _ac(enc, ac_stats[at], fixed, zz, 1, 63, 0, K)
        elif ss == 0 and ah == 0:
            _dc(enc, dc_stats[dt], ctx, last, k, zz[0] >> al, L, U)
        elif ss == 0:
            enc.encode(fixed, 0, (zz[0] >> al) & 1)
        elif ah == 0:
            _ac(enc, ac_stats[at], fixed, zz, ss, se, al, K)
        else:
            _ac_refine(enc, ac_stats[at], fixed, zz, ss, se, al)
    return enc.finish()


def _tables(n: int):
    """(DC, AC) table numbers of each frame component, as libjpeg gives
    them: 0 for the first and the fourth (luma and K), 1 for the rest."""
    return [(0, 0) if c in (0, 3) else (1, 1) for c in range(n)]


def _scan(co, scan, restart, progressive, dac):
    """(DAC and SOS, the jobs of its restart intervals) of one scan."""
    comps, ss, se, ah, al = scan
    B, K, unit = writer._units(co, comps)
    tbl = [_tables(len(co.blocks))[c] for c in comps]
    cond = [dac.get(("dc", d), (0, 1)) + (dac.get(("ac", a), 5),)
            for d, a in tbl]
    uses_dc = ss == 0 and ah == 0
    uses_ac = not progressive or se > 0
    entries = []
    for d in sorted({d for d, _ in tbl}) if uses_dc else ():
        L, U = dac.get(("dc", d), (0, 1))
        entries.append(bytes([d, U << 4 | L]))
    for a in sorted({a for _, a in tbl}) if uses_ac else ():
        entries.append(bytes([0x10 | a, dac.get(("ac", a), 5)]))
    out = jpeg._segment(0xCC, b"".join(entries)) if entries else b""
    n_units = int(unit[-1]) + 1
    step = restart or n_units
    bounds = np.searchsorted(unit, np.arange(0, n_units + step, step))
    jobs = [(B[lo:hi], K[lo:hi], progressive, ss, se, ah, al, tbl, cond)
            for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    sel = b"".join(bytes([c + 1, (tbl[k][0] << 4) | tbl[k][1]])
                   for k, c in enumerate(comps))
    sos = bytes([len(comps)]) + sel + bytes([ss, se, ah << 4 | al])
    return out + jpeg._segment(0xDA, sos), jobs


def _fork_pool(processes: int):
    """A pool of ``processes`` forked workers.  They unpickle the job
    function by its module's name, which a module loaded by path lacks
    in ``sys.modules``: it is registered first."""
    if __name__ not in sys.modules:
        mod = types.ModuleType(__name__)
        mod.__dict__.update(globals())
        sys.modules[__name__] = mod
    return concurrent.futures.ProcessPoolExecutor(
        processes, mp_context=multiprocessing.get_context("fork"))


def encode(co: Coefficients, script=None, progressive: bool = True,
           restart: int = 0, app: Optional[str] = "jfif",
           adobe_transform: int = 0,
           dac: Optional[Dict[Tuple[str, int], object]] = None,
           processes: int = 1) -> bytes:
    """The arithmetic-coded JPEG stream of ``co``: SOF10 in ``script``
    (default: libjpeg's progressive script) or, with ``progressive``
    False, SOF9 with one scan of every component.  ``restart``: a
    restart interval (MCUs, or blocks of a one-component scan) in every
    scan.  ``dac``: conditioning other than T.81's default, {("dc", t):
    (L, U), ("ac", t): K}.  ``app`` and ``adobe_transform`` as
    ``jpeg_writer.encode``.  ``processes`` > 1 codes the restart
    intervals of every scan in that many forked processes."""
    n = len(co.blocks)
    dac = dac or {}
    if script is None:
        script = (writer.simple_progression(n) if progressive
                  else [(tuple(range(n)), 0, 63, 0, 0)])
    out = [b"\xff\xd8"]
    if app == "jfif":
        out.append(jpeg._segment(0xE0, b"JFIF\0" + struct.pack(
            ">BBBHHBB", 1, 1, 0, 1, 1, 0, 0)))
    elif app == "adobe":
        out.append(jpeg._segment(0xEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, adobe_transform)))
    tq, tables = [], []
    for t in co.qt:
        hit = [i for i, u in enumerate(tables) if np.array_equal(u, t)]
        if not hit:
            tables.append(np.asarray(t))
            hit = [len(tables) - 1]
        tq.append(hit[0])
    wide = any(int(t.max()) > 255 for t in tables)
    for i, t in enumerate(tables):
        zz = np.asarray(t)[jpeg.ZIGZAG]
        out.append(jpeg._segment(0xDB, bytes([(wide << 4) | i]) + (
            zz.astype(">u2").tobytes() if wide else bytes(zz.tolist()))))
    sof = struct.pack(">BHHB", 8, co.height, co.width, n)
    for c, (h, v) in enumerate(co.sampling):
        sof += bytes([c + 1, h << 4 | v, tq[c]])
    out.append(jpeg._segment(0xCA if progressive else 0xC9, sof))
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    heads, jobs = zip(*[_scan(co, (tuple(comps), ss, se, ah, al), restart,
                              progressive, dac)
                        for comps, ss, se, ah, al in script])
    flat = [j for js in jobs for j in js]
    if processes > 1:
        with _fork_pool(processes) as pool:
            parts = list(pool.map(_interval, flat))
    else:
        parts = [_interval(j) for j in flat]
    for head, js in zip(heads, jobs):
        mine, parts = parts[:len(js)], parts[len(js):]
        out.append(head + b"".join(
            p + (bytes([0xFF, 0xD0 + i % 8]) if i + 1 < len(mine) else b"")
            for i, p in enumerate(mine)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def transcode(data, script=None, **kw) -> bytes:
    """A stream's coefficients (``jpeg_writer.read_coefficients``, any
    stream the port reads) coded again by ``encode``."""
    return encode(writer.read_coefficients(data), script, **kw)


# ---- lossless (SOF3, Huffman)

_PREDICT = {
    1: lambda a, b, c: a, 2: lambda a, b, c: b, 3: lambda a, b, c: c,
    4: lambda a, b, c: a + b - c, 5: lambda a, b, c: a + ((b - c) >> 1),
    6: lambda a, b, c: b + ((a - c) >> 1), 7: lambda a, b, c: (a + b) >> 1}


def _differences(x: np.ndarray, psv: int, initial: int,
                 interval_rows: int) -> np.ndarray:
    """T.81 H.1.2's differences of samples x [rows, cols] (int64, already
    shifted by the point transform) modulo 2^16, in -32767..32768: the
    first row of the scan and of every restart interval predicted from
    the left (its first sample from ``initial``), the first column from
    above, the rest by predictor ``psv``."""
    pred = np.empty_like(x)
    pred[1:, 1:] = _PREDICT[psv](x[1:, :-1], x[:-1, 1:], x[:-1, :-1])
    pred[1:, 0] = x[:-1, 0]
    starts = np.arange(0, x.shape[0], interval_rows or x.shape[0])
    pred[starts, 0] = initial
    pred[starts, 1:] = x[starts, :-1]
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def encode_lossless(planes: Sequence[np.ndarray], sampling=None,
                    psv: int = 1, pt: int = 0, restart_rows: int = 0,
                    precision: int = 8, app: Optional[str] = None,
                    adobe_transform: int = 0, interleave: bool = True,
                    ids: Optional[Sequence[int]] = None,
                    size: Optional[Tuple[int, int]] = None) -> bytes:
    """A lossless JPEG (SOF3) of the component planes
    (each at its own size: ceil(width * h / h_max) x ceil(height * v /
    v_max), ``sampling`` (h, v) each, default 1 x 1), samples of
    ``precision`` bits, predictor ``psv``, point transform ``pt`` (the
    samples' low ``pt`` bits are dropped), one interleaved scan or one
    scan a component, restart intervals of ``restart_rows`` MCU rows, one
    optimal Huffman table a scan.  ``ids``: the component ids (default
    1, 2, ...); ``size``: (width, height), by default the size of the
    first plane of the largest sampling factors."""
    planes = [np.asarray(p, np.int64) for p in planes]
    n = len(planes)
    sampling = list(sampling or [(1, 1)] * n)
    ids = list(ids or range(1, n + 1))
    hm = max(h for h, _ in sampling)
    vm = max(v for _, v in sampling)
    if size is None:  # the first plane of the largest sampling
        c = next(i for i, s in enumerate(sampling) if s == (hm, vm))
        size = planes[c].shape[1], planes[c].shape[0]
    width, height = size
    out = [b"\xff\xd8"]
    if app == "jfif":
        out.append(jpeg._segment(0xE0, b"JFIF\0" + struct.pack(
            ">BBBHHBB", 1, 1, 0, 1, 1, 0, 0)))
    elif app == "adobe":
        out.append(jpeg._segment(0xEE, b"Adobe" + struct.pack(
            ">HHHB", 100, 0, 0, adobe_transform)))
    sof = struct.pack(">BHHB", precision, height, width, n)
    for i, (h, v) in zip(ids, sampling):
        sof += bytes([i, h << 4 | v, 0])
    out.append(jpeg._segment(0xC3, sof))
    scans = [list(range(n))] if interleave and n > 1 else [[c] for c in
                                                           range(n)]
    initial = 1 << (precision - pt - 1)
    for comps in scans:
        one = len(comps) == 1
        mx = planes[comps[0]].shape[1] if one else -(-width // hm)
        my = planes[comps[0]].shape[0] if one else -(-height // vm)
        samp = [(1, 1) if one else sampling[c] for c in comps]
        diffs = []
        for c, (h, v) in zip(comps, samp):
            p = np.pad(planes[c] >> pt,
                       ((0, my * v - planes[c].shape[0]),
                        (0, mx * h - planes[c].shape[1])), mode="edge")
            d = _differences(p, psv, initial, restart_rows * v)
            # [mcu rows, mcus across, v, h]: this component's samples of
            # each MCU
            diffs.append(d.reshape(my, v, mx, h).transpose(0, 2, 1, 3)
                         .reshape(my, mx, v * h))
        seq = np.concatenate(diffs, axis=2)  # [my, mx, samples an MCU]
        rows = np.split(seq, np.arange(restart_rows, my, restart_rows)
                        ) if restart_rows else [seq]
        flat = [r.ravel() for r in rows]
        allv = np.concatenate(flat)
        cats = np.where(allv == 32768, 16, jpeg._size(allv))
        bits, vals = writer._gen_optimal(np.bincount(cats, minlength=256))
        code, length = jpeg._huffman(bits, vals)
        if restart_rows:
            out.append(jpeg._segment(0xDD, struct.pack(">H",
                                                       restart_rows * mx)))
        sel = b"".join(bytes([ids[c], 0x00]) for c in comps)
        out.append(jpeg._segment(0xC4, b"\x00" + bits + vals))
        out.append(jpeg._segment(0xDA, bytes([len(comps)]) + sel
                                 + bytes([psv, 0, pt])))
        body = []
        for d in flat:
            cat = np.where(d == 32768, 16, jpeg._size(d))
            mag = np.where(cat < 16, cat, 0)
            v = (code[cat] << mag) | jpeg._extra(d, mag)
            body.append(jpeg._pack(v, length[cat] + mag))
        out.append(b"".join(b + (bytes([0xFF, 0xD0 + i % 8])
                                 if i + 1 < len(body) else b"")
                            for i, b in enumerate(body)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src")
    ap.add_argument("dst")
    ap.add_argument("--rgb", action="store_true",
                    help="src is a uint8 [H, W, 3] .npy image")
    ap.add_argument("--progressive", action="store_true")
    ap.add_argument("--restart", type=int, default=0)
    ap.add_argument("--processes", type=int, default=1)
    a = ap.parse_args(argv)
    if a.rgb:
        co = writer.encode_jpeg_coefficients(np.load(a.src))
    else:
        with open(a.src, "rb") as f:
            co = writer.read_coefficients(f.read())
    out = encode(co, progressive=a.progressive, restart=a.restart,
                 processes=a.processes)
    with open(a.dst, "wb") as f:
        f.write(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
