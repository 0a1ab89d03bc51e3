"""A JPEG writer for test streams: what the port's decoder
(``multimodalfusion_tpu_torch.utils.jpeg``) reads and PIL cannot be asked
to write, so that the tests, ``tools/make_jpeg_fixtures.py`` and
``chip_smoke.py`` can hold the decoder to PIL (or, on a machine without
PIL, to the baseline stream a progressive one was transcoded from).

It codes quantised DCT coefficients -- read from a stream
(``read_coefficients``), or made from planes (``from_planes``) -- in any
scan script: sequential (SOF0 / SOF1) or progressive (SOF2) with DC
first and refinement scans, AC spectral selection and successive
approximation with EOB runs and correction bits, as libjpeg's jcphuff.c
codes them; restart intervals in every scan type; 1, 3 or 4 components
(CMYK, or YCCK under an Adobe marker of transform 2).  Each scan gets
optimal Huffman tables of its own (jchuff.c's jpeg_gen_optimal_table),
defined in a DHT segment just before its SOS.  ``simple_progression`` is
libjpeg's default progressive script (jcparam.c).  A script that refines
every coefficient to Al = 0 decodes to the source stream's pixels bit
for bit.  The entropy coding is vectorised over blocks (one pass a band
position), so a whole 8192 x 6144 slide transcodes in seconds.  Loaded
by file path (``importlib.util.spec_from_file_location``), as the tests
load it; the package never imports it.
"""
import concurrent.futures
import os
import struct
import sys
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from multimodalfusion_tpu_torch.utils import jpeg  # noqa: E402

# a scan: (frame component indices, Ss, Se, Ah, Al)
Script = Sequence[Tuple[Tuple[int, ...], int, int, int, int]]


class Coefficients(NamedTuple):
    width: int
    height: int
    sampling: Tuple[Tuple[int, int], ...]  # (h, v) of each component
    qt: Tuple[np.ndarray, ...]             # each one's table, natural order
    blocks: Tuple[np.ndarray, ...]         # [rows, cols, 64] zigzag order
    # over each component's MCU-padded grid


def read_coefficients(data) -> Coefficients:
    """The quantised coefficients of a JPEG stream the port reads (its
    plain entropy decoder; after every scan, unsmoothed)."""
    f = jpeg.parse_jpeg(data)
    grids = jpeg._grids(f)
    coefs = [[0] * (gy * gx * 64) for gy, gx in grids]
    for s in f.scans:
        jpeg._entropy_plain(f, s, coefs)
    blocks = tuple(np.array(c, np.int32).reshape(gy, gx, 64)[..., jpeg.ZIGZAG]
                   for c, (gy, gx) in zip(coefs, grids))
    return Coefficients(f.width, f.height, tuple(zip(f.h, f.v)), f.qt,
                        blocks)


def from_planes(planes: Sequence[np.ndarray],
                sampling: Sequence[Tuple[int, int]], quality: int = 90
                ) -> Coefficients:
    """The coefficients of uint8 planes (full size, already in the
    stream's colour space): component c box-averaged to ``sampling[c]``,
    the edge repeated out to whole MCUs, through the float DCT of
    ``jpeg.encode_jpeg``; quantised by libjpeg's tables for ``quality``
    (luma for the first and fourth component, chroma for the others)."""
    H, W = planes[0].shape
    hm = max(h for h, _ in sampling)
    vm = max(v for _, v in sampling)
    mx, my = -(-W // (8 * hm)), -(-H // (8 * vm))
    qy, qc = jpeg.quant_tables(quality)
    tables = [qy if c in (0, 3) else qc for c in range(len(planes))]
    blocks = []
    for p, (h, v), t in zip(planes, sampling, tables):
        rh, rv = hm // h, vm // v
        full = np.pad(p, ((0, my * vm * 8 - H), (0, mx * hm * 8 - W)),
                      mode="edge").astype(np.float32)
        sub = full.reshape(full.shape[0] // rv, rv, full.shape[1] // rh,
                           rh).mean(axis=(1, 3))
        blocks.append(jpeg._quantised(sub, np.asarray(t)))
    return Coefficients(W, H, tuple(map(tuple, sampling)),
                        tuple(np.asarray(t, np.uint16) for t in tables),
                        tuple(blocks))


def encode_jpeg_coefficients(rgb: np.ndarray,
                             chunk_rows: int = 64) -> Coefficients:
    """The coefficients of ``jpeg.encode_jpeg(rgb)``'s baseline stream
    (YCbCr 4:2:0 at its quality), as its encoder makes them: the same
    stream's coefficients without decoding it, for slides too large for
    the plain entropy decoder."""
    a = np.asarray(rgb)
    chunks = list(jpeg._coefficient_chunks(a, chunk_rows))
    qy, qc = jpeg.quant_tables()
    return Coefficients(a.shape[1], a.shape[0], ((2, 2), (1, 1), (1, 1)),
                        (qy.astype(np.uint16), qc.astype(np.uint16),
                         qc.astype(np.uint16)),
                        tuple(np.concatenate([c[i] for c in chunks])
                              for i in range(3)))


def simple_progression(n: int, ycc: bool = True) -> List:
    """libjpeg's jpeg_simple_progression: its YCbCr script for three
    components (``ycc``), its all-purpose script otherwise."""
    dc = tuple(range(n))
    if n == 3 and ycc:
        return [(dc, 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
                ((0,), 1, 63, 2, 1), (dc, 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
    return ([(dc, 0, 0, 0, 1)] + [((c,), 1, 5, 0, 2) for c in dc]
            + [((c,), 6, 63, 0, 2) for c in dc]
            + [((c,), 1, 63, 2, 1) for c in dc] + [(dc, 0, 0, 1, 0)]
            + [((c,), 1, 63, 1, 0) for c in dc])


# ---- the entropy coder: items (major, minor1, minor2, table, value, bits)
# sorted by (major, minor1, minor2); table -1 is raw bits, else a Huffman
# symbol of that table (DC slot 0-1: 0-1, AC slot 0-1: 2-3).  A block's
# items have major 3 b + 1; an EOB run flushed before block b has 3 b,
# one flushed after it 3 b + 2.

class _Items:
    def __init__(self):
        self.parts = []

    def add(self, major, minor1, minor2, table, value, bits):
        n = np.broadcast(major, minor1, minor2, table, value, bits).shape
        self.parts.append([np.broadcast_to(np.asarray(x, np.int64),
                                           n).ravel()
                           for x in (major, minor1, minor2, table, value,
                                     bits)])

    def arrays(self):
        if not self.parts:
            return [np.zeros(0, np.int64) for _ in range(6)]
        return [np.concatenate([p[i] for p in self.parts]) for i in range(6)]


def _nbits(x: np.ndarray) -> np.ndarray:
    return jpeg._size(np.asarray(x, np.int64))


def _emit_runs(items: _Items, emissions, table: int) -> None:
    """EOBn symbols: (major, run length) -> symbol n << 4 and n bits."""
    if not emissions:
        return
    major, run = (np.array(x, np.int64) for x in zip(*emissions))
    n = _nbits(run) - 1
    items.add(major, 0, 0, table, n << 4, 0)
    keep = n > 0
    items.add(major[keep], 1, 0, -1, run[keep] - (1 << n[keep]), n[keep])


def _dc_items(items, B, K, al, slots, refine):
    """DC first (point transform al, the difference from the component's
    last block) or DC refinement (bit al) of blocks B [n, 64]."""
    major = 3 * np.arange(len(B)) + 1
    v = B[:, 0].astype(np.int64) >> al
    if refine:
        items.add(major, 0, 0, -1, v & 1, 1)
        return
    diff = np.zeros_like(v)
    for k in np.unique(K):
        idx = np.flatnonzero(K == k)
        diff[idx] = np.diff(v[idx], prepend=0)
    size = _nbits(np.abs(diff))
    items.add(major, 0, 0, np.asarray(slots)[K], size, 0)
    keep = size > 0
    items.add(major[keep], 1, 0, -1, jpeg._extra(diff[keep], size[keep]),
              size[keep])


def _ac_first_items(items, B, ss, se, al, table, runs, minor=8):
    """AC first over zigzag ss..se (point transform al) of blocks B: a
    symbol (zero run, size) and the magnitude bits of each nonzero
    coefficient, ZRLs for runs past 15, and EOB runs of blocks whose
    band ends in zeros (``runs``; else each such block's own EOB)."""
    n = len(B)
    band = B[:, ss:se + 1]
    mag = np.abs(band) >> al
    bi, ji = np.nonzero(mag)
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, -1, np.roll(ji, 1))
    r = ji - prev - 1
    m = mag[bi, ji].astype(np.int64)
    val = np.where(band[bi, ji] < 0, -m, m)
    size = _nbits(m)
    major = 3 * bi + 1
    items.add(major, minor + 4 * ji + 1, 0, table, ((r % 16) << 4) | size, 0)
    items.add(major, minor + 4 * ji + 2, 0, -1, jpeg._extra(val, size), size)
    zrl = r // 16
    rep = np.repeat(np.arange(len(bi)), zrl)
    items.add(major[rep], minor + 4 * ji[rep], 0, table, 0xF0, 0)
    # each block's last nonzero position (its items come in order)
    last = np.full(n, -1)
    end = np.ones(len(bi), bool)
    end[:-1] = bi[1:] != bi[:-1]
    last[bi[end]] = ji[end]
    eob = last < se - ss
    if not runs:
        items.add(3 * np.flatnonzero(eob) + 2, 0, 0, table, 0, 0)
        return
    has, eob = (last >= 0).tolist(), eob.tolist()
    emissions, run = [], 0
    for b in range(n):
        if has[b] and run:
            emissions.append((3 * b, run))
            run = 0
        if eob[b]:
            run += 1
            if run == 0x7FFF:
                emissions.append((3 * b + 2, run))
                run = 0
    if run:
        emissions.append((3 * (n - 1) + 2, run))
    _emit_runs(items, emissions, table)


def _ac_refine_items(items, B, ss, se, al, table):
    """AC refinement (bit al) over zigzag ss..se, as jcphuff.c's
    encode_mcu_AC_refine: a symbol (zero run, 1) and a sign bit for each
    coefficient newly nonzero, ZRLs (only before the band's last new
    one), a correction bit for each coefficient already nonzero, sent
    after the next symbol of its block, or after the EOB run its block
    joins; the run is flushed early when its correction bits pass 937."""
    n = len(B)
    # one band position at a time, over every block: [L, n] arrays, in
    # the narrowest types that hold them (a coefficient fits in int16)
    bandT = np.ascontiguousarray(B[:, ss:se + 1].T).astype(np.int16)
    L = bandT.shape[0]
    aT = np.abs(bandT) >> al
    newT, histT = aT == 1, aT > 1
    eob_at = np.where(newT.any(0), L - 1 - np.argmax(newT[::-1], 0), -1)
    r = np.zeros(n, np.int16)
    nzrl = np.zeros((L, n), np.int8)
    symr = np.zeros((L, n), np.int8)
    for j in range(L):
        r += aT[j] == 0
        chk = (aT[j] != 0) & (r > 15) & (j <= eob_at)
        nzrl[j] = np.where(chk, r >> 4, 0)
        r = np.where(chk, r & 15, r)
        symr[j] = np.where(newT[j], r, 0)
        r = np.where(newT[j], 0, r)
    sym_at = (nzrl > 0) | newT
    # the first symbol position after each position, L for none
    nxt = np.empty((L, n), np.int8)
    cur = np.full(n, L, np.int8)
    for j in range(L - 1, -1, -1):
        nxt[j] = cur
        cur = np.where(sym_at[j], j, cur)
    j_z, b_z = np.nonzero(nzrl)
    cnt = nzrl[j_z, b_z].astype(np.int64)
    rep = np.repeat(np.arange(len(b_z)), cnt)
    sub = np.arange(len(rep)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    items.add(3 * b_z[rep] + 1, 8 + 8 * j_z[rep] + np.where(sub == 0, 0, 2),
              0, table, 0xF0, 0)
    j_n, b_n = np.nonzero(newT)
    items.add(3 * b_n + 1, 8 + 8 * j_n + 3, 0, table,
              (symr[j_n, b_n].astype(np.int64) << 4) | 1, 0)
    items.add(3 * b_n + 1, 8 + 8 * j_n + 4, 0, -1, bandT[j_n, b_n] >= 0, 1)
    j_h, b_h = np.nonzero(histT)
    k = nxt[j_h, b_h].astype(np.int64)
    flushed = k < L
    kf, bf, jf = k[flushed], b_h[flushed], j_h[flushed]
    items.add(3 * bf + 1, 8 + 8 * kf + np.where(nzrl[kf, bf] > 0, 1, 5), jf,
              -1, aT[jf, bf] & 1, 1)
    # the EOB runs and the correction bits they carry: each run is a
    # range of blocks [start, b], flushed before the block after it that
    # has a symbol, or early
    has = (eob_at >= 0).tolist()
    eob = (eob_at < L - 1).tolist()
    tail = np.bincount(b_h[~flushed], minlength=n).tolist()
    emissions, runs, run, be, start = [], [], 0, 0, 0
    for b in range(n):
        if has[b] and run:
            emissions.append((3 * b, run))
            runs.append((start, b, 3 * b))
            run = be = 0
        if eob[b]:
            if not run:
                start = b
            run += 1
            be += tail[b]
            if run == 0x7FFF or be > 937:
                emissions.append((3 * b + 2, run))
                runs.append((start, b + 1, 3 * b + 2))
                run = be = 0
    if run:
        emissions.append((3 * (n - 1) + 2, run))
        runs.append((start, n, 3 * (n - 1) + 2))
    emit_major = np.zeros(n, np.int64)
    if runs:
        lo, hi, key = (np.array(x, np.int64) for x in zip(*runs))
        size = hi - lo
        emit_major[np.repeat(lo - np.cumsum(size) + size, size)
                   + np.arange(int(size.sum()))] = np.repeat(key, size)
    bt, jt = b_h[~flushed], j_h[~flushed]
    items.add(emit_major[bt], 2, bt * 64 + jt, -1, aT[jt, bt] & 1, 1)
    _emit_runs(items, emissions, table)


def _gen_optimal(freq: np.ndarray) -> Tuple[bytes, bytes]:
    """jchuff.c's jpeg_gen_optimal_table: (16 code counts, symbols) of a
    Huffman code for symbol counts ``freq`` [256], no code longer than
    16 bits and none all ones."""
    freq = [int(x) for x in freq] + [1]
    codesize = [0] * 257
    others = [-1] * 257
    while True:
        live = [(f, i) for i, f in enumerate(freq) if f]
        if len(live) < 2:
            break
        # the smallest counts, ties to the larger symbol
        live.sort(key=lambda t: (t[0], -t[1]))
        c1, c2 = live[0][1], live[1][1]
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for s in codesize:
        if s:
            bits[s] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the pseudo-symbol 256
    vals = [s for n in range(1, 33) for s in range(256) if codesize[s] == n]
    return bytes(bits[1:17]), bytes(vals)


def _units(co: Coefficients, comps: Sequence[int]):
    """(blocks [n, 64], scan component index [n], unit of each block) in
    the scan's order: MCUs of the padded grids, or one component's own
    blocks in raster order."""
    hm = max(h for h, _ in co.sampling)
    vm = max(v for _, v in co.sampling)
    if len(comps) == 1:
        c = comps[0]
        h, v = co.sampling[c]
        wb = -(-(-(-co.width * h // hm)) // 8)
        hb = -(-(-(-co.height * v // vm)) // 8)
        B = co.blocks[c][:hb, :wb].reshape(-1, 64)
        return B, np.zeros(len(B), np.int64), np.arange(len(B))
    mx, my = -(-co.width // (8 * hm)), -(-co.height // (8 * vm))
    parts = []
    for k, c in enumerate(comps):
        h, v = co.sampling[c]
        g = co.blocks[c].reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4)
        parts.append((g.reshape(my * mx, v * h, 64), k))
    B = np.concatenate([p for p, _ in parts], axis=1)
    K = np.concatenate([np.full(p.shape[1], k) for p, k in parts])
    per = B.shape[1]
    return (B.reshape(-1, 64), np.tile(K, my * mx),
            np.repeat(np.arange(my * mx), per))


def _scan_segments(co, scan, restart, progressive):
    """The scan's restart intervals, each as its items, and the tables
    (DC 0-1, AC 2-3) it uses."""
    comps, ss, se, ah, al = scan
    B, K, unit = _units(co, comps)
    slots = [min(k, 1) for k in range(len(comps))]
    n_units = int(unit[-1]) + 1
    step = restart or n_units
    segs = []
    for u0 in range(0, n_units, step):
        sel = (unit >= u0) & (unit < u0 + step)
        b, k = B[sel], K[sel]
        items = _Items()
        if not progressive:
            _dc_items(items, b, k, 0, slots, False)
            # sequential AC: each component's own table, no EOB runs
            for kk in np.unique(k):
                idx = np.flatnonzero(k == kk)
                sub = _Items()
                _ac_first_items(sub, b[idx], 1, 63, 0, 2 + slots[kk], False)
                for p in sub.parts:  # block numbers back into the scan's
                    blk = (p[0] - 1) // 3
                    p[0] = 3 * idx[blk] + (p[0] - 3 * blk)
                items.parts += sub.parts
        elif ss == 0:
            _dc_items(items, b, k, al, slots, ah > 0)
        elif ah == 0:
            _ac_first_items(items, b, ss, se, al, 2, True)
        else:
            _ac_refine_items(items, b, ss, se, al, 2)
        segs.append(items.arrays())
    return segs


def _scan_bytes(co, scan, restart, progressive) -> bytes:
    """DHT (the scan's optimal tables), SOS and the coded data."""
    comps, ss, se, ah, al = scan
    segs = _scan_segments(co, scan, restart, progressive)
    used = sorted({int(t) for s in segs for t in np.unique(s[3]) if t >= 0})
    code = np.zeros((4, 256), np.int64)
    length = np.zeros((4, 256), np.int64)
    dht = b""
    for t in used:
        freq = sum(np.bincount(s[4][s[3] == t], minlength=256)
                   for s in segs)
        bits, vals = _gen_optimal(freq)
        c, ln = jpeg._huffman(bits, vals)
        code[t], length[t] = c, ln
        dht += bytes([(t >= 2) << 4 | (t % 2)]) + bits + vals
    out = jpeg._segment(0xC4, dht) if dht else b""
    data = []
    for major, m1, m2, tab, val, nb in segs:
        # one int64 key: (major, minor1 < 2^10, minor2); items with
        # equal keys are equal (repeated ZRLs), so the sort need not be
        # stable
        shift = int(m2.max(initial=0)).bit_length()
        if int(major.max(initial=0)).bit_length() + 10 + shift > 63:
            raise ValueError("a scan too large for the writer's sort key")
        order = np.argsort((major << (10 + shift)) | (m1 << shift) | m2)
        tab, val, nb = tab[order], val[order], nb[order]
        sym = tab >= 0
        v, ln = val.copy(), nb.copy()
        v[sym] = code[tab[sym], val[sym]]
        ln[sym] = length[tab[sym], val[sym]]
        if (ln[sym] == 0).any():
            raise AssertionError("a symbol without a code")
        data.append(jpeg._pack(v, ln) if len(v) else b"")
    body = b"".join(d + (bytes([0xFF, 0xD0 + i % 8]) if i + 1 < len(data)
                         else b"") for i, d in enumerate(data))
    # component c has the id c + 1
    sel = b"".join(bytes([c + 1, (min(k, 1) if ss == 0 else 0) << 4
                          | (min(k, 1) if not progressive else 0)])
                   for k, c in enumerate(comps))
    sos = bytes([len(comps)]) + sel + bytes([ss, se, ah << 4 | al])
    return out + jpeg._segment(0xDA, sos) + body


def encode(co: Coefficients, script: Optional[Script] = None,
           progressive: bool = True, restart: int = 0,
           app: Optional[str] = "jfif", adobe_transform: int = 0,
           threads: int = 1) -> bytes:
    """The JPEG stream of ``co`` in ``script`` (default: libjpeg's
    progressive script, or one sequential scan of every component).
    ``restart``: a restart interval (in MCUs, or in blocks of a
    one-component scan) in every scan.  ``app``: "jfif", "adobe" (an
    APP14 marker with ``adobe_transform``: 2 for YCCK) or None.  A
    sequential stream is SOF0 unless a quantisation table has 16-bit
    entries (SOF1).  ``threads``: scans coded at once (numpy releases
    the GIL in most of the work)."""
    n = len(co.blocks)
    if script is None:
        script = (simple_progression(n) if progressive
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
    marker = 0xC2 if progressive else (0xC1 if wide else 0xC0)
    out.append(jpeg._segment(marker, sof))
    if restart:
        out.append(jpeg._segment(0xDD, struct.pack(">H", restart)))
    jobs = [(co, (tuple(comps), ss, se, ah, al), restart, progressive)
            for comps, ss, se, ah, al in script]
    if threads > 1:
        with concurrent.futures.ThreadPoolExecutor(threads) as pool:
            out += pool.map(lambda job: _scan_bytes(*job), jobs)
    else:
        out += [_scan_bytes(*job) for job in jobs]
    out.append(b"\xff\xd9")
    return b"".join(out)


def transcode(data, script: Optional[Script] = None, **kw) -> bytes:
    """A stream's coefficients (``read_coefficients``) coded again by
    ``encode``: by default, libjpeg's progressive script."""
    return encode(read_coefficients(data), script, **kw)
