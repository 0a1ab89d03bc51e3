"""A Zstandard (RFC 8878) encoder for test streams, in numpy and Python:
what writes a ZSTD-compressed TIFF on a machine without a zstd module,
so that the tests, ``tools/make_zstd_fixtures.py`` and ``chip_smoke.py``
can hold the port's decoders (``multimodalfusion_tpu_torch.utils.zstd``
and ``csrc/imgcodec.cpp``'s ``mmf_zstd_decode``) to it, and to libzstd
where there is one.

``compress`` writes one frame: single-segment with its content size, or
with a window descriptor (``window_log``), the content size optional;
the checksum optional.  Each block of at most 128 KiB is whichever of
raw, RLE or compressed is smallest.  A compressed block's matches come
from a greedy parse (the latest earlier position with the same first
``min_match`` bytes, found for every position at once with numpy), its
offsets coded as repeat offsets where they equal one (the ``lit_len ==
0`` shift included).  Its literals are raw, RLE, or Huffman-coded
(code lengths at most 11) in 1 stream (under 256 literals) or 4, with a
new table (its weights sent directly or FSE-coded, the smaller;
FSE-coded when there are more than 128) or treeless, reusing the last
one, when that is smaller.  Each of the literal-length, offset and
match-length tables is predefined, RLE, FSE-coded or repeated from the
previous compressed block, whichever the estimate says is smallest.
``stats`` counts each choice.

``write_tiff`` writes a uint8 image as one ZSTD page (Compression
50000): strips or tiles, chunky or planar, predictor 1 or 2, its chunks
coded in spawned worker processes (``processes``; no CUDA in them).

Loaded by file path (``importlib.util.spec_from_file_location``) or run
as a script; the package never imports it:

    python tools/zstd_writer.py IN.npy OUT.tiff [--tile 256 | --rows N]
        [--planar] [--predictor 2] [--checksum] [--processes N]

which prints the counts of ``stats`` as one JSON line.
"""
import argparse
import concurrent.futures
import heapq
import importlib.util
import json
import math
import multiprocessing
import os
import struct
import sys
from bisect import bisect_left
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's decoder module by its path: its tables, FSE and XXH64 (the
# package's import would bring torch into every worker)
_spec = importlib.util.spec_from_file_location(
    "_mmf_zstd", os.path.join(ROOT, "multimodalfusion_tpu_torch", "utils",
                              "zstd.py"))
zstd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(zstd)

BLOCK_MAX = zstd.BLOCK_MAX
_LL_BASE = np.array(zstd.LL_BASE)
_ML_BASE = np.array(zstd.ML_BASE)


# ---- bits

def _pack(fields: Sequence[Tuple[int, int]]) -> bytes:
    """The fields (value, bit count), in order, as an LSB-first bit
    stream closed by a 1 bit and padded to bytes: read backward, the
    last field comes first."""
    vals = np.array([v for v, _ in fields] + [1], np.uint64)
    nbs = np.array([n for _, n in fields] + [1], np.int64)
    return _pack_arrays(vals, nbs)


def _pack_arrays(vals: np.ndarray, nbs: np.ndarray) -> bytes:
    total = int(nbs.sum())
    field = np.repeat(np.arange(len(nbs)), nbs)
    start = np.cumsum(nbs) - nbs
    shift = (np.arange(total) - start[field]).astype(np.uint64)
    bits = ((vals.astype(np.uint64)[field] >> shift) & np.uint64(1)).astype(
        np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def _forward(fields: Sequence[Tuple[int, int]]) -> bytes:
    """The fields as an LSB-first bit stream, zero-padded to bytes (an
    FSE table description)."""
    v, at = 0, 0
    for x, n in fields:
        v |= x << at
        at += n
    return v.to_bytes((at + 7) // 8, "little")


# ---- FSE

def normalize(counts: Sequence[int], log: int) -> List[int]:
    """Normalized counts summing to 2^log: each present symbol at least
    1, or -1 ("less than one") when its share is under a quarter of a
    state and there are at least 2^(log-2) of them."""
    size, total = 1 << log, sum(counts)
    low = total >= 4 << log
    norm = []
    for c in counts:
        share = c * size / total
        norm.append(0 if c == 0 else -1 if low and share < 0.25 else
                    max(1, round(share)))
    while True:
        diff = size - sum(abs(x) for x in norm)
        if diff == 0:
            return norm
        # move the difference onto the symbols with most room
        order = sorted((s for s in range(len(norm)) if norm[s] > 0),
                       key=lambda s: -norm[s])
        for s in order:
            step = max(-(norm[s] - 1), diff) if diff < 0 else diff
            norm[s] += step
            diff -= step
            if diff == 0:
                break
        if diff:
            raise ValueError(f"{len(order)} counts do not fit 2^{log}")


def table_log(counts: Sequence[int], max_log: int) -> int:
    n = sum(counts)
    present = sum(1 for c in counts if c)
    log = max(5, min(max_log, (max(n, 2) - 1).bit_length() + 1))
    while (1 << log) < present:
        log += 1
    return log


def ncount(norm: Sequence[int], log: int) -> bytes:
    """The FSE table description of ``norm`` (libzstd's
    FSE_writeNCount)."""
    fields = [(log - 5, 4)]
    remaining, threshold, nb = (1 << log) + 1, 1 << log, log + 1
    last = max(s for s in range(len(norm)) if norm[s])
    s, prev0 = 0, False
    while s <= last and remaining > 1:
        if prev0:
            start = s
            while norm[s] == 0:
                s += 1
            run = s - start
            while run >= 3:
                fields.append((3, 2))
                run -= 3
            fields.append((run, 2))
        count = norm[s]
        s += 1
        most = 2 * threshold - 1 - remaining
        remaining -= abs(count)
        v = count + 1
        if v >= threshold:
            v += most
        fields.append((v, nb - 1 if v < most else nb))
        prev0 = v == 1
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1:
        raise AssertionError("a bad normalized distribution")
    return _forward(fields)


class Encoder:
    """The encoding side of a decoding table (``zstd.Table``): for each
    symbol, the state that leads to each next state."""

    def __init__(self, t: "zstd.Table", n_symbols: int):
        self.t = t
        size = 1 << t.log
        self.to = np.full((n_symbols, size), -1, np.int64)
        for u in range(size):
            s = t.sym[u]
            self.to[s, t.base[u]:t.base[u] + (1 << t.nb[u])] = u
        self.init = {}
        for u in range(size):
            self.init.setdefault(t.sym[u], u)
        self.to = self.to.tolist()

    def covers(self, symbols) -> bool:
        return all(s < len(self.to) and self.to[s][0] >= 0 for s in symbols)

    def cost(self, hist: Dict[int, int]) -> float:
        """Bits of the symbols of ``hist`` ({symbol: count})."""
        size = 1 << self.t.log
        per = Counter(self.t.sym)
        return sum(c * math.log2(size / per[s]) for s, c in hist.items())


def _fse_weights(weights: Sequence[int]) -> Optional[bytes]:
    """Huffman weights FSE-coded with two interleaved states (the
    decoder alternates, and stops on reading past the start), or None
    when they cannot be."""
    hist = np.bincount(weights, minlength=13)
    if np.count_nonzero(hist) < 2 or len(weights) < 2:
        return None
    log = 6 if len(weights) > 32 else 5
    norm = normalize(hist.tolist(), log)
    t = zstd.fse_table(norm, log)
    enc = Encoder(t, 13)
    n = len(weights)
    # the last two symbols start the states (no bits); the one decoded
    # last-but-one must read at least one bit past the start, so it
    # takes the state with the most bits
    state = [None, None]
    for j in (n - 1, n - 2):
        cands = [u for u in range(1 << log) if t.sym[u] == weights[j]]
        state[j % 2] = max(cands, key=lambda u: t.nb[u])
    if t.nb[state[(n - 2) % 2]] == 0:
        return None
    fields = []
    for j in range(n - 3, -1, -1):
        nxt = state[j % 2]
        u = enc.to[weights[j]][nxt]
        fields.append((nxt - t.base[u], t.nb[u]))
        state[j % 2] = u
    fields += [(state[1], log), (state[0], log)]
    return ncount(norm, log) + _pack(fields)


# ---- Huffman

def huffman_lengths(counts: np.ndarray, max_bits: int = 11) -> np.ndarray:
    """Code lengths of a Huffman code of ``counts`` (at least two
    present), the counts halved until no code is longer than
    ``max_bits``."""
    counts = counts.astype(np.int64)
    while True:
        syms = np.flatnonzero(counts)
        heap = [(int(counts[s]), i, [int(s)]) for i, s in enumerate(syms)]
        heapq.heapify(heap)
        depth = np.zeros(len(counts), np.int64)
        k = len(heap)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            depth[sa + sb] += 1
            heapq.heappush(heap, (a + b, k, sa + sb))
            k += 1
        if depth.max() <= max_bits:
            return depth
        counts = np.where(counts > 0, np.maximum(counts >> 1, 1), 0)


class Huffman:
    """A Huffman code for the literals: lengths, codes, and its tree
    description (None when it has none)."""

    def __init__(self, lengths: np.ndarray):
        self.lengths = lengths
        top = int(lengths.max())
        last = int(np.flatnonzero(lengths).max())
        w = np.where(lengths > 0, top + 1 - lengths, 0)
        self.weights = w[:last + 1]
        order = sorted((s for s in range(len(w)) if w[s]),
                       key=lambda s: (w[s], s))
        self.codes = np.zeros(256, np.int64)
        start = 0
        for s in order:
            self.codes[s] = start >> (w[s] - 1)
            start += 1 << (w[s] - 1)
        explicit = [int(x) for x in self.weights[:-1]]
        direct = fse = None
        if len(explicit) <= 128:
            nib = explicit + [0] * (len(explicit) % 2)
            direct = bytes([127 + len(explicit)]) + bytes(
                (nib[i] << 4) | nib[i + 1] for i in range(0, len(nib), 2))
        coded = _fse_weights(explicit)
        if coded is not None and len(coded) < 128:
            fse = bytes([len(coded)]) + coded
        self.fse = fse is not None and (direct is None
                                        or len(fse) < len(direct))
        self.description = fse if self.fse else direct

    def covers(self, hist: np.ndarray) -> bool:
        return bool(np.all(self.lengths[hist > 0] > 0))

    def bits(self, hist: np.ndarray) -> int:
        return int((hist * self.lengths).sum())

    def stream(self, lits: np.ndarray) -> bytes:
        rev = lits[::-1]
        vals = np.append(self.codes[rev], 1)
        nbs = np.append(self.lengths[rev], 1)
        return _pack_arrays(vals, nbs)


def _raw_header(kind: int, size: int) -> bytes:
    if size < 32:
        return bytes([kind | (size << 3)])
    if size < 4096:
        return (kind | 4 | (size << 4)).to_bytes(2, "little")
    return (kind | 12 | (size << 4)).to_bytes(3, "little")


def _literals(lits: bytes, prev: Optional[Huffman], stats: Counter,
              streams: Optional[int] = None
              ) -> Tuple[bytes, Optional[Huffman]]:
    """The literals section of ``lits`` and the Huffman table the
    decoder holds after it."""
    n = len(lits)
    arr = np.frombuffer(lits, np.uint8)
    hist = np.bincount(arr, minlength=256)
    if n and np.count_nonzero(hist) == 1:
        stats["literals_rle"] += 1
        return _raw_header(1, n) + lits[:1], prev
    raw = _raw_header(0, n) + lits
    if n < 16:
        stats["literals_raw"] += 1
        return raw, prev
    fresh = Huffman(huffman_lengths(hist))
    use, kind = fresh, 2
    if fresh.description is None or (
            prev is not None and prev.covers(hist)
            and prev.bits(hist) <= fresh.bits(hist)
            + 8 * len(fresh.description)):
        use, kind = prev, 3
    if use is None or not use.covers(hist):
        stats["literals_raw"] += 1
        return raw, prev
    k = streams or (1 if n < 256 else 4)
    if k == 1:
        body = use.stream(arr)
    else:
        seg = (n + 3) // 4
        parts = [use.stream(arr[i * seg:(i + 1) * seg]) for i in range(4)]
        body = b"".join(struct.pack("<H", len(p)) for p in parts[:3]) \
            + b"".join(parts)
    if kind == 2:
        body = use.description + body
    comp = len(body)
    if k == 1 and (n >= 1024 or comp >= 1024):
        k = 4  # cannot say it in 10 bits: recode in 4 streams
        return _literals(lits, prev, stats, 4)
    fmt, bits = ((0, 10) if k == 1 else (1, 10) if max(n, comp) < 1024
                 else (2, 14) if max(n, comp) < 16384 else (3, 18))
    head = (kind | (fmt << 2) | (n << 4) | (comp << (4 + bits))).to_bytes(
        (3, 3, 4, 5)[fmt], "little")
    if len(head) + comp >= len(raw):
        stats["literals_raw"] += 1
        return raw, prev
    stats["literals_treeless" if kind == 3 else
          ("huffman_fse_weights" if use.fse else "huffman_direct_weights")
          ] += 1
    stats[f"huffman_{k}_streams"] += 1
    return head + body, use


# ---- sequences

def _codes(values: np.ndarray, base: np.ndarray) -> np.ndarray:
    return np.searchsorted(base, values, side="right") - 1


def _sequences(seqs: List[Tuple[int, int, int]], prev: Dict[str, object],
               stats: Counter) -> Tuple[bytes, Dict[str, object]]:
    """The sequences section of ``seqs`` ((literal length, offset value,
    match length)) and the tables the decoder holds after it."""
    n = len(seqs)
    if n == 0:
        return b"\0", prev
    a = np.array(seqs, np.int64)
    ll, ov, ml = a[:, 0], a[:, 1], a[:, 2]
    codes = {"ll": _codes(ll, _LL_BASE), "ml": _codes(ml, _ML_BASE),
             "of": np.array([int(v).bit_length() - 1 for v in ov], np.int64)}
    extra = {"ll": (ll - _LL_BASE[codes["ll"]]).tolist(),
             "ml": (ml - _ML_BASE[codes["ml"]]).tolist(),
             "of": (ov - (1 << codes["of"])).tolist()}
    nbits = {"ll": [zstd.LL_BITS[c] for c in codes["ll"]],
             "ml": [zstd.ML_BITS[c] for c in codes["ml"]],
             "of": codes["of"].tolist()}
    head = (bytes([n]) if n < 128 else
            bytes([(n >> 8) + 128, n & 255]) if n < 0x7F00 else
            b"\xff" + (n - 0x7F00).to_bytes(2, "little"))
    modes, descs, encs, now = 0, [], {}, {}
    for key, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        max_symbol, max_log, default, dlog = zstd.SEQ_TABLES[key]
        hist = Counter(codes[key].tolist())
        options = []  # (bits, mode, description, encoder)
        pre = _PREDEFINED[key]
        if pre.covers(hist):
            options.append((pre.cost(hist), 0, b"", pre))
        if prev.get(key) is not None and prev[key].covers(hist):
            options.append((prev[key].cost(hist), 3, b"", prev[key]))
        if len(hist) == 1:
            s = next(iter(hist))
            options.append((8, 1, bytes([s]),
                            Encoder(zstd.rle_table(s), max_symbol + 1)))
        else:
            counts = [hist.get(s, 0) for s in range(max(hist) + 1)]
            log = table_log(counts, max_log)
            norm = normalize(counts, log)
            desc = ncount(norm, log)
            e = Encoder(zstd.fse_table(norm, log), max_symbol + 1)
            options.append((e.cost(hist) + 8 * len(desc), 2, desc, e))
        bits, mode, desc, e = min(options, key=lambda o: (o[0], o[1] != 3))
        stats[f"{key}_{('predefined', 'rle', 'fse', 'repeat')[mode]}"] += 1
        modes |= mode << shift
        descs.append(desc)
        encs[key] = now[key] = e
    # the bit stream, last sequence first (libzstd's ZSTD_encodeSequences)
    c = {k: v.tolist() for k, v in codes.items()}
    st = {k: encs[k].init[c[k][n - 1]] for k in ("ll", "of", "ml")}
    fields = [(extra["ll"][n - 1], nbits["ll"][n - 1]),
              (extra["ml"][n - 1], nbits["ml"][n - 1]),
              (extra["of"][n - 1], nbits["of"][n - 1])]
    tabs = {k: (encs[k].to, encs[k].t.base, encs[k].t.nb) for k in st}
    for i in range(n - 2, -1, -1):
        for k in ("of", "ml", "ll"):
            to, base, nb = tabs[k]
            nxt = st[k]
            u = to[c[k][i]][nxt]
            fields.append((nxt - base[u], nb[u]))
            st[k] = u
        fields += [(extra["ll"][i], nbits["ll"][i]),
                   (extra["ml"][i], nbits["ml"][i]),
                   (extra["of"][i], nbits["of"][i])]
    fields += [(st["ml"], encs["ml"].t.log), (st["of"], encs["of"].t.log),
               (st["ll"], encs["ll"].t.log)]
    return head + bytes([modes]) + b"".join(descs) + _pack(fields), now


_PREDEFINED = {k: Encoder(zstd.fse_table(v[2], v[3]), v[0] + 1)
               for k, v in zstd.SEQ_TABLES.items()}


# ---- matches

def _candidates(buf: np.ndarray, min_match: int) -> np.ndarray:
    """For each position, the latest earlier one with the same next
    ``min_match`` bytes (-1: none)."""
    n = len(buf)
    prev = np.full(n, -1, np.int64)
    m = n - min_match + 1
    if m < 2:
        return prev
    key = np.zeros(m, np.uint64)
    for k in range(min_match):
        key |= buf[k:k + m].astype(np.uint64) << np.uint64(8 * k)
    order = np.argsort(key, kind="stable")
    same = key[order[1:]] == key[order[:-1]]
    prev[order[1:][same]] = order[:-1][same]
    return prev


def _match_len(d: bytes, a: int, b: int, limit: int) -> int:
    """The length of the common prefix of ``d[a:]`` and ``d[b:]``, at
    most ``limit``."""
    n, step = 0, 16
    while n < limit:
        m = min(step, limit - n)
        if d[a + n:a + n + m] == d[b + n:b + n + m]:
            n += m
            step = min(2 * step, 1 << 16)
            continue
        lo, hi = 0, m
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if d[a + n + lo:a + n + mid] == d[b + n + lo:b + n + mid]:
                lo = mid
            else:
                hi = mid
        return n + lo
    return limit


def _offset_value(off: int, ll: int, rep: List[int]) -> int:
    """The offset value of ``off`` after ``ll`` literals, ``rep`` updated
    as the decoder updates it."""
    k = None
    if ll:
        if off in rep:
            k = rep.index(off)
    elif off == rep[1]:
        k = 1
    elif off == rep[2]:
        k = 2
    elif off == rep[0] - 1:
        k = 3
    if k is None:
        rep[:] = [off, rep[0], rep[1]]
        return off + 3
    if k == 1:
        rep[:] = [off, rep[0], rep[2]]
    elif k > 1:
        rep[:] = [off, rep[0], rep[1]]
    return k + (ll != 0)


def _parse(d: bytes, prev: np.ndarray, cand: List[int], bs: int, be: int,
           rep: List[int], min_match: int, window: int):
    """Greedy sequences of the block ``d[bs:be]``: ([(literal length,
    offset value, match length)], the literals)."""
    seqs, lits = [], []
    i = lit = bs
    last = be - min_match  # the last position a match may start at
    k = bisect_left(cand, i)
    while i <= last:
        best, at = 0, i
        for r in rep:
            if 0 < r <= i and d[i:i + min_match] == d[i - r:i - r + min_match]:
                n = _match_len(d, i, i - r, be - i)
                if n > best:
                    best, off = n, r
        if not best:
            while k < len(cand) and cand[k] <= last and (
                    cand[k] - prev[cand[k]] > window):
                k += 1
            if k == len(cand) or cand[k] > last:
                break
            at = cand[k]
            off = at - prev[at]
            best = _match_len(d, at, prev[at], be - at)
        ll = at - lit
        lits.append(d[lit:at])
        seqs.append((ll, _offset_value(off, ll, rep), best))
        i = lit = at + best
        k = bisect_left(cand, i, k)
    lits.append(d[lit:be])
    return seqs, b"".join(lits)


# ---- frames

def compress(data: bytes, checksum: bool = False, content_size: bool = True,
             window_log: Optional[int] = None, min_match: int = 5,
             block: int = BLOCK_MAX, stats: Optional[Counter] = None
             ) -> bytes:
    """One Zstandard frame of ``data`` (see the module's docstring):
    single-segment unless ``window_log`` (10..30) is given, the content
    size then optional."""
    data = bytes(data)
    stats = Counter() if stats is None else stats
    n = len(data)
    single = window_log is None
    window = n if single else 1 << window_log
    fcs = n if (single or content_size) else None
    fhd = (4 if checksum else 0) | (32 if single else 0)
    if fcs is None:
        size_field = b""
    elif single and n < 256:
        size_field = bytes([n])
    elif n < 65536 + 256:
        fhd |= 1 << 6
        size_field = (n - 256).to_bytes(2, "little") if n >= 256 else None
        if size_field is None:  # 2 bytes cannot say under 256
            fhd = (fhd & 63) | (2 << 6)
            size_field = n.to_bytes(4, "little")
    elif n < 1 << 32:
        fhd |= 2 << 6
        size_field = n.to_bytes(4, "little")
    else:
        fhd |= 3 << 6
        size_field = n.to_bytes(8, "little")
    out = [struct.pack("<I", zstd.MAGIC), bytes([fhd])]
    if not single:
        out.append(bytes([(window_log - 10) << 3]))
    out.append(size_field)
    buf = np.frombuffer(data, np.uint8)
    prev = _candidates(buf, min_match)
    cand = np.flatnonzero(prev >= 0).tolist()
    prev = prev.tolist()
    rep, huf, tables = [1, 4, 8], None, {}
    block = max(1, min(block, BLOCK_MAX, window))
    starts = list(range(0, n, block)) or [0]
    for bs in starts:
        be = min(n, bs + block)
        last = be == n
        raw = data[bs:be]
        if be > bs and raw.count(raw[:1]) == be - bs and be - bs > 1:
            stats["block_rle"] += 1
            out.append(struct.pack("<I", last | (1 << 1) | ((be - bs) << 3))
                       [:3] + raw[:1])
            continue
        body = None
        if be - bs > 8:
            r = list(rep)
            seqs, lits = _parse(data, prev, cand, bs, be, r, min_match,
                                window)
            trial = Counter()
            lit_sec, h = _literals(lits, huf, trial)
            seq_sec, t = _sequences(seqs, tables, trial)
            body = lit_sec + seq_sec
        if body is None or len(body) >= be - bs:
            stats["block_raw"] += 1
            out.append(struct.pack("<I", last | ((be - bs) << 3))[:3] + raw)
            continue
        stats["block_compressed"] += 1
        stats.update(trial)
        rep, huf, tables = r, h, t
        stats["repeat_offsets"] += sum(1 for _, v, _ in seqs if v <= 3)
        out.append(struct.pack("<I", last | (2 << 1) | (len(body) << 3))
                   [:3] + body)
    if checksum:
        out.append(struct.pack("<I", zstd.xxh64(data) & 0xFFFFFFFF))
    return b"".join(out)


# ---- TIFF pages

def _pool(processes: int):
    """A pool of ``processes`` spawned workers (no CUDA, no inherited
    threads).  They import the job function by its module's name: this
    file run as a script, or loaded as ``zstd_writer`` with its folder
    on ``sys.path``."""
    return concurrent.futures.ProcessPoolExecutor(
        processes, mp_context=multiprocessing.get_context("spawn"))


def _chunk_job(job):
    raw, kw = job
    stats = Counter()
    return compress(raw, stats=stats, **kw), stats


def _differenced(px: np.ndarray) -> np.ndarray:
    d = px.astype(np.int16)
    d[:, 1:] -= px[:, :-1]
    return (d & 255).astype(np.uint8)


def write_tiff(path: str, img: np.ndarray, tile: Optional[int] = None,
               rows: Optional[int] = None, planar: bool = False,
               predictor: int = 1, extra: Sequence[int] = (),
               processes: int = 1, **kw) -> Counter:
    """``img`` (uint8 [H, W, 3 or 4]) as one ZSTD page of a little-endian
    TIFF at ``path``: ``tile`` x ``tile`` tiles (edge tiles padded with
    edge pixels) or strips of ``rows`` rows; planar (one chunk list a
    sample) or chunky; predictor 1 or 2 (horizontal differencing);
    ExtraSamples ``extra``.  ``kw`` goes to ``compress``.  Returns the
    summed ``stats`` of the chunks."""
    h, w, spp = img.shape
    if tile:
        full = np.pad(img, ((0, -h % tile), (0, -w % tile), (0, 0)),
                      mode="edge")
        pieces = [full[y:y + tile, x:x + tile] for y in range(0, h, tile)
                  for x in range(0, w, tile)]
    else:
        rows = rows or h
        pieces = [img[y:y + rows] for y in range(0, h, rows)]
    planes = [pieces] if not planar else [
        [p[..., s:s + 1] for p in pieces] for s in range(spp)]
    jobs = []
    for plane in planes:
        for p in plane:
            p = _differenced(p) if predictor == 2 else p
            jobs.append((np.ascontiguousarray(p).tobytes(), kw))
    if processes > 1:
        with _pool(processes) as pool:
            done = list(pool.map(_chunk_job, jobs))
    else:
        done = [_chunk_job(j) for j in jobs]
    stats = Counter()
    for _, s in done:
        stats.update(s)
    chunks = [c for c, _ in done]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [8] * spp),
               (259, 3, [50000]), (262, 3, [2]), (277, 3, [spp]),
               (284, 3, [2 if planar else 1]), (317, 3, [predictor])]
    if extra:
        entries.append((338, 3, list(extra)))
    with open(path, "wb") as f:
        f.write(b"II*\0" + struct.pack("<I", 0))
        offsets = []
        for c in chunks:
            offsets.append(f.tell())
            f.write(c)
        sizes = [len(c) for c in chunks]
        if tile:
            entries += [(322, 4, [tile]), (323, 4, [tile]),
                        (324, 4, offsets), (325, 4, sizes)]
        else:
            entries += [(273, 4, offsets), (278, 4, [rows]),
                        (279, 4, sizes)]
        _write_ifd(f, entries)
    return stats


def _write_ifd(f, entries):
    """Append one IFD of ``entries`` ((tag, field type 3 or 4, values))
    to the little-endian TIFF ``f`` and point the header at it."""
    entries = sorted(entries)
    ifd = f.tell() + f.tell() % 2
    f.write(b"\0" * (ifd - f.tell()))
    extra = ifd + 2 + 12 * len(entries) + 4
    body, blobs = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        raw = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(raw) <= 4:
            field = raw.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra + len(blobs))
            blobs += raw
        body += struct.pack("<HHI", tag, typ, len(vals)) + field
    f.write(body + b"\0\0\0\0" + blobs)
    f.seek(4)
    f.write(struct.pack("<I", ifd))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="a uint8 [H, W, 3 or 4] array (.npy)")
    ap.add_argument("dst")
    ap.add_argument("--tile", type=int, default=0)
    ap.add_argument("--rows", type=int, default=0)
    ap.add_argument("--planar", action="store_true")
    ap.add_argument("--predictor", type=int, default=1, choices=(1, 2))
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    ap.add_argument("--checksum", action="store_true")
    ap.add_argument("--min_match", type=int, default=5)
    ap.add_argument("--block", type=int, default=BLOCK_MAX)
    ap.add_argument("--processes", type=int, default=1)
    a = ap.parse_args(argv)
    stats = write_tiff(a.dst, np.load(a.src), tile=a.tile or None,
                       rows=a.rows or None, planar=a.planar,
                       predictor=a.predictor, extra=a.extra,
                       processes=a.processes, checksum=a.checksum,
                       min_match=a.min_match, block=a.block)
    print(json.dumps(dict(sorted(stats.items()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
