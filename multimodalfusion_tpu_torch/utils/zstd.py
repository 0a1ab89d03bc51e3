"""Zstandard decompression (RFC 8878) in numpy and Python: the port's
stand-in for the libzstd that PIL's libtiff links to read ZSTD-compressed
TIFF chunks (Compression 50000), and the plain version that the C++
decoder (``mmf_zstd_decode`` and ``mmf_tiff_chunks_decode``'s codec 50000
in ``csrc/imgcodec.cpp``) is held to bit for bit.

``decompress`` reads one frame after another:

- the frame header: the magic ``0xFD2FB528``, the descriptor, the window
  descriptor or single-segment mode, the frame content size;
- a frame that names a dictionary raises ``NotImplementedError`` naming
  its ID (libtiff never sets one; libzstd refuses one without it);
- raw, RLE and compressed blocks of at most 128 KiB (and of at most the
  window);
- literals: raw, RLE, Huffman-coded in 1 or 4 streams, or treeless (the
  previous block's Huffman table), the weights sent directly or
  FSE-coded;
- sequences: the literal-length, offset and match-length tables
  predefined, RLE, FSE-coded or repeated from the previous block; the
  three repeat offsets; matches over every earlier block of the frame;
- the content checksum (the low 32 bits of ``xxh64``), verified;
- skippable frames (magic ``0x184D2A5?``), skipped.

libzstd's default window limit holds (2^27 bytes, as
``ZSTD_decompressStream`` applies it for libtiff: to a frame that does
not declare a content size fitting the output left): a larger window
raises ``ValueError``.  A corrupt stream raises ``ValueError``.  With
``cap``, decoding stops once the output passes ``cap`` bytes, or once a
frame ends with exactly ``cap`` out, as libtiff stops when a chunk's
buffer is full; what follows is not read.  Nothing is written past
``cap``: the block that crosses it is checked whole and cut there.
With ``one_frame``, decoding stops after the first frame (a skippable
one included), as libtiff's ZSTDDecode stops when
``ZSTD_decompressStream`` says a frame is done: a TIFF chunk is read
so.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50          # the magic of a skippable frame, low 4 bits 0
WINDOW_LOG_LIMIT = 27           # libzstd's ZSTD_WINDOWLOG_LIMIT_DEFAULT
BLOCK_MAX = 1 << 17
HUF_LOG_MAX = 12                # libzstd's HUF_TABLELOG_MAX

# literal length and match length codes: (base, extra bits)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384,
                             32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
# the predefined distributions (accuracy logs 6, 6, 5)
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5
# per table: (max symbol, max accuracy log, predefined counts, their log)
SEQ_TABLES = {"ll": (35, 9, LL_DEFAULT, 6), "of": (31, 8, OF_DEFAULT, 5),
              "ml": (52, 9, ML_DEFAULT, 6)}


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt Zstandard data ({what})")


def dictionary_error(dict_id: int) -> NotImplementedError:
    return NotImplementedError(
        f"a Zstandard frame that names dictionary ID {dict_id}: the port "
        f"decodes frames without a dictionary, as libtiff writes them")


def window_error(window: int) -> ValueError:
    return ValueError(f"a Zstandard window of {window} bytes, over "
                      f"libzstd's default limit of 2^{WINDOW_LOG_LIMIT}")


# ---- xxHash64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    n = len(data)
    mv = memoryview(data).cast("B")
    at = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        lanes = mv[:n // 32 * 32].cast("Q")
        v1, v2, v3, v4 = v
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) & _M64
        for x in (v1, v2, v3, v4):
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
        at = n // 32 * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while at + 8 <= n:
        h ^= _round(0, int.from_bytes(mv[at:at + 8], "little"))
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        at += 8
    if at + 4 <= n:
        h ^= int.from_bytes(mv[at:at + 4], "little") * _P1 & _M64
        h = ((((h << 23) | (h >> 41)) & _M64) * _P2 + _P3) & _M64
        at += 4
    while at < n:
        h ^= mv[at] * _P5 & _M64
        h = (((h << 11) | (h >> 53)) & _M64) * _P1 & _M64
        at += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---- bit streams

class _Back:
    """A backward bit stream over ``data[start:end]``: the last byte's
    highest set bit marks its end; fields are read from there towards
    the start, each an LSB-first integer, zeros past the start.
    ``pos`` is the count of bits left (negative once overread)."""

    def __init__(self, data: bytes, start: int, end: int):
        if end <= start or data[end - 1] == 0:
            raise _corrupt("an empty bit stream or one without its end "
                           "mark")
        self.data, self.start = data, start
        self.pos = 8 * (end - 1 - start) + data[end - 1].bit_length() - 1

    def bits(self, at: int, n: int) -> int:
        """The ``n`` bits from bit ``at`` up (zeros below 0)."""
        if at < 0:
            return self.bits(0, n + at) << -at if n + at > 0 else 0
        b = self.start + (at >> 3)
        return (int.from_bytes(self.data[b:b + 8], "little") >> (at & 7)) \
            & ((1 << n) - 1)

    def read(self, n: int) -> int:
        self.pos -= n
        return self.bits(self.pos, n) if n else 0


# ---- FSE

class Table(NamedTuple):
    """A decoding table: each state's symbol, its bit count and the base
    of the next state; ``log`` is the accuracy log (0: RLE)."""
    sym: List[int]
    nb: List[int]
    base: List[int]
    log: int


def read_ncount(data: bytes, pos: int, end: int, max_symbol: int,
                max_log: int) -> Tuple[List[int], int, int]:
    """An FSE table description at ``pos`` (RFC 8878 4.1.1): the
    normalized counts (-1: less than one), the accuracy log and the
    position after it."""
    if pos >= end:
        raise _corrupt("a missing FSE table description")
    window = int.from_bytes(data[pos:min(end, pos + 600)], "little")
    log = (window & 15) + 5
    if log > max_log:
        raise _corrupt(f"an FSE accuracy log of {log} over {max_log}")
    at, remaining, threshold, nb = 4, (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            while True:
                r = (window >> at) & 3
                at += 2
                counts.extend([0] * r)
                if r != 3:
                    break
            if len(counts) > max_symbol:
                break
        most = 2 * threshold - 1 - remaining
        low = (window >> at) & (threshold - 1)
        if low < most:
            count, at = low, at + nb - 1
        else:
            count = (window >> at) & (2 * threshold - 1)
            if count >= threshold:
                count -= most
            at += nb
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
    used = (at + 7) >> 3
    if remaining != 1 or len(counts) > max_symbol + 1 or pos + used > end:
        raise _corrupt("a bad FSE table description")
    return counts, log, pos + used


def fse_table(counts: List[int], log: int) -> Table:
    """The decoding table of normalized ``counts`` (RFC 8878 4.1.1)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise _corrupt("an FSE table that does not spread")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] += 1
        nb[u] = log + 1 - x.bit_length()
        base[u] = (x << nb[u]) - size
    return Table(sym, nb, base, log)


def rle_table(symbol: int) -> Table:
    return Table([symbol], [0], [0], 0)


_PREDEFINED = {k: fse_table(v[2], v[3]) for k, v in SEQ_TABLES.items()}


# ---- Huffman literals

def _fse_weights(data: bytes, pos: int, end: int) -> List[int]:
    """FSE-coded Huffman weights in ``data[pos:end]``: two interleaved
    states, until the stream is overread (libzstd's FSE_decompress)."""
    counts, log, pos = read_ncount(data, pos, end, 255, 6)
    t = fse_table(counts, log)
    br = _Back(data, pos, end)
    s1, s2 = br.read(log), br.read(log)
    out: List[int] = []
    while True:
        if len(out) > 253:
            raise _corrupt("more than 255 Huffman weights")
        out.append(t.sym[s1])
        s1 = t.base[s1] + br.read(t.nb[s1])
        if br.pos < 0:
            out.append(t.sym[s2])
            return out
        if len(out) > 253:
            raise _corrupt("more than 255 Huffman weights")
        out.append(t.sym[s2])
        s2 = t.base[s2] + br.read(t.nb[s2])
        if br.pos < 0:
            out.append(t.sym[s1])
            return out


class Huffman(NamedTuple):
    """A Huffman decoding table: the symbol and bit count of each
    ``log``-bit prefix."""
    sym: List[int]
    nb: List[int]
    log: int


def read_huffman(data: bytes, pos: int, end: int) -> Tuple[Huffman, int]:
    """The Huffman tree description at ``pos`` (RFC 8878 4.2.1) and the
    position after it."""
    if pos >= end:
        raise _corrupt("a missing Huffman tree description")
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        if pos + (n + 1) // 2 > end:
            raise _corrupt("truncated Huffman weights")
        w = [data[pos + i // 2] >> 4 if i % 2 == 0 else data[pos + i // 2] & 15
             for i in range(n)]
        pos += (n + 1) // 2
    else:
        if pos + head > end:
            raise _corrupt("truncated FSE-coded Huffman weights")
        w = _fse_weights(data, pos, pos + head)
        pos += head
    if max(w) > HUF_LOG_MAX:
        raise _corrupt("a Huffman weight over 12")
    total = sum((1 << x) >> 1 for x in w)
    if total == 0:
        raise _corrupt("Huffman weights of zero")
    log = total.bit_length()
    if log > HUF_LOG_MAX:
        raise _corrupt("a Huffman table over 12 bits")
    rest = (1 << log) - total
    last = rest.bit_length()
    if rest != 1 << (last - 1):
        raise _corrupt("Huffman weights that leave no power of two")
    w.append(last)
    ones = w.count(1)
    if ones < 2 or ones % 2:
        raise _corrupt("an odd count of the longest Huffman codes")
    sym: List[int] = []
    nb: List[int] = []
    for s in sorted((s for s in range(len(w)) if w[s]),
                    key=lambda s: (w[s], s)):
        sym += [s] * (1 << (w[s] - 1))
        nb += [log + 1 - w[s]] * (1 << (w[s] - 1))
    return Huffman(sym, nb, log), pos


def huffman_stream(data: bytes, start: int, end: int, h: Huffman,
                   n: int) -> bytes:
    """``n`` literals from the Huffman stream ``data[start:end]``, which
    they must use up exactly."""
    br = _Back(data, start, end)
    out = bytearray(n)
    sym, nb, log = h.sym, h.nb, h.log
    mask = (1 << log) - 1
    pos = br.pos
    for i in range(n):
        at = pos - log
        if at >= 0:
            b = start + (at >> 3)
            v = (int.from_bytes(data[b:b + 3], "little") >> (at & 7)) & mask
        else:
            v = br.bits(at, log)
        out[i] = sym[v]
        pos -= nb[v]
    if pos != 0:
        raise _corrupt("a Huffman stream not used up exactly")
    return bytes(out)


class _State:
    """What a frame's blocks hand on to the next: the Huffman table, the
    three sequence tables and the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _State
              ) -> Tuple[bytes, int]:
    """The literals section at ``pos``: the literals and the position
    after it."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        hl = (1, 2, 1, 3)[fmt]
        if pos + hl > end:
            raise _corrupt("a truncated literals header")
        v = int.from_bytes(data[pos:pos + hl], "little")
        size = v >> 3 if hl == 1 else v >> 4
        pos += hl
        if kind == 0:
            if pos + size > end:
                raise _corrupt("truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise _corrupt("truncated RLE literals")
        if size > BLOCK_MAX:
            raise _corrupt("more than 128 KiB of literals")
        return bytes(data[pos:pos + 1]) * size, pos + 1
    if end - pos < 5:
        raise _corrupt("a compressed literals section under 5 bytes")
    hl = (3, 3, 4, 5)[fmt]
    v = int.from_bytes(data[pos:pos + hl], "little")
    bits = (10, 10, 14, 18)[fmt]
    regen, comp = (v >> 4) & ((1 << bits) - 1), v >> (4 + bits)
    if regen > BLOCK_MAX:
        raise _corrupt("more than 128 KiB of literals")
    pos += hl
    stop = pos + comp
    if stop > end:
        raise _corrupt("compressed literals past the block")
    if kind == 2:
        st.huffman, pos = read_huffman(data, pos, stop)
    elif st.huffman is None:
        raise _corrupt("treeless literals without a previous Huffman table")
    h = st.huffman
    if fmt == 0:
        return huffman_stream(data, pos, stop, h, regen), stop
    if regen < 6:
        raise _corrupt("fewer than 6 literals in 4 streams")
    if stop - pos < 10:
        raise _corrupt("4 Huffman streams in under 10 bytes")
    sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little")
             for i in range(3)]
    pos += 6
    sizes.append(stop - pos - sum(sizes))
    if sizes[3] < 1:
        raise _corrupt("a Huffman jump table past the literals")
    seg = (regen + 3) // 4
    out = []
    for i, s in enumerate(sizes):
        out.append(huffman_stream(data, pos, pos + s, h,
                                  seg if i < 3 else regen - 3 * seg))
        pos += s
    return b"".join(out), stop


def _sequences(data: bytes, pos: int, end: int, st: _State
               ) -> List[Tuple[int, int, int]]:
    """The sequences section ``data[pos:end]``: (literal length, offset,
    match length) of each sequence, the repeat offsets resolved."""
    if pos >= end:
        raise _corrupt("a missing sequences section")
    b0 = data[pos]
    pos += 1
    if b0 == 0:
        if pos != end:
            raise _corrupt("bytes after an empty sequences section")
        return []
    if b0 == 255:
        if pos + 2 > end:
            raise _corrupt("a truncated sequence count")
        n = data[pos] + (data[pos + 1] << 8) + 0x7F00
        pos += 2
    elif b0 >= 128:
        if pos >= end:
            raise _corrupt("a truncated sequence count")
        n = ((b0 - 128) << 8) + data[pos]
        pos += 1
    else:
        n = b0
    if pos >= end:
        raise _corrupt("missing sequence compression modes")
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise _corrupt("reserved bits set in the compression modes")
    tabs = {}
    for key, mode in (("ll", modes >> 6), ("of", (modes >> 4) & 3),
                      ("ml", (modes >> 2) & 3)):
        max_symbol, max_log = SEQ_TABLES[key][:2]
        if mode == 0:
            t = _PREDEFINED[key]
        elif mode == 1:
            if pos >= end:
                raise _corrupt("a missing RLE symbol")
            if data[pos] > max_symbol:
                raise _corrupt(f"an RLE {key} code of {data[pos]}")
            t = rle_table(data[pos])
            pos += 1
        elif mode == 2:
            counts, log, pos = read_ncount(data, pos, end, max_symbol,
                                           max_log)
            t = fse_table(counts, log)
        else:
            t = st.tables[key]
            if t is None:
                raise _corrupt(f"a repeated {key} table with none before")
        tabs[key] = st.tables[key] = t
    ll_t, of_t, ml_t = tabs["ll"], tabs["of"], tabs["ml"]
    br = _Back(data, pos, end)
    ll_s, of_s, ml_s = br.read(ll_t.log), br.read(of_t.log), br.read(
        ml_t.log)
    rep = st.rep
    seqs = []
    for i in range(n):
        of_code, ll_code, ml_code = of_t.sym[of_s], ll_t.sym[ll_s], \
            ml_t.sym[ml_s]
        ov = (1 << of_code) + br.read(of_code)
        ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code])
        if ov > 3:
            off = ov - 3
            rep[:] = [off, rep[0], rep[1]]
        else:
            k = ov - (ll != 0)      # 0, 1, 2: rep[k]; 3: rep[0] - 1
            off = rep[0] - 1 if k == 3 else rep[k]
            if k == 1:
                rep[:] = [off, rep[0], rep[2]]
            elif k > 1:
                rep[:] = [off, rep[0], rep[1]]
        seqs.append((ll, off, ml))
        if i + 1 < n:
            ll_s = ll_t.base[ll_s] + br.read(ll_t.nb[ll_s])
            ml_s = ml_t.base[ml_s] + br.read(ml_t.nb[ml_s])
            of_s = of_t.base[of_s] + br.read(of_t.nb[of_s])
    if br.pos != 0:
        raise _corrupt("a sequences bit stream not used up exactly")
    return seqs


def _execute(out: bytearray, lits: bytes, seqs, frame_start: int,
             limit: int) -> None:
    """Append the block of ``lits`` and ``seqs`` to ``out`` (the frame
    starts at ``frame_start``); at most ``limit`` bytes."""
    at, start = 0, len(out)
    for ll, off, ml in seqs:
        if at + ll > len(lits):
            raise _corrupt("sequences past the literals")
        out += lits[at:at + ll]
        at += ll
        if off < 1 or off > len(out) - frame_start:
            raise _corrupt(f"an offset of {off} before the frame")
        if len(out) - start + ml > limit:
            raise _corrupt("a block over its maximum size")
        src = len(out) - off
        if off >= ml:
            out += out[src:src + ml]
        else:
            out += (out[src:] * (ml // off + 1))[:ml]
    out += lits[at:]
    if len(out) - start > limit:
        raise _corrupt("a block over its maximum size")


class FrameHeader(NamedTuple):
    window: int                 # bytes
    content_size: Optional[int]
    checksum: bool
    size: int                   # of the header, magic included


def frame_header(data: bytes, pos: int = 0) -> FrameHeader:
    """The header of the Zstandard frame at ``pos``; a dictionary ID
    raises ``NotImplementedError``."""
    if pos + 5 > len(data) or int.from_bytes(data[pos:pos + 4],
                                             "little") != MAGIC:
        raise _corrupt("no frame magic")
    fhd = data[pos + 4]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise _corrupt("the reserved bit of the frame header set")
    did_size = (0, 1, 2, 4)[fhd & 3]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    at = pos + 5
    size = 5 + (not single) + did_size + fcs_size
    if pos + size > len(data):
        raise _corrupt("a truncated frame header")
    window = 0
    if not single:
        wd = data[at]
        at += 1
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
    dict_id = int.from_bytes(data[at:at + did_size], "little")
    at += did_size
    content = None
    if fcs_size:
        content = int.from_bytes(data[at:at + fcs_size], "little") + (
            256 if fcs_size == 2 else 0)
    if single:
        window = content
    if dict_id:
        raise dictionary_error(dict_id)
    return FrameHeader(window, content, bool(fhd & 4), size)


def decompress(data: bytes, cap: Optional[int] = None,
               one_frame: bool = False) -> bytes:
    """Every frame of ``data`` decoded, one after another, or only the
    first (``one_frame``; see the module's docstring; ``cap``: stop
    there, as libtiff does)."""
    data = bytes(data)
    cap = float("inf") if cap is None else cap
    out = bytearray()
    pos, n, frames = 0, len(data), 0
    while pos < n and len(out) < cap and not (one_frame and frames):
        frames += 1
        if pos + 4 > n:
            raise _corrupt("a truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == SKIPPABLE:
            if pos + 8 > n:
                raise _corrupt("a truncated skippable frame")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > n:
                raise _corrupt("a truncated skippable frame")
            continue
        fh = frame_header(data, pos)
        fits = fh.content_size is not None and (
            fh.content_size <= cap - len(out))
        if fh.window > 1 << WINDOW_LOG_LIMIT and not fits:
            raise window_error(fh.window)
        limit = min(fh.window, BLOCK_MAX)
        pos += fh.size
        frame_start = len(out)
        st = _State()
        while True:
            if pos + 3 > n:
                raise _corrupt("a truncated block header")
            bh = int.from_bytes(data[pos:pos + 3], "little")
            last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
            pos += 3
            if kind == 3:
                raise _corrupt("a reserved block type")
            if size > limit:
                raise _corrupt(f"a block of {size} bytes over {limit}")
            if pos + (1 if kind == 1 else size) > n:
                raise _corrupt("a truncated block")
            if kind == 0:
                out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                out += data[pos:pos + 1] * size
                pos += 1
            else:
                if size < 2:
                    raise _corrupt("a compressed block under 2 bytes")
                end = pos + size
                lits, at = _literals(data, pos, end, st)
                seqs = _sequences(data, at, end, st)
                _execute(out, lits, seqs, frame_start, limit)
                pos = end
            if len(out) > cap:
                return bytes(out[:cap])
            if last:
                break
        got = len(out) - frame_start
        if fh.content_size is not None and got != fh.content_size:
            raise _corrupt(f"a frame of {got} bytes that declares "
                           f"{fh.content_size}")
        if fh.checksum:
            if pos + 4 > n:
                raise _corrupt("a truncated checksum")
            want = int.from_bytes(data[pos:pos + 4], "little")
            if xxh64(bytes(out[frame_start:])) & 0xFFFFFFFF != want:
                raise ValueError("Zstandard content checksum mismatch")
            pos += 4
    return bytes(out)
