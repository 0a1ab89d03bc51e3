"""A reader and a writer of the YAML subset that the heatmap configs use,
in the standard library (the port's stand-in for PyYAML, which the machine
with the card lacks).  ``load`` returns what ``yaml.safe_load`` returns for
a document inside the subset, and raises ``ValueError`` for anything
outside it: it never guesses.  ``dump`` writes block YAML that both
``load`` and ``yaml.safe_load`` read back as the object it was given.

The subset:

- block mappings, and block sequences of scalars, of mappings and of
  sequences, a sequence under a key indented or at the key's column;
- flow sequences ``[...]`` and flow mappings ``{...}`` on one line;
- comments (``#`` at a line's start or after a space, outside quotes);
- plain, single-quoted and double-quoted scalars on one line, the
  double-quoted ones with the usual backslash escapes;
- PyYAML's (YAML 1.1) resolution of plain scalars: ``null`` / ``~`` /
  nothing, its booleans (``true``, ``yes``, ``on`` ... and their
  negatives), decimal ints (a sign allowed) and floats as PyYAML reads
  them (``.5``, ``1.0e-3``, ``-2.``, ``.inf``, ``.nan``; ``1e-3`` has no
  dot and stays a string, as in PyYAML).

Outside it (``ValueError``): anchors, aliases, tags, block scalars
(``|``, ``>``), scalars that span lines, complex keys (``?``), document
markers and directives, merge keys, timestamps, and ints PyYAML reads in
another base or with ``_`` or ``:``.
"""
from __future__ import annotations

import json
import re
from typing import Any, List, Tuple

import numpy as np

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _fail(line: int, what: str):
    raise _Error(f"YAML line {line + 1}: {what} (outside the subset this "
                 f"reader takes)")


def _resolve(text: str, line: int) -> Any:
    """A plain scalar as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _FLOAT.match(text):
        if "_" in text or ":" in text:
            _fail(line, f"float {text!r} with '_' or ':'")
        low = text.lower()
        if low.endswith(".inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low == ".nan":
            return float("nan")
        return float(text)
    if _INT.match(text):
        if not _DECIMAL.match(text):
            _fail(line, f"int {text!r} in another base or with '_' or ':'")
        return int(text)
    if text in ("<<", "=") or _TIMESTAMP.match(text):
        _fail(line, f"merge key, value key or timestamp {text!r}")
    return text


class _Line:
    """The scalars and flow collections of one line, read left to right
    from ``pos``."""

    def __init__(self, text: str, line: int, pos: int = 0):
        self.text, self.line, self.pos = text, line, pos

    def fail(self, what: str):
        _fail(self.line, what)

    def skip_space(self):
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """Nothing but spaces and a comment left."""
        self.skip_space()
        if self.text.startswith("#", self.pos) and (
                self.pos == 0 or self.text[self.pos - 1] == " "):
            self.pos = len(self.text)
        return self.pos >= len(self.text)

    def quoted(self) -> str:
        q = self.text[self.pos]
        i, out = self.pos + 1, []
        while i < len(self.text):
            c = self.text[i]
            if q == "'" and c == "'":
                if self.text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            if q == '"' and c == '"':
                self.pos = i + 1
                return "".join(out)
            if q == '"' and c == "\\":
                e = self.text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                    continue
                if e in _HEX:
                    digits = self.text[i + 2:i + 2 + _HEX[e]]
                    if len(digits) != _HEX[e] or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + _HEX[e]
                    continue
                self.fail(f"escape \\{e} at the end of a line or unknown")
            out.append(c)
            i += 1
        self.fail("a quoted scalar that does not end on its line")

    def plain(self, flow: bool) -> str:
        """A plain scalar: up to ': ', ' #', the line's end and, in a flow
        collection, ',' '[' ']' '{' '}'."""
        i = start = self.pos
        stops = ",[]{}" if flow else ""
        while i < len(self.text):
            c = self.text[i]
            if c in stops:
                break
            if c == ":" and (i + 1 == len(self.text)
                             or self.text[i + 1] == " "
                             or (flow and self.text[i + 1] in ",[]{}")):
                break
            if c == "#" and i > start and self.text[i - 1] == " ":
                break
            i += 1
        self.pos = i
        return self.text[start:i].rstrip()

    def scalar(self, flow: bool) -> Any:
        self.skip_space()
        c = self.text[self.pos:self.pos + 1]
        if c in ("'", '"'):
            return self.quoted()
        spaced = self.text[self.pos + 1:self.pos + 2] in ("", " ")
        if c in ("&", "*", "!", "|", ">", "%", "@", "`", ",", "]", "}") or (
                c in ("?", "-", ":") and spaced):
            self.fail(f"indicator {c!r}: anchors, aliases, tags, block "
                      f"scalars, complex keys, directives, or a sequence "
                      f"entry or flow end where a scalar should be")
        text = self.plain(flow)
        if not text and not flow:
            return None
        return _resolve(text, self.line)

    def node(self, flow: bool) -> Any:
        """A flow collection or a scalar."""
        self.skip_space()
        c = self.text[self.pos:self.pos + 1]
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        return self.scalar(flow)

    def expect(self, c: str):
        self.skip_space()
        if self.text[self.pos:self.pos + 1] != c:
            self.fail(f"expected {c!r} at column {self.pos + 1} (a flow "
                      f"collection must end on its line)")
        self.pos += 1

    def flow_seq(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_space()
            if self.text[self.pos:self.pos + 1] == "]":
                self.pos += 1
                return out
            item = self.node(flow=True)
            self.skip_space()
            if self.text[self.pos:self.pos + 1] == ":":
                self.fail("a single-pair mapping inside a flow sequence")
            out.append(item)
            self.skip_space()
            if self.text[self.pos:self.pos + 1] != "]":
                self.expect(",")

    def flow_map(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self.skip_space()
            if self.text[self.pos:self.pos + 1] == "}":
                self.pos += 1
                return out
            key = self.node(flow=True)
            if isinstance(key, (list, dict)):
                self.fail("a collection as a mapping key")
            self.skip_space()
            if self.text[self.pos:self.pos + 1] == ":":
                self.pos += 1
                self.skip_space()
                nxt = self.text[self.pos:self.pos + 1]
                value = None if nxt in (",", "}") else self.node(flow=True)
            else:
                value = None
            out[key] = value
            self.skip_space()
            if self.text[self.pos:self.pos + 1] != "}":
                self.expect(",")

    def key(self) -> Tuple[Any, bool]:
        """(key, True) when the rest of the line is ``key: ...`` (pos then
        after the ':'), else (None, False) with pos unchanged."""
        start = self.pos
        c = self.text[self.pos:self.pos + 1]
        if c in ("[", "{"):
            return None, False
        try:
            k = self.scalar(flow=False)
        except _Error:
            self.pos = start
            return None, False
        self.skip_space()
        if self.text[self.pos:self.pos + 1] == ":" and (
                self.pos + 1 == len(self.text)
                or self.text[self.pos + 1] == " "):
            self.pos += 1
            return k, True
        self.pos = start
        return None, False


def _lines(src: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, text) of each line that holds content (a
    comment after content is left to ``_Line``)."""
    out = []
    for n, raw in enumerate(src.splitlines()):
        body = raw.lstrip(" ")
        if not body.strip() or body.startswith("#"):
            continue
        if body.startswith("\t"):
            _fail(n, "a tab in the indentation")
        if raw.startswith(("---", "...", "%")):
            _fail(n, "a document marker or directive")
        out.append((n, len(raw) - len(body), body.rstrip()))
    return out


class _Block:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        """The block node whose first line is the current one, at
        ``indent``."""
        n, ind, text = self.peek()
        if text == "-" or text.startswith("- "):
            return self.seq(ind)
        ln = _Line(text, n)
        _, is_key = ln.key()
        if is_key:
            return self.map(ind)
        value = ln.node(flow=False)
        if not ln.at_end():
            ln.fail(f"text after a value: {text[ln.pos:]!r}")
        self.i += 1
        self.no_continuation(ind, n)
        return value

    def no_continuation(self, indent: int, n: int):
        nxt = self.peek()
        if nxt is not None and nxt[1] > indent:
            _fail(nxt[0], f"a line indented under line {n + 1}'s value "
                          f"(a scalar that spans lines)")

    def value_after(self, ln: _Line, indent: int, seq_at_indent: bool):
        """The value of a key or sequence entry: on its line, or the block
        node on the lines below."""
        n = ln.line
        if not ln.at_end():
            value = ln.node(flow=False)
            if not ln.at_end():
                ln.fail(f"text after a value: {ln.text[ln.pos:]!r}")
            self.i += 1
            self.no_continuation(indent, n)
            return value
        self.i += 1
        nxt = self.peek()
        if nxt is None:
            return None
        _, ind, text = nxt
        is_seq = text == "-" or text.startswith("- ")
        if ind > indent or (seq_at_indent and ind == indent and is_seq):
            return self.node(ind)
        return None

    def map(self, indent: int) -> dict:
        out = {}
        while True:
            cur = self.peek()
            if cur is None or cur[1] < indent:
                return out
            n, ind, text = cur
            if ind > indent:
                _fail(n, "a line indented deeper than its mapping")
            ln = _Line(text, n)
            key, is_key = ln.key()
            if not is_key:
                _fail(n, f"a mapping entry without 'key:' ({text!r})")
            out[key] = self.value_after(ln, indent, seq_at_indent=True)

    def seq(self, indent: int) -> list:
        out = []
        while True:
            cur = self.peek()
            if cur is None or cur[1] < indent:
                return out
            n, ind, text = cur
            if ind > indent:
                _fail(n, "a line indented deeper than its sequence")
            if not (text == "-" or text.startswith("- ")):
                return out
            rest = text[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                out.append(self.value_after(_Line("", n), indent,
                                            seq_at_indent=False))
                continue
            # the entry's content is a node at its own column
            col = ind + len(text) - len(rest)
            self.lines[self.i] = (n, col, rest)
            out.append(self.node(col))


def load(src: str) -> Any:
    """``yaml.safe_load(src)`` for a document inside the subset."""
    lines = _lines(src)
    if not lines:
        return None
    block = _Block(lines)
    out = block.node(lines[0][1])
    if block.peek() is not None:
        n, _, text = block.peek()
        _fail(n, f"content after the document's top node: {text!r}")
    return out


def load_file(path: str) -> Any:
    with open(path, encoding="utf-8") as f:
        return load(f.read())



# a plain scalar may not start with an indicator, nor hold ': ' or ' #';
# one that starts with a digit, a sign or a dot is quoted too
_PLAIN_START = set("-?:,[]{}#&*!|>'\"%@`. +0123456789~")
_PRINTABLE = re.compile("^[\x21-\x7e\u00a0-\ud7ff\ue000-\ufffd]"
                        "[\x20-\x7e\u00a0-\ud7ff\ue000-\ufffd]*$")


def _plain_ok(text: str) -> bool:
    """True when ``text`` may be written unquoted: printable on one line,
    no indicator, digit, sign or dot first, no ': ' or ' #', no ' ' or ':'
    last, and read back as this same string."""
    if not _PRINTABLE.match(text) or text[0] in _PLAIN_START \
            or ": " in text or " #" in text or text[-1] in " :":
        return False
    try:
        return _resolve(text, 0) == text
    except ValueError:
        return False


def _scalar(v) -> str:
    """A scalar as PyYAML's safe_dump would write one that reads back
    equal: strings plain when they are safe, else double-quoted."""
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v)
        if "." not in text:  # 1e-05: YAML 1.1 floats need a dot and a sign
            mant, _, exp = text.partition("e")
            text = f"{mant}.0e{exp if exp[0] in '+-' else '+' + exp}"
        return text
    if isinstance(v, str):
        return v if _plain_ok(v) else json.dumps(v, ensure_ascii=False)
    raise TypeError(f"dump: a {type(v).__name__} is outside the subset")


def _is_block(v) -> bool:
    return isinstance(v, (dict, list, tuple)) and len(v) > 0


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def _block(v) -> List[str]:
    """The lines of a non-empty mapping or sequence at column 0, laid out
    as ``yaml.dump(default_flow_style=False, sort_keys=False)`` lays them
    out: keys in insertion order, a sequence under a key at the key's
    column."""
    out: List[str] = []
    if isinstance(v, dict):
        for k, item in v.items():
            if isinstance(k, (dict, list, tuple)):
                raise TypeError("dump: a collection as a mapping key")
            key = _scalar(k) + ":"
            if not _is_block(item):
                out.append(f"{key} {_inline(item)}")
                continue
            out.append(key)
            sub = _block(item)
            out += sub if isinstance(item, (list, tuple)) else [
                "  " + line for line in sub]
        return out
    for item in v:
        if not _is_block(item):
            out.append(f"- {_inline(item)}")
            continue
        sub = _block(item)
        out += ["- " + sub[0]] + ["  " + line for line in sub[1:]]
    return out


def dump(obj) -> str:
    """``obj`` (nested dicts and lists of str, int, float, bool and None)
    as block YAML that ``load`` and ``yaml.safe_load`` read back equal."""
    if _is_block(obj):
        return "\n".join(_block(obj)) + "\n"
    return _inline(obj) + "\n"


def dump_file(obj, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dump(obj))
