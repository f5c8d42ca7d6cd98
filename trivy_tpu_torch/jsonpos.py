"""JSON parsing with per-member line spans (the port's copy of the JAX
package's jsonpos.py).

The reference's npm/packagejson parsers use liamg/jfather to recover the
start/end line of every object member so lockfile packages can carry
`Locations` (pkg/dependency/parser/nodejs/npm/parse.go StartLine/EndLine,
surfaced in npm.json.golden). Python's json module discards positions, so
this is a small recursive-descent parser that returns dicts whose
`.spans[key] == (start_line, end_line)` — the 1-indexed lines of the
member's value (first token line through last token line).
"""

from __future__ import annotations

import re

__all__ = ["SpanDict", "SpanList", "parse"]


class SpanDict(dict):
    """dict with .spans: key → (start_line, end_line) of the value."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.spans: dict = {}


class SpanList(list):
    """list with .spans: index → (start_line, end_line) of the element
    (composer.lock / Package.resolved report per-array-entry spans)."""

    def __init__(self, *a):
        super().__init__(*a)
        self.spans: list = []


_NUM = re.compile(r"-?(?:0|[1-9]\d*)(?:\.\d+)?(?:[eE][-+]?\d+)?")
_WS = " \t\r\n"


class JSONPosError(ValueError):
    pass


class _Parser:
    def __init__(self, text: str):
        self.s = text
        self.n = len(text)
        self.i = 0
        self.line = 1

    def error(self, msg: str) -> JSONPosError:
        return JSONPosError(f"line {self.line}: {msg}")

    def ws(self):
        s, n = self.s, self.n
        while self.i < n and s[self.i] in _WS:
            if s[self.i] == "\n":
                self.line += 1
            self.i += 1

    def value(self):
        self.ws()
        if self.i >= self.n:
            raise self.error("unexpected end of input")
        c = self.s[self.i]
        if c == "{":
            return self.obj()
        if c == "[":
            return self.arr()
        if c == '"':
            return self.string()
        if self.s.startswith("true", self.i):
            self.i += 4
            return True
        if self.s.startswith("false", self.i):
            self.i += 5
            return False
        if self.s.startswith("null", self.i):
            self.i += 4
            return None
        m = _NUM.match(self.s, self.i)
        if m:
            self.i = m.end()
            text = m.group(0)
            return float(text) if ("." in text or "e" in text
                                   or "E" in text) else int(text)
        raise self.error(f"unexpected character {c!r}")

    def obj(self) -> SpanDict:
        out = SpanDict()
        self.i += 1  # {
        self.ws()
        if self.i < self.n and self.s[self.i] == "}":
            self.i += 1
            return out
        while True:
            self.ws()
            if self.i >= self.n or self.s[self.i] != '"':
                raise self.error("expected object key")
            key = self.string()
            self.ws()
            if self.i >= self.n or self.s[self.i] != ":":
                raise self.error("expected ':'")
            self.i += 1
            self.ws()
            start = self.line
            out[key] = self.value()
            out.spans[key] = (start, self.line)
            self.ws()
            if self.i < self.n and self.s[self.i] == ",":
                self.i += 1
                continue
            if self.i < self.n and self.s[self.i] == "}":
                self.i += 1
                return out
            raise self.error("expected ',' or '}'")

    def arr(self) -> "SpanList":
        out = SpanList()
        self.i += 1  # [
        self.ws()
        if self.i < self.n and self.s[self.i] == "]":
            self.i += 1
            return out
        while True:
            self.ws()
            start = self.line
            out.append(self.value())
            out.spans.append((start, self.line))
            self.ws()
            if self.i < self.n and self.s[self.i] == ",":
                self.i += 1
                continue
            if self.i < self.n and self.s[self.i] == "]":
                self.i += 1
                return out
            raise self.error("expected ',' or ']'")

    _HEX = set("0123456789abcdefABCDEF")

    def _hex4(self, at: int, strict: bool = True) -> int:
        """Four hex digits at ``at`` (\\uXXXX payload). strict=False
        returns -1 on malformed input instead of raising (used when
        probing for a low surrogate)."""
        hx = self.s[at:at + 4]
        if len(hx) == 4 and all(c in self._HEX for c in hx):
            return int(hx, 16)
        if strict:
            raise self.error("invalid \\u escape")
        return -1

    def string(self) -> str:
        # JSON strings cannot contain raw newlines, so no line tracking
        s = self.s
        j = self.i + 1
        buf = []
        while j < self.n:
            c = s[j]
            if c == '"':
                self.i = j + 1
                return "".join(buf)
            if c == "\\":
                if j + 1 >= self.n:
                    raise self.error("unterminated string")
                esc = s[j + 1]
                if esc == "u":
                    cp = self._hex4(j + 2)
                    j += 6
                    # UTF-16 surrogate pair → one astral char
                    if 0xD800 <= cp <= 0xDBFF and s[j:j + 2] == "\\u":
                        lo = self._hex4(j + 2, strict=False)
                        if 0xDC00 <= lo <= 0xDFFF:
                            cp = 0x10000 + ((cp - 0xD800) << 10) \
                                + (lo - 0xDC00)
                            j += 6
                    buf.append(chr(cp))
                    continue
                buf.append({"n": "\n", "t": "\t", "r": "\r", "b": "\b",
                            "f": "\f"}.get(esc, esc))
                j += 2
                continue
            buf.append(c)
            j += 1
        raise self.error("unterminated string")


def parse(data: bytes | str):
    """→ parsed value; every dict is a SpanDict with .spans filled."""
    if isinstance(data, bytes):
        data = data.decode("utf-8", errors="replace")
    if data.startswith("﻿"):
        data = data[1:]
    p = _Parser(data)
    v = p.value()
    p.ws()
    if p.i != p.n:
        raise p.error("trailing data")
    return v
