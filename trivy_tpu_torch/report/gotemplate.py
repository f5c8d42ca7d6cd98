"""Go text/template subset interpreter for `--format template`.

The reference renders user templates (and the shipped contrib/*.tpl:
html, junit, gitlab, gitlab-codequality, asff) with Go text/template +
sprig (pkg/report/template.go:32-75). We execute the same template
language over the report's JSON-shaped dict tree, covering every
construct those templates use: actions with trim markers, comments,
if/else-if/else, range (with key/value vars), with, variables
($x := / $x =), pipelines, parenthesised calls, and the function set
(sprig subset + trivy's escapeXML/escapeString/endWithPeriod/
sourceID/appVersion).

Go-struct field promotion (e.g. `.Vulnerability.Severity` on a
DetectedVulnerability, whose JSON form inlines the embedded struct) is
emulated by _EMBEDDED markers.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import datetime as _dt

__all__ = ["Template", "TemplateError"]


class TemplateError(ValueError):
    pass


# ---------------------------------------------------------------- lexer

_ACTION_RE = re.compile(r"\{\{(-)?((?:[^}\"'`]|\"(?:[^\"\\]|\\.)*\"|'(?:[^'\\]|\\.)*'|`[^`]*`|\}(?!\}))*?)(-)?\}\}")

_TOKEN_RE = re.compile(r"""
    \s+
  | (?P<raw>`[^`]*`)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<char>'(?:[^'\\]|\\.)*')
  | (?P<num>-?\d+(?:\.\d+)?)
  | (?P<decl>:=)
  | (?P<assign>=)
  | (?P<pipe>\|)
  | (?P<lparen>\()
  | (?P<rparen>\))
  | (?P<comma>,)
  | (?P<var>\$[A-Za-z0-9_]*)
  | (?P<field>(?:\.[A-Za-z0-9_]+)+)
  | (?P<dot>\.)
  | (?P<ident>[A-Za-z][A-Za-z0-9_]*)
""", re.VERBOSE)


def _tokenize_action(src: str) -> list[tuple]:
    """Tokens are (kind, text, spaced) — `spaced` marks a token preceded
    by whitespace, which separates operands (`.A .B` is two operands,
    `$x.A` attaches the field chain to the variable)."""
    toks, pos, spaced = [], 0, True
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise TemplateError(f"bad token at {src[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind:
            toks.append((kind, m.group(), spaced))
            spaced = False
        else:
            spaced = True
    return toks


# ----------------------------------------------------------------- AST

class _Text:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s


class _Action:
    __slots__ = ("pipe",)

    def __init__(self, pipe):
        self.pipe = pipe


class _If:
    __slots__ = ("pipe", "body", "els")

    def __init__(self, pipe, body, els):
        self.pipe, self.body, self.els = pipe, body, els


class _Range:
    __slots__ = ("kvar", "vvar", "pipe", "body", "els")

    def __init__(self, kvar, vvar, pipe, body, els):
        self.kvar, self.vvar, self.pipe = kvar, vvar, pipe
        self.body, self.els = body, els


class _TemplateCall:
    __slots__ = ("name", "pipe")

    def __init__(self, name, pipe):
        self.name = name
        self.pipe = pipe


class _With:
    __slots__ = ("pipe", "body", "els")

    def __init__(self, pipe, body, els):
        self.pipe, self.body, self.els = pipe, body, els


# pipeline = optional (varname, op) + list of commands; command = list of
# operands; operand = ("lit", v) | ("dot", fields) | ("var", name, fields)
# | ("call", name, args, fields) | ("paren", pipeline, fields)


def _unquote_name(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] in "\"`" and s[-1] == s[0]:
        return s[1:-1]
    return s


class _Parser:
    def __init__(self, text: str):
        self.items = self._split(text)
        self.i = 0
        self.defines: dict[str, list] = {}

    @staticmethod
    def _split(text):
        """Split template into ('text', s) / ('action', src) items,
        applying {{- -}} whitespace trimming."""
        items = []
        pos = 0
        for m in _ACTION_RE.finditer(text):
            pre = text[pos:m.start()]
            if m.group(1):  # {{-  : trim trailing ws of preceding text
                pre = pre.rstrip(" \t\r\n")
            items.append(("text", pre))
            items.append(("action", m.group(2).strip(), bool(m.group(3))))
            pos = m.end()
        items.append(("text", text[pos:]))
        # apply -}} trimming to following text
        out = []
        trim_next = False
        for it in items:
            if it[0] == "text":
                s = it[1]
                if trim_next:
                    s = s.lstrip(" \t\r\n")
                    trim_next = False
                if s:
                    out.append(("text", s))
            else:
                out.append(("action", it[1]))
                trim_next = it[2]
        return out

    def parse(self):
        body, term = self._parse_list(top=True)
        if term is not None:
            raise TemplateError(f"unexpected {{{{{term}}}}}")
        return body

    def _parse_list(self, top=False):
        nodes = []
        while self.i < len(self.items):
            kind = self.items[self.i][0]
            src = self.items[self.i][1]
            self.i += 1
            if kind == "text":
                nodes.append(_Text(src))
                continue
            if src.startswith("/*"):
                continue  # comment
            word = src.split(None, 1)[0] if src else ""
            if word in ("end", "else"):
                return nodes, src
            if word == "if":
                nodes.append(self._parse_if(src[2:].strip()))
            elif word == "range":
                nodes.append(self._parse_range(src[5:].strip()))
            elif word == "with":
                nodes.append(self._parse_with(src[4:].strip()))
            elif word == "define":
                name = _unquote_name(src[6:].strip())
                body, term = self._parse_list()
                if term != "end":
                    raise TemplateError("define: missing {{end}}")
                self.defines[name] = body
            elif word == "block":
                toks = _tokenize_action(src[5:].strip())
                if not toks or toks[0][0] != "lit":
                    raise TemplateError("block: expected name")
                name = toks[0][1]
                pipe = _parse_pipeline(toks[1:]) if len(toks) > 1 \
                    else (None, [[("dot", [])]])
                body, term = self._parse_list()
                if term != "end":
                    raise TemplateError("block: missing {{end}}")
                self.defines[name] = body
                nodes.append(_TemplateCall(name, pipe))
            elif word == "template":
                toks = _tokenize_action(src[8:].strip())
                if not toks or toks[0][0] != "lit":
                    raise TemplateError("template: expected name")
                name = toks[0][1]
                pipe = _parse_pipeline(toks[1:]) if len(toks) > 1 \
                    else None
                nodes.append(_TemplateCall(name, pipe))
            elif src:
                nodes.append(_Action(_parse_pipeline(_tokenize_action(src))))
        if top:
            return nodes, None
        raise TemplateError("unexpected EOF: missing {{end}}")

    def _parse_if(self, cond_src):
        pipe = _parse_pipeline(_tokenize_action(cond_src))
        body, term = self._parse_list()
        els = []
        while term != "end":
            rest = term[4:].strip()  # after "else"
            if rest.startswith("if"):
                sub = self._parse_if(rest[2:].strip())
                els = [sub]
                return _If(pipe, body, els)
            elif rest:
                raise TemplateError(f"bad else clause {term!r}")
            else:
                els, term = self._parse_list()
                break
        return _If(pipe, body, els)

    def _parse_branch_tail(self):
        body, term = self._parse_list()
        els = []
        if term != "end":
            rest = term[4:].strip()
            if rest:
                raise TemplateError("else-if only valid on if")
            els, term = self._parse_list()
            if term != "end":
                raise TemplateError("missing {{end}}")
        return body, els

    def _parse_range(self, src):
        toks = _tokenize_action(src)
        kvar = vvar = None
        # range $k, $v := pipe | range $v := pipe | range pipe
        if (len(toks) >= 2 and toks[0][0] == "var"
                and any(t[0] == "decl" for t in toks[:4])):
            if toks[1][0] == "comma":
                kvar, vvar = toks[0][1], toks[2][1]
                assert toks[3][0] == "decl"
                toks = toks[4:]
            else:
                vvar = toks[0][1]
                assert toks[1][0] == "decl"
                toks = toks[2:]
        pipe = _parse_pipeline(toks)
        body, els = self._parse_branch_tail()
        return _Range(kvar, vvar, pipe, body, els)

    def _parse_with(self, src):
        pipe = _parse_pipeline(_tokenize_action(src))
        body, els = self._parse_branch_tail()
        return _With(pipe, body, els)


def _parse_pipeline(toks):
    """Returns (decl, cmds): decl = (varname, ':='|'=') or None."""
    decl = None
    if (len(toks) >= 2 and toks[0][0] == "var"
            and toks[1][0] in ("decl", "assign")):
        decl = (toks[0][1], toks[1][0])
        toks = toks[2:]
    cmds, cur = [], []
    i = 0
    while i < len(toks):
        kind, val = toks[i][0], toks[i][1]
        if kind == "pipe":
            if not cur:
                raise TemplateError("empty pipeline stage")
            cmds.append(cur)
            cur = []
            i += 1
            continue
        cur.append(_parse_operand(toks, i))
        i = cur[-1][-1]  # operands carry end index as last element
        cur[-1] = cur[-1][:-1]
    if cur:
        cmds.append(cur)
    if not cmds:
        raise TemplateError("empty pipeline")
    return (decl, cmds)


def _parse_operand(toks, i):
    """Parse one operand starting at i; returns tuple ending with next
    index."""
    kind, val = toks[i][0], toks[i][1]
    if kind in ("str", "char"):
        body = val[1:-1]
        s = body.encode().decode("unicode_escape") if "\\" in body else body
        return ("lit", s, i + 1)
    if kind == "raw":
        return ("lit", val[1:-1], i + 1)
    if kind == "num":
        return ("lit", float(val) if "." in val else int(val), i + 1)
    if kind == "ident":
        if val == "true":
            return ("lit", True, i + 1)
        if val == "false":
            return ("lit", False, i + 1)
        if val == "nil":
            return ("lit", None, i + 1)
        return ("fn", val, i + 1)
    if kind == "dot":
        return ("dot", [], i + 1)
    if kind == "field":
        return ("dot", val[1:].split("."), i + 1)
    if kind == "var":
        fields = []
        j = i + 1
        if j < len(toks) and toks[j][0] == "field" and not toks[j][2]:
            fields = toks[j][1][1:].split(".")
            j += 1
        return ("var", val, fields, j)
    if kind == "lparen":
        depth, j = 1, i + 1
        while j < len(toks) and depth:
            if toks[j][0] == "lparen":
                depth += 1
            elif toks[j][0] == "rparen":
                depth -= 1
            j += 1
        if depth:
            raise TemplateError("unbalanced parens")
        inner = _parse_pipeline(toks[i + 1:j - 1])
        fields = []
        if j < len(toks) and toks[j][0] == "field" and not toks[j][2]:
            fields = toks[j][1][1:].split(".")
            j += 1
        return ("paren", inner, fields, j)
    raise TemplateError(f"unexpected token {val!r}")


# ------------------------------------------------------------- runtime

# Go embedded-struct field promotion: JSON inlines the embedded struct,
# so `.Vulnerability` on a detected-vulnerability dict resolves to the
# dict itself (marker key proves the shape).
_EMBEDDED = {
    "Vulnerability": "VulnerabilityID",
    "CauseMetadata": "ID",
}


def _field(obj, name):
    if obj is None:
        return None
    if isinstance(obj, dict):
        if name in obj:
            return obj[name]
        marker = _EMBEDDED.get(name)
        if marker and marker in obj:
            return obj
        return None
    raise TemplateError(
        f"can't access field {name!r} on {type(obj).__name__}")


def _truthy(v):
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return v != 0
    if isinstance(v, (str, list, tuple, dict)):
        return len(v) > 0
    return True


def _go_str(v):
    if v is None:
        return "<no value>"
    if isinstance(v, _dt.datetime):
        # Go time.Time default String(): fractional seconds only when
        # nonzero, numeric offset + zone name
        frac = f".{v.microsecond:06d}".rstrip("0") if v.microsecond \
            else ""
        off = v.strftime("%z") or "+0000"
        tz = v.tzname() or "UTC"
        if tz.startswith(("UTC+", "UTC-")):
            tz = off  # Go repeats the numeric offset for fixed zones
        return v.strftime("%Y-%m-%d %H:%M:%S") + frac + \
            f" {off} {tz}"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    if isinstance(v, (list, tuple)):
        return "[" + " ".join(_go_str(x) for x in v) + "]"
    if isinstance(v, dict):
        return ("map[" + " ".join(f"{k}:{_go_str(x)}"
                                  for k, x in sorted(v.items())) + "]")
    return str(v)


def _go_quote(s):
    return json.dumps(_go_str(s), ensure_ascii=False)


_VERB_RE = re.compile(r"%[-+ #0]*\d*(?:\.\d+)?[vsdqftxXeEgGbcoU%]")


def _go_printf(fmt, *args):
    out, ai = [], 0
    pos = 0
    for m in _VERB_RE.finditer(fmt):
        out.append(fmt[pos:m.start()])
        pos = m.end()
        verb = m.group()
        if verb.endswith("%"):
            out.append("%")
            continue
        arg = args[ai] if ai < len(args) else "<missing>"
        ai += 1
        flags, v = verb[1:-1], verb[-1]
        if v == "q":
            out.append(_go_quote(arg))
        elif v in "vs":
            s = _go_str(arg)
            if flags:
                s = ("%" + flags + "s") % s
            out.append(s)
        elif v == "t":
            out.append("true" if _truthy(arg) else "false")
        elif v in "dboc":
            out.append(("%" + flags + ("d" if v == "d" else v))
                       % int(arg or 0))
        elif v in "xX":
            if isinstance(arg, str):
                h = arg.encode().hex()
                out.append(h.upper() if v == "X" else h)
            else:
                out.append(("%" + flags + v) % int(arg or 0))
        else:
            out.append(("%" + flags + v) % float(arg or 0))
    out.append(fmt[pos:])
    return "".join(out)


_GO_DATE_TOKENS = [
    (".999999999", lambda d: (".%09d" % (d.microsecond * 1000)).rstrip("0")
     if d.microsecond else ""),
    ("2006", lambda d: "%04d" % d.year),
    ("January", lambda d: d.strftime("%B")),
    ("Monday", lambda d: d.strftime("%A")),
    ("Jan", lambda d: d.strftime("%b")),
    ("Mon", lambda d: d.strftime("%a")),
    ("Z07:00", lambda d: _tz_offset(d, colon=True)),
    ("Z0700", lambda d: _tz_offset(d, colon=False)),
    ("-07:00", lambda d: _tz_offset(d, colon=True, z=False)),
    ("15", lambda d: "%02d" % d.hour),
    ("01", lambda d: "%02d" % d.month),
    ("02", lambda d: "%02d" % d.day),
    ("03", lambda d: "%02d" % (d.hour % 12 or 12)),
    ("04", lambda d: "%02d" % d.minute),
    ("05", lambda d: "%02d" % d.second),
    ("06", lambda d: "%02d" % (d.year % 100)),
    ("PM", lambda d: "PM" if d.hour >= 12 else "AM"),
]


def _tz_offset(d, colon=True, z=True):
    off = d.utcoffset()
    if off is None or off == _dt.timedelta(0):
        if z:
            return "Z"
        off = _dt.timedelta(0)
    total = int(off.total_seconds())
    sign = "+" if total >= 0 else "-"
    total = abs(total)
    hh, mm = divmod(total // 60, 60)
    return f"{sign}{hh:02d}:{mm:02d}" if colon else f"{sign}{hh:02d}{mm:02d}"


def _go_date(layout, d):
    if isinstance(d, str):
        d = _dt.datetime.fromisoformat(d.replace("Z", "+00:00"))
    out = []
    i = 0
    while i < len(layout):
        for tok, fn in _GO_DATE_TOKENS:
            if layout.startswith(tok, i):
                out.append(fn(d))
                i += len(tok)
                break
        else:
            out.append(layout[i])
            i += 1
    return "".join(out)


def _xml_escape(s):
    s = _go_str(s)
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace("'", "&#39;")
            .replace('"', "&#34;"))


def _html_escape(s):
    return (_go_str(s).replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;").replace("'", "&#39;")
            .replace('"', "&#34;"))


def _index(obj, *keys):
    for k in keys:
        if obj is None:
            return None
        if isinstance(obj, dict):
            obj = obj.get(k)
        elif isinstance(obj, (list, tuple, str)):
            k = int(k)
            obj = obj[k] if 0 <= k < len(obj) else None
        else:
            return None
    return obj


def _go_replacement(repl: str) -> str:
    """Convert a Go regexp replacement string ($1, ${name}, $$) to
    Python re.sub syntax, leaving other characters (incl. braces)
    untouched."""
    out = []
    i = 0
    while i < len(repl):
        c = repl[i]
        if c == "\\":
            out.append("\\\\")
            i += 1
        elif c == "$":
            if repl.startswith("$$", i):
                out.append("$")
                i += 2
            elif i + 1 < len(repl) and repl[i + 1] == "{":
                j = repl.find("}", i + 2)
                if j == -1:
                    out.append("$")
                    i += 1
                else:
                    out.append(f"\\g<{repl[i + 2:j]}>")
                    i = j + 1
            else:
                m = re.match(r"\d+|[A-Za-z_]\w*", repl[i + 1:])
                if m:
                    out.append(f"\\g<{m.group()}>")
                    i += 1 + m.end()
                else:
                    out.append("$")
                    i += 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _num(v):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except (TypeError, ValueError):
        return 0


def _substr(start, end, s):
    """sprig substring: negative start means 'from the beginning',
    negative end means 'to the end' — NOT Python's negative
    indexing."""
    s = _go_str(s)
    start, end = int(start), int(end)
    if start < 0:
        return s[:end] if end >= 0 else s
    if end < 0:
        return s[start:]
    return s[start:end]


def _builtin_funcs():
    return {
        "eq": lambda a, *bs: any(a == b for b in bs),
        "ne": lambda a, b: a != b,
        "lt": lambda a, b: _num(a) < _num(b),
        "le": lambda a, b: _num(a) <= _num(b),
        "gt": lambda a, b: _num(a) > _num(b),
        "ge": lambda a, b: _num(a) >= _num(b),
        "and": lambda *a: next((x for x in a if not _truthy(x)), a[-1]),
        "or": lambda *a: next((x for x in a if _truthy(x)), a[-1]),
        "not": lambda a: not _truthy(a),
        "len": lambda a: len(a) if a is not None else 0,
        "index": _index,
        "print": lambda *a: " ".join(_go_str(x) for x in a),
        "println": lambda *a: " ".join(_go_str(x) for x in a) + "\n",
        "printf": _go_printf,
        # sprig subset used by contrib templates
        "add": lambda *a: sum(_num(x) for x in a),
        "sub": lambda a, b: _num(a) - _num(b),
        "mul": lambda *a: __import__("math").prod(_num(x) for x in a),
        "list": lambda *a: list(a),
        "first": lambda a: a[0] if a else None,
        "last": lambda a: a[-1] if a else None,
        "join": lambda sep, lst: sep.join(_go_str(x) for x in (lst or [])),
        "default": lambda d, v=None: v if _truthy(v) else d,
        "empty": lambda v: not _truthy(v),
        "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
        "toString": _go_str,
        "lower": lambda s: _go_str(s).lower(),
        "upper": lambda s: _go_str(s).upper(),
        "title": lambda s: _go_str(s).title(),
        "trim": lambda s: _go_str(s).strip(),
        "trimAll": lambda c, s: _go_str(s).strip(c),
        "trunc": lambda n, s: _go_str(s)[:n] if n >= 0 else _go_str(s)[n:],
        "abbrev": lambda n, s: (_go_str(s) if len(_go_str(s)) <= n
                                else _go_str(s)[:n - 3] + "..."),
        "replace": lambda old, new, s: _go_str(s).replace(old, new),
        "nospace": lambda s: re.sub(r"\s", "", _go_str(s)),
        "contains": lambda sub, s: sub in _go_str(s),
        "hasPrefix": lambda p, s: _go_str(s).startswith(p),
        "hasSuffix": lambda p, s: _go_str(s).endswith(p),
        "split": lambda sep, s: dict(
            (f"_{i}", p) for i, p in enumerate(_go_str(s).split(sep))),
        "splitList": lambda sep, s: _go_str(s).split(sep),
        "regexFind": lambda pat, s: (
            (re.search(pat, _go_str(s)) or [""])[0]
            if re.search(pat, _go_str(s)) else ""),
        "regexMatch": lambda pat, s: bool(re.search(pat, _go_str(s))),
        "regexReplaceAll": lambda pat, s, repl: re.sub(
            pat, _go_replacement(repl), _go_str(s)),
        "sha1sum": lambda s: hashlib.sha1(_go_str(s).encode()).hexdigest(),
        "sha256sum": lambda s: hashlib.sha256(
            _go_str(s).encode()).hexdigest(),
        "env": lambda name: os.environ.get(name, ""),
        "getEnv": lambda name: os.environ.get(name, ""),
        # a pinned clock is injected via write_template(now=...)
        "now": lambda: _dt.datetime.now().astimezone(),
        "substr": _substr,
        "date": _go_date,
        "toJson": lambda v: json.dumps(v, ensure_ascii=False),
        "dict": lambda *a: {a[i]: a[i + 1] for i in range(0, len(a), 2)},
        "uniq": lambda lst: list(dict.fromkeys(lst or [])),
        "sortAlpha": lambda lst: sorted(_go_str(x) for x in (lst or [])),
        "int": lambda v: int(_num(v)),
        "int64": lambda v: int(_num(v)),
        "float64": lambda v: float(_num(v)),
        # trivy-specific (pkg/report/template.go:40-62)
        "escapeXML": _xml_escape,
        "escapeString": _html_escape,
        "endWithPeriod": lambda s: (_go_str(s) if _go_str(s).endswith(".")
                                    else _go_str(s) + "."),
        "sourceID": lambda s: s,
        "appVersion": lambda: "dev",
    }


class _Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent=None):
        self.vars = {}
        self.parent = parent

    def get(self, name):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise TemplateError(f"undefined variable {name}")

    def declare(self, name, val):
        self.vars[name] = val

    def assign(self, name, val):
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = val
                return
            s = s.parent
        raise TemplateError(f"undefined variable {name}")


class Template:
    """Compile once, render many. ``funcs`` overrides/extends builtins
    (e.g. {"now": frozen_clock, "appVersion": lambda: version})."""

    def __init__(self, text: str, funcs: dict | None = None):
        p = _Parser(text)
        self.nodes = p.parse()
        self.defines = p.defines
        self.funcs = _builtin_funcs()
        if funcs:
            self.funcs.update(funcs)

    def add_associated(self, text: str) -> None:
        """Parse another file in the same template namespace (its
        {{define}}s become callable here — helm's _helpers.tpl)."""
        p = _Parser(text)
        p.parse()
        self.defines.update(p.defines)

    def render(self, data) -> str:
        out = []
        scope = _Scope()
        scope.declare("$", data)
        self._exec(self.nodes, data, scope, out)
        return "".join(out)

    def execute_template(self, name: str, data) -> str:
        """Render a named {{define}} (backs helm's `include`)."""
        nodes = self.defines.get(name)
        if nodes is None:
            raise TemplateError(f"undefined template {name!r}")
        out = []
        scope = _Scope()
        scope.declare("$", data)
        self._exec(nodes, data, scope, out)
        return "".join(out)

    def _exec(self, nodes, dot, scope, out):
        for n in nodes:
            if isinstance(n, _Text):
                out.append(n.s)
            elif isinstance(n, _Action):
                decl, _ = n.pipe
                val = self._pipe(n.pipe, dot, scope)
                if decl is None:
                    out.append(val if isinstance(val, str) else _go_str(val))
            elif isinstance(n, _If):
                if _truthy(self._pipe_value(n.pipe, dot, scope)):
                    self._exec(n.body, dot, _Scope(scope), out)
                else:
                    self._exec(n.els, dot, _Scope(scope), out)
            elif isinstance(n, _TemplateCall):
                sub = self.defines.get(n.name)
                if sub is None:
                    raise TemplateError(
                        f"undefined template {n.name!r}")
                sub_dot = self._pipe_value(n.pipe, dot, scope) \
                    if n.pipe is not None else None
                s = _Scope()
                s.declare("$", sub_dot)
                self._exec(sub, sub_dot, s, out)
            elif isinstance(n, _With):
                v = self._pipe_value(n.pipe, dot, scope)
                if _truthy(v):
                    self._exec(n.body, v, _Scope(scope), out)
                else:
                    self._exec(n.els, dot, _Scope(scope), out)
            elif isinstance(n, _Range):
                coll = self._pipe_value(n.pipe, dot, scope)
                items = []
                if isinstance(coll, dict):
                    items = sorted(coll.items())
                elif isinstance(coll, (list, tuple)):
                    items = list(enumerate(coll))
                elif isinstance(coll, int):
                    items = [(i, i) for i in range(coll)]
                if not items:
                    self._exec(n.els, dot, _Scope(scope), out)
                    continue
                for k, v in items:
                    s = _Scope(scope)
                    if n.kvar:
                        s.declare(n.kvar, k)
                    if n.vvar:
                        s.declare(n.vvar, v)
                    self._exec(n.body, v, s, out)

    def _pipe_value(self, pipe, dot, scope):
        """Evaluate a pipeline for its value (if/range conditions may
        also declare — Go allows `if $x := f`; both happen here)."""
        return self._pipe(pipe, dot, scope)

    def _pipe(self, pipe, dot, scope):
        decl, cmds = pipe
        val = None
        for ci, cmd in enumerate(cmds):
            val = self._command(cmd, val, ci > 0, dot, scope)
        if decl is not None:
            name, op = decl
            if op == "decl":
                scope.declare(name, val)
            else:
                scope.assign(name, val)
        return val

    def _command(self, cmd, piped, has_piped, dot, scope):
        head = cmd[0]
        if head[0] == "fn":
            args = [self._operand(a, dot, scope) for a in cmd[1:]]
            if has_piped:
                args.append(piped)
            fn = self.funcs.get(head[1])
            if fn is None:
                raise TemplateError(f"unknown function {head[1]!r}")
            return fn(*args)
        if len(cmd) > 1:
            raise TemplateError("unexpected arguments after operand")
        val = self._operand(head, dot, scope)
        return val

    def _operand(self, op, dot, scope):
        kind = op[0]
        if kind == "lit":
            return op[1]
        if kind == "dot":
            v = dot
            for f in op[1]:
                v = _field(v, f)
            return v
        if kind == "var":
            v = scope.get(op[1])
            for f in op[2]:
                v = _field(v, f)
            return v
        if kind == "fn":
            fn = self.funcs.get(op[1])
            if fn is None:
                raise TemplateError(f"unknown function {op[1]!r}")
            return fn()
        if kind == "paren":
            v = self._pipe(op[1], dot, scope)
            for f in op[2]:
                v = _field(v, f)
            return v
        raise TemplateError(f"bad operand {op!r}")
