"""HCL2 lexer, parser, and expression evaluator.

The reference embeds hashicorp/hcl and a 6.2k-LoC terraform scanner
(pkg/iac/scanners/terraform, pkg/iac/terraform value model); this is a
native subset sized for misconfiguration scanning: blocks, attributes,
the full operator grammar, string templates, heredocs, for-expressions,
splats, and the commonly used function library.  Anything outside the
subset (`...` grouping mode, template directives, unresolved
references) evaluates to Unknown, which checks treat as passing — the
same stance the reference takes for values it cannot know before
`terraform apply`.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

from .cloud import UNKNOWN, Unknown

# --- lexer ----------------------------------------------------------

_PUNCT2 = ("==", "!=", "<=", ">=", "&&", "||", "=>", "::")
_PUNCT1 = "{}[]()=,.?:<>!+-*/%"


@dataclass
class Tok:
    kind: str       # ident num str tmpl punct nl heredoc eof
    value: object
    line: int


class HclError(Exception):
    pass


def lex(text: str) -> list[Tok]:
    toks: list[Tok] = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            toks.append(Tok("nl", "\n", line))
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#" or text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
            continue
        if text.startswith("/*", i):
            j = text.find("*/", i + 2)
            if j < 0:
                break
            line += text.count("\n", i, j)
            i = j + 2
            continue
        if text.startswith("<<", i):
            m = re.match(r"<<(-?)([A-Za-z_][A-Za-z0-9_-]*)\r?\n",
                         text[i:])
            if m:
                indent, tag = m.group(1), m.group(2)
                start = i + m.end()
                end_re = re.compile(
                    r"^[ \t]*" + re.escape(tag) + r"[ \t]*$",
                    re.MULTILINE)
                em = end_re.search(text, start)
                if em is None:
                    raise HclError(f"unterminated heredoc {tag}")
                body = text[start:em.start()]
                if indent == "-":
                    body = re.sub(r"^[ \t]+", "", body, flags=re.M)
                body = body.rstrip("\n")
                if re.search(r"(?<!\$)\$\{|(?<!%)%\{", body):
                    # interpolated heredoc — out of subset → unknown,
                    # never a concrete (and wrong) literal
                    toks.append(Tok("str", [("interp", None)], line))
                else:
                    toks.append(Tok(
                        "str",
                        [body.replace("$${", "${").replace("%%{", "%{")],
                        line))
                line += text.count("\n", i, em.end())
                i = em.end()
                continue
        if c == '"':
            parts, j, ln = _lex_template(text, i + 1, line)
            toks.append(Tok("str", parts, line))
            line = ln
            i = j
            continue
        if c.isdigit() or (c == "." and i + 1 < n and
                           text[i + 1].isdigit()):
            m = re.match(r"\d+(\.\d+)?([eE][+-]?\d+)?", text[i:])
            s = m.group(0)
            toks.append(Tok("num", float(s) if "." in s or "e" in s
                            or "E" in s else int(s), line))
            i += m.end()
            continue
        if c.isalpha() or c == "_":
            m = re.match(r"[A-Za-z_][A-Za-z0-9_-]*", text[i:])
            toks.append(Tok("ident", m.group(0), line))
            i += m.end()
            continue
        two = text[i:i + 2]
        if two in _PUNCT2:
            toks.append(Tok("punct", two, line))
            i += 2
            continue
        if c in _PUNCT1:
            toks.append(Tok("punct", c, line))
            i += 1
            continue
        raise HclError(f"unexpected character {c!r} at line {line}")
    toks.append(Tok("eof", None, line))
    return toks


def _lex_template(text: str, i: int, line: int):
    """Parse a quoted template starting after the opening quote.
    → (parts, next_index, line); parts are str literals and
    ('interp', token-list) tuples."""
    parts: list = []
    buf: list[str] = []
    n = len(text)
    while i < n:
        c = text[i]
        if c == '"':
            if buf:
                parts.append("".join(buf))
            return parts, i + 1, line
        if c == "\\" and i + 1 < n:
            esc = text[i + 1]
            buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\",
                        "r": "\r"}.get(esc, "\\" + esc))
            i += 2
            continue
        if text.startswith("$${", i) or text.startswith("%%{", i):
            buf.append(text[i + 1:i + 3])
            i += 3
            continue
        if text.startswith("${", i):
            if buf:
                parts.append("".join(buf))
                buf = []
            depth, j = 1, i + 2
            while j < n and depth:
                if text[j] == "{":
                    depth += 1
                elif text[j] == "}":
                    depth -= 1
                elif text[j] == '"':  # nested string
                    _, j, line = _lex_template(text, j + 1, line)
                    continue
                j += 1
            inner = text[i + 2:j - 1]
            parts.append(("interp", lex(inner)))
            i = j
            continue
        if text.startswith("%{", i):
            # template directives (if/for) are out of subset → unknown
            parts.append(("interp", None))
            depth, j = 1, i + 2
            while j < n and depth:
                if text[j] == "{":
                    depth += 1
                elif text[j] == "}":
                    depth -= 1
                j += 1
            i = j
            continue
        if c == "\n":
            line += 1
        buf.append(c)
        i += 1
    raise HclError("unterminated string")


# --- AST ------------------------------------------------------------

@dataclass
class Attr:
    name: str
    expr: object
    start: int
    end: int


@dataclass
class Block:
    type: str
    labels: list
    body: "Body"
    start: int
    end: int


@dataclass
class Body:
    attrs: list = field(default_factory=list)    # [Attr]
    blocks: list = field(default_factory=list)   # [Block]


@dataclass
class Lit:
    value: object


@dataclass
class Tmpl:
    parts: list


@dataclass
class Ref:
    chain: list      # mix of str names and Index markers


@dataclass
class IndexOp:
    expr: object     # expression or SPLAT


SPLAT = object()


@dataclass
class Call:
    name: str
    args: list


@dataclass
class Un:
    op: str
    x: object


@dataclass
class Bin:
    op: str
    x: object
    y: object


@dataclass
class Cond:
    c: object
    t: object
    f: object


@dataclass
class ListE:
    items: list


@dataclass
class MapE:
    items: list      # [(key_expr_or_name, value_expr)]


class Unsupported:
    """out-of-subset constructs — evaluate to Unknown."""


@dataclass
class ForE:
    """[for v in coll : body if cond] / {for k, v in coll : key =>
    value if cond} (no `...` grouping — that parses to Unsupported)."""
    names: list      # [value_name] or [key_name, value_name]
    coll: object
    key: object      # None for list comprehension
    body: object
    cond: object     # optional filter


# --- parser ---------------------------------------------------------

class Parser:
    def __init__(self, toks: list[Tok]):
        self.toks = toks
        self.i = 0
        self._saw_ellipsis = False  # grouping-mode detection

    def peek(self, skip_nl=False) -> Tok:
        j = self.i
        if skip_nl:
            while self.toks[j].kind == "nl":
                j += 1
        return self.toks[j]

    def next(self, skip_nl=False) -> Tok:
        if skip_nl:
            while self.toks[self.i].kind == "nl":
                self.i += 1
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def expect(self, kind, value=None, skip_nl=False) -> Tok:
        t = self.next(skip_nl=skip_nl)
        if t.kind != kind or (value is not None and t.value != value):
            raise HclError(
                f"expected {value or kind}, got {t.value!r} "
                f"(line {t.line})")
        return t

    def parse_body(self, top=False) -> Body:
        body = Body()
        while True:
            t = self.peek(skip_nl=True)
            if t.kind == "eof":
                break
            if t.kind == "punct" and t.value == "}" and not top:
                break
            if t.kind not in ("ident", "str"):
                raise HclError(
                    f"unexpected {t.value!r} in body (line {t.line})")
            name_tok = self.next(skip_nl=True)
            name = name_tok.value if name_tok.kind == "ident" else \
                "".join(p for p in name_tok.value if isinstance(p, str))
            t = self.peek()
            if t.kind == "punct" and t.value == "=":
                self.next()
                expr = self.parse_expr()
                end_line = self.toks[self.i - 1].line
                body.attrs.append(Attr(name, expr, name_tok.line,
                                       end_line))
            else:
                labels = []
                while True:
                    t = self.peek()
                    if t.kind == "ident":
                        labels.append(self.next().value)
                    elif t.kind == "str":
                        parts = self.next().value
                        labels.append("".join(
                            p for p in parts if isinstance(p, str)))
                    else:
                        break
                self.expect("punct", "{")
                inner = self.parse_body()
                close = self.expect("punct", "}", skip_nl=True)
                body.blocks.append(Block(name, labels, inner,
                                         name_tok.line, close.line))
        return body

    # expression parsing — precedence climbing
    def parse_expr(self):
        return self.parse_cond()

    def parse_cond(self):
        c = self.parse_or()
        t = self.peek()
        if t.kind == "punct" and t.value == "?":
            self.next()
            a = self.parse_expr()
            self.expect("punct", ":", skip_nl=True)
            b = self.parse_expr()
            return Cond(c, a, b)
        return c

    def _bin(self, sub, ops):
        x = sub()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value in ops:
                self.next()
                x = Bin(t.value, x, sub())
            else:
                return x

    def parse_or(self):
        return self._bin(self.parse_and, ("||",))

    def parse_and(self):
        return self._bin(self.parse_eq, ("&&",))

    def parse_eq(self):
        return self._bin(self.parse_cmp, ("==", "!="))

    def parse_cmp(self):
        return self._bin(self.parse_add, ("<", ">", "<=", ">="))

    def parse_add(self):
        return self._bin(self.parse_mul, ("+", "-"))

    def parse_mul(self):
        return self._bin(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        t = self.peek()
        if t.kind == "punct" and t.value in ("!", "-"):
            self.next()
            return Un(t.value, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        x = self.parse_primary()
        while True:
            t = self.peek()
            if t.kind == "punct" and t.value == ".":
                self.next()
                if self.peek().kind == "punct" and \
                        self.peek().value == ".":
                    # "..." — call varargs expansion OR for-expression
                    # grouping mode; record it so _parse_for can fall
                    # back to Unsupported (the dots are consumed here)
                    while self.peek().kind == "punct" and \
                            self.peek().value == ".":
                        self.next()
                    self._saw_ellipsis = True
                    return x
                nt = self.next()
                if nt.kind == "ident":
                    x = self._extend(x, nt.value)
                elif nt.kind == "num":
                    x = self._extend(x, IndexOp(Lit(nt.value)))
                elif nt.kind == "punct" and nt.value == "*":
                    x = self._extend(x, IndexOp(SPLAT))
                else:
                    raise HclError(f"bad attribute access "
                                   f"(line {nt.line})")
            elif t.kind == "punct" and t.value == "[":
                self.next()
                it = self.peek(skip_nl=True)
                if it.kind == "punct" and it.value == "*":
                    self.next(skip_nl=True)
                    idx = IndexOp(SPLAT)
                else:
                    idx = IndexOp(self.parse_expr())
                self.expect("punct", "]", skip_nl=True)
                x = self._extend(x, idx)
            else:
                return x

    @staticmethod
    def _extend(x, part):
        if isinstance(x, Ref):
            return Ref(x.chain + [part])
        return Ref([x, part])     # indexing a non-ref expression

    def parse_primary(self):
        t = self.next(skip_nl=True)
        if t.kind == "num":
            return Lit(t.value)
        if t.kind == "str":
            if len(t.value) == 1 and isinstance(t.value[0], str):
                return Lit(t.value[0])
            if not t.value:
                return Lit("")
            return Tmpl(t.value)
        if t.kind == "ident":
            if t.value == "true":
                return Lit(True)
            if t.value == "false":
                return Lit(False)
            if t.value == "null":
                return Lit(None)
            # function call?
            name = t.value
            while self.peek().kind == "punct" and \
                    self.peek().value == "::":
                self.next()
                name += "::" + self.expect("ident").value
            if self.peek().kind == "punct" and self.peek().value == "(":
                self.next()
                args = []
                while True:
                    nt = self.peek(skip_nl=True)
                    if nt.kind == "punct" and nt.value == ")":
                        self.next(skip_nl=True)
                        break
                    args.append(self.parse_expr())
                    nt = self.peek(skip_nl=True)
                    if nt.kind == "punct" and nt.value == ",":
                        self.next(skip_nl=True)
                return Call(name, args)
            return Ref([name])
        if t.kind == "punct" and t.value == "(":
            e = self.parse_expr()
            self.expect("punct", ")", skip_nl=True)
            return e
        if t.kind == "punct" and t.value == "[":
            first = self.peek(skip_nl=True)
            if first.kind == "ident" and first.value == "for":
                self.next(skip_nl=True)
                return self._parse_for("]")
            items = []
            while True:
                nt = self.peek(skip_nl=True)
                if nt.kind == "punct" and nt.value == "]":
                    self.next(skip_nl=True)
                    break
                items.append(self.parse_expr())
                nt = self.peek(skip_nl=True)
                if nt.kind == "punct" and nt.value == ",":
                    self.next(skip_nl=True)
            return ListE(items)
        if t.kind == "punct" and t.value == "{":
            first = self.peek(skip_nl=True)
            if first.kind == "ident" and first.value == "for":
                self.next(skip_nl=True)
                return self._parse_for("}")
            items = []
            while True:
                nt = self.peek(skip_nl=True)
                if nt.kind == "punct" and nt.value == "}":
                    self.next(skip_nl=True)
                    break
                if nt.kind in ("ident", "str"):
                    kt = self.next(skip_nl=True)
                    key = kt.value if kt.kind == "ident" else "".join(
                        p for p in kt.value if isinstance(p, str))
                elif nt.kind == "punct" and nt.value == "(":
                    key_expr = self.parse_expr()
                    key = key_expr
                else:
                    key = self.parse_expr()
                sep = self.next(skip_nl=True)
                if not (sep.kind == "punct" and sep.value in
                        ("=", ":")):
                    raise HclError(f"expected = or : in object "
                                   f"(line {sep.line})")
                items.append((key, self.parse_expr()))
                nt = self.peek(skip_nl=True)
                if nt.kind == "punct" and nt.value == ",":
                    self.next(skip_nl=True)
            return MapE(items)
        raise HclError(f"unexpected token {t.value!r} (line {t.line})")

    def _parse_for(self, close_c):
        """After the consumed `for` keyword. `...` grouping mode falls
        back to Unsupported (skip to the closing bracket)."""
        open_c = "[" if close_c == "]" else "{"
        names = []
        t = self.next(skip_nl=True)
        if t.kind != "ident":
            raise HclError(f"bad for-expression (line {t.line})")
        names.append(t.value)
        if self.peek(skip_nl=True).value == ",":
            self.next(skip_nl=True)
            t = self.next(skip_nl=True)
            if t.kind != "ident":
                raise HclError(f"bad for-expression (line {t.line})")
            names.append(t.value)
        t = self.next(skip_nl=True)
        if not (t.kind == "ident" and t.value == "in"):
            raise HclError(f"expected 'in' (line {t.line})")
        coll = self.parse_expr()
        t = self.next(skip_nl=True)
        if not (t.kind == "punct" and t.value == ":"):
            raise HclError(f"expected ':' (line {t.line})")
        key = None
        saw = self._saw_ellipsis
        self._saw_ellipsis = False
        body = self.parse_expr()
        if close_c == "}":
            t = self.next(skip_nl=True)
            if not (t.kind == "punct" and t.value == "=>"):
                raise HclError(f"expected '=>' (line {t.line})")
            key = body
            self._saw_ellipsis = False
            body = self.parse_expr()
        # grouping mode only exists in map-fors; a list-for body may
        # legitimately contain a call-varargs `...` (f(xs...))
        grouping = self._saw_ellipsis and close_c == "}"
        self._saw_ellipsis = saw
        cond = None
        nt = self.peek(skip_nl=True)
        if grouping or (nt.kind == "punct" and nt.value == "."):
            # value grouping `...` — out of subset (parse_postfix
            # consumed the dots while parsing the value expression)
            if not (nt.kind == "punct" and nt.value == close_c):
                self._skip_until_close(open_c, close_c)
            else:
                self.next(skip_nl=True)
            return Unsupported()
        if nt.kind == "ident" and nt.value == "if":
            self.next(skip_nl=True)
            cond = self.parse_expr()
        self.expect("punct", close_c, skip_nl=True)
        return ForE(names, coll, key, body, cond)

    def _skip_until_close(self, open_c, close_c):
        depth = 1
        while depth:
            t = self.next(skip_nl=True)
            if t.kind == "eof":
                raise HclError("unterminated for-expression")
            if t.kind == "punct":
                if t.value == open_c:
                    depth += 1
                elif t.value == close_c:
                    depth -= 1


def parse(text: str) -> Body:
    return Parser(lex(text)).parse_body(top=True)


# --- evaluator ------------------------------------------------------

def _is_unknown(v) -> bool:
    return isinstance(v, Unknown)


def _contains_unknown(v) -> bool:
    if _is_unknown(v):
        return True
    if isinstance(v, list):
        return any(_contains_unknown(x) for x in v)
    if isinstance(v, dict):
        return any(_contains_unknown(x) for x in v.values())
    return False


class Scope:
    """Name resolution for expression evaluation."""

    def __init__(self, variables=None, locals_=None, resolver=None):
        self.variables = variables or {}
        self.locals = locals_ or {}
        self.resolver = resolver  # fn(chain) → value for resource refs
        self.bindings: dict = {}  # for-expression loop variables

    def child(self, bindings: dict) -> "Scope":
        s = Scope(self.variables, self.locals, self.resolver)
        s.bindings = {**self.bindings, **bindings}
        return s

    def resolve(self, chain):
        head = chain[0]
        if head in self.bindings:
            return _walk_chain(self.bindings[head], chain[1:], self)
        if head == "var":
            if len(chain) >= 2 and isinstance(chain[1], str):
                base = self.variables.get(chain[1], UNKNOWN)
                return _walk_chain(base, chain[2:], self)
            return UNKNOWN
        if head == "local":
            if len(chain) >= 2 and isinstance(chain[1], str):
                base = self.locals.get(chain[1], UNKNOWN)
                return _walk_chain(base, chain[2:], self)
            return UNKNOWN
        if self.resolver is not None:
            return self.resolver(chain)
        return UNKNOWN


def _walk_chain(value, rest, scope):
    for i, part in enumerate(rest):
        if _is_unknown(value):
            return UNKNOWN
        if isinstance(part, str):
            if isinstance(value, dict):
                value = value.get(part, UNKNOWN)
            else:
                return UNKNOWN
        elif isinstance(part, IndexOp):
            if part.expr is SPLAT:
                # full splat: map the REMAINING chain over each
                # element (hcl: null splats to an empty tuple, any
                # other non-list value wraps to [value])
                rest2 = rest[i + 1:]
                if value is None:
                    return []
                if not isinstance(value, (list, tuple)):
                    value = [value]
                return [_walk_chain(v, rest2, scope) for v in value]
            idx = evaluate(part.expr, scope)
            if _is_unknown(idx):
                return UNKNOWN
            try:
                value = value[idx if not isinstance(idx, float)
                              else int(idx)]
            except (TypeError, KeyError, IndexError):
                return UNKNOWN
        else:
            return UNKNOWN
    return value


def evaluate(node, scope: Scope):
    if isinstance(node, Lit):
        return node.value
    if isinstance(node, ForE):
        coll = evaluate(node.coll, scope)
        if _is_unknown(coll):
            return UNKNOWN
        if isinstance(coll, dict):
            pairs = list(coll.items())
        elif isinstance(coll, (list, tuple)):
            pairs = list(enumerate(coll))
        else:
            return UNKNOWN
        out_list: list = []
        out_map: dict = {}
        for k, v in pairs:
            if len(node.names) == 2:
                child = scope.child({node.names[0]: k,
                                     node.names[1]: v})
            else:
                child = scope.child({node.names[0]: v})
            if node.cond is not None:
                c = evaluate(node.cond, child)
                if _is_unknown(c):
                    return UNKNOWN  # filter unknowable → whole result
                if not c:
                    continue
            val = evaluate(node.body, child)
            if node.key is None:
                out_list.append(val)
            else:
                kk = evaluate(node.key, child)
                if _is_unknown(kk):
                    return UNKNOWN
                if isinstance(kk, (list, tuple, dict)):
                    return UNKNOWN  # HCL rejects non-scalar keys
                out_map[_to_str(kk)] = val  # HCL map keys: strings
        return out_map if node.key is not None else out_list
    if isinstance(node, Tmpl):
        out = []
        for p in node.parts:
            if isinstance(p, str):
                out.append(p)
            else:
                _, toks = p[0], p[1]
                if toks is None:
                    return UNKNOWN
                try:
                    expr = Parser(toks).parse_expr()
                except HclError:
                    return UNKNOWN
                v = evaluate(expr, scope)
                if _is_unknown(v):
                    return UNKNOWN
                out.append(_to_str(v))
        return "".join(out)
    if isinstance(node, Ref):
        head = node.chain[0]
        if not isinstance(head, str):
            base = evaluate(head, scope)
            return _walk_chain(base, node.chain[1:], scope)
        return scope.resolve(node.chain)
    if isinstance(node, Call):
        return _call(node.name, [evaluate(a, scope)
                                 for a in node.args], node, scope)
    if isinstance(node, Un):
        v = evaluate(node.x, scope)
        if _is_unknown(v):
            return UNKNOWN
        try:
            return (not v) if node.op == "!" else (-v)
        except TypeError:
            return UNKNOWN
    if isinstance(node, Bin):
        x = evaluate(node.x, scope)
        if node.op == "||":
            if x is True:
                return True
            y = evaluate(node.y, scope)
            if _is_unknown(x) or _is_unknown(y):
                return UNKNOWN
            return bool(x or y)
        if node.op == "&&":
            if x is False:
                return False
            y = evaluate(node.y, scope)
            if _is_unknown(x) or _is_unknown(y):
                return UNKNOWN
            return bool(x and y)
        y = evaluate(node.y, scope)
        if _is_unknown(x) or _is_unknown(y):
            return UNKNOWN
        try:
            if node.op == "==":
                return x == y
            if node.op == "!=":
                return x != y
            if node.op == "<":
                return x < y
            if node.op == ">":
                return x > y
            if node.op == "<=":
                return x <= y
            if node.op == ">=":
                return x >= y
            if node.op == "+":
                return x + y
            if node.op == "-":
                return x - y
            if node.op == "*":
                return x * y
            if node.op == "/":
                return x / y if y else UNKNOWN
            if node.op == "%":
                return x % y if y else UNKNOWN
        except (TypeError, ValueError):
            # e.g. string % formatting on arbitrary scanned input
            return UNKNOWN
    if isinstance(node, Cond):
        c = evaluate(node.c, scope)
        if _is_unknown(c):
            return UNKNOWN
        return evaluate(node.t if c else node.f, scope)
    if isinstance(node, ListE):
        return [evaluate(i, scope) for i in node.items]
    if isinstance(node, MapE):
        out = {}
        for k, v in node.items:
            key = k if isinstance(k, str) else evaluate(k, scope)
            if _is_unknown(key):
                continue
            out[_to_str(key)] = evaluate(v, scope)
        return out
    if isinstance(node, Unsupported):
        return UNKNOWN
    return UNKNOWN


def _to_str(v):
    if v is True:
        return "true"
    if v is False:
        return "false"
    if v is None:
        return ""
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return str(v)


def _call(name, args, node, scope):
    name = name.split("::")[-1]     # provider::fn → fn
    if name == "try":
        for a in args:
            if not _is_unknown(a):
                return a
        return UNKNOWN
    if name == "can":
        return UNKNOWN if any(_is_unknown(a) for a in args) else True
    if name == "coalesce":
        for a in args:
            if _is_unknown(a):
                return UNKNOWN
            if a not in (None, ""):
                return a
        return None
    if any(_contains_unknown(a) for a in args):
        return UNKNOWN
    try:
        if name == "lower":
            return str(args[0]).lower()
        if name == "upper":
            return str(args[0]).upper()
        if name == "length":
            return len(args[0])
        if name == "concat":
            out = []
            for a in args:
                out.extend(a)
            return out
        if name == "join":
            return _to_str(args[0]).join(_to_str(x) for x in args[1])
        if name == "split":
            return str(args[1]).split(str(args[0]))
        if name == "replace":
            return str(args[0]).replace(str(args[1]), str(args[2]))
        if name == "trimspace":
            return str(args[0]).strip()
        if name == "format":
            fmt = re.sub(r"%([#vdsfq])",
                         lambda m: {"v": "%s", "d": "%d", "s": "%s",
                                    "f": "%f", "q": '"%s"',
                                    "#": "%"}[m.group(1)], args[0])
            return fmt % tuple(args[1:])
        if name == "tostring":
            return _to_str(args[0])
        if name == "tonumber":
            f = float(args[0])
            return int(f) if f.is_integer() else f
        if name == "tobool":
            return args[0] in (True, "true")
        if name in ("tolist", "toset"):
            return list(args[0])
        if name == "tomap":
            return dict(args[0])
        if name == "jsonencode":
            return json.dumps(args[0], separators=(",", ":"))
        if name == "jsondecode":
            return json.loads(args[0])
        if name == "merge":
            out = {}
            for a in args:
                if isinstance(a, dict):
                    out.update(a)
            return out
        if name == "lookup":
            d = args[0]
            if isinstance(d, dict) and args[1] in d:
                return d[args[1]]
            return args[2] if len(args) > 2 else UNKNOWN
        if name == "element":
            seq = args[0]
            return seq[int(args[1]) % len(seq)] if seq else UNKNOWN
        if name == "contains":
            return args[1] in args[0]
        if name == "keys":
            return sorted(args[0].keys())
        if name == "values":
            return [args[0][k] for k in sorted(args[0].keys())]
        if name == "min":
            return min(args[0] if len(args) == 1 and
                       isinstance(args[0], list) else args)
        if name == "max":
            return max(args[0] if len(args) == 1 and
                       isinstance(args[0], list) else args)
        if name == "compact":
            return [x for x in args[0] if x not in (None, "")]
        if name == "flatten":
            out = []

            def rec(xs):
                for x in xs:
                    if isinstance(x, list):
                        rec(x)
                    else:
                        out.append(x)
            rec(args[0])
            return out
        if name == "distinct":
            seen, out = set(), []
            for x in args[0]:
                k = json.dumps(x, sort_keys=True, default=str)
                if k not in seen:
                    seen.add(k)
                    out.append(x)
            return out
        if name == "startswith":
            return str(args[0]).startswith(str(args[1]))
        if name == "endswith":
            return str(args[0]).endswith(str(args[1]))
        if name == "substr":
            s, off, ln = str(args[0]), int(args[1]), int(args[2])
            return s[off:] if ln < 0 else s[off:off + ln]
    except (TypeError, ValueError, IndexError, KeyError,
            ZeroDivisionError, json.JSONDecodeError):
        return UNKNOWN
    # file/templatefile/cidr*/uuid/timestamp/... → not statically known
    return UNKNOWN
