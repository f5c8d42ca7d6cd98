"""SPDX license expression parser (reference pkg/licensing/expression).

Parses compound expressions — `A AND (B OR C) WITH exception`, trailing
`+` — into the same tree the reference's goyacc grammar
(expression/parser.go.y) builds, with matching precedence (OR < AND <
WITH < '+'), matching lexing (words split on whitespace; '(', ')', '+'
are terminals; an interior '+' stays inside the word), matching
stringification (versioned GNU ids render -only/-or-later; children are
parenthesized when the parent conjunction binds tighter), and the same
two normalization hooks (licensing.Normalize applied per simple
expression, NormalizeForSPDX character cleanup)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Union

# conjunction binding powers double as the yacc token ordering used by
# CompoundExpr.String() for parenthesization (types.go:60-80)
_OR, _AND, _WITH = 1, 2, 3

# GNU ids whose plus/bare forms render -or-later/-only (types.go:11-29)
VERSIONED = {
    "AGPL-1.0", "AGPL-3.0",
    "GFDL-1.1-invariants", "GFDL-1.1-no-invariants", "GFDL-1.1",
    "GFDL-1.2-invariants", "GFDL-1.2-no-invariants", "GFDL-1.2",
    "GFDL-1.3-invariants", "GFDL-1.3-no-invariants", "GFDL-1.3",
    "GPL-1.0", "GPL-2.0", "GPL-3.0",
    "LGPL-2.0", "LGPL-2.1", "LGPL-3.0",
}


class ParseError(ValueError):
    pass


@dataclass
class SimpleExpr:
    license: str
    has_plus: bool = False

    def render(self) -> str:
        if self.license in VERSIONED:
            return self.license + (
                "-or-later" if self.has_plus else "-only")
        return self.license + ("+" if self.has_plus else "")


@dataclass
class CompoundExpr:
    left: "Expr"
    conj: int           # _OR | _AND | _WITH
    conj_lit: str       # as written ("or", "AND", "WITH", ...)
    right: "Expr"

    def render(self) -> str:
        left = self.left.render()
        if isinstance(self.left, CompoundExpr) and \
                self.conj > self.left.conj:
            left = f"({left})"
        right = self.right.render()
        if isinstance(self.right, CompoundExpr) and \
                self.conj > self.right.conj:
            right = f"({right})"
        return f"{left} {self.conj_lit} {right}"


Expr = Union[SimpleExpr, CompoundExpr]

_CONJ = {"OR": _OR, "AND": _AND, "WITH": _WITH}


def _lex(s: str) -> list[str]:
    """Reference Lexer split (lexer.go:22-70): whitespace-separated
    words; '(', ')' always terminals; a leading '+' is a terminal; an
    interior '+' stays in the word unless followed by space/paren/end
    (so 'GPLv2+' lexes as 'GPLv2', '+')."""
    out: list[str] = []
    i, n = 0, len(s)
    while i < n:
        while i < n and s[i].isspace():
            i += 1
        if i >= n:
            break
        if s[i] in "()+":
            out.append(s[i])
            i += 1
            continue
        start = i
        while i < n:
            c = s[i]
            if c in "()" or c.isspace():
                break
            if c == "+":
                nxt = s[i + 1] if i + 1 < n else ""
                if nxt == "" or nxt.isspace() or nxt in "()":
                    break       # trailing plus → its own token
            i += 1
        out.append(s[start:i])
    return out


class _Parser:
    def __init__(self, tokens: list[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str | None:
        t = self.peek()
        if t is not None:
            self.i += 1
        return t

    def parse(self) -> Expr:
        e = self.expr(0)
        if self.peek() is not None:
            raise ParseError(f"unexpected token {self.peek()!r}")
        return e

    def expr(self, min_bp: int) -> Expr:
        left = self.primary()
        while True:
            t = self.peek()
            if t is None or t == ")":
                return left
            conj = _CONJ.get(t.upper())
            if conj is None:
                return left
            # left-assoc for OR/AND, right-assoc for WITH (%right)
            if conj < min_bp or (conj == min_bp and conj != _WITH):
                return left
            self.next()
            # the callee returns on an equal binding power unless the
            # operator is WITH, which gives left-assoc OR/AND and
            # right-assoc WITH with the same min_bp
            right = self.expr(conj)
            left = CompoundExpr(left, conj, t, right)

    def primary(self) -> Expr:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of expression")
        if t == "(":
            self.next()
            e = self.expr(0)
            if self.next() != ")":
                raise ParseError("missing ')'")
            return e
        if t in (")", "+") or _CONJ.get(t.upper()) is not None:
            raise ParseError(f"unexpected token {t!r}")
        # one or more adjacent words form one simple expression
        # ("Public Domain"); a '+' terminal attaches to it
        words = [self.next()]
        while True:
            nxt = self.peek()
            if nxt is None or nxt in ("(", ")", "+") or \
                    _CONJ.get(nxt.upper()) is not None:
                break
            words.append(self.next())
        lic = " ".join(words)
        if self.peek() == "+":
            self.next()
            return SimpleExpr(lic, has_plus=True)
        return SimpleExpr(lic)


def parse(expr: str) -> Expr:
    toks = _lex(expr)
    if not toks:
        raise ParseError("empty expression")
    return _Parser(toks).parse()


def normalize_for_spdx(s: str) -> str:
    """Replace characters outside the SPDX idstring grammar with '-'
    (expression.go NormalizeForSPDX; ':' kept for DocumentRef). ASCII
    only — idstring = 1*(ALPHA / DIGIT / '-' / '.'), so non-ASCII
    letters are invalid too."""
    out = []
    for c in s:
        if ("a" <= c <= "z" or "A" <= c <= "Z" or "0" <= c <= "9"
                or c in "-.:"):
            out.append(c)
        else:
            out.append("-")
    return "".join(out)


def normalize(expr: str, *fns: Callable[[str], str],
              plus_fn: Callable[[str], str] | None = None) -> str:
    """Parse, apply the per-license normalizers to every simple
    expression, uppercase conjunctions, and render (expression.go
    Normalize). Raises ParseError on invalid input.

    plus_fn, when given, is consulted with the '+'-suffixed form of a
    plus expression first — the normalize table carries entries like
    'lgplv2+' that are more specific than bare-license-plus-suffix
    (the reference loses these: its lexer strips the '+' before
    licensing.Normalize ever sees it)."""
    tree = parse(expr)

    def walk(e: Expr) -> Expr:
        if isinstance(e, SimpleExpr):
            lic = e.license
            has_plus = e.has_plus
            if has_plus and plus_fn is not None:
                mapped = plus_fn(lic + "+")
                if mapped != lic + "+":
                    lic = mapped
                    has_plus = False
            for f in fns:
                lic = f(lic)
            return SimpleExpr(lic, has_plus)
        return CompoundExpr(walk(e.left), e.conj,
                            e.conj_lit.upper(), walk(e.right))

    return walk(tree).render()


def normalize_pkg_licenses(licenses: list[str]) -> str:
    """SPDX marshal entry point (spdx/marshal.go NormalizeLicense):
    '-with-' becomes a WITH conjunction, each license is parenthesized,
    the conjunction of all is AND, normalized through
    licensing.Normalize + NormalizeForSPDX. Returns '' when the joined
    expression does not parse (the reference logs and soldiers on)."""
    from .licensing import normalize as licensing_normalize
    parts = []
    for lic in licenses:
        lic = lic.replace("-with-", " WITH ").replace("-WITH-",
                                                      " WITH ")
        parts.append(f"({lic})")
    joined = " AND ".join(parts)
    if not joined:
        return ""
    try:
        return normalize(joined, licensing_normalize,
                         normalize_for_spdx,
                         plus_fn=licensing_normalize)
    except ParseError:
        return ""
