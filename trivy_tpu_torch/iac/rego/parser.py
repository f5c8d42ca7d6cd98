"""Rego language lexer + parser (subset).

Parses the Rego dialect used by trivy-checks and user custom checks:
packages, imports (incl. rego.v1 / future.keywords no-ops), complete
rules, partial set/object rules (`deny[msg]`, `deny contains msg if`),
functions, `default`, `else`, `not`, `some .. in`, `every`, unification
and `:=` assignment, arrays/objects/sets, comprehensions, refs with
variable keys, arithmetic/comparison operators, and `# METADATA`
annotation blocks.

Reference counterpart: the OPA ast package consumed by
pkg/iac/rego/scanner.go:129 (NewScanner) and load.go; the metadata
conventions follow pkg/iac/rego/metadata.go.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

KEYWORDS = {
    "package", "import", "as", "default", "not", "some", "every", "in",
    "if", "contains", "else", "true", "false", "null", "with",
}

_TOKEN_RE = re.compile(r"""
    (?P<ws>[ \t\r]+)
  | (?P<comment>\#[^\n]*)
  | (?P<nl>\n)
  | (?P<raw>`[^`]*`)
  | (?P<str>"(?:\\.|[^"\\])*")
  | (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<punct>:=|==|!=|<=|>=|\||&|[\[\]{}().,:;=<>+\-*/%])
""", re.VERBOSE)


@dataclass
class Token:
    kind: str   # ident kw str num punct nl
    val: object
    line: int


def tokenize(src: str):
    toks: list[Token] = []
    comments: list[tuple[int, str]] = []
    line = 1
    pos = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise RegoSyntaxError(f"line {line}: bad character {src[pos]!r}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind == "ws":
            continue
        if kind == "comment":
            comments.append((line, text))
            continue
        if kind == "nl":
            toks.append(Token("nl", "\n", line))
            line += 1
            continue
        if kind == "raw":
            toks.append(Token("str", text[1:-1], line))
            line += text.count("\n")
            continue
        if kind == "str":
            toks.append(Token("str", _unescape(text[1:-1]), line))
            continue
        if kind == "num":
            v = float(text)
            if v.is_integer() and "." not in text and "e" not in text.lower():
                v = int(text)
            toks.append(Token("num", v, line))
            continue
        if kind == "ident":
            toks.append(Token("kw" if text in KEYWORDS else "ident",
                              text, line))
            continue
        toks.append(Token("punct", text, line))
    toks.append(Token("eof", None, line))
    return toks, comments


def _unescape(s: str) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            mapped = {"n": "\n", "t": "\t", "r": "\r", '"': '"',
                      "\\": "\\", "/": "/"}.get(nxt)
            if mapped is not None:
                out.append(mapped)
                i += 2
                continue
            if nxt == "u" and i + 5 < len(s):
                out.append(chr(int(s[i + 2:i + 6], 16)))
                i += 6
                continue
        out.append(c)
        i += 1
    return "".join(out)


class RegoSyntaxError(Exception):
    pass


# ---- AST --------------------------------------------------------------
# Terms are tuples:
#   ('num', v) ('str', s) ('bool', b) ('null',) ('var', name)
#   ('ref', baseterm, [('dot', name) | ('idx', term), ...])
#   ('array', [t]) ('object', [(k, v)]) ('set', [t])
#   ('call', ref_term, [args])
#   ('bin', op, a, b)            op in + - * / % | & (set ops | & -)
#   ('cmp', op, a, b)            op in == != < <= > >=
#   ('in', x, coll) ('in2', k, v, coll)
#   ('acompr', head, body) ('scompr', head, body)
#   ('ocompr', k, v, body)
# Body exprs:
#   ('term', t) ('not', t) ('assign', target, t) ('unify', a, b)
#   ('some', [names]) ('somein', kvar_or_None, vvar, coll)
#   ('every', kvar_or_None, vvar, coll, body)
# each expr is (line, node, withs) where withs = [(ref_term, term), ...]


@dataclass
class Rule:
    name: str
    key: object = None          # partial set/object key term
    value: object = None        # value term (None => true)
    args: object = None         # function params (list of terms)
    body: list = field(default_factory=list)
    is_default: bool = False
    else_rules: list = field(default_factory=list)
    line: int = 0
    metadata: dict = field(default_factory=dict)
    is_partial_set: bool = False
    is_partial_obj: bool = False


@dataclass
class Module:
    package: tuple
    imports: list
    rules: list
    metadata: dict = field(default_factory=dict)
    path: str = ""

    def rules_named(self, name):
        return [r for r in self.rules if r.name == name]


class Parser:
    def __init__(self, src: str, path: str = ""):
        self.toks, self.comments = tokenize(src)
        self.i = 0
        self.path = path
        self.annotations = _parse_annotations(self.comments)

    # -- token helpers
    def peek(self, k=0):
        j = self.i
        seen = 0
        while j < len(self.toks):
            t = self.toks[j]
            if t.kind != "nl":
                if seen == k:
                    return t
                seen += 1
            j += 1
        return self.toks[-1]

    def peek_raw(self):
        return self.toks[self.i]

    def next(self):
        while self.toks[self.i].kind == "nl":
            self.i += 1
        t = self.toks[self.i]
        self.i += 1
        return t

    def skip_nl(self):
        while self.toks[self.i].kind == "nl":
            self.i += 1

    def expect(self, kind, val=None):
        t = self.next()
        if t.kind != kind or (val is not None and t.val != val):
            raise RegoSyntaxError(
                f"{self.path}:{t.line}: expected {val or kind}, "
                f"got {t.val!r}")
        return t

    def at_punct(self, val):
        t = self.peek()
        return t.kind == "punct" and t.val == val

    def at_kw(self, val):
        t = self.peek()
        return t.kind == "kw" and t.val == val

    def eat_punct(self, val):
        if self.at_punct(val):
            self.next()
            return True
        return False

    def eat_kw(self, val):
        if self.at_kw(val):
            self.next()
            return True
        return False

    # -- module
    def parse_module(self) -> Module:
        self.skip_nl()
        pkg_line = self.peek().line
        self.expect("kw", "package")
        pkg = self._parse_pkg_path()
        imports = []
        rules = []
        mod_meta = self._annotation_for(pkg_line, scope_default="package")
        while True:
            self.skip_nl()
            t = self.peek()
            if t.kind == "eof":
                break
            if t.kind == "kw" and t.val == "import":
                self.next()
                imports.append(self._parse_import())
                continue
            rules.append(self._parse_rule())
        m = Module(tuple(pkg), imports, rules, metadata=mod_meta or {},
                   path=self.path)
        return m

    def _parse_pkg_path(self):
        parts = [self.expect("ident").val]
        while self.eat_punct("."):
            t = self.next()
            if t.kind not in ("ident", "kw"):
                raise RegoSyntaxError(f"bad package path at line {t.line}")
            parts.append(t.val)
        return parts

    def _parse_import(self):
        # import data.lib.foo [as bar] / import rego.v1 / import input.x
        parts = [self.next().val]
        while self.eat_punct("."):
            t = self.next()
            parts.append(t.val)
        alias = None
        if self.eat_kw("as"):
            alias = self.expect("ident").val
        return (tuple(parts), alias)

    def _annotation_for(self, line, scope_default="rule"):
        best = None
        for ann in self.annotations:
            if ann["end_line"] < line and (
                    best is None or ann["end_line"] > best["end_line"]):
                # annotation must be adjacent (within 1 line of gap)
                if line - ann["end_line"] <= 1:
                    best = ann
        if best is None:
            return {}
        return best["data"]

    # -- rules
    def _parse_rule(self) -> Rule:
        line = self.peek().line
        meta = self._annotation_for(line)
        is_default = self.eat_kw("default")
        name_tok = self.next()
        if name_tok.kind not in ("ident", "kw"):
            raise RegoSyntaxError(
                f"{self.path}:{name_tok.line}: expected rule name, got "
                f"{name_tok.val!r}")
        name = name_tok.val
        rule = Rule(name=name, line=line, is_default=is_default,
                    metadata=meta)

        if self.at_punct("("):
            # function definition
            self.next()
            args = []
            if not self.at_punct(")"):
                while True:
                    args.append(self._parse_term())
                    if not self.eat_punct(","):
                        break
            self.expect("punct", ")")
            rule.args = args
        elif self.at_punct("["):
            # partial set rule deny[msg] or partial object rule a[k] = v
            self.next()
            rule.key = self._parse_term()
            self.expect("punct", "]")
            if self.at_punct("=") or self.at_punct(":="):
                self.next()
                rule.value = self._parse_term()
                rule.is_partial_obj = True
            else:
                rule.is_partial_set = True
        elif self.eat_kw("contains"):
            # deny contains msg if { ... }
            rule.key = self._parse_term()
            rule.is_partial_set = True

        if rule.args is not None or not (rule.is_partial_set or
                                         rule.is_partial_obj):
            if self.at_punct("=") or self.at_punct(":="):
                self.next()
                rule.value = self._parse_term()

        self.eat_kw("if")
        if self.at_punct("{"):
            rule.body = self._parse_body()
        elif not is_default and rule.value is None and not (
                rule.is_partial_set or rule.is_partial_obj):
            # bare `name if expr` single-expression body or `name := v`
            expr = self._parse_expr()
            rule.body = [expr]
        elif self.peek().kind != "eof" and \
                self.peek_raw().kind != "nl" and not self.at_kw("else"):
            # single-expression body after `if` on same line
            if not (self.at_kw("default") or self.at_punct("}")):
                t = self.peek()
                if t.kind in ("ident", "kw", "str", "num", "punct") and \
                        not self.at_punct("}"):
                    nxt = self.peek()
                    if not (nxt.kind == "kw" and nxt.val in
                            ("default", "package", "import")):
                        rule.body = [self._parse_expr()]

        while self.at_kw("else"):
            self.next()
            er = Rule(name=name, line=self.peek().line)
            if self.at_punct("=") or self.at_punct(":="):
                self.next()
                er.value = self._parse_term()
            self.eat_kw("if")
            if self.at_punct("{"):
                er.body = self._parse_body()
            rule.else_rules.append(er)
        return rule

    def _parse_body(self):
        self.expect("punct", "{")
        exprs = []
        while True:
            self.skip_nl()
            if self.at_punct("}"):
                self.next()
                break
            exprs.append(self._parse_expr())
            self.skip_nl()
            self.eat_punct(";")
        return exprs

    # -- expressions
    def _parse_expr(self):
        line = self.peek().line
        node = self._parse_expr_node()
        withs = []
        while self.at_kw("with"):
            self.next()
            target = self._parse_term()
            self.expect("kw", "as")
            val = self._parse_term()
            withs.append((target, val))
        return (line, node, withs)

    def _parse_expr_node(self):
        if self.eat_kw("not"):
            t = self._parse_term()
            return ("not", t)
        if self.at_kw("some"):
            self.next()
            # parse below `in` precedence so `some x in coll` keeps the
            # `in` for us to consume
            names = [self._parse_cmp()]
            while self.eat_punct(","):
                names.append(self._parse_cmp())
            if self.eat_kw("in"):
                coll = self._parse_term()
                if len(names) == 1:
                    return ("somein", None, names[0], coll)
                return ("somein", names[0], names[1], coll)
            out = []
            for nm in names:
                if nm[0] != "var":
                    raise RegoSyntaxError("some: expected variable")
                out.append(nm[1])
            return ("some", out)
        if self.at_kw("every"):
            self.next()
            v1 = self._parse_cmp()
            v2 = None
            if self.eat_punct(","):
                v2 = self._parse_cmp()
            self.expect("kw", "in")
            coll = self._parse_term()
            body = self._parse_body()
            if v2 is None:
                return ("every", None, v1, coll, body)
            return ("every", v1, v2, coll, body)

        t = self._parse_term()
        if self.at_punct(":="):
            self.next()
            rhs = self._parse_term()
            return ("assign", t, rhs)
        if self.at_punct("="):
            self.next()
            rhs = self._parse_term()
            return ("unify", t, rhs)
        return ("term", t)

    # -- terms (precedence: in < cmp < add < mul < unary < postfix)
    def _parse_term(self):
        return self._parse_in()

    def _parse_in(self):
        t = self._parse_cmp()
        if self.at_kw("in"):
            self.next()
            coll = self._parse_cmp()
            return ("in", t, coll)
        if self.at_punct(","):
            # `k, v in coll` only valid inside some/every which handle
            # commas themselves; here comma terminates the term.
            pass
        return t

    def _parse_cmp(self):
        t = self._parse_add()
        while self.peek().kind == "punct" and self.peek().val in (
                "==", "!=", "<", "<=", ">", ">="):
            op = self.next().val
            rhs = self._parse_add()
            t = ("cmp", op, t, rhs)
        return t

    def _parse_add(self):
        t = self._parse_mul()
        # NOTE: `|`/`&` set operators are intentionally not parsed as
        # binary ops — `|` would be ambiguous with the comprehension
        # separator; use union()/intersection() builtins instead.
        while self.peek().kind == "punct" and self.peek().val in (
                "+", "-"):
            op = self.next().val
            rhs = self._parse_mul()
            t = ("bin", op, t, rhs)
        return t

    def _parse_mul(self):
        t = self._parse_unary()
        while self.peek().kind == "punct" and self.peek().val in (
                "*", "/", "%"):
            op = self.next().val
            rhs = self._parse_unary()
            t = ("bin", op, t, rhs)
        return t

    def _parse_unary(self):
        if self.at_punct("-"):
            self.next()
            t = self._parse_unary()
            return ("bin", "-", ("num", 0), t)
        return self._parse_postfix()

    def _parse_postfix(self):
        t = self._parse_primary()
        while True:
            if self.at_punct("."):
                # only a ref/dot if followed by ident on same logical pos
                self.next()
                name_tok = self.next()
                if name_tok.kind not in ("ident", "kw"):
                    raise RegoSyntaxError(
                        f"{self.path}:{name_tok.line}: bad ref")
                t = _extend_ref(t, ("dot", name_tok.val))
            elif self._at_idx_bracket():
                self.next()
                idx = self._parse_term()
                self.expect("punct", "]")
                t = _extend_ref(t, ("idx", idx))
            elif self.at_punct("(") and _callable_ref(t):
                self.next()
                args = []
                if not self.at_punct(")"):
                    while True:
                        args.append(self._parse_term())
                        if not self.eat_punct(","):
                            break
                self.expect("punct", ")")
                t = ("call", t, args)
            else:
                return t

    def _at_idx_bracket(self):
        # `[` directly after the previous token (no newline) → index
        if not self.at_punct("["):
            return False
        return self.peek_raw().kind != "nl"

    def _parse_primary(self):
        t = self.next()
        if t.kind == "num":
            return ("num", t.val)
        if t.kind == "str":
            return ("str", t.val)
        if t.kind == "kw":
            if t.val == "true":
                return ("bool", True)
            if t.val == "false":
                return ("bool", False)
            if t.val == "null":
                return ("null",)
            if t.val == "in":  # allow use as var in odd spots? no
                raise RegoSyntaxError(f"line {t.line}: unexpected 'in'")
            # keywords like `contains`/`if` used as plain idents (e.g.
            # builtin `contains(...)`)
            return ("var", t.val)
        if t.kind == "ident":
            return ("var", t.val)
        if t.kind == "punct":
            if t.val == "(":
                inner = self._parse_term()
                self.expect("punct", ")")
                return inner
            if t.val == "[":
                return self._parse_array_or_compr()
            if t.val == "{":
                return self._parse_obj_set_or_compr()
        raise RegoSyntaxError(f"line {t.line}: unexpected {t.val!r}")

    def _parse_array_or_compr(self):
        self.skip_nl()
        if self.at_punct("]"):
            self.next()
            return ("array", [])
        first = self._parse_term()
        if self.at_punct("|"):
            self.next()
            body = self._parse_compr_body("]")
            return ("acompr", first, body)
        items = [first]
        while self.eat_punct(","):
            self.skip_nl()
            if self.at_punct("]"):
                break
            items.append(self._parse_term())
        self.skip_nl()
        self.expect("punct", "]")
        return ("array", items)

    def _parse_obj_set_or_compr(self):
        self.skip_nl()
        if self.at_punct("}"):
            self.next()
            return ("object", [])
        first = self._parse_term()
        if self.at_punct(":"):
            self.next()
            val = self._parse_term()
            if self.at_punct("|"):
                self.next()
                body = self._parse_compr_body("}")
                return ("ocompr", first, val, body)
            pairs = [(first, val)]
            while self.eat_punct(","):
                self.skip_nl()
                if self.at_punct("}"):
                    break
                k = self._parse_term()
                self.expect("punct", ":")
                v = self._parse_term()
                pairs.append((k, v))
            self.skip_nl()
            self.expect("punct", "}")
            return ("object", pairs)
        if self.at_punct("|"):
            self.next()
            body = self._parse_compr_body("}")
            return ("scompr", first, body)
        items = [first]
        while self.eat_punct(","):
            self.skip_nl()
            if self.at_punct("}"):
                break
            items.append(self._parse_term())
        self.skip_nl()
        self.expect("punct", "}")
        return ("set", items)

    def _parse_compr_body(self, closer):
        exprs = []
        while True:
            self.skip_nl()
            if self.at_punct(closer):
                self.next()
                break
            exprs.append(self._parse_expr())
            self.skip_nl()
            self.eat_punct(";")
        return exprs


def _extend_ref(t, op):
    if t[0] == "ref":
        return ("ref", t[1], t[2] + [op])
    return ("ref", t, [op])


def _callable_ref(t):
    if t[0] == "var":
        return True
    if t[0] == "ref" and all(op[0] == "dot" for op in t[2]):
        return True
    return False


def _parse_annotations(comments):
    """Collect `# METADATA` blocks → [{'end_line': n, 'data': {...}}]."""
    anns = []
    i = 0
    comments = sorted(comments)
    n = len(comments)
    while i < n:
        line, text = comments[i]
        if text.strip() == "# METADATA":
            yaml_lines = []
            last = line
            j = i + 1
            while j < n and comments[j][0] == last + 1:
                body = comments[j][1]
                if not body.startswith("#"):
                    break
                yaml_lines.append(body[1:].removeprefix(" "))
                last = comments[j][0]
                j += 1
            data = _load_yaml("\n".join(yaml_lines))
            if isinstance(data, dict):
                anns.append({"end_line": last, "data": data})
            i = j
        else:
            i += 1
    return anns


def _load_yaml(text):
    try:
        import yaml
        return yaml.safe_load(text)
    except Exception:
        return None


def parse_module(src: str, path: str = "") -> Module:
    return Parser(src, path).parse_module()
