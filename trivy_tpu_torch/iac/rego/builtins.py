"""Rego builtin functions (subset used by trivy checks / custom checks).

Mirrors the OPA builtins the reference's bundle relies on (string ops,
aggregates, regex, object/array helpers, type checks, json codecs).
Functions raise or return UNDEF on type mismatch; the evaluator converts
exceptions to undefined (OPA's silent-failure semantics).
"""

from __future__ import annotations

import json
import re


class _Undef:
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "<undefined>"

    def __bool__(self):
        return False


UNDEF = _Undef()


class Halt(Exception):
    pass


class RSet:
    """Rego set: equality-based membership over arbitrary JSON values."""
    __slots__ = ("items",)

    def __init__(self, items=None):
        self.items = []
        for it in items or []:
            self.add(it)

    def add(self, v):
        if not self.has(v):
            self.items.append(v)

    def has(self, v):
        return any(rego_eq(v, x) for x in self.items)

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def __repr__(self):
        return "{" + ", ".join(repr(x) for x in self.items) + "}"

    def __eq__(self, other):
        if not isinstance(other, RSet):
            return NotImplemented
        return len(self) == len(other) and all(other.has(x) for x in self)

    def __hash__(self):
        return len(self.items)

    def to_list(self):
        return sorted(self.items, key=_sort_key)


def _sort_key(v):
    # total order across types for deterministic iteration
    if v is None:
        return (0, "")
    if isinstance(v, bool):
        return (1, str(v))
    if isinstance(v, (int, float)):
        return (2, v)
    if isinstance(v, str):
        return (3, v)
    return (4, json.dumps(unfreeze(v), sort_keys=True, default=str))


def unfreeze(v):
    if isinstance(v, RSet):
        return [unfreeze(x) for x in v.to_list()]
    if isinstance(v, list):
        return [unfreeze(x) for x in v]
    if isinstance(v, dict):
        return {k: unfreeze(x) for k, x in v.items()}
    return v


def rego_eq(a, b):
    if isinstance(a, RSet) or isinstance(b, RSet):
        if not (isinstance(a, RSet) and isinstance(b, RSet)):
            return False
        return a == b
    if isinstance(a, bool) != isinstance(b, bool):
        return False
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    if type(a) is not type(b):
        return False
    if isinstance(a, list):
        return len(a) == len(b) and all(
            rego_eq(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(
            rego_eq(a[k], b[k]) for k in a)
    return a == b


def to_key(v):
    """Object keys in our model: strings/numbers/bools kept as-is;
    compound keys JSON-encoded."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return json.dumps(unfreeze(v), sort_keys=True)


def index_into(v, key):
    if v is UNDEF:
        return UNDEF
    if isinstance(v, dict):
        if key in v:
            return v[key]
        # numeric string keys from yaml etc.
        return UNDEF
    if isinstance(v, list):
        if isinstance(key, bool):
            return UNDEF
        if isinstance(key, (int, float)) and not isinstance(key, bool):
            i = int(key)
            if 0 <= i < len(v):
                return v[i]
        return UNDEF
    if isinstance(v, RSet):
        return key if v.has(key) else UNDEF
    return UNDEF


def iter_collection(v):
    """Yield (key, value) pairs for enumeration."""
    if isinstance(v, list):
        for i, x in enumerate(v):
            yield i, x
    elif isinstance(v, dict):
        for k, x in v.items():
            yield k, x
    elif isinstance(v, RSet):
        for x in v.to_list():
            yield x, x


def member(x, coll):
    if isinstance(coll, list):
        return any(rego_eq(x, y) for y in coll)
    if isinstance(coll, RSet):
        return coll.has(x)
    if isinstance(coll, dict):
        return any(rego_eq(x, y) for y in coll.values())
    if isinstance(coll, str) and isinstance(x, str):
        return x in coll
    return False


def compare(op, a, b):
    if op == "==":
        return rego_eq(a, b)
    if op == "!=":
        return not rego_eq(a, b)
    try:
        if op == "<":
            return _cmp_lt(a, b)
        if op == "<=":
            return rego_eq(a, b) or _cmp_lt(a, b)
        if op == ">":
            return _cmp_lt(b, a)
        if op == ">=":
            return rego_eq(a, b) or _cmp_lt(b, a)
    except TypeError:
        return UNDEF
    return UNDEF


def _cmp_lt(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) and \
            not isinstance(a, bool) and not isinstance(b, bool):
        return a < b
    if isinstance(a, str) and isinstance(b, str):
        return a < b
    return _sort_key(a) < _sort_key(b)


def arith(op, a, b):
    if isinstance(a, RSet) and isinstance(b, RSet):
        if op == "-":
            return RSet([x for x in a if not b.has(x)])
        return UNDEF
    if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
        return UNDEF
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if b == 0:
            return UNDEF
        r = a / b
        return int(r) if isinstance(a, int) and isinstance(b, int) and \
            a % b == 0 else r
    if op == "%":
        if b == 0:
            return UNDEF
        return a % b
    return UNDEF


def walk_paths(v, path=None):
    path = path or []
    yield list(path), v
    if isinstance(v, dict):
        for k, x in v.items():
            yield from walk_paths(x, path + [k])
    elif isinstance(v, list):
        for i, x in enumerate(v):
            yield from walk_paths(x, path + [i])
    elif isinstance(v, RSet):
        for x in v.to_list():
            yield from walk_paths(x, path + [x])


# ---- builtin function table ------------------------------------------

def _count(x):
    if isinstance(x, (list, dict, RSet)):
        return len(x)
    if isinstance(x, str):
        return len(x)
    raise TypeError


def _sum(x):
    vals = list(x) if not isinstance(x, dict) else list(x.values())
    return sum(vals)


def _sprintf(fmt, args):
    if not isinstance(args, list):
        args = [args]
    out = []
    i = 0
    ai = 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%":
            out.append(c)
            i += 1
            continue
        # parse verb (with optional width/precision flags)
        j = i + 1
        while j < len(fmt) and fmt[j] in "+-# 0123456789.":
            j += 1
        if j >= len(fmt):
            out.append(c)
            break
        verb = fmt[j]
        if verb == "%":
            out.append("%")
            i = j + 1
            continue
        a = args[ai] if ai < len(args) else ""
        ai += 1
        if verb in ("v", "s"):
            out.append(_gostr(a))
        elif verb == "d":
            out.append(str(int(a)))
        elif verb in ("f", "g", "e"):
            spec = fmt[i:j + 1].replace("%", "")
            try:
                out.append(("%" + spec) % float(a))
            except Exception:
                out.append(str(float(a)))
        elif verb == "q":
            out.append(json.dumps(str(a)))
        elif verb == "t":
            out.append("true" if a else "false")
        elif verb == "x":
            out.append(format(int(a), "x"))
        else:
            out.append(_gostr(a))
        i = j + 1
    return "".join(out)


def _gostr(a):
    if a is None:
        return "null"
    if isinstance(a, bool):
        return "true" if a else "false"
    if isinstance(a, float) and a.is_integer():
        return str(int(a))
    if isinstance(a, (dict, list, RSet)):
        return json.dumps(unfreeze(a), separators=(", ", ": "))
    return str(a)


def _format_int(x, base):
    return {2: "{:b}", 8: "{:o}", 10: "{:d}", 16: "{:x}"}[
        int(base)].format(int(x))


def _concat(sep, coll):
    items = coll.to_list() if isinstance(coll, RSet) else list(coll)
    return sep.join(str(x) for x in items)


def _object_get(obj, key, default):
    if isinstance(key, list):
        cur = obj
        for k in key:
            got = index_into(cur, k)
            if got is UNDEF:
                return default
            cur = got
        return cur
    got = index_into(obj, key)
    return default if got is UNDEF else got


def _union(x):
    out = RSet()
    for s in x:
        for v in s:
            out.add(v)
    return out


def _intersection(x):
    sets = list(x)
    if not sets:
        return RSet()
    out = RSet([v for v in sets[0]
                if all(s.has(v) for s in sets[1:])])
    return out


def _to_number(x):
    if isinstance(x, bool):
        return 1 if x else 0
    if isinstance(x, (int, float)):
        return x
    if x is None:
        return 0
    s = str(x).strip()
    v = float(s)
    return int(v) if v.is_integer() and "." not in s and \
        "e" not in s.lower() else v


def _type_name(x):
    if x is None:
        return "null"
    if isinstance(x, bool):
        return "boolean"
    if isinstance(x, (int, float)):
        return "number"
    if isinstance(x, str):
        return "string"
    if isinstance(x, list):
        return "array"
    if isinstance(x, dict):
        return "object"
    if isinstance(x, RSet):
        return "set"
    return "unknown"


def _regex_split(pat, s):
    return re.split(pat, s)


def _glob_match(pattern, delimiters, match):
    # translate glob to regex; ** crosses delimiters, * does not.
    # OPA semantics: null/unspecified delimiters default to ["."];
    # an EMPTY array means no delimiters (so * crosses everything).
    if isinstance(delimiters, RSet):
        delimiters = delimiters.to_list()
    if delimiters is None:
        delims = ["."]
    elif isinstance(delimiters, list):
        delims = [str(d) for d in delimiters]
    else:
        delims = ["."]
    d = "".join(re.escape(x) for x in delims)
    star = f"[^{d}]*" if d else ".*"
    qmark = f"[^{d}]" if d else "."
    rx = ""
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "*":
            if pattern[i:i + 2] == "**":
                rx += ".*"
                i += 2
                continue
            rx += star
        elif c == "?":
            rx += qmark
        elif c in ".^$+{}[]()|\\":
            rx += "\\" + c
        else:
            rx += c
        i += 1
    return re.fullmatch(rx, match) is not None


def _startswith(s, p):
    return isinstance(s, str) and s.startswith(p)


def _endswith(s, p):
    return isinstance(s, str) and s.endswith(p)


def _substring(s, start, length):
    start = int(start)
    if start < 0:
        raise TypeError
    if length < 0:
        return s[start:]
    return s[start:start + int(length)]


def _array_slice(arr, lo, hi):
    lo = max(0, int(lo))
    hi = min(len(arr), int(hi))
    return arr[lo:hi] if lo <= hi else []


def _json_unmarshal(s):
    return json.loads(s)


def _yaml_unmarshal(s):
    import yaml
    return yaml.safe_load(s)


def _base64_decode(s):
    import base64
    return base64.b64decode(s).decode("utf-8", "replace")


def _base64_encode(s):
    import base64
    return base64.b64encode(s.encode()).decode()


def _set_diff(a, b):
    return RSet([x for x in a if not b.has(x)])


def _numbers_range(a, b):
    a, b = int(a), int(b)
    return list(range(a, b + 1)) if a <= b else list(range(a, b - 1, -1))


def _cast_set(x):
    if isinstance(x, RSet):
        return x
    return RSet(list(x))


def _cast_array(x):
    if isinstance(x, RSet):
        return x.to_list()
    return list(x)


def _semver_compare(a, b):
    def parse(v):
        core = re.split(r"[-+]", v, 1)[0]
        return [int(p) for p in core.split(".")]
    pa, pb = parse(a), parse(b)
    return -1 if pa < pb else (1 if pa > pb else 0)


BUILTINS = {
    "count": _count,
    "sum": _sum,
    "product": lambda x: __import__("math").prod(
        list(x.values()) if isinstance(x, dict) else list(x)),
    "max": lambda x: max(x.to_list() if isinstance(x, RSet) else x),
    "min": lambda x: min(x.to_list() if isinstance(x, RSet) else x),
    "sort": lambda x: sorted(
        x.to_list() if isinstance(x, RSet) else x, key=_sort_key),
    "abs": abs,
    "ceil": lambda x: int(__import__("math").ceil(x)),
    "floor": lambda x: int(__import__("math").floor(x)),
    "round": lambda x: int(round(x)),
    "to_number": _to_number,
    "numbers.range": _numbers_range,

    "concat": _concat,
    "contains": lambda s, sub: isinstance(s, str) and sub in s,
    "startswith": _startswith,
    "endswith": _endswith,
    "format_int": _format_int,
    "indexof": lambda s, sub: s.find(sub),
    "lower": lambda s: s.lower(),
    "upper": lambda s: s.upper(),
    "replace": lambda s, old, new: s.replace(old, new),
    "split": lambda s, d: s.split(d),
    "sprintf": _sprintf,
    "substring": _substring,
    "trim": lambda s, cut: s.strip(cut),
    "trim_left": lambda s, cut: s.lstrip(cut),
    "trim_right": lambda s, cut: s.rstrip(cut),
    "trim_prefix": lambda s, p: s[len(p):] if s.startswith(p) else s,
    "trim_suffix": lambda s, p: s[:-len(p)] if p and s.endswith(p) else s,
    "trim_space": lambda s: s.strip(),
    "strings.reverse": lambda s: s[::-1],
    "strings.replace_n": lambda pats, s: _replace_n(pats, s),
    "strings.any_prefix_match": lambda s, ps: _any_affix(s, ps, True),
    "strings.any_suffix_match": lambda s, ps: _any_affix(s, ps, False),

    "re_match": lambda pat, s: re.search(pat, s) is not None,
    "regex.match": lambda pat, s: re.search(pat, s) is not None,
    "regex.is_valid": lambda pat: _re_valid(pat),
    "regex.split": _regex_split,
    "regex.replace": lambda s, pat, new: re.sub(pat, new, s),
    "regex.find_n": lambda pat, s, n: (
        re.findall(pat, s)[:None if n < 0 else int(n)]),
    "glob.match": _glob_match,

    "array.concat": lambda a, b: list(a) + list(b),
    "array.slice": _array_slice,
    "array.reverse": lambda a: list(reversed(a)),

    "object.get": _object_get,
    "object.keys": lambda o: RSet(list(o.keys())),
    "object.remove": lambda o, ks: {
        k: v for k, v in o.items()
        if not member(k, ks)},
    "object.filter": lambda o, ks: {
        k: v for k, v in o.items() if member(k, ks)},
    "object.union": lambda a, b: {**a, **b},
    "object.union_n": lambda arr: {
        k: v for o in arr for k, v in o.items()},

    "union": _union,
    "intersection": _intersection,
    "set_diff": _set_diff,
    "cast_set": _cast_set,
    "cast_array": _cast_array,

    "is_string": lambda x: isinstance(x, str),
    "is_number": lambda x: isinstance(x, (int, float)) and
    not isinstance(x, bool),
    "is_boolean": lambda x: isinstance(x, bool),
    "is_array": lambda x: isinstance(x, list),
    "is_object": lambda x: isinstance(x, dict),
    "is_set": lambda x: isinstance(x, RSet),
    "is_null": lambda x: x is None,
    "type_name": _type_name,

    "json.unmarshal": _json_unmarshal,
    "json.marshal": lambda x: json.dumps(
        unfreeze(x), separators=(",", ":")),
    "json.is_valid": lambda s: _json_valid(s),
    "yaml.unmarshal": _yaml_unmarshal,
    "yaml.marshal": lambda x: __import__("yaml").safe_dump(unfreeze(x)),
    "base64.decode": _base64_decode,
    "base64.encode": _base64_encode,

    "semver.compare": _semver_compare,
    "semver.is_valid": lambda v: bool(re.fullmatch(
        r"\d+\.\d+\.\d+(?:-[0-9A-Za-z.-]+)?(?:\+[0-9A-Za-z.-]+)?",
        str(v))),

    "print": lambda *a: True,
    "trace": lambda *a: True,
    "object.subset": lambda sup, sub: _subset(sup, sub),
}


def _replace_n(pats, s):
    for old, new in pats.items():
        s = s.replace(old, new)
    return s


def _any_affix(s, ps, prefix):
    items = ps.to_list() if isinstance(ps, RSet) else (
        ps if isinstance(ps, list) else [ps])
    if prefix:
        return any(s.startswith(p) for p in items)
    return any(s.endswith(p) for p in items)


def _re_valid(pat):
    try:
        re.compile(pat)
        return True
    except re.error:
        return False


def _json_valid(s):
    try:
        json.loads(s)
        return True
    except Exception:
        return False


def _subset(sup, sub):
    if isinstance(sup, dict) and isinstance(sub, dict):
        return all(k in sup and rego_eq(sup[k], v)
                   for k, v in sub.items())
    if isinstance(sup, RSet) and isinstance(sub, RSet):
        return all(sup.has(x) for x in sub)
    if isinstance(sup, list) and isinstance(sub, list):
        return all(member(x, sup) for x in sub)
    return False
