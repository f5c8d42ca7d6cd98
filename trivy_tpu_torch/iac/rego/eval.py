"""Rego evaluator (subset) — generator-based backtracking interpreter.

Semantics follow OPA as exercised by the reference's check bundle and
custom-check docs (pkg/iac/rego/scanner.go runQuery): rules are virtual
documents under `data.<package>`, bodies are conjunctive queries over
possibly-unbound variables, `undefined` propagates as query failure.

Values are plain Python: dict / list / RSet / str / int / float / bool /
None. `undefined` is the UNDEF sentinel.
"""

from __future__ import annotations

from .parser import Module, Rule, parse_module
from . import builtins as B

UNDEF = B.UNDEF
RSet = B.RSet


class RegoEvalError(Exception):
    pass


class _Wildcard:
    _n = 0

    @classmethod
    def fresh(cls):
        cls._n += 1
        return f"$w{cls._n}"


class Env:
    """Immutable-ish binding environment (copy-on-bind)."""
    __slots__ = ("b",)

    def __init__(self, b=None):
        self.b = b or {}

    def get(self, name):
        return self.b.get(name, UNDEF)

    def bind(self, name, value):
        nb = dict(self.b)
        nb[name] = value
        return Env(nb)


class Interpreter:
    def __init__(self, modules: list[Module], data: dict | None = None,
                 trace=None):
        self.modules = modules
        self.base_data = data or {}
        self.pkg_index: dict[tuple, list[Module]] = {}
        for m in modules:
            self.pkg_index.setdefault(m.package, []).append(m)
        self.rule_cache: dict = {}
        self.input = UNDEF
        self.trace = trace
        self._depth = 0
        # query() mutates input/rule_cache for the whole evaluation —
        # a shared Interpreter (custom-checks scanner under --parallel
        # walks) must serialize queries
        import threading
        self._query_lock = threading.Lock()

    # -- public API ----------------------------------------------------
    def query(self, path: str, input_doc=UNDEF):
        """Evaluate `data.<path>` → value or UNDEF. Thread-safe: the
        evaluation state (input, rule cache) is per-query."""
        with self._query_lock:
            self.input = input_doc
            self.rule_cache = {}
            parts = tuple(path.split("."))
            try:
                return self._data_path(parts)
            finally:
                self.input = UNDEF

    def rule_names(self, pkg: tuple) -> list[str]:
        names = []
        for m in self.pkg_index.get(pkg, []):
            for r in m.rules:
                if r.name not in names:
                    names.append(r.name)
        return names

    # -- data document -------------------------------------------------
    def _data_path(self, parts: tuple):
        # walk down: packages win over base data at the same key
        for cut in range(len(parts), 0, -1):
            pkg = parts[:cut]
            if pkg in self.pkg_index:
                val = self._eval_rule_path(pkg, parts[cut:])
                if val is not UNDEF:
                    return val
        # base data fallback
        cur = self.base_data
        for p in parts:
            if isinstance(cur, dict) and p in cur:
                cur = cur[p]
            else:
                return UNDEF
        return cur

    def _eval_rule_path(self, pkg: tuple, rest: tuple):
        if not rest:
            # whole package document
            out = {}
            for name in self.rule_names(pkg):
                v = self.eval_rule(pkg, name)
                if v is not UNDEF:
                    out[name] = v
            return out
        head, tail = rest[0], rest[1:]
        v = self.eval_rule(pkg, head)
        for p in tail:
            if v is UNDEF:
                return UNDEF
            v = B.index_into(v, p)
        return v

    # -- rules ---------------------------------------------------------
    def eval_rule(self, pkg: tuple, name: str):
        key = (pkg, name)
        if key in self.rule_cache:
            return self.rule_cache[key]
        if self.trace is not None:
            self.trace("enter", ".".join(pkg + (name,)), self._depth)
        self._depth += 1
        try:
            return self._eval_rule_inner(key, pkg, name)
        finally:
            self._depth -= 1
            if self.trace is not None:
                self.trace("exit", ".".join(pkg + (name,)), self._depth)

    def _eval_rule_inner(self, key, pkg: tuple, name: str):
        self.rule_cache[key] = UNDEF  # cycle guard
        defs = []
        for m in self.pkg_index.get(pkg, []):
            for r in m.rules:
                if r.name == name:
                    defs.append((m, r))
        if not defs:
            return UNDEF
        if any(r.args is not None for _, r in defs):
            fn = _UserFunction(self, [(m, r) for m, r in defs
                                      if r.args is not None])
            self.rule_cache[key] = fn
            return fn

        partial_set = any(r.is_partial_set for _, r in defs)
        partial_obj = any(r.is_partial_obj for _, r in defs)
        default_val = UNDEF
        result = UNDEF
        if partial_set:
            result = RSet()
            for m, r in defs:
                if not r.is_partial_set:
                    continue
                for env in self.eval_body(r.body, Env(), m):
                    for v, env2 in self.eval_term(r.key, env, m):
                        if v is not UNDEF:
                            result.add(v)
        elif partial_obj:
            result = {}
            for m, r in defs:
                if not r.is_partial_obj:
                    continue
                for env in self.eval_body(r.body, Env(), m):
                    for k, env2 in self.eval_term(r.key, env, m):
                        for v, _ in self.eval_term(r.value, env2, m):
                            if k is not UNDEF and v is not UNDEF:
                                result[B.to_key(k)] = v
        else:
            for m, r in defs:
                if r.is_default:
                    for v, _ in self.eval_term(r.value, Env(), m):
                        default_val = v
                    continue
                got = self._eval_complete_def(m, r)
                if got is not UNDEF:
                    result = got
                    break
            if result is UNDEF:
                result = default_val
        self.rule_cache[key] = result
        return result

    def _eval_complete_def(self, m, r: Rule):
        for env in self.eval_body(r.body, Env(), m):
            if r.value is None:
                return True
            for v, _ in self.eval_term(r.value, env, m):
                return v
        for er in r.else_rules:
            for env in self.eval_body(er.body, Env(), m):
                if er.value is None:
                    return True
                for v, _ in self.eval_term(er.value, env, m):
                    return v
        return UNDEF

    # -- bodies --------------------------------------------------------
    def eval_body(self, body, env: Env, mod: Module):
        if not body:
            yield env
            return
        yield from self._eval_exprs(body, 0, env, mod)

    def _eval_exprs(self, body, i, env, mod):
        if i >= len(body):
            yield env
            return
        line, node, withs = body[i]
        if withs:
            import copy
            saved = self.input
            saved_data = self.base_data
            try:
                for tgt, val_t in withs:
                    if tgt == ("var", "input") or (
                            tgt[0] == "ref" and tgt[1] == ("var", "input")
                            and not tgt[2]):
                        for v, env in self.eval_term(val_t, env, mod):
                            self.input = v
                            break
                    # `with input.x as v` partial override
                    elif tgt[0] == "ref" and tgt[1] == ("var", "input"):
                        base = copy.deepcopy(self.input) \
                            if isinstance(self.input, (dict, list)) else {}
                        self.input = _override_path(
                            base, tgt[2], val_t, self, env, mod)
                    elif tgt[0] == "ref" and tgt[1] == ("var", "data"):
                        base = copy.deepcopy(self.base_data)
                        self.base_data = _override_path(
                            base, tgt[2], val_t, self, env, mod)
                    else:
                        raise RegoEvalError(
                            "unsupported with-modifier target")
                # materialize while the override is active; rule results
                # computed under `with` must not leak into the cache
                saved_cache = self.rule_cache
                self.rule_cache = {}
                solutions = list(self._eval_one(node, env, mod))
                self.rule_cache = saved_cache
            finally:
                self.input = saved
                self.base_data = saved_data
            for e2 in solutions:
                yield from self._eval_exprs(body, i + 1, e2, mod)
            return
        for e2 in self._eval_one(node, env, mod):
            yield from self._eval_exprs(body, i + 1, e2, mod)

    def _eval_one(self, node, env, mod):
        kind = node[0]
        if kind == "term":
            for v, e2 in self.eval_term(node[1], env, mod):
                if v is not UNDEF and v is not False:
                    yield e2
            return
        if kind == "not":
            for v, _ in self.eval_term(node[1], env, mod):
                if v is not UNDEF and v is not False:
                    return
            yield env
            return
        if kind == "assign":
            target, rhs = node[1], node[2]
            for v, e2 in self.eval_term(rhs, env, mod):
                if v is UNDEF:
                    continue
                e3 = _bind_pattern(target, v, e2)
                if e3 is not None:
                    yield e3
            return
        if kind == "unify":
            yield from self._unify(node[1], node[2], env, mod)
            return
        if kind == "some":
            # declares locals; nothing to do eagerly
            yield env
            return
        if kind == "somein":
            _, kvar, vvar, coll_t = node
            for coll, e2 in self.eval_term(coll_t, env, mod):
                for k, v in B.iter_collection(coll):
                    e3 = e2
                    if kvar is not None:
                        e3 = _bind_pattern(kvar, k, e3)
                        if e3 is None:
                            continue
                    e4 = _bind_pattern(vvar, v, e3)
                    if e4 is not None:
                        yield e4
            return
        if kind == "every":
            _, kvar, vvar, coll_t, body = node
            for coll, e2 in self.eval_term(coll_t, env, mod):
                ok = True
                for k, v in B.iter_collection(coll):
                    e3 = e2
                    if kvar is not None:
                        e3 = _bind_pattern(kvar, k, e3)
                    e3 = _bind_pattern(vvar, v, e3) if e3 else None
                    if e3 is None:
                        ok = False
                        break
                    if not any(True for _ in self.eval_body(body, e3, mod)):
                        ok = False
                        break
                if ok:
                    yield e2
                    return
            return
        raise RegoEvalError(f"unknown expr {kind}")

    def _unify(self, a, b, env, mod):
        # try evaluating both; bind whichever side is an unbound pattern
        a_ground = _is_ground(a, env)
        b_ground = _is_ground(b, env)
        if a_ground and b_ground:
            for va, e2 in self.eval_term(a, env, mod):
                for vb, e3 in self.eval_term(b, e2, mod):
                    if B.rego_eq(va, vb):
                        yield e3
            return
        if a_ground:
            for va, e2 in self.eval_term(a, env, mod):
                if va is UNDEF:
                    continue
                e3 = _bind_pattern(b, va, e2)
                if e3 is not None:
                    yield e3
            return
        if b_ground:
            for vb, e2 in self.eval_term(b, env, mod):
                if vb is UNDEF:
                    continue
                e3 = _bind_pattern(a, vb, e2)
                if e3 is not None:
                    yield e3
            return
        # both non-ground: iterate a's possibilities (ref enumeration)
        for va, e2 in self.eval_term(a, env, mod):
            if va is UNDEF:
                continue
            e3 = _bind_pattern(b, va, e2)
            if e3 is not None:
                yield e3

    # -- terms ---------------------------------------------------------
    def eval_term(self, t, env: Env, mod: Module):
        """Yield (value, env) pairs — multiple when unbound vars occur
        in ref indices (enumeration)."""
        kind = t[0]
        if kind == "num" or kind == "str" or kind == "bool":
            yield t[1], env
            return
        if kind == "null":
            yield None, env
            return
        if kind == "var":
            name = t[1]
            if name == "_":
                yield UNDEF, env  # bare wildcard as value: undefined
                return
            if name == "input":
                yield self.input, env
                return
            if name == "data":
                yield _DataDoc(self), env
                return
            v = env.get(name)
            if v is not UNDEF:
                yield v, env
                return
            # maybe a rule or import in this module's package
            v = self._resolve_name(name, mod)
            yield v, env
            return
        if kind == "ref":
            yield from self._eval_ref(t, env, mod)
            return
        if kind == "array":
            yield from self._eval_array(t[1], env, mod)
            return
        if kind == "object":
            yield from self._eval_object(t[1], env, mod)
            return
        if kind == "set":
            s = RSet()
            done = env
            ok = True
            for item in t[1]:
                got = next(self.eval_term(item, done, mod), None)
                if got is None or got[0] is UNDEF:
                    ok = False
                    break
                s.add(got[0])
                done = got[1]
            if ok:
                yield s, done
            return
        if kind == "cmp":
            _, op, a, b = t
            for va, e2 in self.eval_term(a, env, mod):
                for vb, e3 in self.eval_term(b, e2, mod):
                    if va is UNDEF or vb is UNDEF:
                        continue
                    yield B.compare(op, va, vb), e3
            return
        if kind == "bin":
            _, op, a, b = t
            for va, e2 in self.eval_term(a, env, mod):
                for vb, e3 in self.eval_term(b, e2, mod):
                    if va is UNDEF or vb is UNDEF:
                        continue
                    yield B.arith(op, va, vb), e3
            return
        if kind == "in":
            _, x, coll_t = t
            for vx, e2 in self.eval_term(x, env, mod):
                for coll, e3 in self.eval_term(coll_t, e2, mod):
                    yield B.member(vx, coll), e3
            return
        if kind == "call":
            yield from self._eval_call(t, env, mod)
            return
        if kind == "acompr":
            head, body = t[1], t[2]
            out = []
            for e2 in self.eval_body(body, env, mod):
                for v, _ in self.eval_term(head, e2, mod):
                    if v is not UNDEF:
                        out.append(v)
            yield out, env
            return
        if kind == "scompr":
            head, body = t[1], t[2]
            s = RSet()
            for e2 in self.eval_body(body, env, mod):
                for v, _ in self.eval_term(head, e2, mod):
                    if v is not UNDEF:
                        s.add(v)
            yield s, env
            return
        if kind == "ocompr":
            kt, vt, body = t[1], t[2], t[3]
            out = {}
            for e2 in self.eval_body(body, env, mod):
                for k, e3 in self.eval_term(kt, e2, mod):
                    for v, _ in self.eval_term(vt, e3, mod):
                        if k is not UNDEF and v is not UNDEF:
                            out[B.to_key(k)] = v
            yield out, env
            return
        raise RegoEvalError(f"unknown term {kind}")

    def _eval_array(self, items, env, mod):
        def rec(idx, acc, e):
            if idx == len(items):
                yield list(acc), e
                return
            for v, e2 in self.eval_term(items[idx], e, mod):
                if v is UNDEF:
                    continue
                yield from rec(idx + 1, acc + [v], e2)
        yield from rec(0, [], env)

    def _eval_object(self, pairs, env, mod):
        def rec(idx, acc, e):
            if idx == len(pairs):
                yield dict(acc), e
                return
            kt, vt = pairs[idx]
            for k, e2 in self.eval_term(kt, e, mod):
                for v, e3 in self.eval_term(vt, e2, mod):
                    if k is UNDEF or v is UNDEF:
                        continue
                    yield from rec(idx + 1, acc + [(B.to_key(k), v)], e3)
        yield from rec(0, [], env)

    def _resolve_name(self, name, mod: Module):
        if mod is None:
            return UNDEF
        for path, alias in mod.imports:
            nm = alias or path[-1]
            if nm == name:
                if path[0] == "data":
                    return self._data_path(path[1:])
                if path[0] == "input":
                    v = self.input
                    for p in path[1:]:
                        v = B.index_into(v, p)
                    return v
                return UNDEF
        # rule in same package
        if any(r.name == name for r in mod.rules):
            return self.eval_rule(mod.package, name)
        # builtin zero-ref (e.g. used as function elsewhere)
        return UNDEF

    def _eval_ref(self, t, env, mod):
        base, ops = t[1], t[2]
        # data refs resolved lazily to support packages at any depth
        if base == ("var", "data"):
            yield from self._eval_data_ref(ops, env, mod)
            return
        for v, e in self.eval_term(base, env, mod):
            yield from self._walk_ops(v, ops, 0, e, mod)

    def _walk_ops(self, v, ops, i, env, mod):
        if v is UNDEF:
            return
        if isinstance(v, _UserFunction) or callable(v):
            # ref into function result unsupported without call
            return
        if i == len(ops):
            yield v, env
            return
        op = ops[i]
        if op[0] == "dot":
            yield from self._walk_ops(B.index_into(v, op[1]), ops, i + 1,
                                      env, mod)
            return
        idx_t = op[1]
        if idx_t[0] == "var":
            name = idx_t[1]
            if name == "_":
                for k, item in B.iter_collection(v):
                    yield from self._walk_ops(item, ops, i + 1, env, mod)
                return
            bound = env.get(name)
            if bound is UNDEF and not self._is_defined_name(name, mod):
                # unbound variable: enumerate collection, binding it
                for k, item in B.iter_collection(v):
                    yield from self._walk_ops(item, ops, i + 1,
                                              env.bind(name, k), mod)
                return
        for idx_v, e2 in self.eval_term(idx_t, env, mod):
            if idx_v is UNDEF:
                continue
            yield from self._walk_ops(B.index_into(v, idx_v), ops, i + 1,
                                      e2, mod)

    def _is_defined_name(self, name, mod):
        if name in ("input", "data"):
            return True
        if mod is not None:
            if any(r.name == name for r in mod.rules):
                return True
            for path, alias in mod.imports:
                if (alias or path[-1]) == name:
                    return True
        return False

    def _eval_data_ref(self, ops, env, mod):
        # resolve leading dot-ops as a static data path, then dynamic
        static = []
        i = 0
        while i < len(ops) and ops[i][0] == "dot":
            static.append(ops[i][1])
            i += 1
        v = self._data_path(tuple(static))
        yield from self._walk_ops(v, ops, i, env, mod)

    # -- calls ---------------------------------------------------------
    def _eval_call(self, t, env, mod):
        fn_t, args = t[1], t[2]
        name = _ref_to_name(fn_t)
        # user function in same package or imported lib?
        target = self._lookup_function(name, fn_t, env, mod)
        if target is not None:
            yield from target.call(args, env, mod)
            return
        if name == "walk":
            for v, e in self.eval_term(args[0], env, mod):
                for path, val in B.walk_paths(v):
                    yield [path, val], e
            return
        bfn = B.BUILTINS.get(name)
        if bfn is None:
            raise RegoEvalError(f"unknown function {name}")
        def rec(idx, acc, e):
            if idx == len(args):
                try:
                    yield bfn(*acc), e
                except B.Halt:
                    raise
                except Exception:
                    yield UNDEF, e
                return
            for v, e2 in self.eval_term(args[idx], e, mod):
                yield from rec(idx + 1, acc + [v], e2)
        yield from rec(0, [], env)

    def _lookup_function(self, name, fn_t, env, mod):
        if fn_t[0] == "var":
            if mod is not None and any(
                    r.name == name and r.args is not None
                    for r in mod.rules):
                v = self.eval_rule(mod.package, name)
                if isinstance(v, _UserFunction):
                    return v
            if mod is not None:
                for path, alias in mod.imports:
                    if (alias or path[-1]) == name and path[0] == "data":
                        v = self._data_path(path[1:])
                        if isinstance(v, _UserFunction):
                            return v
            v = env.get(name)
            if isinstance(v, _UserFunction):
                return v
            return None
        # dotted: maybe data.lib.fn or imported-lib.fn
        if fn_t[0] == "ref":
            parts = _ref_parts(fn_t)
            if parts is None:
                return None
            if parts[0] == "data":
                v = self._data_path(tuple(parts[1:]))
                if isinstance(v, _UserFunction):
                    return v
                return None
            if mod is not None:
                for path, alias in mod.imports:
                    if (alias or path[-1]) == parts[0] and \
                            path[0] == "data":
                        v = self._data_path(tuple(path[1:]) +
                                            tuple(parts[1:]))
                        if isinstance(v, _UserFunction):
                            return v
        return None


class _UserFunction:
    def __init__(self, interp, defs):
        self.interp = interp
        self.defs = defs  # [(module, rule)]

    def call(self, arg_terms, env, call_mod):
        interp = self.interp
        # evaluate args in caller env
        def rec(idx, acc, e):
            if idx == len(arg_terms):
                yield acc, e
                return
            for v, e2 in interp.eval_term(arg_terms[idx], e, call_mod):
                if v is UNDEF:
                    continue
                yield from rec(idx + 1, acc + [v], e2)
        # each argument-enumeration solution is an independent call;
        # yield at most one value per solution but keep enumerating
        for argvals, env_out in rec(0, [], env):
            produced = False
            for m, r in self.defs:
                if len(r.args) != len(argvals):
                    continue
                fenv = Env()
                ok = True
                for pat, v in zip(r.args, argvals):
                    fenv = _bind_pattern(pat, v, fenv)
                    if fenv is None:
                        ok = False
                        break
                if not ok:
                    continue
                clauses = [(r.value, r.body)] + [
                    (er.value, er.body) for er in r.else_rules]
                for val_t, body in clauses:
                    for fe in interp.eval_body(body, fenv, m):
                        if val_t is None:
                            yield True, env_out
                            produced = True
                            break
                        for v, _ in interp.eval_term(val_t, fe, m):
                            yield v, env_out
                            produced = True
                            break
                        break
                    if produced:
                        break
                if produced:
                    break


class _DataDoc:
    """Placeholder for bare `data` references (rarely used directly)."""

    def __init__(self, interp):
        self.interp = interp


def _override_path(base, ops, val_t, interp, env, mod):
    """Set a dotted path inside a deep-copied document (with-modifier)."""
    if not isinstance(base, dict):
        base = {}
    cur = base
    for j, op in enumerate(ops):
        if op[0] != "dot":
            raise RegoEvalError("with: only dotted paths supported")
        k = op[1]
        if j == len(ops) - 1:
            for v, _ in interp.eval_term(val_t, env, mod):
                cur[k] = v
                break
        else:
            nxt = cur.get(k)
            if not isinstance(nxt, dict):
                nxt = {}
                cur[k] = nxt
            cur = nxt
    return base


def _bind_pattern(pat, value, env):
    """Bind pattern term to concrete value; None on mismatch."""
    if env is None:
        return None
    kind = pat[0]
    if kind == "var":
        name = pat[1]
        if name == "_":
            return env
        bound = env.get(name)
        if bound is UNDEF:
            return env.bind(name, value)
        return env if B.rego_eq(bound, value) else None
    if kind == "array":
        if not isinstance(value, list) or len(value) != len(pat[1]):
            return None
        for sub, v in zip(pat[1], value):
            env = _bind_pattern(sub, v, env)
            if env is None:
                return None
        return env
    if kind == "object":
        if not isinstance(value, dict):
            return None
        for kt, vt in pat[1]:
            if kt[0] != "str":
                return None
            if kt[1] not in value:
                return None
            env = _bind_pattern(vt, value[kt[1]], env)
            if env is None:
                return None
        return env
    if kind in ("num", "str", "bool"):
        return env if B.rego_eq(pat[1], value) else None
    if kind == "null":
        return env if value is None else None
    return None


def _is_ground(t, env):
    """True when the term contains no unbound variables (conservative:
    refs with variable indices count as ground — they enumerate)."""
    kind = t[0]
    if kind == "var":
        return t[1] in ("input", "data") or env.get(t[1]) is not UNDEF \
            or t[1] == "_" and False
    if kind == "array":
        return all(_is_ground(x, env) for x in t[1])
    if kind == "object":
        return all(_is_ground(k, env) and _is_ground(v, env)
                   for k, v in t[1])
    return True


def _ref_to_name(t):
    if t[0] == "var":
        return t[1]
    parts = _ref_parts(t)
    return ".".join(parts) if parts else "?"


def _ref_parts(t):
    if t[0] == "var":
        return [t[1]]
    if t[0] != "ref":
        return None
    base = _ref_parts(t[1])
    if base is None:
        return None
    for op in t[2]:
        if op[0] != "dot":
            return None
        base.append(op[1])
    return base
