"""The port's rego engine (trivy_tpu_torch/iac/rego) held against the JAX
package's on the same sources and inputs, with tolerance 0: the parsed
modules, every builtin, query results, static metadata, the checks
scanner's misconfigurations, the trace events, and the ignore policy.
The port's interpreter also serves several threads at once, as the
ingest pipeline's walkers use it."""

import dataclasses
import json
import textwrap
import threading

import numpy as np
import pytest

from trivy_tpu.iac import rego as ref_rego
from trivy_tpu.iac.rego import builtins as ref_b
from trivy_tpu.iac.rego import eval as ref_eval
from trivy_tpu.iac.rego import parser as ref_parser
from trivy_tpu.result import filter as ref_filter
from trivy_tpu_torch.iac import rego as port_rego
from trivy_tpu_torch.iac.rego import builtins as port_b
from trivy_tpu_torch.iac.rego import eval as port_eval
from trivy_tpu_torch.iac.rego import parser as port_parser
from trivy_tpu_torch.result import filter as port_filter

SIDES = {"port": (port_parser, port_eval, port_b),
         "ref": (ref_parser, ref_eval, ref_b)}


def canon(v):
    """A rego value as plain JSON-able data, the same for both packages'
    value classes (sets sorted, undefined marked)."""
    name = type(v).__name__
    if name == "RSet":
        return {"<set>": sorted((canon(x) for x in v.items),
                                key=lambda x: json.dumps(x, sort_keys=True))}
    if name == "_Undef":
        return "<undefined>"
    if isinstance(v, dict):
        return {str(k): canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [canon(x) for x in v]
    return v


LIB = """
package lib.k8s

is_pod {
    input.kind == "Pod"
}

name = input.metadata.name
"""

# (sources, [(query, input, data)])
CASES = {
    "complete_default": ([
        """
        package test

        default allow = false

        allow = true {
            input.user == "admin"
        }
        """], [("test.allow", {"user": "admin"}, None),
               ("test.allow", {"user": "bob"}, None)]),
    "partial_set_contains": ([
        """
        package test

        deny[msg] {
            input.x > 3
            msg := sprintf("x is %d", [input.x])
        }

        deny contains msg if {
            input.y == "bad"
            msg := "y is bad"
        }
        """], [("test.deny", {"x": 5, "y": "bad"}, None),
               ("test.deny", {"x": 1, "y": "ok"}, None)]),
    "iteration": ([
        """
        package test

        names[n] {
            n := input.items[_].name
        }

        indexed[i] {
            input.items[i].name == "b"
        }

        pairs[k] = v {
            v := input.m[k]
        }
        """], [("test.names", {"items": [{"name": "a"}, {"name": "b"}]},
                None),
               ("test.indexed", {"items": [{"name": "a"}, {"name": "b"}]},
                None),
               ("test.pairs", {"m": {"a": 1, "b": [2]}}, None),
               ("test", {"items": [], "m": {}}, None)]),
    "some_in_every_not": ([
        """
        package test
        import rego.v1

        has_bad if {
            some item in input.items
            item.bad
        }

        all_good if {
            every item in input.items {
                not item.bad
            }
        }

        kv_pairs contains s if {
            some k, v in input.m
            s := sprintf("%s=%s", [k, v])
        }
        """], [("test.has_bad", {"items": [{"bad": False}, {"bad": True}],
                                 "m": {}}, None),
               ("test.all_good", {"items": [{"bad": False}], "m": {}}, None),
               ("test.all_good", {"items": [{"bad": True}], "m": {}}, None),
               ("test.kv_pairs", {"items": [], "m": {"a": "1", "b": "2"}},
                None)]),
    "comprehensions": ([
        """
        package test

        arr := [x | x := input.nums[_]; x > 2]
        st := {x | x := input.nums[_]}
        obj := {k: v | v := input.m[k]}
        """], [("test.arr", {"nums": [1, 3, 4, 3], "m": {"a": 1}}, None),
               ("test.st", {"nums": [1, 3, 4, 3], "m": {"a": 1}}, None),
               ("test.obj", {"nums": [], "m": {"a": 1, "b": None}}, None)]),
    "functions_else": ([
        """
        package test

        double(x) = y {
            y := x * 2
        }

        classify(n) = "big" {
            n > 100
        } else = "small" {
            n >= 0
        } else = "negative" {
            true
        }

        big(x) = true {
            x > 5
        }

        result := double(21)
        cls := classify(input.n)
        deny[msg] {
            big(input.nums[_])
            msg := "has big"
        }
        """], [("test.result", None, None),
               ("test.cls", {"n": 500, "nums": [1, 10]}, None),
               ("test.cls", {"n": 5, "nums": [1]}, None),
               ("test.cls", {"n": -1, "nums": []}, None),
               ("test.deny", {"n": 0, "nums": [1, 10]}, None),
               ("test.deny", {"n": 0, "nums": [1, 2]}, None)]),
    "cross_package_data": ([
        LIB, """
        package user.mycheck

        import data.lib.k8s

        deny[msg] {
            k8s.is_pod
            msg := sprintf("pod %s", [k8s.name])
        }

        banned[msg] {
            b := data.banned[_]
            input.metadata.name == b
            msg := "banned"
        }
        """], [("user.mycheck.deny",
                {"kind": "Pod", "metadata": {"name": "x"}}, None),
               ("user.mycheck.banned", {"kind": "Pod",
                                        "metadata": {"name": "evil"}},
                {"banned": ["evil", "bad"]}),
               ("lib.k8s", {"kind": "Pod", "metadata": {"name": "x"}},
                None)]),
    "builtins_in_rules": ([
        """
        package test

        r1 := count(input.xs)
        r2 := concat(",", ["a", "b"])
        r3 := contains("hello", "ell")
        r4 := lower("ABC")
        r5 := split("a/b/c", "/")
        r6 := regex.match("^ab+$", "abbb")
        r7 := object.get(input, "missing", "dflt")
        r8 := to_number("42")
        r9 := trim_prefix("foo.bar", "foo.")
        r10 := union({{1, 2}, {2, 3}})
        r11 := startswith("hello", "he")
        r12 := sprintf("%s:%d %v", ["x", 7, input.xs])
        r13 := array.concat([1], [2])
        r14 := max([3, 9, 1])
        r15 := json.marshal({"a": [1, true, null]})
        r16 := glob.match("a.*", [], "a.b.c")
        r17 := object.union({"a": 1}, {"b": 2})
        r18 := [p | [p, v] := walk(input); v == 3]
        """], [("test", {"xs": [1, 2, 3]}, None)]),
    "walk_unification": ([
        """
        package test

        privileged[path] {
            [path, value] := walk(input)
            value == true
            path[count(path) - 1] == "privileged"
        }
        """], [("test.privileged", {"spec": {"containers": [
            {"name": "a", "securityContext": {"privileged": True}},
            {"name": "b", "securityContext": {"privileged": False}}]}},
            None)]),
    "negation_arith": ([
        """
        package test

        deny[msg] {
            not input.spec.limits
            msg := "no limits"
        }

        calc := (input.a + 2) * 3 - 1
        ratio := input.a / 8
        rem := input.a % 3
        """], [("test.deny", {"spec": {}, "a": 4}, None),
               ("test.deny", {"spec": {"limits": 1}, "a": 4}, None),
               ("test.calc", {"spec": {}, "a": 4}, None),
               ("test", {"spec": {}, "a": 7}, None)]),
    "with_data_override": ([
        """
        package test

        allowed {
            input.name == data.settings.allowed_name
        }

        check1 {
            allowed with data.settings.allowed_name as "bob"
        }
        """], [("test.check1", {"name": "bob"},
                {"settings": {"allowed_name": "alice"}}),
               ("test.allowed", {"name": "bob"},
                {"settings": {"allowed_name": "alice"}})]),
    "objects_and_strings": ([
        """
        package test
        import future.keywords.in

        ports[p] {
            some c in input.containers
            p := c.ports[_].containerPort
            p < 1024
        }

        images := {name: img |
            c := input.containers[_]
            name := c.name
            img := c.image
        }

        tagged[c.name] {
            c := input.containers[_]
            not endswith(c.image, ":latest")
            contains(c.image, ":")
        }

        msg := sprintf("%d containers, first %q", [count(input.containers),
                                                   input.containers[0].name])
        """], [("test", {"containers": [
            {"name": "web", "image": "nginx:latest",
             "ports": [{"containerPort": 80}, {"containerPort": 8080}]},
            {"name": "db", "image": "postgres:16",
             "ports": [{"containerPort": 5432}]},
            {"name": "side", "image": "busybox", "ports": []}]}, None)]),
}


def _interp(side, srcs, data):
    parser, ev, _b = SIDES[side]
    mods = [parser.parse_module(textwrap.dedent(s)) for s in srcs]
    return ev.Interpreter(mods, data=data)


@pytest.mark.parametrize("name", sorted(CASES))
def test_parse_like_reference(name):
    for src in CASES[name][0]:
        src = textwrap.dedent(src)
        port = dataclasses.asdict(port_parser.parse_module(src, path="x"))
        ref = dataclasses.asdict(ref_parser.parse_module(src, path="x"))
        assert repr(port) == repr(ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_query_like_reference(name):
    srcs, queries = CASES[name]
    defined = 0
    for path, doc, data in queries:
        got = {}
        for side, (_p, ev, _b) in SIDES.items():
            interp = _interp(side, srcs, data)
            got[side] = canon(interp.query(
                path, ev.UNDEF if doc is None else doc))
        assert got["port"] == got["ref"], (path, doc)
        defined += got["port"] != "<undefined>"
    assert defined


def test_syntax_errors_like_reference():
    for src in ("package", "package a\n\ndeny[ {", "package a\nx := [1,",
                "package a\nf(x) = y { y := }"):
        errs = []
        for parser in (port_parser, ref_parser):
            with pytest.raises(Exception) as e:
                parser.parse_module(src)
            errs.append((type(e.value).__name__, str(e.value)))
        assert errs[0] == errs[1]


# one argument tuple per builtin, several where the edge cases differ
BUILTIN_ARGS = {
    "count": [([1, 2],), ("abc",), ({"a": 1},)],
    "sum": [([1, 2.5],)],
    "product": [([2, 3, 4],)],
    "max": [([3, 9, 1],)], "min": [([3, 9, 1],)],
    "sort": [([3, "a", 1, None, True],)],
    "abs": [(-3,)], "ceil": [(1.2,)], "floor": [(1.8,)], "round": [(2.5,)],
    "to_number": [("42",), ("4.5",), (True,), (None,)],
    "numbers.range": [(1, 4), (4, 1)],
    "concat": [(",", ["a", "b"])],
    "contains": [("hello", "ell"), (3, "a")],
    "startswith": [("hello", "he")], "endswith": [("hello", "lo")],
    "format_int": [(255, 16), (8, 2)],
    "indexof": [("hello", "l")],
    "lower": [("ABC",)], "upper": [("abc",)],
    "replace": [("aXbX", "X", "-")],
    "split": [("a/b/c", "/")],
    "sprintf": [("%s:%d %v %q %x", ["x", 7, [1, "a"], "q", 255]),
                ("%.2f|%5s|%-3d|", [3.14159, "ab", 7])],
    "substring": [("hello", 1, 3), ("hello", 2, -1)],
    "trim": [("xxhixx", "x")], "trim_left": [("xxhi", "x")],
    "trim_right": [("hixx", "x")],
    "trim_prefix": [("foo.bar", "foo.")], "trim_suffix": [("a.txt", ".txt")],
    "trim_space": [("  a  ",)],
    "strings.reverse": [("abc",)],
    "strings.replace_n": [({"a": "1", "b": "2"}, "abc")],
    "strings.any_prefix_match": [("hello", ["x", "he"])],
    "strings.any_suffix_match": [("hello", ["lo"])],
    "re_match": [("^ab+$", "abbb")],
    "regex.match": [("b+", "abbb")],
    "regex.is_valid": [("(",), ("a*",)],
    "regex.split": [(",\\s*", "a, b,c")],
    "regex.replace": [("a1b22", "[0-9]+", "#")],
    "regex.find_n": [("[0-9]", "a1b2c3", 2), ("[0-9]", "a1b2", -1)],
    "glob.match": [("*dev*", [], "my.dev.env"), ("*dev*", None, "my.dev"),
                   ("a.*", None, "a.b.c"), ("a/**", ["/"], "a/b/c")],
    "array.concat": [([1], [2, 3])],
    "array.slice": [([1, 2, 3, 4], 1, 3), ([1, 2], 1, 9)],
    "array.reverse": [([1, 2, 3],)],
    "object.get": [({"a": {"b": 1}}, ["a", "b"], 0), ({}, "k", "d")],
    "object.keys": [({"a": 1, "b": 2},)],
    "object.remove": [({"a": 1, "b": 2}, ["a"])],
    "object.filter": [({"a": 1, "b": 2}, ["a"])],
    "object.union": [({"a": 1}, {"a": 2, "b": 3})],
    "object.union_n": [([{"a": 1}, {"b": 2}],)],
    "union": [None], "intersection": [None], "set_diff": [None],
    "cast_set": [([1, 1, 2],)], "cast_array": [([1, 2],)],
    "is_string": [("a",), (1,)], "is_number": [(1,), (True,)],
    "is_boolean": [(False,)], "is_array": [([],)], "is_object": [({},)],
    "is_set": [([],)], "is_null": [(None,)],
    "type_name": [("a",), (1,), (None,), ([],), ({},), (True,)],
    "json.unmarshal": [('{"a": [1, 2]}',)],
    "json.marshal": [({"a": [1, None]},)],
    "json.is_valid": [("{",), ("[]",)],
    "yaml.unmarshal": [("a: [1, b]\n",)],
    "yaml.marshal": [({"a": [1, "b"]},)],
    "base64.decode": [("aGVsbG8=",)], "base64.encode": [("hello",)],
    "semver.compare": [("1.2.3", "1.10.0"), ("2.0.0", "2.0.0")],
    "semver.is_valid": [("1.2.3-rc.1",), ("1.2",)],
    "print": [("x",)], "trace": [("x",)],
    "object.subset": [({"a": 1, "b": {"c": 2}}, {"b": {"c": 2}}),
                      ({"a": 1}, {"a": 2})],
}


def _set_args(b, name):
    s = [b.RSet([1, 2]), b.RSet([2, 3])]
    return {"union": [(b.RSet(s),)], "intersection": [(b.RSet(s),)],
            "set_diff": [tuple(s)]}[name]


def test_every_builtin_has_cases():
    assert set(port_b.BUILTINS) == set(ref_b.BUILTINS) == set(BUILTIN_ARGS)


@pytest.mark.parametrize("name", sorted(BUILTIN_ARGS))
def test_builtin_like_reference(name):
    cases = BUILTIN_ARGS[name]
    for i in range(len(_set_args(port_b, name)) if cases == [None]
                   else len(cases)):
        out = {}
        for side, b in (("port", port_b), ("ref", ref_b)):
            args = _set_args(b, name)[i] if cases == [None] else cases[i]
            try:
                out[side] = ("ok", canon(b.BUILTINS[name](*args)))
            except Exception as e:  # noqa: BLE001 — both must agree
                out[side] = ("raise", type(e).__name__)
        assert out["port"] == out["ref"], (name, i)


META_SRC = """\
# METADATA
# title: Custom check title
# description: Something bad
# related_resources:
# - https://example.com/check
# custom:
#   id: ID001
#   avd_id: AVD-USR-0001
#   severity: CRITICAL
#   recommended_actions: Fix it
#   input:
#     selector:
#     - type: kubernetes
package user.example

deny[msg] {
    input.kind == "Pod"
    msg := "found a pod"
}
"""

LEGACY_SRC = """\
package user.legacy

__rego_metadata__ := {
    "id": "LEG001",
    "title": "Legacy",
    "severity": "LOW",
    "recommended_actions": "do better",
}

__rego_input__ := {"selector": [{"type": "dockerfile"}]}

deny[res] {
    input.bad
    res := {"msg": "bad", "startline": 3, "endline": 4}
}

warn_multi[res] {
    input.bad
    res := [{"startline": 7}, "second message"]
}
"""


@pytest.mark.parametrize("src", [META_SRC, LEGACY_SRC])
def test_metadata_like_reference(src):
    got = []
    for parser, ev, rego in ((port_parser, port_eval, port_rego),
                             (ref_parser, ref_eval, ref_rego)):
        mod = parser.parse_module(src)
        got.append(vars(rego.retrieve_metadata(ev.Interpreter([mod]), mod)))
    assert got[0] == got[1]


def _write_checks(root):
    root.mkdir()
    (root / "meta.rego").write_text(META_SRC)
    (root / "legacy.rego").write_text(LEGACY_SRC)
    (root / "shared_a.rego").write_text(
        "package user.shared\n\ndeny[msg] {\n\tinput.a\n"
        "\tmsg := \"a bad\"\n}\n")
    (root / "shared_b.rego").write_text(
        "package user.shared\n\ndeny[msg] {\n\tinput.b\n"
        "\tmsg := \"b bad\"\n}\n")
    (root / "warny.rego").write_text(
        "package custom.warny\n\nwarn[msg] {\n\tinput.replicas < 2\n"
        "\tmsg := \"too few replicas\"\n}\n")
    (root / "skip_test.rego").write_text("package user.skipped\n")
    (root / "data.yaml").write_text("banned: [evil]\n")


DOCS = [{"kind": "Pod", "a": True, "b": True, "replicas": 1, "bad": True,
         "__defsec_metadata": {"startline": 2, "endline": 9}},
        {"kind": "Deployment", "replicas": 3},
        {"kind": "Pod", "metadata": {"name": "evil"}}]


@pytest.mark.parametrize("ftype", ["kubernetes", "yaml", "dockerfile",
                                   "json"])
def test_checks_scanner_like_reference(ftype, tmp_path):
    _write_checks(tmp_path / "checks")
    text = "a: 1\n# trivy:ignore:LEG001\nb: 2\n" * 4
    out = []
    for rego in (port_rego, ref_rego):
        s = rego.RegoChecksScanner.from_paths(
            [str(tmp_path / "checks")],
            data_paths=[str(tmp_path / "checks" / "data.yaml")],
            namespaces=["user"])
        failures, successes, exceptions = s.scan_docs(
            ftype, "x." + ftype, DOCS, text)
        out.append(([f.to_json() for f in failures], successes, exceptions,
                    sorted(".".join(m.package) for m in s.check_modules())))
    assert out[0] == out[1]
    assert out[0][0] or ftype == "dockerfile"


TRACE_SRC = """
package user.t

helper {
  input.x == 1
}

deny[res] {
  helper
  res := "hit"
}
"""


def test_trace_events_like_reference():
    events = {}
    for side, rego in (("port", port_rego), ("ref", ref_rego)):
        seen = []
        rego.set_rego_trace(lambda e, p, d: seen.append((e, p, d)))
        try:
            mod = SIDES[side][0].parse_module(TRACE_SRC)
            s = rego.RegoChecksScanner([mod], namespaces=["user"])
            assert rego.rego_trace() is not None
            s.interp.query("user.t.deny", {"x": 1})
        finally:
            rego.set_rego_trace(None)
        events[side] = seen
    assert events["port"] == events["ref"]
    assert ("enter", "user.t.helper", 1) in events["port"]
    assert port_rego.rego_trace() is None


def test_scanner_serves_threads(tmp_path):
    """One scanner, many walker threads: each thread's misconfigurations
    equal a serial scan's, legacy metadata included."""
    _write_checks(tmp_path / "checks")
    s = port_rego.RegoChecksScanner.from_paths([str(tmp_path / "checks")],
                                              namespaces=["user"])
    rng = np.random.default_rng(7)
    docs = [{"kind": "Pod", "a": bool(a), "b": bool(b), "bad": bool(c),
             "replicas": int(r)}
            for a, b, c, r in rng.integers(0, 3, size=(16, 4))]
    want = [[f.to_json() for f in s.scan_docs("kubernetes", "p.yaml",
                                              [d])[0]] for d in docs]
    errors = []

    def work(k):
        for i in range(len(docs)):
            j = (i + k) % len(docs)
            got = [f.to_json() for f in s.scan_docs(
                "kubernetes", "p.yaml", [docs[j]])[0]]
            if got != want[j]:
                errors.append(j)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert any(want)


IGNORE_POLICY = """package trivy

import data.lib.trivy

default ignore = false

ignore_ids := {"CVE-2023-0286", "DS002"}

ignore {
    ignore_ids[input.VulnerabilityID]
}

ignore {
    ignore_ids[input.ID]
}

ignore {
    input.Severity == "LOW"
    startswith(input.RuleID, "aws")
}
"""

FINDINGS = [{"VulnerabilityID": "CVE-2023-0286", "Severity": "HIGH"},
            {"VulnerabilityID": "CVE-2023-2650", "Severity": "MEDIUM"},
            {"ID": "DS002", "Severity": "HIGH"},
            {"ID": "KSV001", "Severity": "MEDIUM"},
            {"RuleID": "aws-access-key-id", "Severity": "LOW"},
            {"RuleID": "aws-secret", "Severity": "CRITICAL"},
            {}]


def test_ignore_policy_like_reference(tmp_path):
    p = tmp_path / "policy.rego"
    p.write_text(IGNORE_POLICY)
    port = [port_filter.IgnorePolicy(str(p)).ignore(f) for f in FINDINGS]
    ref = [ref_filter.IgnorePolicy(str(p)).ignore(f) for f in FINDINGS]
    assert port == ref == [True, False, True, False, True, False, False]
    # a policy that fails to evaluate has no effect, in both
    p.write_text("package trivy\n\nignore {\n\tinput.x / 0\n}\n")
    assert [port_filter.IgnorePolicy(str(p)).ignore({"x": 1})] == \
        [ref_filter.IgnorePolicy(str(p)).ignore({"x": 1})]
