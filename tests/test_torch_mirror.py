"""A harness that holds the port to the JAX package case by case, and its
own tests.

`mirror_cases(test_file)` runs a JAX test file's own test functions with
each `trivy_tpu.X` module they import replaced by a twin module,
`twin_trivy.X`. A twin calls the port's function and the JAX one on the
same arguments, compares what they return (or raise) at tolerance 0, and
hands the port's value on to the test. So every JAX case runs once more:
its assertions are checked on the port's values, and each value it reads
on the way equals the reference's.

Values compare through `canon`, a plain-data form that names each
object's class: records by their `to_json()`, dataclasses by their
fields (those at their default left out), other objects by their class
alone (what a test reads from them compares when it is read). So the
port's `Unknown` sentinel equals the JAX one by class name, and neither
package's sentinel ever meets the other's module. A
value that is immutable plain data (a str, a number, a tuple of them)
goes on as the port's; any other (an object, a list, a dict, a class)
goes on as a Twin of both, so that a later call, attribute, index,
mutation or `isinstance` reaches both sides.

Inside `numpy_by_value()` (a test file's fixture) numpy arrays of
numbers compare by dtype, shape and every element, and numpy scalars by
value (and pass on as plain data); arrays of objects by dtype and
shape. Outside it they compare by class, as other objects do.

`twin_cases` does the same with the JAX file's parametrised tests
expanded; `port_cases` runs the JAX file's cases against the port
alone (its `trivy_tpu` imports turned into `trivy_tpu_torch` ones), for
cases whose values are clocks, random ids or process-wide state that
two packages cannot share. Both take source edits (`subs`, each of
which must apply) and global overrides (`env`)."""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib
import importlib.abc
import importlib.util
import inspect
import json
import os
import sys
import types

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = "twin_trivy"
PORT, REF = "trivy_tpu_torch", "trivy_tpu"


_BY_VALUE = [False]


@contextlib.contextmanager
def numpy_by_value():
    """Compare numpy values by value while the block runs."""
    _BY_VALUE[0] = True
    try:
        yield
    finally:
        _BY_VALUE[0] = False


def _numpy_canon(v):
    if isinstance(v, np.generic):
        return {f"<{type(v).__name__}>": v.item()}
    if v.dtype == object:
        return {"<ndarray>": ["object", list(v.shape)]}
    return {"<ndarray>": [v.dtype.str, list(v.shape), v.tolist()]}


def canon(v, _stack=()):
    """v as JSON-able data that names every object's class, the same for
    both packages' equal values."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if _BY_VALUE[0] and isinstance(v, (np.ndarray, np.generic)):
        return _numpy_canon(v)
    if isinstance(v, (bytes, bytearray)):
        return {"<bytes>": bytes(v).decode("latin-1")}
    if isinstance(v, enum.Enum):
        return {f"<{type(v).__name__}>": canon(v.value)}
    if isinstance(v, type):
        return {"<class>": v.__qualname__}
    if isinstance(v, types.ModuleType):
        return {"<module>": v.__name__.split(".", 1)[-1]}
    if isinstance(v, (types.FunctionType, types.BuiltinFunctionType,
                      types.MethodType)):
        return {"<function>": v.__name__}
    if isinstance(v, BaseException):
        return {"<raise>": [type(v).__name__, str(v)]}
    if id(v) in _stack:
        return "<cycle>"
    stack = _stack + (id(v),)
    if isinstance(v, dict):
        return {"<dict>": [[canon(k, stack), canon(x, stack)]
                           for k, x in v.items()]}
    if isinstance(v, list):
        return [canon(x, stack) for x in v]
    if isinstance(v, tuple):
        return {"<tuple>": [canon(x, stack) for x in v]}
    if isinstance(v, (set, frozenset)):
        return {"<set>": sorted((canon(x, stack) for x in v),
                                key=lambda x: json.dumps(x, sort_keys=True))}
    name = f"<{type(v).__name__}>"
    if callable(getattr(v, "to_json", None)):
        return {name: canon(v.to_json(), stack)}
    if dataclasses.is_dataclass(v):
        # a field at its default is left out: the port's types lack a
        # few fields of the JAX ones (custom_resources, secret_files),
        # which then compare equal while they are empty
        return {name: [[f.name, canon(getattr(v, f.name), stack)]
                       for f in dataclasses.fields(v)
                       if not _at_default(v, f)]}
    # any other object (a module, a scanner, an artifact) by its class:
    # what a test reads from it compares when it is read
    return name


def _at_default(obj, f) -> bool:
    v = getattr(obj, f.name)
    if f.default is not dataclasses.MISSING:
        return type(v) is type(f.default) and v == f.default
    if f.default_factory is not dataclasses.MISSING:
        d = f.default_factory()
        return type(v) is type(d) and v == d
    return False


def _frozen(v) -> bool:
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return True
    if _BY_VALUE[0] and isinstance(v, np.generic):
        return True
    return isinstance(v, tuple) and all(_frozen(x) for x in v)


def unwrap(x, side: int):
    """The port's (side 0) or the reference's (side 1) half of x; plain
    containers are copied, so the two calls never share one."""
    if isinstance(x, Twin):
        return object.__getattribute__(x, "_pair")[side]
    if isinstance(x, list):
        return [unwrap(i, side) for i in x]
    if isinstance(x, tuple):
        return tuple(unwrap(i, side) for i in x)
    if isinstance(x, dict):
        return {unwrap(k, side): unwrap(i, side) for k, i in x.items()}
    if isinstance(x, (set, frozenset)):
        return type(x)(unwrap(i, side) for i in x)
    return x


def _same(p, r, what: str) -> None:
    cp, cr = canon(p), canon(r)
    if cp != cr:
        raise AssertionError(
            f"{what}: the port differs from the reference\n"
            f"  port:      {json.dumps(cp)[:3000]}\n"
            f"  reference: {json.dumps(cr)[:3000]}")


def wrap(p, r, what: str = "value"):
    """The port's value once it equals the reference's; a Twin where a
    later use must reach both."""
    _same(p, r, what)
    if isinstance(p, types.ModuleType):
        return importlib.import_module(ROOT + p.__name__[len(PORT):])
    if isinstance(p, type) and issubclass(p, BaseException):
        return p   # pytest.raises needs the class; call() checks both
    if _frozen(p):
        return p
    return Twin(p, r)


def call(pf, rf, args, kwargs, what: str = "call"):
    """pf and rf on the same arguments: equal values, or the same
    exception (the port's is raised)."""
    out, errs = [], []
    for side, fn in enumerate((pf, rf)):
        try:
            out.append(fn(*unwrap(args, side), **unwrap(kwargs, side)))
            errs.append(None)
        except Exception as e:  # noqa: BLE001 — compared below
            out.append(None)
            errs.append(e)
    if errs[0] is not None or errs[1] is not None:
        _same(errs[0], errs[1], f"{what} raised")
        raise errs[0]
    return wrap(out[0], out[1], what)


class Twin:
    """A port value beside the reference's equal value."""
    __slots__ = ("_pair",)

    def __init__(self, p, r):
        object.__setattr__(self, "_pair", (p, r))

    def _both(self, op, *args, what=""):
        p, r = object.__getattribute__(self, "_pair")
        a = op(p, *unwrap(args, 0))
        b = op(r, *unwrap(args, 1))
        _same(a, b, what or op.__name__)
        return a

    def __getattr__(self, name):
        p, r = object.__getattribute__(self, "_pair")
        return wrap(getattr(p, name), getattr(r, name), name)

    def __setattr__(self, name, value):
        p, r = object.__getattribute__(self, "_pair")
        setattr(p, name, unwrap(value, 0))
        setattr(r, name, unwrap(value, 1))

    def __call__(self, *args, **kwargs):
        p, r = object.__getattribute__(self, "_pair")
        return call(p, r, args, kwargs,
                    getattr(p, "__qualname__", type(p).__name__))

    def __getitem__(self, key):
        return call(lambda k: object.__getattribute__(self, "_pair")[0][k],
                    lambda k: object.__getattribute__(self, "_pair")[1][k],
                    (key,), {}, f"[{key!r}]")

    def __setitem__(self, key, value):
        p, r = object.__getattribute__(self, "_pair")
        p[unwrap(key, 0)] = unwrap(value, 0)
        r[unwrap(key, 1)] = unwrap(value, 1)

    def __iter__(self):
        p, r = object.__getattribute__(self, "_pair")
        ps, rs = list(p), list(r)
        _same(len(ps), len(rs), "iteration length")
        return iter([wrap(a, b, "item") for a, b in zip(ps, rs)])

    def __len__(self):
        return self._both(len, what="len")

    def __bool__(self):
        return self._both(bool, what="bool")

    def __contains__(self, x):
        return self._both(lambda c, i: i in c, x, what="in")

    def __eq__(self, other):
        return self._both(lambda a, b: a == b, other, what="==")

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(object.__getattribute__(self, "_pair")[0])

    def __add__(self, other):
        p, r = object.__getattribute__(self, "_pair")
        return wrap(p + unwrap(other, 0), r + unwrap(other, 1), "+")

    def __radd__(self, other):
        p, r = object.__getattribute__(self, "_pair")
        return wrap(unwrap(other, 0) + p, unwrap(other, 1) + r, "+")

    def __instancecheck__(self, obj):
        return self._both(lambda cls, o: isinstance(o, cls), obj,
                          what="isinstance")

    def __repr__(self):
        return f"Twin({object.__getattribute__(self, '_pair')[0]!r})"

    def __str__(self):
        return str(object.__getattribute__(self, "_pair")[0])


def _twin_module(name: str, port, ref) -> types.ModuleType:
    mod = types.ModuleType(name)
    mod.__path__ = []

    def __getattr__(attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return wrap(getattr(port, attr), getattr(ref, attr), attr)
    mod.__getattr__ = __getattr__
    return mod


class _TwinFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Imports `twin_trivy.X` as the twin of trivy_tpu_torch.X and
    trivy_tpu.X; every other import is left alone."""

    def find_spec(self, name, path=None, target=None):
        if name == ROOT or name.startswith(ROOT + "."):
            return importlib.util.spec_from_loader(name, self,
                                                   is_package=True)
        return None

    def create_module(self, spec):
        sub = spec.name[len(ROOT):]
        return _twin_module(spec.name, importlib.import_module(PORT + sub),
                            importlib.import_module(REF + sub))

    def exec_module(self, module):
        pass


if not any(isinstance(f, _TwinFinder) for f in sys.meta_path):
    sys.meta_path.insert(0, _TwinFinder())


def load_mirror(test_file: str, root: str = ROOT, subs=(),
                env=None) -> types.ModuleType:
    """The JAX test file, executed with its `trivy_tpu` imports turned
    into `root` ones: `twin_trivy` (the twins) or `trivy_tpu_torch` (the
    port alone). `subs` are more (old, new) source replacements, each
    of which must apply; `env` overrides module globals after the
    load. The file itself is not changed."""
    path = os.path.join(HERE, test_file)
    with open(path, encoding="utf-8") as f:
        src = f.read()
    for a, b in (("from trivy_tpu.", f"from {root}."),
                 ("from trivy_tpu import", f"from {root} import"),
                 ("import trivy_tpu.", f"import {root}.")):
        src = src.replace(a, b)
    for a, b in subs:
        assert a in src, f"{test_file}: {a!r} not found"
        src = src.replace(a, b)
    mod = types.ModuleType(f"mirror_{root}_" + test_file[:-3])
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    mod.__dict__.update(env or {})
    return mod


def port_cases(test_file: str, keep=None, subs=(), env=None) -> list:
    """[(cls, function, params)] of the JAX file's tests run against the
    port ALONE (its `trivy_tpu` imports turned into `trivy_tpu_torch`
    ones, plus `subs`): for cases whose values are clocks, random ids or
    process state that two packages cannot share. A parametrised test
    gives one case per parameter set."""
    return _cases(load_mirror(test_file, PORT, subs, env), keep,
                  expand=True)


def twin_cases(test_file: str, keep=None, subs=(), env=None) -> list:
    """[(cls, function, params)] of the JAX file's tests through the
    twins (each value equal to the reference's at tolerance 0), with
    parametrised tests expanded."""
    return _cases(load_mirror(test_file, ROOT, subs, env), keep,
                  expand=True)


def mirror_cases(test_file: str, keep=None) -> list:
    """[(case id, function)] of every test of the JAX file, in its
    order: the module's test_* functions and the test_* methods of its
    Test* classes. keep(case id) selects a subset."""
    return _cases(load_mirror(test_file), keep)


def _cases(mod, keep, expand: bool = False) -> list:
    found = []
    for name, obj in vars(mod).items():
        if name.startswith("test_") and inspect.isfunction(obj):
            found.append((obj.__code__.co_firstlineno, name, None, obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if mname.startswith("test_") and inspect.isfunction(meth):
                    found.append((meth.__code__.co_firstlineno,
                                  f"{name}::{mname}", obj, meth))
    cases = []
    for _line, case_id, cls, fn in sorted(found, key=lambda c: c[0]):
        if keep is not None and not keep(case_id):
            continue
        marks = [m for m in getattr(fn, "pytestmark", ())
                 if m.name == "parametrize"]
        if not expand:
            # a parametrised JAX test would need its cases expanded here
            assert not marks, case_id
            cases.append(pytest.param(cls, fn, id=case_id))
            continue
        assert len(marks) <= 1, case_id
        if not marks:
            cases.append(pytest.param(cls, fn, {}, id=case_id))
            continue
        names, values = marks[0].args[:2]
        names = [n.strip() for n in names.split(",")] \
            if isinstance(names, str) else list(names)
        for i, v in enumerate(values):
            v = v if len(names) > 1 else (v,)
            cases.append(pytest.param(cls, fn, dict(zip(names, v)),
                                      id=f"{case_id}[{i}]"))
    return cases


def run_case(cls, fn, request, given=None) -> None:
    """One mirrored case, with the fixtures its signature names (and
    the parameter values `given` for a parametrised one)."""
    given = given or {}
    params = list(inspect.signature(fn).parameters)
    args = []
    if cls is not None:
        inst = cls()
        if hasattr(inst, "setup_method"):
            inst.setup_method(fn)
        args.append(inst)
        params = params[1:]
    args += [given[p] if p in given else request.getfixturevalue(p)
             for p in params]
    fn(*args)


# --- the harness's own tests ------------------------------------------

def test_twin_call_refuses_a_divergence():
    twin = Twin(lambda x: [x, 1], lambda x: [x, 2])
    with pytest.raises(AssertionError, match="differs from the reference"):
        twin(0)
    assert Twin(lambda x: {"a": [x]}, lambda x: {"a": [x]})(3) == \
        {"a": [3]}


def test_twin_compares_exceptions():
    def boom(x):
        raise ValueError(f"bad {x}")

    def other(x):
        raise KeyError(x)
    with pytest.raises(ValueError, match="bad 1"):
        Twin(boom, boom)(1)
    with pytest.raises(AssertionError, match="raised"):
        Twin(boom, other)(1)
    with pytest.raises(AssertionError, match="raised"):
        Twin(boom, lambda x: x)(1)


def test_twin_mutation_reaches_both_sides():
    p, r = {"a": []}, {"a": []}
    twin = wrap(p, r)
    twin["b"] = 2
    twin["a"].append(Twin(1, 1))
    assert p == r == {"a": [1], "b": 2}


def test_canon_names_the_unknown_class():
    from trivy_tpu.iac import cloud as ref_cloud
    from trivy_tpu_torch.iac import cloud as port_cloud
    assert canon(port_cloud.UNKNOWN) == canon(ref_cloud.UNKNOWN) == \
        "<Unknown>"
    assert canon(port_cloud.UNKNOWN) != canon(None)
    assert port_cloud.UNKNOWN is not ref_cloud.UNKNOWN
    twin = wrap(port_cloud.UNKNOWN, ref_cloud.UNKNOWN)
    assert isinstance(twin, wrap(port_cloud.Unknown, ref_cloud.Unknown))
    assert not isinstance(twin, wrap(port_cloud.Attr, ref_cloud.Attr))


def test_twin_modules_are_the_port_and_the_reference():
    from twin_trivy.iac import hcl  # noqa: I001 — the twin namespace
    p, r = object.__getattribute__(hcl.parse, "_pair")
    assert p.__module__ == "trivy_tpu_torch.iac.hcl"
    assert r.__module__ == "trivy_tpu.iac.hcl"
    from trivy_tpu_torch.iac.hcl import HclError
    assert hcl.HclError is HclError
