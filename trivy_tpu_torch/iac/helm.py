"""Helm chart scanner (reference pkg/iac/scanners/helm).

Renders a chart the way the reference drives helm's engine
(parser/parser.go RenderedChartFiles: load chart → render release with
merged values → split manifests), then runs the kubernetes checks over
each rendered manifest. The template engine is our Go text/template
subset (report/gotemplate.py) extended with the sprig/helm functions
charts rely on (include, tpl, toYaml, nindent, required, ...).

Charts are detected by a `Chart.yaml` (pkg/iac/detection helm type);
`.tgz` archives are unpacked in memory (parser_tar.go).
"""

from __future__ import annotations

import gzip
import hashlib
import io
import json
import re
import tarfile

import yaml

from ..report.gotemplate import Template, TemplateError, _go_str


class HelmRenderError(Exception):
    pass


# ---- value helpers ----------------------------------------------------

def _deep_merge(base: dict, over: dict) -> dict:
    """helm's coalesce: `over` wins, dicts merge recursively."""
    out = dict(base)
    for k, v in (over or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _set_path(values: dict, dotted: str, value) -> None:
    """--set a.b.c=v (ValueOptions.MergeValues, vals.go)."""
    parts = dotted.split(".")
    cur = values
    for p in parts[:-1]:
        nxt = cur.get(p)
        if not isinstance(nxt, dict):
            nxt = {}
            cur[p] = nxt
        cur = nxt
    cur[parts[-1]] = value


def _parse_set_value(raw: str):
    if raw == "true":
        return True
    if raw == "false":
        return False
    if raw == "null":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


# ---- chart model ------------------------------------------------------

class Chart:
    def __init__(self, metadata: dict, values: dict,
                 templates: dict[str, str], helpers: dict[str, str],
                 subcharts: list["Chart"], root: str = ""):
        self.metadata = metadata or {}
        self.values = values or {}
        self.templates = templates      # rel path (templates/x.yaml) → src
        self.helpers = helpers          # rel path (_*.tpl) → src
        self.subcharts = subcharts
        self.root = root

    @property
    def name(self) -> str:
        return str(self.metadata.get("name", "chart"))


def load_chart_dir(files: dict[str, bytes], prefix: str = "") -> Chart:
    """files: rel-path → bytes for one chart tree (paths relative to the
    chart root, e.g. 'Chart.yaml', 'templates/deploy.yaml',
    'charts/sub/Chart.yaml')."""
    meta = {}
    values: dict = {}
    templates: dict[str, str] = {}
    helpers: dict[str, str] = {}
    sub_files: dict[str, dict[str, bytes]] = {}
    for path, content in files.items():
        if path.startswith("charts/"):
            rest = path[len("charts/"):]
            if "/" in rest:
                subname, subpath = rest.split("/", 1)
                sub_files.setdefault(subname, {})[subpath] = content
            elif rest.endswith(".tgz"):
                try:
                    subc = load_chart_tgz(content)
                    sub_files.setdefault(
                        "\x00tgz:" + rest, {})["\x00chart"] = subc
                except Exception:
                    pass
            continue
        if path == "Chart.yaml":
            try:
                meta = yaml.safe_load(content) or {}
            except yaml.YAMLError:
                meta = {}
        elif path == "values.yaml":
            try:
                values = yaml.safe_load(content) or {}
            except yaml.YAMLError:
                values = {}
        elif path.startswith("templates/"):
            name = path.rsplit("/", 1)[-1]
            text = content.decode("utf-8", errors="replace")
            if name.startswith("_"):
                helpers[path] = text
            elif name == "NOTES.txt":
                continue
            elif path.startswith("templates/tests/"):
                continue
            elif name.endswith((".yaml", ".yml", ".tpl", ".json")):
                templates[path] = text
    subcharts = []
    for subname, sf in sub_files.items():
        if "\x00chart" in sf:
            subcharts.append(sf["\x00chart"])
        elif "Chart.yaml" in sf:
            subcharts.append(load_chart_dir(sf))
    return Chart(meta, values, templates, helpers, subcharts,
                 root=prefix)


def load_chart_tgz(data: bytes) -> Chart:
    """Helm package archives: one top-level dir per chart
    (parser_tar.go)."""
    buf = io.BytesIO(data)
    try:
        raw = gzip.decompress(data)
    except OSError:
        raw = data
    files: dict[str, bytes] = {}
    with tarfile.open(fileobj=io.BytesIO(raw), mode="r") as tf:
        for m in tf.getmembers():
            if not m.isfile():
                continue
            parts = m.name.split("/", 1)
            if len(parts) != 2:
                continue
            f = tf.extractfile(m)
            if f is not None:
                files[parts[1]] = f.read()
    return load_chart_dir(files)


# ---- helm/sprig function table ---------------------------------------

def _to_yaml(v) -> str:
    if v is None:
        return ""
    return yaml.safe_dump(v, default_flow_style=False,
                          sort_keys=False).rstrip("\n")


def _indent(n, s):
    pad = " " * int(n)
    return "\n".join(pad + line for line in _go_str(s).split("\n"))


def _helm_funcs(engine_ref: dict) -> dict:
    """Functions closing over the active Template (include/tpl need to
    call back into the engine)."""

    def include(name, data):
        tmpl = engine_ref.get("tmpl")
        return tmpl.execute_template(name, data)

    def tpl(text, ctx):
        tmpl = engine_ref.get("tmpl")
        sub = Template(_go_str(text), funcs=tmpl.funcs)
        sub.defines = tmpl.defines
        return sub.render(ctx)

    def required(msg, v):
        if v is None or v == "":
            raise HelmRenderError(_go_str(msg))
        return v

    def fail(msg):
        raise HelmRenderError(_go_str(msg))

    def semver_compare(constraint, version):
        # minimal: supports >=, >, <=, <, =, ^ and plain versions
        def parse(v):
            m = re.match(r"v?(\d+)(?:\.(\d+))?(?:\.(\d+))?", str(v))
            if not m:
                return (0, 0, 0)
            return tuple(int(g or 0) for g in m.groups())
        c = str(constraint).strip()
        m = re.match(r"(>=|<=|>|<|\^|=)?\s*(.+)", c)
        op, rhs = (m.group(1) or "="), m.group(2)
        a, b = parse(version), parse(rhs)
        return {">=": a >= b, "<=": a <= b, ">": a > b, "<": a < b,
                "=": a == b,
                "^": a >= b and a[0] == b[0]}.get(op, a == b)

    def merge(dst, *srcs):
        out = dict(dst or {})
        for s in srcs:
            out = _deep_merge(s or {}, out)   # dst wins in sprig merge
        return out

    def merge_overwrite(dst, *srcs):
        out = dict(dst or {})
        for s in srcs:
            out = _deep_merge(out, s or {})
        return out

    def _get(d, key):
        return (d or {}).get(key, "")

    def _set(d, key, val):
        d[key] = val
        return d

    def _unset(d, key):
        d.pop(key, None)
        return d

    def kind_is(kind, v):
        return {
            "map": isinstance(v, dict),
            "slice": isinstance(v, list),
            "string": isinstance(v, str),
            "bool": isinstance(v, bool),
            "int": isinstance(v, int) and not isinstance(v, bool),
            "int64": isinstance(v, int) and not isinstance(v, bool),
            "float64": isinstance(v, float),
            "invalid": v is None,
        }.get(kind, False)

    import base64
    return {
        "include": include,
        "tpl": tpl,
        "required": required,
        "fail": fail,
        "lookup": lambda *a: {},
        "toYaml": _to_yaml,
        "fromYaml": lambda s: yaml.safe_load(s) or {},
        "fromJson": lambda s: json.loads(s) if s else {},
        "toToml": _to_yaml,   # close enough for rendering side effects
        "indent": _indent,
        "nindent": lambda n, s: "\n" + _indent(n, s),
        "quote": lambda *a: " ".join(
            '"%s"' % _go_str(x).replace('"', '\\"') for x in a),
        "squote": lambda *a: " ".join(
            "'%s'" % _go_str(x) for x in a),
        "b64enc": lambda s: base64.b64encode(
            _go_str(s).encode()).decode(),
        "b64dec": lambda s: base64.b64decode(
            _go_str(s)).decode("utf-8", "replace"),
        "trimSuffix": lambda suf, s: _go_str(s)[:-len(suf)]
        if suf and _go_str(s).endswith(suf) else _go_str(s),
        "trimPrefix": lambda pre, s: _go_str(s)[len(pre):]
        if pre and _go_str(s).startswith(pre) else _go_str(s),
        "repeat": lambda n, s: _go_str(s) * int(n),
        "add1": lambda v: int(v) + 1,
        "sub1": lambda v: int(v) - 1,
        "mod": lambda a, b: int(a) % int(b),
        "div": lambda a, b: int(a) // int(b),
        "max": lambda *a: max(int(x) for x in a),
        "min": lambda *a: min(int(x) for x in a),
        "ceil": lambda v: -(-int(float(v)) // 1),
        "floor": lambda v: int(float(v)),
        "until": lambda n: list(range(int(n))),
        "untilStep": lambda a, b, s: list(range(int(a), int(b), int(s))),
        "get": _get,
        "set": _set,
        "unset": _unset,
        "hasKey": lambda d, k: k in (d or {}),
        "keys": lambda *ds: [k for d in ds for k in (d or {})],
        "pluck": lambda k, *ds: [d[k] for d in ds if k in (d or {})],
        "merge": merge,
        "mergeOverwrite": merge_overwrite,
        "deepCopy": lambda v: json.loads(json.dumps(v)),
        "dig": lambda *a: _dig(list(a)),
        "ternary": lambda t, f, c: t if c else f,
        "kindIs": kind_is,
        "kindOf": lambda v: (
            "map" if isinstance(v, dict) else
            "slice" if isinstance(v, list) else
            "bool" if isinstance(v, bool) else
            "int" if isinstance(v, int) else
            "float64" if isinstance(v, float) else
            "string" if isinstance(v, str) else "invalid"),
        "typeOf": lambda v: type(v).__name__,
        "typeIs": lambda t, v: type(v).__name__ == t,
        "semverCompare": semver_compare,
        "rest": lambda lst: (lst or [])[1:],
        "initial": lambda lst: (lst or [])[:-1],
        "append": lambda lst, v: list(lst or []) + [v],
        "prepend": lambda lst, v: [v] + list(lst or []),
        "concat": lambda *ls: [x for l in ls for x in (l or [])],
        "has": lambda v, lst: v in (lst or []),
        "without": lambda lst, *vs: [x for x in (lst or [])
                                     if x not in vs],
        "compact": lambda lst: [x for x in (lst or []) if x],
        "randAlphaNum": lambda n: hashlib.sha256(
            b"seed").hexdigest()[:int(n)],
        "randAlpha": lambda n: ("a" * int(n)),
        "uuidv4": lambda: "00000000-0000-4000-8000-000000000000",
        "snakecase": lambda s: re.sub(
            r"(?<=[a-z0-9])([A-Z])", r"_\1", _go_str(s)).lower(),
        "camelcase": lambda s: "".join(
            w.capitalize() for w in re.split(r"[_-]", _go_str(s))),
        "kebabcase": lambda s: re.sub(
            r"(?<=[a-z0-9])([A-Z])", r"-\1", _go_str(s)).lower(),
        "untitle": lambda s: _go_str(s)[:1].lower() + _go_str(s)[1:],
        "print": lambda *a: "".join(_go_str(x) for x in a),
        "println": lambda *a: "".join(_go_str(x) for x in a) + "\n",
    }


def _dig(args):
    # dig "a" "b" default dict
    *path, default, d = args
    cur = d
    for p in path:
        if not isinstance(cur, dict) or p not in cur:
            return default
        cur = cur[p]
    return cur


# ---- rendering --------------------------------------------------------

DEFAULT_KUBE_VERSION = "v1.30.0"


def render_chart(chart: Chart, values_override: dict | None = None,
                 release_name: str | None = None,
                 _parent_values: dict | None = None,
                 _path_prefix: str = "") -> dict[str, str]:
    """→ {'<chart>/templates/x.yaml': rendered_text}.

    Mirrors helm's engine semantics for the constructs the checks care
    about; unrenderable templates are skipped (the reference logs and
    continues on individual template errors)."""
    values = dict(chart.values)
    if _parent_values:
        values = _deep_merge(values, _parent_values)
    if values_override:
        values = _deep_merge(values, values_override)
    name = release_name or chart.name
    ctx_base = {
        "Values": values,
        "Chart": _cap_meta(chart.metadata),
        "Release": {
            "Name": name, "Namespace": "default", "Service": "Helm",
            "IsInstall": True, "IsUpgrade": False, "Revision": 1,
        },
        "Capabilities": {
            "KubeVersion": {
                "Version": DEFAULT_KUBE_VERSION,
                "Major": "1", "Minor": "30",
                "GitVersion": DEFAULT_KUBE_VERSION,
            },
            "APIVersions": ["v1", "apps/v1", "batch/v1",
                            "networking.k8s.io/v1"],
            "HelmVersion": {"Version": "v3.14.0"},
        },
    }
    out: dict[str, str] = {}
    prefix = _path_prefix or chart.name
    for tpath, src in sorted(chart.templates.items()):
        engine_ref: dict = {}
        funcs = _helm_funcs(engine_ref)
        try:
            tmpl = Template(src, funcs=funcs)
            engine_ref["tmpl"] = tmpl
            for hsrc in chart.helpers.values():
                tmpl.add_associated(hsrc)
            ctx = dict(ctx_base)
            ctx["Template"] = {"Name": f"{prefix}/{tpath}",
                               "BasePath": f"{prefix}/templates"}
            rendered = tmpl.render(ctx)
        except Exception:
            # individual template failures skip the file, like the
            # reference which surfaces render errors per chart file
            continue
        if rendered.strip():
            out[f"{prefix}/{tpath}"] = rendered
    # subcharts: values scoped under the subchart name + global
    for sub in chart.subcharts:
        sub_vals = values.get(sub.name) or {}
        if isinstance(values.get("global"), dict):
            sub_vals = _deep_merge(sub_vals,
                                   {"global": values["global"]})
        if _enabled(values, sub.name):
            out.update(render_chart(
                sub, values_override=sub_vals, release_name=name,
                _path_prefix=f"{prefix}/charts/{sub.name}"))
    return out


def _enabled(values: dict, sub_name: str) -> bool:
    v = values.get(sub_name)
    if isinstance(v, dict) and v.get("enabled") is False:
        return False
    return True


def _cap_meta(meta: dict) -> dict:
    out = {}
    for k, v in (meta or {}).items():
        out[k[:1].upper() + k[1:]] = v
    out.setdefault("Name", "chart")
    out.setdefault("Version", "0.1.0")
    out.setdefault("AppVersion", "")
    return out


# ---- scanning ---------------------------------------------------------

def scan_chart_files(files: dict[str, bytes],
                     values_override: dict | None = None):
    """files: chart-root-relative path → bytes.
    → [T.Misconfiguration] records (one per rendered file with
    findings), matching the terraform post-analyzer output shape."""
    chart = load_chart_dir(files)
    return scan_rendered_chart(chart, values_override=values_override)


# process-wide value overrides (reference --set / --values,
# pkg/fanal/analyzer/config ScannerOption HelmValueOverrides): applied
# on top of every scanned chart's values
_OVERRIDES: dict = {"sets": [], "files": []}


def set_helm_overrides(sets=None, values_files=None) -> None:
    """Loads --helm-values files EAGERLY: a typo'd or malformed file
    must fail the run, not silently render default values."""
    docs = []
    for vf in values_files or []:
        try:
            with open(vf) as f:
                docs.append(yaml.safe_load(f) or {})
        except (OSError, yaml.YAMLError) as e:
            raise HelmRenderError(f"--helm-values {vf}: {e}") from None
    _OVERRIDES["sets"] = list(sets or [])
    _OVERRIDES["files"] = docs


def _apply_overrides(base: dict | None) -> dict | None:
    if not _OVERRIDES["sets"] and not _OVERRIDES["files"]:
        return base
    merged = dict(base or {})
    for doc in _OVERRIDES["files"]:
        merged = _deep_merge(merged, doc)
    for raw in _OVERRIDES["sets"]:
        key, _, val = raw.partition("=")
        if key:
            _set_path(merged, key, _parse_set_value(val))
    return merged


def scan_rendered_chart(chart: Chart,
                        values_override: dict | None = None,
                        prefix: str = ""):
    from .. import types as T
    from .kubernetes import scan_kubernetes
    rendered = render_chart(
        chart, values_override=_apply_overrides(values_override))
    records = []
    for rpath, text in rendered.items():
        try:
            docs = [d for d in yaml.safe_load_all(text) if d is not None]
        except yaml.YAMLError:
            continue
        if not any(isinstance(d, dict) and d.get("kind") for d in docs):
            continue
        failures, successes = scan_kubernetes(rpath, text.encode(),
                                              docs=None)
        if not failures and not successes:
            continue
        for f in failures:
            f.type = "helm"
        # report chart-root-relative paths, the way the reference's
        # helm scanner does (helm_testchart.json.golden targets are
        # "templates/deployment.yaml", not "<chartname>/templates/…")
        rel = rpath[len(chart.name) + 1:] \
            if rpath.startswith(chart.name + "/") else rpath
        records.append(T.Misconfiguration(
            file_type="helm", file_path=prefix + rel,
            successes=successes, failures=failures))
    return records


def find_charts(files) -> dict[str, list[str]]:
    """Group walked file paths by chart root (dirs holding Chart.yaml).
    Nested roots under charts/ belong to the parent chart."""
    roots = []
    for path in files:
        if path.endswith("Chart.yaml"):
            root = path[:-len("Chart.yaml")].rstrip("/")
            roots.append(root)
    # keep only top-most roots (subcharts folded into parents)
    tops = []
    for r in sorted(roots, key=len):
        if not any(r != t and r.startswith(t + "/") for t in tops):
            tops.append(r)
    out: dict[str, list[str]] = {t: [] for t in tops}
    for path in files:
        for t in sorted(tops, key=len, reverse=True):
            if t == "" or path == t or path.startswith(t + "/"):
                out[t].append(path)
                break
    return out
