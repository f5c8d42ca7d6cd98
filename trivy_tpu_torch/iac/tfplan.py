"""Terraform plan (tfplan JSON) scanner.

Reference: pkg/iac/scanners/terraformplan/tfjson — `terraform show -json
plan.out` output is converted back into synthetic HCL (parser.go ToFS,
resource_block.go ToHCL) and run through the terraform scanner, so plan
scanning reuses every terraform check unchanged.

We mirror that: planned resource values (`resource_changes[].change.
after`, falling back to configuration expression constants) become a
`main.tf` that feeds iac.terraform.scan_terraform_files.
"""

from __future__ import annotations

import json

from .. import types as T


def _is_map_list(v) -> bool:
    return isinstance(v, list) and bool(v) and \
        all(isinstance(x, dict) for x in v)


def _render_primitive(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        # always a quoted string (escapes handled by the HCL lexer):
        # heredocs break inside single-line map/list values and terminate
        # early when the content contains a bare delimiter line; plan
        # values are literal, so interpolation markers must be escaped
        # ($${ / %%{ round-trip through the lexer back to ${ / %{)
        v = v.replace("${", "$${").replace("%{", "%%{")
        return json.dumps(v, ensure_ascii=False)
    if isinstance(v, (int, float)):
        return json.dumps(v)
    if isinstance(v, dict):
        return _render_map(v)
    if isinstance(v, list):
        return "[" + ", ".join(_render_primitive(x) for x in v) + "]"
    return json.dumps(str(v))


def _render_map(m: dict) -> str:
    inner = ", ".join(f"{json.dumps(k)} = {_render_primitive(v)}"
                      for k, v in sorted(m.items()))
    return "{ " + inner + " }"


def _render_body(attrs: dict, indent: str) -> list[str]:
    lines = []
    for name, value in sorted(attrs.items()):
        if value is None:
            continue
        if _is_map_list(value):
            # nested blocks: one block per element (plan JSON encodes
            # repeated blocks as arrays of objects)
            for elem in value:
                lines.append(f"{indent}{name} {{")
                lines.extend(_render_body(elem, indent + "  "))
                lines.append(f"{indent}}}")
        elif isinstance(value, dict):
            lines.append(f"{indent}{name} = {_render_map(value)}")
        else:
            lines.append(f"{indent}{name} = {_render_primitive(value)}")
    return lines


def plan_to_hcl(plan: dict) -> str:
    """Synthesize main.tf from a terraform plan JSON document."""
    out = []
    changes = {c.get("address"): c
               for c in plan.get("resource_changes", [])}
    conf_res = _configuration_constants(plan)
    for res in _walk_resources(
            plan.get("planned_values", {}).get("root_module", {})):
        if res.get("mode") not in (None, "managed"):
            continue
        rtype = res.get("type", "")
        rname = res.get("name", "")
        addr = res.get("address", f"{rtype}.{rname}")
        attrs: dict = {}
        change = changes.get(addr)
        if change:
            after = change.get("change", {}).get("after")
            if isinstance(after, dict):
                attrs.update(after)
        # configuration constants fill attributes the plan omits
        for k, v in conf_res.get(addr, {}).items():
            attrs.setdefault(k, v)
        out.append(f'resource "{rtype}" "{rname}" {{')
        out.extend(_render_body(attrs, "  "))
        out.append("}")
        out.append("")
    return "\n".join(out)


def _walk_resources(module: dict):
    yield from module.get("resources", []) or []
    for child in module.get("child_modules", []) or []:
        yield from _walk_resources(child)


def _configuration_constants(plan: dict) -> dict[str, dict]:
    """address → {attr: constant_value} from configuration expressions
    (parser.go unpackConfigurationValue keeps constant_value entries)."""
    out: dict[str, dict] = {}

    def walk(module: dict, prefix: str):
        for res in module.get("resources", []) or []:
            addr = (prefix + "." if prefix else "") + \
                res.get("address", "")
            consts = {}
            for attr, expr in (res.get("expressions") or {}).items():
                if isinstance(expr, dict) and "constant_value" in expr:
                    consts[attr] = expr["constant_value"]
            if consts:
                out[addr] = consts
        for name, call in (module.get("module_calls") or {}).items():
            walk(call.get("module", {}),
                 (prefix + "." if prefix else "") + f"module.{name}")

    walk(plan.get("configuration", {}).get("root_module", {}), "")
    return out


def looks_like_plan(doc) -> bool:
    return isinstance(doc, dict) and "format_version" in doc and (
        "planned_values" in doc or "resource_changes" in doc)


def scan_plan_file(path: str, content: bytes) -> list[T.Misconfiguration]:
    """→ Misconfiguration records; findings point at the plan file with
    line ranges in the synthesized HCL."""
    from .terraform import scan_terraform_files
    try:
        plan = json.loads(content.decode("utf-8", errors="replace"))
    except json.JSONDecodeError:
        return []
    if not looks_like_plan(plan):
        return []
    hcl = plan_to_hcl(plan)
    if not hcl.strip():
        return []
    records = scan_terraform_files({"main.tf": hcl.encode()})
    for rec in records:
        rec.file_type = "terraformplan"
        rec.file_path = path
        for f in rec.failures:
            f.type = "terraformplan"
    return records
