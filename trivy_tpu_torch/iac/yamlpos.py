"""YAML loading with source positions.

The reference's IaC parsers keep per-node line ranges so every finding
carries cause metadata (pkg/iac/scanners/kubernetes/parser,
pkg/iac/scanners/cloudformation/parser/property.go).  PyYAML's
compose tree carries marks; this module converts it to plain Python
values wrapped in position-aware dict/list subclasses.

Unknown tags (CloudFormation's !Ref/!GetAtt/!Sub short forms) are
converted to single-key mappings {"Fn::X"/"Ref": value} the same way
cfn's long form would parse, so the adapter handles one shape.
"""

from __future__ import annotations

import yaml


class PosDict(dict):
    """dict that knows its own line range and each key's value range."""

    def __init__(self):
        super().__init__()
        self.start = 0       # 1-based first line
        self.end = 0         # 1-based last line
        self.key_lines = {}  # key -> (start, end) of the value


class PosList(list):
    def __init__(self):
        super().__init__()
        self.start = 0
        self.end = 0
        self.item_lines = []  # per-item (start, end)


_CFN_SHORT = {
    "!Ref": "Ref", "!Condition": "Condition",
}


def _node_range(node) -> tuple[int, int]:
    start = node.start_mark.line + 1
    end = node.end_mark.line + 1
    # end_mark points just past the node; for block nodes that is usually
    # the first line of the next sibling.
    if node.end_mark.column == 0 and end > start:
        end -= 1
    return start, end


def _intrinsic_key(tag: str) -> str:
    name = tag.lstrip("!")
    return _CFN_SHORT.get(tag, "Ref" if name == "Ref" else f"Fn::{name}")


_MAX_DEPTH = 200


def _construct(node, depth=0):
    if depth > _MAX_DEPTH:
        # cyclic alias graph (a: &x [*x]) or absurd nesting — bail out
        raise yaml.YAMLError("document too deep or cyclic")
    tag = node.tag
    if isinstance(node, yaml.MappingNode):
        out = PosDict()
        out.start, out.end = _node_range(node)
        for knode, vnode in node.value:
            key = _construct(knode, depth + 1)
            if isinstance(key, (PosDict, PosList)):
                key = str(key)
            out[key] = _construct(vnode, depth + 1)
            out.key_lines[key] = _node_range(vnode)
        if tag.startswith("!"):
            # short-form intrinsic over a mapping body (e.g. !If {...})
            return {_intrinsic_key(tag): out}
        return out
    if isinstance(node, yaml.SequenceNode):
        out = PosList()
        out.start, out.end = _node_range(node)
        for item in node.value:
            out.append(_construct(item, depth + 1))
            out.item_lines.append(_node_range(item))
        if tag.startswith("!"):
            # short-form intrinsic over a sequence (e.g. !Join [..])
            return {_intrinsic_key(tag): list(out)}
        return out
    # scalar
    value = node.value
    if tag == "tag:yaml.org,2002:null":
        return None
    if tag == "tag:yaml.org,2002:bool":
        return value.lower() in ("true", "yes", "on")
    if tag == "tag:yaml.org,2002:int":
        try:
            return int(value, 0) if isinstance(value, str) else int(value)
        except ValueError:
            return value
    if tag == "tag:yaml.org,2002:float":
        try:
            return float(value)
        except ValueError:
            return value
    if tag.startswith("!"):
        # CloudFormation short-form intrinsic: !GetAtt a.b → Fn::GetAtt
        key = _intrinsic_key(tag)
        if key == "Fn::GetAtt" and isinstance(value, str):
            return {key: value.split(".")}
        return {key: value}
    return value


def load_documents(text: str):
    """→ list of position-aware documents (PosDict/PosList/scalars)."""
    docs = []
    try:
        for node in yaml.compose_all(text, Loader=yaml.SafeLoader):
            if node is None:
                continue
            docs.append(_construct(node))
    except (yaml.YAMLError, RecursionError):
        return []
    return docs


def value_range(container, key_or_index, default=(0, 0)):
    """Line range of container[key] / container[i], if tracked."""
    if isinstance(container, PosDict):
        return container.key_lines.get(key_or_index, default)
    if isinstance(container, PosList):
        try:
            return container.item_lines[key_or_index]
        except (IndexError, TypeError):
            return default
    return default
