"""VEX suppression (reference pkg/vex): OpenVEX, CycloneDX VEX and CSAF
statements mark findings not_affected or fixed, and those findings drop
from the results before the other filters run.

The format is sniffed as pkg/vex/vex.go:28-60 does; a statement matches
by vulnerability id and, when it names products, by the package URL
(query string ignored) that the port's `purl.py` gave the package, or by
`name@version`. The port's copy of the JAX package's vex.py."""

from __future__ import annotations

import json
from dataclasses import dataclass

from . import types as T

SUPPRESS_STATUSES = {"not_affected", "fixed"}


@dataclass
class VexStatement:
    vuln_id: str
    status: str
    justification: str = ""
    products: tuple = ()  # purls; empty = applies to everything


def load_vex_file(path: str) -> list[VexStatement]:
    with open(path) as f:
        doc = json.load(f)
    if "statements" in doc:  # OpenVEX
        return _openvex(doc)
    if doc.get("bomFormat") == "CycloneDX":
        return _cyclonedx_vex(doc)
    if "document" in doc and "vulnerabilities" in doc:  # CSAF VEX
        return _csaf(doc)
    raise ValueError(
        "unrecognized VEX format (want OpenVEX, CycloneDX, or CSAF)")


def _openvex(doc: dict) -> list[VexStatement]:
    out = []
    for st in doc.get("statements", []):
        vuln = st.get("vulnerability")
        if isinstance(vuln, dict):
            vuln = vuln.get("name", "")
        products = []
        for p in st.get("products", []):
            if isinstance(p, str):
                products.append(p)
            elif isinstance(p, dict):
                pid = p.get("@id") or ""
                ids = p.get("identifiers") or {}
                products.append(ids.get("purl") or pid)
        out.append(VexStatement(
            vuln_id=vuln or "",
            status=st.get("status", ""),
            justification=st.get("justification", ""),
            products=tuple(x for x in products if x)))
    return out


def _cyclonedx_vex(doc: dict) -> list[VexStatement]:
    out = []
    for v in doc.get("vulnerabilities", []):
        analysis = v.get("analysis") or {}
        state = analysis.get("state", "")
        status = {"not_affected": "not_affected", "resolved": "fixed",
                  "false_positive": "not_affected"}.get(state, state)
        out.append(VexStatement(
            vuln_id=v.get("id", ""),
            status=status,
            justification=analysis.get("justification", ""),
            products=tuple(a.get("ref", "") for a in v.get("affects", []))))
    return out


def _csaf(doc: dict) -> list[VexStatement]:
    """CSAF VEX (reference pkg/vex/csaf.go): per-vulnerability
    product_status lists product ids; the product tree (branches +
    relationships) resolves each id to purls."""
    purls: dict[str, list[str]] = {}

    def walk_branches(node):
        for br in node.get("branches") or []:
            prod = br.get("product") or {}
            pid = prod.get("product_id")
            p = (prod.get("product_identification_helper") or {}) \
                .get("purl")
            if pid and p:
                purls.setdefault(pid, []).append(p)
            walk_branches(br)

    tree = doc.get("product_tree") or {}
    walk_branches(tree)
    # relationships: "pkg as a component of product" — the combined
    # product id inherits the referenced package's purls
    # (csaf.go inspectProductRelationships). Iterated to a fixed point:
    # chained relationships may be listed parent-first.
    rels = [(r.get("full_product_name") or {}, r.get("product_reference"))
            for r in tree.get("relationships") or []]
    changed = True
    while changed:
        changed = False
        for full_name, ref in rels:
            full = full_name.get("product_id")
            if not (full and ref and ref in purls):
                continue
            have = purls.setdefault(full, [])
            new = [p for p in purls[ref] if p not in have]
            if new:
                have.extend(new)
                changed = True

    out = []
    for v in doc.get("vulnerabilities") or []:
        cve = v.get("cve", "")
        status_map = {"known_not_affected": "not_affected",
                      "fixed": "fixed"}
        for key, status in status_map.items():
            pids = (v.get("product_status") or {}).get(key) or []
            products = tuple(p for pid in pids
                             for p in purls.get(pid, ()))
            if not cve or not pids:
                continue
            # CSAF statements never apply to everything: without a
            # resolvable purl the statement cannot match (csaf.go
            # match returns "" on nil purl)
            if not products:
                continue
            out.append(VexStatement(vuln_id=cve, status=status,
                                    products=products))
    return out


def apply_vex(results: list[T.Result],
              statements: list[VexStatement]) -> None:
    """Drop suppressed findings in place (reference pkg/result/filter.go:84
    runs VEX before other filters)."""
    by_vuln: dict[str, list[VexStatement]] = {}
    for st in statements:
        if st.status in SUPPRESS_STATUSES:
            by_vuln.setdefault(st.vuln_id, []).append(st)
    for res in results:
        kept = []
        for v in res.vulnerabilities:
            if not _suppressed(v, by_vuln.get(v.vulnerability_id, [])):
                kept.append(v)
        res.vulnerabilities = kept


def _suppressed(v: T.DetectedVulnerability,
                statements: list[VexStatement]) -> bool:
    for st in statements:
        if not st.products:
            return True
        purl = v.pkg_identifier.purl
        for product in st.products:
            if product and purl and product.split("?")[0] == purl.split("?")[0]:
                return True
            if product == f"{v.pkg_name}@{v.installed_version}":
                return True
    return False
