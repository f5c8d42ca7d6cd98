"""SecretScanner: exact multi-keyword prefilter on the device, regex
confirmation on the host.

Parity contract with the reference scanner (pkg/fanal/secret/scanner.go
Scan:341-418), as the JAX package's secret/engine.py keeps it: per file
— global allow paths, per-rule path gates, keyword prefilter (one
device shift-or pass over all files x all keywords instead of
bytes.Contains per rule per file), regex locations with optional
secret-group submatch, allow regexes, exclude blocks, censoring,
line/context extraction (findLocation:447-504), finding sort.

The prefilter takes one of three paths, counted per scanner in
`prefilter_path`:

  cuda   the shift-or kernel (csrc/shiftor.cu via ops/shiftor.py), for a
         scanner on a CUDA device
  torch  the kernel's plain torch version (ops/shiftor.shiftor_plain),
         for a scanner on the CPU
  host   bytes.find per keyword, for batches under `small_batch_bytes`
         (2 MiB): a device launch cannot pay for itself there. This is
         the routing policy of the JAX package, not a fallback: a
         kernel that fails to build or launch raises.

With `mesh=` (parallel/mesh.py) the device pieces shard their chunk
rows over every cell of the mesh (mesh.sharded_shiftor_scan's
launches: one per cell, the bank and its index replicated to each
device once), as the JAX package's meshed secret lane does; the path
label is the cells' (cuda or torch).

Instrumented as the JAX package's engine is: `secret.prefilter` and
`secret.confirm` spans, the trivy_tpu_secret_* series (the prefilter
path label takes the values above), the dispatch ledger's "secret" rows
(the first launch of a (rows, chunk_len) shape is its "compile"), the
bank's resident bytes, and device ms / transfer bytes / scanned bytes
charged to the request's cost ledger.
"""

from __future__ import annotations

import hashlib
import re
import threading
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..device import resolve_device
from ..metrics import METRICS
from ..obs import cost as _cost
from ..obs import note_dispatch, span
from ..obs.perf import LEDGER, ndarray_bytes
from ..ops import ac, next_pow2
from ..ops import shiftor as so
from .rules import BUILTIN_RULES, GLOBAL_ALLOW_RULES, Rule

CHUNK_LEN = 16384
# max chunk rows per kernel launch (64 MiB of chunk bytes), padded to a
# power of two (floor 64) like the JAX package's batches
DEVICE_ROWS = 4096
# below this many total bytes the host bytes.find scan serves the batch
SMALL_BATCH_BYTES = 2 << 20


class SecretScanner:
    def __init__(self, rules: Optional[list[Rule]] = None,
                 allow_rules: Optional[list] = None,
                 exclude_regexes: Optional[list] = None,
                 small_batch_bytes: Optional[int] = None,
                 device: str | torch.device | None = None, mesh=None):
        # a mesh carries its devices: the scanner's is its first
        self.mesh = mesh
        self.device = resolve_device(
            mesh.devices.flat[0] if mesh is not None and device is None
            else device)
        self.rules = rules if rules is not None else BUILTIN_RULES
        self.global_allow = (allow_rules if allow_rules is not None
                             else GLOBAL_ALLOW_RULES)
        # global exclude-block regexes (scanner.go:27-41 Config)
        self.global_exclude = exclude_regexes or []
        self.small_batch_bytes = SMALL_BATCH_BYTES \
            if small_batch_bytes is None else small_batch_bytes
        # prefilter calls per path: "cuda" | "torch" | "host"
        self.prefilter_path: Counter = Counter()
        # keyword → rule bitset mapping for the shared automaton
        self._keywords: list[bytes] = []
        self._kw_rules: list[list[int]] = []
        kw_index: dict[bytes, int] = {}
        self._no_keyword_rules = []
        for ri, rule in enumerate(self.rules):
            if not rule.keywords:
                self._no_keyword_rules.append(ri)
                continue
            for kw in rule.keywords:
                k = kw.lower().encode()
                if k not in kw_index:
                    kw_index[k] = len(self._keywords)
                    self._keywords.append(k)
                    self._kw_rules.append([])
                self._kw_rules[kw_index[k]].append(ri)
        self._bank = ac.build_literal_bank(self._keywords) \
            if self._keywords else None
        self._bank_dev = None   # the bank on self.device, uploaded once
        self._bank_mesh = None  # the bank on each mesh device, likewise
        # launch shapes (rows, chunk_len) met so far: the ledger's
        # first-of-shape "compile"
        self._shape_lock = threading.Lock()
        self._seen_shapes: set = set()
        if self._bank is not None:
            LEDGER.note_resident(
                "secret_bank", ndarray_bytes(self._bank.kw_words,
                                             self._bank.kw_masks))

    # --- keyword prefilter ---

    def _keyword_masks(self, files: list[bytes]) -> list[set[int]]:
        """→ per-file set of rule indices whose keywords appear (exact:
        the bitmask IS keyword presence, no host re-confirm)."""
        if self._bank is None:
            return [set() for _ in files]
        total = sum(len(f) for f in files)
        if total >= self.small_batch_bytes:
            out, path = self._keyword_masks_device(files)
        else:
            out, path = self._keyword_masks_host(files), "host"
        self.prefilter_path[path] += 1
        self._note_path(path, total)
        return out

    @staticmethod
    def _note_path(path: str, n_bytes: int) -> None:
        METRICS.inc("trivy_tpu_secret_prefilter_path_total", path=path)
        METRICS.inc("trivy_tpu_secret_scan_bytes_total", n_bytes,
                    path=path)
        # the scanned bytes, billed to the requesting tenant by the
        # path that served them
        _cost.charge_secret_bytes(path, float(n_bytes))

    def _keyword_masks_host(self, files: list[bytes]) -> list[set[int]]:
        out = []
        for data in files:
            low = bytes(ac.lower_bytes(data)) if data else b""
            hit = set()
            for ki, kw in enumerate(self._keywords):
                if kw in low:
                    hit.update(self._kw_rules[ki])
            out.append(hit)
        return out

    def _bank_arrays(self):
        """→ (pack_bank's arrays, the kernel's bigram index) on the
        scanner's device, uploaded once."""
        if self._bank_dev is None:
            def up(arrays):
                return tuple(torch.from_numpy(a).to(self.device)
                             for a in arrays)
            packed = so.pack_bank(self._bank)
            self._bank_dev = (up(packed), up(so.bank_index(*packed)))
        return self._bank_dev

    def _keyword_masks_device(self, files: list[bytes]
                              ) -> tuple[list[set[int]], str]:
        """→ (per-file exact rule sets, the path that served them)."""
        bank = self._bank
        # so.shiftor picks kernel or plain version from the tensors'
        # device; the label only counts which one served
        path = "cuda" if self.device.type == "cuda" else "torch"
        chunks, owner = ac.pack_chunks(files, CHUNK_LEN, bank.max_kw_len - 1)
        out: list[set[int]] = [set() for _ in files]
        if chunks.shape[0] == 0:
            return out, path
        # content-addressed dedup: container filesystems repeat whole
        # blocks across files, so each distinct 16 KiB chunk is scanned
        # once and its verdict fanned back out
        seen: dict[bytes, int] = {}
        remap = np.empty(chunks.shape[0], np.int64)
        uniq_rows: list[int] = []
        for i in range(chunks.shape[0]):
            h = hashlib.blake2b(chunks[i], digest_size=16).digest()
            j = seen.get(h)
            if j is None:
                j = seen[h] = len(uniq_rows)
                uniq_rows.append(i)
            remap[i] = j
        uniq = chunks[np.asarray(uniq_rows)] \
            if len(uniq_rows) < chunks.shape[0] else chunks
        if self.mesh is not None:
            from ..parallel import mesh as M
            if self._bank_mesh is None:
                self._bank_mesh = M.replicate_bank(
                    self.mesh, *so.pack_bank(bank))
        else:
            arrays, index = self._bank_arrays()
        site = "secret"
        pieces = []
        for off in range(0, uniq.shape[0], DEVICE_ROWS):
            piece = uniq[off:off + DEVICE_ROWS]
            real_rows, row_len = int(piece.shape[0]), int(piece.shape[1])
            b = next_pow2(real_rows, floor=64)
            with self._shape_lock:
                new_shape = (b, row_len) not in self._seen_shapes
                self._seen_shapes.add((b, row_len))
            t0 = time.perf_counter()
            padded = np.zeros((b, row_len), np.uint8)
            padded[:real_rows] = piece
            if self.mesh is not None:
                pieces.append((b, M.launch_shiftor_cells(
                    self.mesh, self._bank_mesh, padded, bank.words)))
            else:
                dev_piece = torch.from_numpy(padded).to(self.device)
                pieces.append(so.shiftor(*arrays, dev_piece,
                                         n_words=bank.words, index=index))
            launch_ms = (time.perf_counter() - t0) * 1e3
            if new_shape:
                LEDGER.note_compile(site, b, 0, launch_ms)
            LEDGER.note_dispatch(site, real_rows, b, row_bytes=row_len)
            _cost.charge_device_ms(site, launch_ms)
        note_dispatch(self.device)
        t_get = time.perf_counter()
        if self.mesh is not None:
            fetched = np.concatenate([M.fetch_shiftor_cells(cells, b)
                                      for b, cells in pieces])
        else:
            fetched = torch.cat(pieces).cpu().numpy()
        _cost.charge_device_ms(site, (time.perf_counter() - t_get) * 1e3)
        _cost.ledgered_transfer("dense", float(fetched.nbytes))
        masks = fetched[:uniq.shape[0]][remap]
        # decode the exact bitmask: a set bit means the full keyword
        # occurs in that chunk row, so file hits are direct unions
        u8 = np.ascontiguousarray(masks.astype(np.uint32)).view(np.uint8)
        bits = np.unpackbits(u8, axis=1, bitorder="little")
        hit_ci, hit_ki = np.nonzero(bits[:, :bank.n_keywords])
        owner_l = owner.tolist()
        for ci, ki in zip(hit_ci.tolist(), hit_ki.tolist()):
            out[owner_l[ci]].update(self._kw_rules[ki])
        return out, path

    # --- host confirmation (exact reference semantics) ---

    def scan_files(self, files: list[tuple[str, bytes]]) -> list[T.Secret]:
        """files: [(path, content)] → per-file Secret results (empty
        findings omitted)."""
        return self.scan_files_many([files])[0]

    def scan_files_many(self, batches: list[list[tuple[str, bytes]]]
                        ) -> list[list[T.Secret]]:
        """Coalesced entry: ONE keyword-prefilter pass over every
        batch's files, then per-file regex confirmation. Results are
        per batch, in batch/file order — identical to per-batch
        scan_files calls (the prefilter is exact either way; only the
        device launch is shared)."""
        files = [fc for batch in batches for fc in batch]
        contents = [c for _, c in files]
        n_bytes = sum(len(c) for c in contents)
        with span("secret.prefilter", files=len(files),
                  batches=len(batches), bytes=n_bytes) as sp:
            masks = self._keyword_masks(contents)
            flagged = sum(len(m) for m in masks)
            sp.attrs["candidates"] = flagged
        results: list[list[T.Secret]] = []
        confirmed = 0
        it = iter(zip(files, masks))
        with span("secret.confirm", files=len(files)) as sp:
            for batch in batches:
                out = []
                for _ in batch:
                    (path, content), rule_idx = next(it)
                    gated = set(rule_idx)
                    sec = self.scan_file(
                        path, content,
                        candidate_rules=gated
                        | set(self._no_keyword_rules))
                    if sec.findings:
                        out.append(sec)
                        hit_ids = {f.rule_id for f in sec.findings}
                        confirmed += sum(1 for ri in gated
                                         if self.rules[ri].id in hit_ids)
                results.append(out)
            n_findings = sum(len(s.findings) for out in results
                             for s in out)
            sp.attrs["findings"] = n_findings
        if flagged:
            # the regex yield of the keyword gate
            METRICS.observe("trivy_tpu_secret_candidate_precision",
                            confirmed / flagged)
        METRICS.inc("trivy_tpu_secret_files_total", len(files))
        METRICS.inc("trivy_tpu_secret_bytes_total", n_bytes)
        METRICS.inc("trivy_tpu_secret_findings_total", n_findings)
        return results

    def scan_file(self, path: str, content: bytes,
                  candidate_rules: Optional[set] = None) -> T.Secret:
        if any(a.path and a.path.search(path) for a in self.global_allow):
            return T.Secret(file_path=path)
        text = content.decode("utf-8", errors="surrogateescape")
        censored = None
        matched = []
        global_exb = _blocks(text, self.global_exclude) \
            if self.global_exclude else []
        if candidate_rules is None:
            low = bytes(ac.lower_bytes(content)) if content else b""
        for ri, rule in enumerate(self.rules):
            if candidate_rules is not None and ri not in candidate_rules:
                continue
            if not rule.match_path(path):
                continue
            if rule.allow_path(path):
                continue
            if candidate_rules is None and not rule.match_keywords(low):
                continue
            locs = self._find_locations(rule, text)
            if not locs:
                continue
            exb = _blocks(text, rule.exclude_regexes) + global_exb
            for start, end in locs:
                if _in_blocks(start, end, exb):
                    continue
                matched.append((rule, start, end))
                if censored is None:
                    censored = list(text)
                for i in range(start, end):
                    censored[i] = "*"
        if not matched:
            return T.Secret(file_path=path)
        censored_text = "".join(censored)
        findings = [self._to_finding(rule, s, e, censored_text)
                    for rule, s, e in matched]
        findings.sort(key=lambda f: (f.rule_id, f.match))
        return T.Secret(file_path=path, findings=findings)

    def _find_locations(self, rule: Rule, text: str):
        locs = []
        if rule.secret_group:
            # a Go regex may bind the group name more than once
            # (renamed name__N at compile); each occurrence is a finding
            groups = (rule.secret_group,) + tuple(
                getattr(rule, "secret_aliases", ()))
            for m in rule.regex.finditer(text):
                if self._allowed(rule, m.group(0)):
                    continue
                for g in groups:
                    try:
                        s, e = m.span(g)
                    except (IndexError, re.error):
                        continue
                    if s >= 0:
                        locs.append((s, e))
        else:
            for m in rule.regex.finditer(text):
                if self._allowed(rule, m.group(0)):
                    continue
                locs.append(m.span())
        return locs

    def _allowed(self, rule: Rule, match: str) -> bool:
        if any(a.regex and a.regex.search(match) for a in self.global_allow):
            return True
        return rule.allow_match(match)

    @staticmethod
    def _to_finding(rule: Rule, start: int, end: int,
                    content: str) -> T.SecretFinding:
        start_line, end_line, code, match_line = _find_location(
            start, end, content)
        return T.SecretFinding(
            rule_id=rule.id,
            category=rule.category,
            severity=rule.severity or "UNKNOWN",
            title=rule.title,
            start_line=start_line,
            end_line=end_line,
            code=code,
            match=match_line,
        )


def _blocks(text: str, regexes) -> list[tuple[int, int]]:
    out = []
    for rx in regexes:
        for m in rx.finditer(text):
            out.append(m.span())
    return out


def _in_blocks(start: int, end: int, blocks) -> bool:
    return any(bs <= start and end <= be for bs, be in blocks)


_RADIUS = 2  # context lines above/below (scanner.go secretHighlightRadius)


def _find_location(start: int, end: int, content: str):
    """Line numbers, context code window, and the censored match line —
    reference findLocation (scanner.go:447-504)."""
    start_line_num = content.count("\n", 0, start)
    line_start = content.rfind("\n", 0, start)
    line_start = 0 if line_start == -1 else line_start + 1
    line_end = content.find("\n", start)
    line_end = len(content) if line_end == -1 else line_end
    if line_end - line_start > 100:
        line_start = max(start - 30, 0)
        line_end = min(end + 20, len(content))
    match_line = content[line_start:line_end]
    end_line_num = start_line_num + content.count("\n", start, end)

    lines = content.split("\n")
    code_start = max(start_line_num - _RADIUS, 0)
    code_end = min(end_line_num + _RADIUS, len(lines))
    code_lines = []
    found_first = False
    for i, raw in enumerate(lines[code_start:code_end]):
        real = code_start + i
        in_cause = start_line_num <= real <= end_line_num
        code_lines.append(T.CodeLine(
            number=code_start + i + 1,
            content=raw,
            is_cause=in_cause,
            highlighted=raw,
            first_cause=in_cause and not found_first,
            last_cause=False,
        ))
        found_first = found_first or in_cause
    for cl in reversed(code_lines):
        if cl.is_cause:
            cl.last_cause = True
            break
    return (start_line_num + 1, end_line_num + 1,
            T.Code(lines=code_lines), match_line)
