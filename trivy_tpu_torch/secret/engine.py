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
"""

from __future__ import annotations

import hashlib
import re
from collections import Counter
from typing import Optional

import numpy as np
import torch

from .. import types as T
from ..device import resolve_device
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
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
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
        return out

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
        arrays, index = self._bank_arrays()
        pieces = []
        for off in range(0, uniq.shape[0], DEVICE_ROWS):
            piece = uniq[off:off + DEVICE_ROWS]
            b = next_pow2(piece.shape[0], floor=64)
            padded = np.zeros((b, piece.shape[1]), np.uint8)
            padded[:piece.shape[0]] = piece
            dev_piece = torch.from_numpy(padded).to(self.device)
            pieces.append(so.shiftor(*arrays, dev_piece, n_words=bank.words,
                                     index=index))
        masks = torch.cat(pieces).cpu().numpy()[:uniq.shape[0]][remap]
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
        masks = self._keyword_masks([c for _, c in files])
        results: list[list[T.Secret]] = []
        it = iter(zip(files, masks))
        for batch in batches:
            out = []
            for _ in batch:
                (path, content), rule_idx = next(it)
                sec = self.scan_file(
                    path, content,
                    candidate_rules=set(rule_idx)
                    | set(self._no_keyword_rules))
                if sec.findings:
                    out.append(sec)
            results.append(out)
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
