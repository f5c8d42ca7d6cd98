#!/usr/bin/env python3
"""The secret lane of two checkouts of this repo on one card, side by
side in one call:

    python3 scripts/prefilter_ab.py A_DIR B_DIR [--runs 4]

Builds chip_smoke.py's apps table and `fs` checkout once (with A_DIR's
chip_smoke.py), then alternates A, B, B, A, ...: each turn runs
`python -m trivy_tpu_torch fs CHECKOUT --scanners vuln,secret --trace`
from that directory in a fresh process (its `secret.prefilter` and
`secret.confirm` span totals, its wall) and a probe process that walks
the checkout and times, on the card, the CUDA context, two
`ops.ac.pack_chunks` calls over the secret candidates and three
`SecretScanner._keyword_masks` calls. The first turn of each directory
also builds its kernels (nvcc) inside the `fs` run's prefilter span.
One JSON line per turn; the card's name and power limit last. Needs a
CUDA device; run from anywhere.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

PROBE = r'''
import json, sys, time
t0 = time.perf_counter()
import torch
from trivy_tpu_torch.fanal.analyzers import (INDIVIDUAL_PKG_ANALYZERS,
                                             AnalyzerGroup)
from trivy_tpu_torch.fanal.walker import walk_fs
from trivy_tpu_torch.ops import ac
from trivy_tpu_torch.secret.engine import CHUNK_LEN, SecretScanner
out = {"import_s": time.perf_counter() - t0}
scan = walk_fs(sys.argv[1], AnalyzerGroup(disabled=INDIVIDUAL_PKG_ANALYZERS),
               collect_secrets=True)
contents = [c for _, c in scan.secret_files]
out.update(files=len(contents), bytes=sum(map(len, contents)))
t = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
out["ctx_ms"] = (time.perf_counter() - t) * 1e3
s = SecretScanner(device="cuda")
for k in (1, 2):
    t = time.perf_counter()
    ac.pack_chunks(contents, CHUNK_LEN, s._bank.max_kw_len - 1)
    out[f"pack{k}_ms"] = (time.perf_counter() - t) * 1e3
for k in (1, 2, 3):
    t = time.perf_counter()
    s._keyword_masks(contents)
    out[f"prefilter{k}_ms"] = (time.perf_counter() - t) * 1e3
print(json.dumps(out))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a_dir")
    ap.add_argument("b_dir")
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    trees = {"A": os.path.abspath(args.a_dir), "B": os.path.abspath(args.b_dir)}
    sys.path.insert(0, trees["A"])
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("prefilter_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from trivy_tpu_torch.db.table import build_table
    from trivy_tpu_torch.obs.trace import phase_totals
    tmp = tempfile.mkdtemp(prefix="prefilter_ab_")
    env = {**os.environ, "TRIVY_TPU_HOME": os.path.join(tmp, "home")}
    try:
        _deb, names, raw = chip_smoke.apps_raw(
            np.random.default_rng(chip_smoke.SEED + 6))
        db = os.path.join(tmp, "apps.npz")
        build_table(raw).save(db)
        root = os.path.join(tmp, "checkout")
        for rel, data in chip_smoke.checkout_files(
                np.random.default_rng(chip_smoke.SEED + 4), names).items():
            os.makedirs(os.path.dirname(os.path.join(root, rel)),
                        exist_ok=True)
            with open(os.path.join(root, rel), "wb") as f:
                f.write(data)
        order = ["A", "B", "B", "A"] * ((args.runs + 3) // 4)
        for i, who in enumerate(order[:args.runs]):
            trace = os.path.join(tmp, f"trace{i}.json")
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", "trivy_tpu_torch", "fs", root,
                 "--db", db, "--scanners", "vuln,secret", "--trace", trace,
                 "--format", "json", "--cache-dir",
                 os.path.join(tmp, f"cache{i}"),
                 "-o", os.path.join(tmp, f"report{i}.json")],
                cwd=trees[who], env=env, capture_output=True, text=True)
            wall_s = time.perf_counter() - t0
            if p.returncode != 0:
                raise SystemExit(f"fs in {trees[who]}:\n{p.stderr[-3000:]}")
            with open(trace) as f:
                totals = phase_totals(json.load(f))
            q = subprocess.run([sys.executable, "-c", PROBE, root],
                               cwd=trees[who], env=env, capture_output=True,
                               text=True)
            if q.returncode != 0:
                raise SystemExit(f"probe in {trees[who]}:\n{q.stderr[-3000:]}")
            print(json.dumps({
                "turn": i, "tree": who, "dir": trees[who], "wall_s": wall_s,
                "prefilter_ms": totals["secret.prefilter"]["total_ms"],
                "confirm_ms": totals["secret.confirm"]["total_ms"],
                "probe": json.loads(q.stdout.strip().splitlines()[-1])}),
                flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
