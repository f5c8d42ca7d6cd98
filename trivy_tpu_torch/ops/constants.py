"""Single source of truth for the device-visible representation contract.

The columnar advisory table (db/table.py), the join kernel
(csrc/csr_join.cu) and its plain version (ops/join.py) communicate
through int32 flag words and an int8 report word; every producer and
consumer imports the bit values from here. The values equal the JAX
package's, so tables and join results carry across bit for bit.
"""

from __future__ import annotations

# ---- interval flag bits (int32 `flags` column; one word per advisory
# row, produced by db.table.build_table, consumed by ops.join._pair_core)
HAS_LO = 1        # row has a lower bound (lo_tok is meaningful)
LO_INCL = 2       # lower bound is inclusive (>=, not >)
HAS_HI = 4        # row has an upper bound (hi_tok is meaningful)
HI_INCL = 8       # upper bound is inclusive (<=, not <)
INEXACT = 16      # token encoding lossy — host must re-check with the
                  # exact comparator before reporting
NEGATIVE = 32     # row describes a patched/unaffected range, not a
                  # vulnerable one (subtracted at assembly)

FLAG_BITS = {
    "HAS_LO": HAS_LO, "LO_INCL": LO_INCL, "HAS_HI": HAS_HI,
    "HI_INCL": HI_INCL, "INEXACT": INEXACT, "NEGATIVE": NEGATIVE,
}
FLAG_MASK = HAS_LO | LO_INCL | HAS_HI | HI_INCL | INEXACT | NEGATIVE

# ---- report bits (int8 per candidate pair, returned by the join)
SATISFIED = 1       # interval predicate holds for this pair
NEEDS_RECHECK = 2   # INEXACT row: treat as candidate, re-check on host

REPORT_BITS = {"SATISFIED": SATISFIED, "NEEDS_RECHECK": NEEDS_RECHECK}

# ---- columnar table schema, as consumed by ops.join's gathers:
#   name -> (dtype, rank). K is the version-token key width
# (version.KEY_WIDTH); A is the row count.
TABLE_SCHEMA = {
    "hash": ("int32", 2),     # [A, 2] biased (hi, lo) fnv1a64 halves
    "lo_tok": ("int32", 2),   # [A, K] lower-bound version tokens
    "hi_tok": ("int32", 2),   # [A, K] upper-bound version tokens
    "flags": ("int32", 1),    # [A]    FLAG_BITS words
    "group": ("int32", 1),    # [A]    advisory group id
}

# dtype of the join's per-pair report word
REPORT_DTYPE = "int8"

# leading tokens of each bound kept in the join kernel's derived [A, 4]
# prefix planes (AdvisoryTable.device_arrays): 16 contiguous bytes a row,
# compared first; the full vectors are read only when the prefixes tie
PREFIX_TOKENS = 4

# pair slots one block of the join kernel owns; ops/kernels.py compiles
# csrc/csr_join.cu with this value and PREFIX_TOKENS, and ops/join.py
# sizes the kernel's scratch with it
JOIN_TILE = 2048
