"""graftfleet, as far as the port has it: the detection-result memo
(memo.py). Its re-detect daemon lives in detect/redetect.py. The JAX
package's ring, router and replica supervisor come with ROADMAP A12."""

from .memo import FSMemo, MemoryMemo, MemoSession, MemoStore, open_memo

__all__ = ["FSMemo", "MemoSession", "MemoStore", "MemoryMemo", "open_memo"]
