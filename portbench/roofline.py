"""Bytes the engines' algorithms need, counted from the work on these inputs.

A roofline share is the least time the card could take for the work,
bytes over its peak memory rate, divided by the time its kernels ran. The
bytes are counted from what the algorithm has to touch on these inputs,
each byte once, and never from the arrays an implementation happens to
build: a change that fuses a gather into a kernel, or moves a loop onto
the card, changes the time and leaves the work as it was.

  SAAT, a query: each admitted posting's doc id (4 B), each admitted
  segment's impact (4 B), the query's live slots (term id and weight,
  8 B), and k (id, score) pairs written (8 B each).

  DAAT, a query: phase 0 reads the query terms' block-max lists once (block
  id and maximum, 8 B an entry); every scored block's doc slots (the term
  id, 4 B) and, where the slot's term is a query term, its weight (4 B);
  the query's live slots (8 B each) and k pairs written.

Both are memory-bound: a few flops a byte at most.
"""
from __future__ import annotations

# NVIDIA H100 SXM 80 GB HBM3: the data sheet's memory rate, at the 700 W
# power limit (a card set lower reaches less; runs state the limit).
HBM_BYTES_PER_S = 3.35e12


def saat_query_bytes(processed: int, segments: int, live_slots: int, k: int) -> int:
    return 4 * processed + 4 * segments + 8 * live_slots + 8 * k


def daat_query_bytes(bm_entries: int, doc_slots: int, matched_slots: int, live_slots: int,
                     k: int) -> int:
    return 8 * bm_entries + 4 * doc_slots + 4 * matched_slots + 8 * live_slots + 8 * k


def roofline_pct(total_bytes: float, kernel_busy_s: float) -> float | None:
    """The work's least time at the memory rate, as a share (%) of the time
    the card's kernels were busy; None where there is no busy time."""
    if kernel_busy_s <= 0:
        return None
    return 100.0 * (total_bytes / HBM_BYTES_PER_S) / kernel_busy_s
