"""Chunked prefill planning.

A long prompt is admitted in bounded slices interleaved with decode
steps instead of one monolithic prefill: the engine claims the slot and
pool blocks up front, then each engine step advances the admission by
ONE slice, which gathers the already-filled prefix from the pool, runs
the suffix prefill over just the slice and scatters the slice's KV into
the request's pool blocks. The final slice rides the ordinary suffix
commit (hot-row rebuild, first-token sample, PAM placement), so from
then on the request is indistinguishable from a single-shot admission,
and its stream is the single-shot one (causality, applied slice by
slice).

Counterpart of ``repro.frontend.chunking``: pure host-side planning;
the device work lives in ``repro_torch.serving.engine``.
"""

from __future__ import annotations

import dataclasses


def validate_budget(budget: int) -> None:
    """A chunk budget must be a positive power of two: intermediate
    slices are always exactly ``budget`` tokens, and the final slice
    buckets to a power of two like any prefill."""
    if budget <= 0 or budget & (budget - 1):
        raise ValueError(f"need a positive power-of-two chunk, got {budget}")


def plan_slices(start: int, total: int, budget: int) -> list[tuple[int, int]]:
    """Slice schedule for a prompt of ``total`` tokens whose first
    ``start`` are already cache-resident (a prefix-cache hit): a list of
    ``(begin, length)`` pairs covering ``[start, total)``. Every slice
    is exactly ``budget`` tokens except the last, which is the remainder
    in ``(0, budget]``; the final slice always exists (it produces the
    first-token logits)."""
    validate_budget(budget)
    if not 0 <= start < total:
        raise ValueError(f"need 0 <= start < total, got {start}, {total}")
    out = []
    begin = start
    while begin < total:
        t = min(budget, total - begin)
        out.append((begin, t))
        begin += t
    return out


@dataclasses.dataclass
class ChunkPlan:
    """Host state of one in-flight chunked admission. The slot and the
    full block window are claimed at admission; ``done`` novel tokens
    have been filled so far; ``cow_src`` is the still-pinned shared tail
    block to copy-on-write in the FIRST slice (-1 = none)."""

    rid: int
    slot: int
    start: int  # cache-resident prefix tokens at admission
    total: int  # full prompt length
    budget: int
    done: int = 0  # novel tokens filled so far
    cow_src: int = -1
    slices: int = 0

    def next_slice(self) -> tuple[int, int]:
        begin = self.start + self.done
        return begin, min(self.budget, self.total - begin)

    @property
    def finished(self) -> bool:
        return self.start + self.done >= self.total
