"""The default source: every corpus row is a candidate.

``FullScanSpec`` makes "scan the whole corpus" one point of the protocol
the sublinear sources implement: the cascade driver sees ``full_scan=True``
and runs its original stage-1 path (full-corpus ``retrieval.batch_scores``
and a top-budget), bitwise the unsourced cascade and the only ADMISSIBLE
source (seeing every row is what the exact-top-l guarantee needs).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.candidates.base import (SourceSpec, SourceTables,
                                         register_source)


@register_source
@dataclasses.dataclass(frozen=True)
class FullScanSpec(SourceSpec):
    """Stage 0 = the whole corpus. No build parameters, no state."""

    kind = "full_scan"
    admissible = True
    full_scan = True

    def build(self, corpus, *, n_valid: int | None = None):
        return FullScanSource(spec=self)

    def wrap(self, leaves):
        if tuple(leaves):
            raise ValueError("FullScanSource carries no state arrays")
        return FullScanSource(spec=self)

    def describe(self) -> str:
        return "full_scan"


@dataclasses.dataclass(frozen=True)
class FullScanSource(SourceTables):
    """Stateless built form of :class:`FullScanSpec`. The cascade driver
    never calls :meth:`candidates` (it keeps the full-corpus stage-1 path);
    the method exists so the protocol is total."""

    spec: FullScanSpec

    @property
    def width(self) -> int | None:
        return None                          # the corpus itself

    def candidates(self, corpus, q_ids, q_w, budget: int | None = None):
        n = corpus.n if budget is None else min(budget, corpus.n)
        nq = q_ids.shape[0]
        rows = torch.arange(n, dtype=torch.int32,
                            device=corpus.device).expand(nq, n)
        return rows, torch.ones((nq, n), dtype=torch.bool,
                                device=corpus.device)
