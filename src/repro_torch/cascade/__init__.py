"""Cascaded prune-and-rescore search (the Theorem-2 serving pattern).

The paper's bound hierarchy RWMD <= OMR <= ACT-k <= ICT <= EMD exists so
cheap lower bounds can prune candidates before expensive measures run:

* :class:`CascadeSpec` / :class:`CascadeStage`: typed ``(method, budget)``
  ladders with static admissibility validation;
* :func:`cascade_search`: full-corpus stage 1 through the batched registry
  engines, gather-compacted later stages (``retrieval.cand_scores``),
  rescoring by any registry method or the cascade-only ``sinkhorn`` /
  exact ``emd`` rescorers;
* ``CASCADES``: named presets (``EngineConfig.cascade`` accepts these).

Callers reach it through ``repro_torch.api.EmdIndex``
(``EngineConfig(cascade=...)`` or ``index.search(..., cascade=...)``).
"""
from repro_torch.cascade.rescore import RESCORERS, Rescorer
from repro_torch.cascade.search import (CascadeResult, cascade_search,
                                        stage_rows, topk_recall,
                                        topk_smallest)
from repro_torch.cascade.spec import (CASCADES, CascadeSpec, CascadeStage,
                                      is_lower_bound, resolve_spec)

__all__ = [
    "CASCADES", "CascadeResult", "CascadeSpec", "CascadeStage",
    "RESCORERS", "Rescorer", "cascade_search", "is_lower_bound",
    "resolve_spec", "stage_rows", "topk_recall", "topk_smallest",
]
