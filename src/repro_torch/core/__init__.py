"""Numeric core of the port: precision policies, ground distances, the
LC engines (single-query, batched and candidate-compacted), the per-pair
relaxations and the exact-EMD and Sinkhorn oracles, as the JAX package's
``repro.core`` exports them."""
from repro_torch.core.emd import emd_exact
from repro_torch.core.geometry import (l1_normalize, l2_normalize,
                                       pairwise_dist, pairwise_sqdist)
from repro_torch.core.lc import (Corpus, lc_act_scores, lc_omr_scores,
                                 lc_rwmd_scores, lc_rwmd_scores_rev,
                                 symmetric_scores)
from repro_torch.core.relaxations import (act, act_dir, ict, ict_dir, omr,
                                          omr_dir, rwmd, rwmd_dir)
from repro_torch.core.sinkhorn import sinkhorn_cost

__all__ = [
    "emd_exact",
    "l1_normalize", "l2_normalize", "pairwise_dist", "pairwise_sqdist",
    "Corpus", "lc_act_scores", "lc_omr_scores", "lc_rwmd_scores",
    "lc_rwmd_scores_rev", "symmetric_scores",
    "act", "act_dir", "ict", "ict_dir", "omr", "omr_dir", "rwmd", "rwmd_dir",
    "sinkhorn_cost",
]
