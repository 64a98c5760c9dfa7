"""The paper's own workload: LC-ACT text similarity search, 20News-scale.
n=18,828 docs, h=500 (truncated), v=69,682 words, m=300 (word2vec)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class EMDWorkload:
    name: str
    n_db: int            # database histograms
    vocab: int           # vocabulary size v
    dim: int             # embedding dimension m
    hmax: int            # padded histogram size
    iters: int           # ACT Phase-2 iterations
    queries: int         # query batch scored together
    method: str = "act"  # retrieval.METHODS registry key


CONFIG = EMDWorkload(name="emd-20news", n_db=18_828, vocab=69_682,
                     dim=300, hmax=500, iters=7, queries=256)
