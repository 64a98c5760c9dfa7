"""Quickstart on the PyTorch/CUDA port: every distance measure on one
histogram pair, then a top-5 search through ``EmdIndex``.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.api import EmdIndex, EngineConfig
from repro_torch.core import (act, emd_exact, ict, l1_normalize, omr,
                              pairwise_dist, rwmd, sinkhorn_cost)
from repro_torch.data.synth import make_text_like


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default cuda)")
    ap.add_argument("--n-docs", type=int, default=64,
                    help="corpus rows of the search (default 64)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    rng = np.random.default_rng(0)
    # Two histograms over 3-D embedded coordinates, one shared coordinate.
    P = rng.normal(size=(5, 3))
    Q = rng.normal(size=(6, 3))
    Q[0] = P[0]                                   # overlap
    p = l1_normalize(torch.tensor(rng.uniform(0.1, 1.0, 5),
                                  dtype=torch.float32, device=device))
    q = l1_normalize(torch.tensor(rng.uniform(0.1, 1.0, 6),
                                  dtype=torch.float32, device=device))
    C = pairwise_dist(torch.tensor(P, dtype=torch.float32, device=device),
                      torch.tensor(Q, dtype=torch.float32, device=device))

    print("Theorem 2 chain (each a tighter lower bound of EMD):")
    print(f"  RWMD  = {float(rwmd(p, q, C)):.4f}")
    print(f"  OMR   = {float(omr(p, q, C)):.4f}")
    print(f"  ACT-1 = {float(act(p, q, C, iters=1)):.4f}")
    print(f"  ACT-3 = {float(act(p, q, C, iters=3)):.4f}")
    print(f"  ICT   = {float(ict(p, q, C)):.4f}")
    print(f"  EMD   = {emd_exact(p.cpu(), q.cpu(), C.cpu()):.4f}   "
          "(exact LP)")
    print(f"  Sinkhorn(lam=20) = {float(sinkhorn_cost(p, q, C)):.4f} "
          "(regularized, above EMD)")

    corpus, labels = make_text_like(n_docs=args.n_docs, vocab=256, m=16,
                                    doc_len=40, hmax=24, seed=1)
    index = EmdIndex.build(corpus, EngineConfig(method="act", iters=2,
                                                top_l=5), device=device)
    scores, idx = index.search(corpus.ids[7], corpus.w[7])
    idx = idx.cpu().numpy()
    print(f"\nLC-ACT top-5 neighbors of doc 7 on {device} "
          f"(label {labels[7]}): ids={idx.tolist()} "
          f"labels={labels[idx].tolist()}")
    print(f"scores={np.round(scores.cpu().double().numpy(), 4).tolist()}")


if __name__ == "__main__":
    main()
