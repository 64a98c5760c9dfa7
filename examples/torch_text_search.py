"""End-to-end text similarity search on the PyTorch/CUDA port (the paper's
20 Newsgroups workflow at a small size).

Builds a word2vec-like embedded corpus, scores it through one ``EmdIndex``
per method, and reports precision@top-l and the time per query, a
miniature of the paper's Fig. 8(a). Serving queries then go through the
cascaded search (cheap bounds prune, ACT rescores), with recall measured
against exact EMD. Last, the same call on ``backend="reference"`` (plain
PyTorch ops) and on the scan engine (a loop of single queries), each
against the kernels' result.

Run: PYTHONPATH=src python examples/torch_text_search.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import cascade
from repro_torch.api import EmdIndex, EngineConfig
from repro_torch.cascade import CascadeSpec, CascadeStage
from repro_torch.core import retrieval
from repro_torch.data.synth import make_text_like


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default cuda)")
    ap.add_argument("--n-docs", type=int, default=256,
                    help="corpus rows (default 256)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    corpus, labels = make_text_like(n_docs=args.n_docs, n_classes=8,
                                    vocab=1024, m=48, doc_len=60, hmax=48,
                                    seed=2)
    print(f"corpus: n={corpus.n} hmax={corpus.hmax} v={corpus.v} "
          f"m={corpus.m} on {device}")

    for name, cfg in [("BoW-cosine", EngineConfig(method="bow")),
                      ("WCD", EngineConfig(method="wcd")),
                      ("LC-RWMD", EngineConfig(method="rwmd")),
                      ("LC-OMR", EngineConfig(method="omr")),
                      ("LC-ACT-1", EngineConfig(method="act", iters=1)),
                      ("LC-ACT-7", EngineConfig(method="act", iters=7))]:
        index = EmdIndex.build(corpus, cfg, device=device)
        t0 = time.perf_counter()
        S = index.all_pairs()
        _sync(device)
        dt = time.perf_counter() - t0
        precs = [retrieval.precision_at_l(S, labels, L) for L in (1, 4, 16)]
        print(f"{name:10s} prec@1/4/16 = "
              + "/".join(f"{p:.3f}" for p in precs)
              + f"   ({1e3 * dt / corpus.n:.2f} ms/query)")

    # Cascaded serving: wcd prefetch -> rwmd prune -> ACT rescore, with
    # recall against EXACT EMD from an admissible ladder at generous
    # budgets that feeds the host-side LP rescorer.
    top_l, nq = 8, 4
    fast = EmdIndex.build(corpus, EngineConfig(cascade="fast", top_l=top_l),
                          device=device)
    q_ids, q_w = fast.corpus.ids[:nq], fast.corpus.w[:nq]
    t0 = time.perf_counter()
    _, idx_fast = fast.search(q_ids, q_w)
    _sync(device)
    dt = time.perf_counter() - t0
    exact_spec = CascadeSpec(stages=(CascadeStage("rwmd", 0.5),
                                     CascadeStage("act", 0.1, iters=3)),
                             rescorer="emd")
    assert exact_spec.admissible
    _, idx_exact = fast.with_config(cascade=exact_spec).search(q_ids, q_w)
    rows = cascade.stage_rows(cascade.CASCADES["fast"], corpus.n, top_l)
    print(f"\ncascade {cascade.CASCADES['fast'].describe()}  "
          f"(rows/query: {rows})")
    print(f"  recall@{top_l} vs exact EMD "
          f"({exact_spec.describe()}, admissible) = "
          f"{cascade.topk_recall(idx_fast, idx_exact):.3f}   "
          f"({1e3 * dt / nq:.2f} ms/query)")

    # The same call through plain PyTorch ops, and one query at a time.
    kern = EmdIndex.build(corpus, EngineConfig(method="act", iters=3),
                          device=device)
    s_k = kern.scores(kern.corpus.ids[:8], kern.corpus.w[:8])
    s_r = kern.with_config(backend="reference").scores(kern.corpus.ids[:8],
                                                       kern.corpus.w[:8])
    print(f"\nreference backend max |diff| vs {kern.config.backend} "
          f"backend: {float((s_r - s_k).abs().max())}")
    s_s = kern.with_config(batch_engine="scan").scores(kern.corpus.ids[:8],
                                                       kern.corpus.w[:8])
    loop = torch.stack([kern.scores(kern.corpus.ids[u], kern.corpus.w[u])
                        for u in range(8)])
    print("scan engine (a loop of single queries) max |diff| vs batched "
          f"engine: {float((s_s - s_k).abs().max())}; vs the loop: "
          f"{float((s_s - loop).abs().max())}")


if __name__ == "__main__":
    main()
