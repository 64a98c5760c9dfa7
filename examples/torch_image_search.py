"""Dense-histogram image search on the PyTorch/CUDA port: the RWMD failure
mode and its fix.

MNIST-like blobs WITH background (all supports overlap): RWMD collapses to
0 for every pair (paper Table 6: precision at chance); OMR and ACT restore
the ranking at the same linear complexity. Serving queries run the
cascaded prune-and-rescore path with a ladder matched to the domain (the
dense cascade prunes with OMR, never with the collapsed RWMD), with recall
against exact EMD.

Run: PYTHONPATH=src python examples/torch_image_search.py [--device cpu]
"""
import argparse

import torch

from repro_torch import cascade
from repro_torch.api import EmdIndex, EngineConfig
from repro_torch.cascade import CascadeSpec, CascadeStage
from repro_torch.data.synth import make_image_like


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default cuda)")
    ap.add_argument("--n-images", type=int, default=96,
                    help="images per corpus (default 96)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    for background in (False, True):
        corpus, labels = make_image_like(n_images=args.n_images, n_classes=6,
                                         side=12,
                                         include_background=background,
                                         seed=4)
        tag = "dense (with background)" if background else "sparse"
        print(f"\n=== {tag}: n={corpus.n} bins/histogram={corpus.hmax} "
              f"on {device} ===")
        base = EmdIndex.build(corpus, EngineConfig(method="rwmd"),
                              device=device)
        rw = base.scores(base.corpus.ids[0], base.corpus.w[0])
        print(f"RWMD scores vs doc 0: min={float(rw.min()):.5f} "
              f"max={float(rw.max()):.5f}"
              + ("   <- ALL ZERO: full support overlap" if background
                 else ""))
        for name, method, iters in [("RWMD", "rwmd", 0), ("OMR", "omr", 0),
                                    ("ACT-7", "act", 7)]:
            index = base.with_config(method=method, iters=iters)
            p = index.precision_at_l(labels, 8)
            chance = 1.0 / (int(labels.max()) + 1)
            note = "  (~chance!)" if abs(p - chance) < 0.08 else ""
            print(f"  {name:6s} precision@8 = {p:.3f}{note}")

        # Cascaded serving + recall vs exact EMD: sparse supports keep the
        # per-pair LP cheap enough for full exact scoring; on dense
        # histograms the exact reference itself runs as an admissible
        # cascade (OMR/ACT prune, host-side LP rescore).
        top_l, nq = 6, 3
        q_ids, q_w = base.corpus.ids[:nq], base.corpus.w[:nq]
        if background:
            spec = CascadeSpec(stages=(CascadeStage("omr", 0.33),),
                               rescorer="act", rescorer_iters=7)
            exact_spec = CascadeSpec(
                stages=(CascadeStage("omr", 0.25),
                        CascadeStage("act", 8, iters=7)),
                rescorer="emd")
        else:
            spec = CascadeSpec(stages=(CascadeStage("wcd", 0.5),
                                       CascadeStage("rwmd", 0.25)),
                               rescorer="act", rescorer_iters=7)
            exact_spec = CascadeSpec(stages=(CascadeStage("rwmd", corpus.n),),
                                     rescorer="emd")   # full exact EMD
        assert exact_spec.admissible
        _, idx = base.search(q_ids, q_w, top_l, cascade=spec)
        _, idx_exact = base.search(q_ids, q_w, top_l, cascade=exact_spec)
        print(f"  cascade {spec.describe()}: recall@{top_l} vs exact EMD "
              f"({exact_spec.describe()}) = "
              f"{cascade.topk_recall(idx, idx_exact):.3f}")


if __name__ == "__main__":
    main()
