"""The paper's own workload: LC-ACT image similarity, MNIST-scale.
n=60,000 images, v=784 pixel coords (717 used), m=2, dense histograms."""
from repro_torch.configs.emd_20news import EMDWorkload

CONFIG = EMDWorkload(name="emd-mnist", n_db=60_000, vocab=784,
                     dim=2, hmax=784, iters=7, queries=1024)
