"""The mesh with its ranks on the card: a 2 x 2 gloo mesh whose four ranks
share one CUDA device and launch the kernels on their shards, against the
single-card cuda index on the same corpus.

Needs a CUDA device and ``nvcc``; skips without them. This file imports no
JAX: on the card the reference is the port's own single-card index, bitwise
for act, rwmd, omr and the ``chain`` cascade, within float32 rtol 1e-5 /
atol 1e-6 for the rest (``chip_smoke.py`` phase 12 says why).
"""
import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.api import EmdIndex, EngineConfig, corpus_from_numpy
from repro_torch.data.synth import make_text_like
from repro_torch.launch.local import run_local

BITWISE = ("act", "rwmd", "omr")
TOP_L, PAD = 4, 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks launch the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mesh_ranks_on_the_card_match_the_single_card_index(cuda):
    c, _ = make_text_like(n_docs=120, n_classes=4, vocab=256, m=16,
                          doc_len=20, hmax=32, seed=1)
    arrays = tuple(x.numpy() for x in (c.ids, c.w, c.coords))
    qi, qw = arrays[0][:6], arrays[1][:6]
    res = run_local(ranks.index_suite, 2, 2, backend="gloo", device="cuda",
                    args=(arrays, qi, qw, TOP_L, PAD), timeout=300)[0]
    corpus = corpus_from_numpy(*arrays, cuda)
    q = (torch.tensor(qi, device=cuda), torch.tensor(qw, device=cuda))
    for method in ("act", "rwmd", "omr", "rwmd_rev", "ict"):
        index = EmdIndex.build(corpus, EngineConfig(method=method, iters=3,
                                                    top_l=TOP_L),
                               device=cuda)
        want = index.scores(*q).cpu().numpy()
        got = res[f"scores:{method}"]
        if method in BITWISE:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    index = EmdIndex.build(corpus, EngineConfig(method="act", iters=3,
                                                top_l=TOP_L), device=cuda)
    s, i = index.search(*q, cascade="chain")
    np.testing.assert_array_equal(res["cascade:chain"][0], s.cpu().numpy())
    np.testing.assert_array_equal(res["cascade:chain"][1], i.cpu().numpy())


@pytest.mark.cuda
def test_implicit_meshes_on_the_card_then_the_cpu_in_one_process(cuda):
    """Two distributed builds without a mesh, the first on the card (NCCL's
    device) and the second on the CPU (gloo's), in one process: neither
    leaves a process group behind, so the second is not refused."""
    import torch.distributed as dist
    c, _ = make_text_like(n_docs=40, n_classes=4, vocab=128, m=8,
                          doc_len=10, hmax=16, seed=3)
    arrays = tuple(x.numpy() for x in (c.ids, c.w, c.coords))
    cfg = EngineConfig(backend="distributed", method="act", iters=3,
                       top_l=TOP_L)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        index = EmdIndex.build(corpus_from_numpy(*arrays, dev), cfg,
                               device=dev)
        assert index.device.type == dev.type
        out[dev.type] = index.scores(torch.tensor(arrays[0][:4]),
                                     torch.tensor(arrays[1][:4])).cpu()
        assert not dist.is_initialized()
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-5, atol=1e-6)
