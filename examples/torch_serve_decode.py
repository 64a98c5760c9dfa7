"""Serving driver on the PyTorch/CUDA port: batched prompts decoded token by
token into the decode cache, greedy continuations, then EMD neighbor
retrieval of each generated sequence through the port's ``EmdIndex``.

The same flow and flags as the JAX package's ``examples/serve_decode.py``
(the reduced ``smoke_config`` of ``--arch``), plus ``--device``.

Run: PYTHONPATH=src python examples/torch_serve_decode.py [--arch gemma3-27b]
     [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.api import EmdIndex, EngineConfig
from repro_torch.configs import smoke_config
from repro_torch.core.histogram import docs_to_corpus
from repro_torch.data.synth import make_text_like
from repro_torch.data.tokens import DataConfig, global_batch
from repro_torch.models import model as M


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-27b")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="where the model and the index live (default cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = smoke_config(args.arch)
    model = M.init(cfg, seed=0, device=device)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.prompt_len,
                    global_batch=args.batch, seed=7)
    prompts = torch.as_tensor(global_batch(dc, 0)["tokens"], device=device)
    print(f"{cfg.name} (reduced) on {device}: prefill "
          f"{tuple(prompts.shape)} then decode {args.gen_len} tokens")

    def step(tokens, t, cache):
        return M.decode_step(model, {"tokens": tokens, "cache_index": t},
                             cache)

    total = args.prompt_len + args.gen_len
    t0 = time.perf_counter()
    cache = M.init_decode_cache(cfg, args.batch, total, dtype=torch.float32,
                                device=device)
    # The prompt goes through the decode path token by token, for cache
    # layout parity with the JAX example (prefill returns a compact cache).
    for t in range(args.prompt_len):
        logits, cache = step(prompts[:, t:t + 1], t, cache)
    sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for t in range(args.prompt_len, total):
        out.append(tok)
        logits, cache = step(tok, t, cache)
        tok = logits[:, -1, :].argmax(dim=-1)[:, None]
    sync(device)
    dt = time.perf_counter() - t0

    gen = torch.cat(out, dim=1)
    print(f"prefill(sequential) {t_prefill:.2f}s; decode "
          f"{args.gen_len} x {args.batch} tokens in {dt:.2f}s "
          f"({1e3 * dt / args.gen_len:.1f} ms/token/batch)")
    print("continuations:", gen[:, :8].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")

    # Retrieval stage: the decoded sequences become EMD queries against a
    # document store served by EmdIndex (one build, batched queries).
    store, _ = make_text_like(n_docs=128, vocab=512, m=16, doc_len=40,
                              hmax=24, seed=11)
    index = EmdIndex.build(store, EngineConfig(method="act", iters=2,
                                               top_l=3), device=device)
    seqs = torch.cat([prompts, gen], dim=1).cpu().numpy() % store.v
    queries = docs_to_corpus(list(seqs), store.coords.numpy(), store.hmax)
    t0 = time.perf_counter()
    scores, idx = index.search(queries.ids.to(device),
                               queries.w.to(device))
    sync(device)
    dt_r = time.perf_counter() - t0
    print(f"EMD retrieval over {store.n} docs: "
          f"{1e3 * dt_r / args.batch:.2f} ms/request, "
          f"neighbors={idx.cpu().numpy().tolist()}")
    print("OK")


if __name__ == "__main__":
    main()
