"""Serving example through the PyTorch port: continuous batching + the
Ludo-paged KV cache demo.  The counterpart of ``examples/serve_kvs.py``;
it runs on the card unless ``--device cpu``.

Part 1 serves batched requests through the engine (its decode steps go
through ``fused_norm_matmul``); part 2 runs the paper's technique on the
serving side: a Ludo page table drives paged flash-decode attention,
compared with the 2-fetch cuckoo baseline (same outputs, 2x the page
DMA), through the ``paged_attention`` and ``cuckoo_paged_attention``
kernels on the card (their plain versions on the CPU).

    PYTHONPATH=src python examples/serve_kvs_torch.py [--device cuda]
"""

import argparse

import numpy as np
import torch

from repro_torch.cache import CuckooPageTable, LudoPageTable
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "run on the CPU")
    dev = torch.device(args.device)

    # ---- part 1: continuous-batching engine -------------------------------
    cfg = get_config("llama3.2-1b", reduced=True)
    model = LM(cfg, device=dev)
    eng = Engine(model, model.init(0), lanes=4, max_seq=96)
    rng = np.random.default_rng(0)
    for i in range(10):
        eng.submit(Request(rid=i,
                           prompt=list(rng.integers(1, cfg.vocab_size, 5)),
                           max_new=8))
    eng.run()
    print(f"served {eng.stats.finished} requests in "
          f"{eng.stats.decode_steps} decode steps "
          f"({eng.stats.prefill_tokens} prefill tokens)")

    # ---- part 2: Ludo-paged attention vs cuckoo baseline -------------------
    n_kv, g, d, ps, L = 2, 4, 64, 16, 8
    pool = 256
    lt = LudoPageTable(pool, device=dev)
    ct = CuckooPageTable(pool, device=dev)
    for l in range(L):
        lt.append_page(7, l)
        ct.append_page(7, l)
    pm, ok = lt.lookup_batch(7, L)
    pm2, sel = ct.lookup2_batch(7, L)
    q = torch.as_tensor(rng.standard_normal((n_kv, g, d)),
                        dtype=torch.float32, device=dev)
    k = torch.as_tensor(rng.standard_normal((pool, ps, n_kv, d)),
                        dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.standard_normal((pool, ps, n_kv, d)),
                        dtype=torch.float32, device=dev)
    o1, _, _ = ops.paged_attention(q, k, v, pm, L * ps)
    o2, _, _ = ops.cuckoo_paged_attention(q, k, v, pm2, sel, L * ps)
    page_bytes = 2 * ps * n_kv * d * 4
    match = bool(np.allclose(o1.cpu().numpy(), o2.cpu().numpy(), atol=1e-5))
    print(f"paged attention: outputs match = {match}")
    print(f"index DMA per step: ludo {L * page_bytes / 1e3:.0f} KB "
          f"(exact pages) vs cuckoo {2 * L * page_bytes / 1e3:.0f} KB (2x)")
    print(f"page-table memory: ludo CN {lt.cn_bits_per_page():.2f} bits/page "
          f"vs cuckoo {ct.table_bits_per_page():.1f} bits/page")
    print(f"kernel launches: {dict(ops.LAUNCHES)}")
    return dict(finished=eng.stats.finished, outputs_match=match,
                pages_found=bool(ok.all()))


if __name__ == "__main__":
    main()
