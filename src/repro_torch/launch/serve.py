"""Serving launcher: the reference's ``launch/serve.py`` through the port,
continuous batching over ``--arch`` on one device.

It serves the reduced configs (``reduced=True``, as in the reference) on
the card, or on the CPU with ``--device cpu``, and prints the engine's
counts as its last line.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
        --requests 8
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import LM
from repro_torch.serve import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "serve on the CPU")
    cfg = get_config(args.arch, reduced=True)
    model = LM(cfg, device=args.device)
    eng = Engine(model, model.init(0), lanes=args.lanes,
                 max_seq=args.max_seq)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(rid=i,
                           prompt=list(rng.integers(1, cfg.vocab_size, 6)),
                           max_new=args.max_new))
    eng.run()
    st = eng.stats
    print(f"finished={st.finished} decode_steps={st.decode_steps} "
          f"prefill_tokens={st.prefill_tokens}")


if __name__ == "__main__":
    main()
