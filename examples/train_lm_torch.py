"""End-to-end training run through the PyTorch port: ~100M-param
llama-style model, a few hundred steps on synthetic data, with
checkpoint/restart mid-run (fault tolerance).  The counterpart of
``examples/train_lm.py``; it runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300] \\
        [--d-model 256] [--device cuda]
"""

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.models.common import count_params
from repro_torch.models.lm import LM
from repro_torch.train import (Prefetcher, SyntheticLM, init_state,
                               latest_step, make_train_step, restore, save)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    # ~100M params: scale the llama3.2-1b family down
    cfg = dataclasses.replace(
        get_config("llama3.2-1b"), num_layers=8, d_model=args.d_model,
        num_heads=8, num_kv_heads=4, head_dim=args.d_model // 8,
        d_ff=4 * args.d_model, vocab_size=32768)
    model = LM(cfg, device=args.device)
    print(f"model: {count_params(model.init(0)) / 1e6:.1f}M params")

    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=20,
                       learning_rate=3e-4, checkpoint_every=100)
    state = init_state(model.init(0))
    step_fn = make_train_step(model, tcfg)
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch)
    pipe = Prefetcher(src)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")

    def run_until(state, stop):
        pipe.seek(int(state.step))
        while int(state.step) < stop:
            state, m = step_fn(state, pipe.get())
            s = int(m["step"])
            if s % 50 == 0 or s == 1:
                print(f"step {s:4d}  loss {float(m['loss']):.4f}  "
                      f"gnorm {float(m['gnorm']):.3f}")
            if s % tcfg.checkpoint_every == 0:
                save(ckpt_dir, s, state.tree())
        return state

    half = args.steps // 2
    state = run_until(state, half)
    save(ckpt_dir, int(state.step), state.tree())
    print(f"-- simulated failure at step {int(state.step)}; restarting from "
          f"checkpoint {latest_step(ckpt_dir)} --")
    restored = restore(ckpt_dir, state.tree())
    state = init_state(model.init(0))  # fresh process stand-in
    state = dataclasses.replace(
        state, params=restored["params"], m=restored["m"], v=restored["v"],
        step=restored["step"])
    state = run_until(state, args.steps)
    print(f"done at step {int(state.step)}; data pipeline stats: "
          f"{pipe.stats}")
    return state


if __name__ == "__main__":
    main()
