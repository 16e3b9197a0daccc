"""Training launcher: the reference's ``launch/train.py`` through the port,
on one device.

It runs the reduced configs end to end (real steps) on the card, or on the
CPU with ``--device cpu``.  The step updates its state in place
(``make_train_step(..., inplace=True)``), as the reference donates the
state to its jitted step (``donate_argnums=0``); ``--resume`` restores
into the state's own tensors, and a checkpoint reads every leaf to the
host before the next step.  As in the reference, ``--reduced`` is always on
(``store_true`` with ``default=True``), so the full configs are not
reachable from this entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 50 --reduced
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.models.lm import LM
from repro_torch.train import (Prefetcher, SyntheticLM, init_state,
                               latest_step, make_train_step, restore_into,
                               save)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "train on the CPU")
    cfg = get_config(args.arch, reduced=args.reduced)
    model = LM(cfg, device=args.device)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=5,
                       microbatch=args.microbatch)
    state = init_state(model.init(0))
    if args.resume and args.checkpoint_dir and latest_step(args.checkpoint_dir):
        restore_into(args.checkpoint_dir, state.tree())
        print(f"resumed from step {int(state.step)}")
    # the state is donated to the step, as the reference's
    step_fn = make_train_step(model, tcfg, inplace=True)
    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                      frontend=("vision" if cfg.vision_tokens else
                                "audio" if cfg.is_encdec else None),
                      d_model=cfg.d_model,
                      aux_len=cfg.vision_tokens or cfg.encoder_seq)
    pipe = Prefetcher(src)
    pipe.seek(int(state.step))
    while int(state.step) < args.steps:
        state, m = step_fn(state, pipe.get())
        s = int(m["step"])
        if s % 10 == 0 or s == 1:
            print(f"step {s:4d}  loss {float(m['loss']):.4f}")
        if args.checkpoint_dir and s % tcfg.checkpoint_every == 0:
            save(args.checkpoint_dir, s, state.tree())
    if args.checkpoint_dir:
        save(args.checkpoint_dir, int(state.step), state.tree())
    print("done")


if __name__ == "__main__":
    main()
