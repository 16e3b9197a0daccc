"""The training path: the reference's ``train/`` in PyTorch (optimizer,
step, data, checkpoint).  Imports ``torch`` and ``numpy``, nothing of
``repro`` or JAX."""

from repro_torch.train.checkpoint import (latest_step, restore,
                                          restore_into, save)
from repro_torch.train.data import Prefetcher, SyntheticLM
from repro_torch.train.optimizer import (TrainState, abstract_state,
                                         adamw_update, init_state,
                                         lr_schedule, state_pspecs,
                                         zero1_spec)
from repro_torch.train.step import make_train_step

__all__ = ["latest_step", "restore", "restore_into", "save", "Prefetcher",
           "SyntheticLM", "TrainState", "abstract_state", "adamw_update",
           "init_state", "lr_schedule", "state_pspecs", "zero1_spec",
           "make_train_step"]
