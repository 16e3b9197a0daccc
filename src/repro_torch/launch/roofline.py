"""Roofline of one rank's step on the H100: the reference's
``launch/roofline.py`` on this card's constants.

Three terms per (arch x shape x mesh) cell, from the counts of
``launch/hlo_analysis.py`` (one rank's program, traced by
``launch/dryrun.py``):

    compute_s    = FLOPs            / 989e12  FLOP/s (bf16, dense)
    memory_s     = bytes            / 3.35e12 B/s    (HBM3)
    collective_s = collective bytes / 50e9    B/s    (one 400 Gb/s link)

``PEAK_FLOPS`` and ``HBM_BW`` are the H100 SXM data sheet's at its full
700 W.  ``LINK_BW`` is published, not measured (the port has run on one
card only): the 400 Gb/s NDR InfiniBand link of each card, which a ``(16,
16)`` mesh's groups cross between nodes of 8 cards; NVLink within a node
is faster, so the term is an upper bound for a group inside a node.

MODEL_FLOPS = 6*N*D (train), 2*N*D (prefill) or 2*N*B (decode), with N
the dense parameters plus the active share of the experts (embeddings
excluded) from the port's ``param_template``, D the tokens of a step;
MODEL_FLOPS / counted FLOPs exposes remat and other redundant work.

What differs from the reference: there is no compiled artifact, so
:class:`Roofline` has no ``raw_xla_flops`` / ``raw_xla_bytes`` (XLA's
uncorrected ``cost_analysis``), and :func:`analyse` takes the counter's
cost rather than a compiled module.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.common import sorted_leaves

PEAK_FLOPS = 989e12  # bf16 dense / card
HBM_BW = 3.35e12  # B/s / card
LINK_BW = 50e9  # B/s / card, published, not measured


@dataclasses.dataclass
class Roofline:
    flops: float  # per rank
    hbm_bytes: float  # per rank
    coll_bytes: float  # per rank
    coll_by_kind: dict
    chips: int
    model_flops: float  # whole step, all ranks
    hbm_bytes_upper: float = 0.0  # op-materialized upper bound

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        t = self.step_time_s
        return (self.model_flops / (self.chips * PEAK_FLOPS * t)) if t else 0.0

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "coll_by_kind": self.coll_by_kind,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
            "hbm_bytes_upper": self.hbm_bytes_upper,
        }


def analyse(cost, *, chips: int, model_flops: float) -> Roofline:
    """The three terms of ``cost`` (an ``hlo_analysis.HloCost`` of one
    rank's step)."""
    return Roofline(flops=cost.flops, hbm_bytes=cost.bytes,
                    coll_bytes=cost.coll_total,
                    coll_by_kind={k: int(v) for k, v in
                                  cost.coll_bytes.items()},
                    chips=chips, model_flops=model_flops,
                    hbm_bytes_upper=cost.bytes_upper)


# --------------------------------------------------------- MODEL_FLOPS
def model_flops_for(cfg, shape, n_params_dense: float,
                    n_params_expert: float) -> float:
    """6*N_active*D; decode steps process 1 token per sequence."""
    if cfg.moe is not None:
        frac = (cfg.moe.top_k + cfg.moe.num_shared) / cfg.moe.num_experts
        n_active = n_params_dense + n_params_expert * frac
    else:
        n_active = n_params_dense
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token per sequence
        return 2.0 * n_active * tokens  # forward only
    tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0  # fwd+bwd vs fwd
    return mult * n_active * tokens


def count_params_split(template, leaf_cls) -> tuple[float, float]:
    """(dense_params, expert_params) from a param template, embeddings and
    router excluded from 'dense', expert tensors counted separately."""
    dense = expert = 0.0
    for names, lf in sorted_leaves(template):
        if not isinstance(lf, leaf_cls):
            continue
        n = float(np.prod(lf.shape))
        if any(k in names for k in ("embed", "lm_head")):
            continue
        if names[-1] in ("w_gate", "w_up", "w_down") and len(lf.shape) == 4:
            expert += n  # stacked (L, E, d, f) expert tensors
        else:
            dense += n
    return dense, expert
