"""Continuous-batching serving engine: the reference's ``serve/engine.py``
in PyTorch.

Fixed-lane decode batch over the model's cache API: new requests claim free
lanes and are prefilled token by token into the lane's cache region, then
join the decode batch; finished lanes free immediately for the next request
(continuous batching).  The step runs eagerly, on the model's device.

The semantics are the reference's, quirks included: a lane's last prompt
token is fed twice (once in prefill, once as its first decode token); a
batched decode step writes every lane's cache and advances every length,
lanes still prefilling and idle lanes too; a prefill token runs a
whole-batch step and merges back its own lane; a request finishes at
``seq_len >= max_seq - 1``.  ``park``/``resume`` keep a lane's state in an
in-process dict; parking through the KVS (``session_store=``) is not yet
ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.models.common import tree_map
from repro_torch.models.lm import LM


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    decode_steps: int = 0
    finished: int = 0
    parked: int = 0
    resumed: int = 0


class Engine:
    def __init__(self, model: LM, params, *, lanes: int = 4,
                 max_seq: int = 256, sampler: Callable | None = None,
                 eos_id: int | None = None, session_store=None):
        if session_store is not None:
            raise NotImplementedError("session_store= (parking through the "
                                      "KVS) is not yet ported")
        self.model = model
        self.params = params
        self.lanes = lanes
        self.max_seq = max_seq
        self.eos = eos_id
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.cache = model.init_cache(lanes, max_seq)
        self.active: list[Request | None] = [None] * lanes
        self.pending: list[Request] = []
        self.to_prefill: list[tuple[int, list[int]]] = []  # (lane, tokens)
        self.stats = EngineStats()
        self.parked_states: dict[int, dict] = {}
        self._step = model.decode_step

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _admit(self) -> None:
        for lane in range(self.lanes):
            if self.active[lane] is None and self.pending:
                req = self.pending.pop(0)
                self.active[lane] = req
                self._reset_lane(lane)
                self.to_prefill.append((lane, list(req.prompt)))

    def _reset_lane(self, lane: int) -> None:
        # zero the lane across the cache tree (the batch dim is the dim
        # right after the layer-stack dim); in place: nothing else holds
        # the engine's cache tensors
        def zero_lane(c):
            c[:, lane] = 0

        tree_map(zero_lane, self.cache["stages"])
        self.cache["length"][lane] = 0

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(tokens).to(self.model.device)

    # -------------------------------------------------------------- stepping
    def step(self) -> None:
        """One engine iteration: prefill a chunk of queued tokens, then one
        decode step for all lanes holding live sequences."""
        self._admit()
        still = []
        for lane, toks in self.to_prefill:
            n = min(8, len(toks))
            for t in toks[:n]:
                self._decode_lane_token(lane, t)
                self.stats.prefill_tokens += 1
            if len(toks) > n:
                still.append((lane, toks[n:]))
        self.to_prefill = still
        prefilling = {lane for lane, _ in self.to_prefill}

        # batched decode for lanes that are past prefill
        live = [ln for ln in range(self.lanes)
                if self.active[ln] is not None and ln not in prefilling]
        if live:
            tokens = np.zeros((self.lanes, 1), np.int32)
            for ln in live:
                req = self.active[ln]
                tokens[ln, 0] = (req.out[-1] if req.out else req.prompt[-1])
            logits, self.cache = self._step(self.params, self._tokens(tokens),
                                            self.cache)
            nxt = self.sampler(logits).tolist()
            lengths = self.cache["length"].tolist()
            self.stats.decode_steps += 1
            for ln in live:
                req = self.active[ln]
                tok = int(nxt[ln])
                req.out.append(tok)
                if (len(req.out) >= req.max_new
                        or (self.eos is not None and tok == self.eos)
                        or lengths[ln] >= self.max_seq - 1):
                    req.done = True
                    self.stats.finished += 1
                    self.active[ln] = None

    def _decode_lane_token(self, lane: int, tok: int) -> None:
        tokens = np.zeros((self.lanes, 1), np.int32)
        tokens[lane, 0] = tok
        # freeze other lanes: a whole-batch step, then only this lane's
        # cache and length are kept
        before = self.cache["length"]
        _, cache = self._step(self.params, self._tokens(tokens), self.cache)
        keep = torch.arange(self.lanes, device=before.device) == lane

        def merge(new, old):
            return torch.where(
                keep.view((1, self.lanes) + (1,) * (new.dim() - 2)), new, old)

        self.cache = {"stages": tree_map(merge, cache["stages"],
                                         self.cache["stages"]),
                      "length": torch.where(keep, before + 1, before)}

    def run(self, max_iters: int = 1000) -> None:
        it = 0
        while (any(self.active) or self.pending or self.to_prefill) \
                and it < max_iters:
            self.step()
            it += 1

    # ------------------------------------------------ session parking
    def park(self, lane: int) -> int:
        """Copy a lane's state out of the cache into an in-process dict and
        free the lane."""
        req = self.active[lane]
        if req is None:
            raise ValueError(f"lane {lane} holds no request")
        state = tree_map(lambda c: (c[:, lane] if c.dim() >= 2
                                    else c[lane]).clone(), self.cache)
        self.parked_states[req.rid] = {"state": state, "req": req}
        self.active[lane] = None
        self.stats.parked += 1
        return req.rid

    def resume(self, rid: int) -> int:
        entry = self.parked_states.pop(rid)
        lane = next(ln for ln in range(self.lanes) if self.active[ln] is None)
        self._reset_lane(lane)

        def put(c, s):
            if c.dim() >= 2:
                c[:, lane] = s
            else:
                c[lane] = s

        tree_map(put, self.cache, entry["state"])
        self.active[lane] = entry["req"]
        self.stats.resumed += 1
        return lane
