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
``seq_len >= max_seq - 1``.

Attention-free archs (rwkv6) get **session state parking**: ``park``
copies a lane's state out of the cache and ``resume`` puts it back into a
free lane without re-prefilling.  By default the state stays in an
in-process dict.  With a ``repro_torch.serve.session_store.KVSessionStore``
as ``session_store`` the state's bytes travel through the Outback KVS, in
the reference's byte order (the order of ``jax.tree.flatten``, which sorts
dict keys: ``length`` first, then ``stages``, ``ffn`` before ``mixer``),
so the same parks give the same chunk values, meters and MN images; the
per-leaf structure stays on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.models.common import sorted_leaves, tree_map
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
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.eos = eos_id
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        # over a mesh with a data axis, ``lanes`` are the whole mesh's and
        # this rank serves its share of them
        self.cache = model.init_cache(lanes, max_seq)
        self.lanes = int(self.cache["length"].shape[0])
        self.active: list[Request | None] = [None] * self.lanes
        self.pending: list[Request] = []
        self.to_prefill: list[tuple[int, list[int]]] = []  # (lane, tokens)
        self.stats = EngineStats()
        self.parked_states: dict[int, dict] = {}
        self.session_store = session_store  # optional KVSessionStore
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
                    if self.session_store is not None:
                        # reclaim any parked blob this session left behind
                        self.session_store.delete(req.rid)

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
        """Copy a lane's state out of the cache and free the lane.

        With a ``session_store`` the state's bytes go through the Outback
        KVS (one copy to the host); otherwise the state stays in an
        in-process dict."""
        req = self.active[lane]
        if req is None:
            raise ValueError(f"lane {lane} holds no request")
        state = tree_map(lambda c: (c[:, lane] if c.dim() >= 2
                                    else c[lane]).clone(), self.cache)
        if self.session_store is not None:
            paths, leaves = zip(*sorted_leaves(state))
            self.session_store.put(req.rid, _to_bytes(leaves))
            meta = [(tuple(x.shape), x.dtype, x.numel() * x.element_size())
                    for x in leaves]
            self.parked_states[req.rid] = {"paths": paths, "meta": meta,
                                           "req": req}
        else:
            self.parked_states[req.rid] = {"state": state, "req": req}
        self.active[lane] = None
        self.stats.parked += 1
        return req.rid

    def resume(self, rid: int) -> int:
        entry = self.parked_states[rid]
        if self.session_store is not None:
            blob = self.session_store.get(rid)
            if blob is None:  # keep the metadata so a retry can succeed
                raise KeyError(f"session {rid} lost from the KVS")
            leaves = _from_bytes(blob, entry["meta"], self.model.device)
            # The blob stays put: a re-park of this rid overwrites the same
            # chunk keys in place (insert resolves to update), and repeat
            # resumes keep hitting the CN cache.  Reclaimed on finish.
            placed = list(zip(entry["paths"], leaves))
        else:
            placed = sorted_leaves(entry["state"])
        del self.parked_states[rid]
        lane = next(ln for ln in range(self.lanes) if self.active[ln] is None)
        self._reset_lane(lane)
        for path, s in placed:
            c = _at(self.cache, path)
            if c.dim() >= 2:
                c[:, lane] = s
            else:
                c[lane] = s
        self.active[lane] = entry["req"]
        self.stats.resumed += 1
        return lane


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _to_bytes(leaves) -> bytes:
    """The leaves' bytes back to back (native byte order, as numpy's
    ``tobytes``), in one copy to the host; a bf16 leaf gives its bits."""
    flat = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in leaves])
    return flat.cpu().numpy().tobytes()


def _from_bytes(blob: bytes, meta, device) -> list:
    """Inverse of :func:`_to_bytes`: the leaves of ``meta``'s shapes and
    torch dtypes, on ``device`` (one copy from the host)."""
    buf = torch.frombuffer(bytearray(blob), dtype=torch.uint8).to(device)
    out, off = [], 0
    for shape, dtype, nbytes in meta:
        # a clone starts each leaf at offset 0, as ``view(dtype)`` needs
        out.append(buf[off:off + nbytes].clone().view(dtype).reshape(shape))
        off += nbytes
    return out
