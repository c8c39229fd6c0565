"""Minimal batched serving engine (continuous-batching style, one card).

Requests arrive with token prompts; each slot feeds its prompt through
teacher-forced decode steps, then decodes greedily until
``max_new_tokens``.  Slots are fixed; a finished slot is refilled from the
queue.  The slot, refill and stop rules are the reference's, traps
included (ROADMAP §3): one ``pos`` is shared by every slot, so a request
refilled mid-run starts at that ``pos`` over its predecessor's KV entries,
conv window and SSM state, and an empty slot goes on decoding its last
token (0 if it never held a request) into the cache.  ``decode_step`` runs
eagerly, one step a token for the whole batch, for every family.

The encoder-decoder (whisper-small) is served as the reference serves it,
traps included (ROADMAP §3): the engine never calls ``prefill``, so the
cross-attention K/V stay zero (a uniform softmax over zero values adds
nothing); the cache is ``init_cache(B, max_seq)``, so ``enc_len`` is
``max_seq`` and the self cache holds ``dec_len_for(max_seq)`` slots,
rolling at ``pos % dec_len`` as the decoder's position embedding wraps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.lsm import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import Params, as_tree


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # int32 [n]
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: Params, batch_size: int = 4,
                 max_seq: int = 128, device=None):
        """``params`` (a ``DecoderLM``, an ``EncDecLM`` or their tree) must
        lie on ``device`` (the card unless the caller asks for the CPU)."""
        self.cfg = cfg
        self.model = build_model(cfg)
        self.device = resolve_device(device)
        leaf = as_tree(params)["embed"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"the parameters lie on {leaf.device}, the "
                             f"engine runs on {self.device}")
        self.params = params
        self.B = batch_size
        self.max_seq = max_seq
        self.steps = 0                # decode steps of the last run

    @torch.inference_mode()
    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        queue = list(requests)
        slots: List[Optional[Request]] = [None] * self.B
        cache = self.model.init_cache(self.B, self.max_seq, device=self.device)
        cur_tok = np.zeros((self.B, 1), np.int32)
        remaining_prompt: List[np.ndarray] = [np.zeros(0, np.int32)] * self.B
        pos = 0
        results: Dict[int, List[int]] = {}

        def refill():
            for i in range(self.B):
                if slots[i] is None and queue:
                    r = queue.pop(0)
                    slots[i] = r
                    cur_tok[i, 0] = r.prompt[0]
                    remaining_prompt[i] = r.prompt[1:]

        refill()
        while any(s is not None for s in slots) and pos < self.max_seq - 1:
            tok = torch.from_numpy(cur_tok).to(self.device, torch.int64)
            logits, cache = self.model.decode_step(self.params, cache, tok, pos)
            nxt = torch.argmax(logits, dim=-1).cpu().numpy()
            pos += 1
            for i, r in enumerate(slots):
                if r is None:
                    continue
                if remaining_prompt[i].size > 0:  # teacher-forced prefill
                    cur_tok[i, 0] = remaining_prompt[i][0]
                    remaining_prompt[i] = remaining_prompt[i][1:]
                else:
                    tok = int(nxt[i])
                    r.output.append(tok)
                    cur_tok[i, 0] = tok
                    if len(r.output) >= r.max_new_tokens:
                        results[r.rid] = r.output
                        slots[i] = None
            refill()
        self.steps = pos
        for r in slots:
            if r is not None:
                results[r.rid] = r.output
        return results
