"""Serving engine with control-plane-driven adaptive batching (the port of
``repro/serving/engine.py``).

This is the paper's §7 machine-learning-inference use case built on the same
decision-workflow machinery: a *batching decision node* trades latency
against utilization (batch big when the queue is deep, small when
latency-bound), and slot claims go through the GlobalController so serving
co-exists with background jobs (Fig. 8 semantics at request granularity).

The engine runs lockstep continuous batching: one prefill per admitted wave
(the whole active set re-prefilled, prompts padded to ``max_seq``), one
decode step over the active batch per step. The reference caches a jitted
program per shape; the port runs eagerly, and every attention core goes
through the port's kernels (K4 in prefill, K5 in decode) on the card.
Prefill and decode run under ``torch.inference_mode()``, so a model whose
parameters ask for gradients (after training) records no graph.

Recurrent layers (Mamba, mLSTM, sLSTM) keep their states in the same
decode state. The prompts are padded to ``max_seq`` with token 0, and the
engine passes each row's real length to ``prefill_step`` (``lengths``):
a recurrent state takes in the row's tokens before its last real one and
none of the pads, an attention cache masks the pads, and every row is
left at its last real token, which the next decode step feeds once. So
every model's tokens are the greedy continuation of its prompt. The
reference's engine prefills without lengths and rewinds the positions
alone, so its recurrent states take in every pad and the last real token
twice. A model with a stub frontend is refused when the engine is built:
the engine feeds token ids only (the reference fails at its first
prefill).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.config import Frontend, ModelConfig
from repro_torch.core.controllers import GlobalController, PrivateController
from repro_torch.core.decisions import (
    Decision,
    DecisionContext,
    DecisionNode,
    Schedule,
)
from repro_torch.device import resolve_device
from repro_torch.models.lm import (
    LM,
    decode_step,
    init_decode_state,
    prefill_step,
)


@dataclass
class Request:
    req_id: int
    tokens: list[int]
    max_new_tokens: int = 16
    arrival: float = field(default_factory=time.monotonic)
    output: list[int] = field(default_factory=list)
    done: bool = False


def batching_decision(ctx: DecisionContext) -> Decision:
    """Adaptive batching (paper §7): large batches amortize weight reads,
    small batches bound latency. Inputs: queue depth, SLO, active load."""
    queue = ctx.app.get("queue_depth", 0)
    slo_ms = ctx.app.get("slo_ms", 200.0)
    per_seq_ms = ctx.profile.get("decode_ms_per_step", 5.0)
    max_batch = ctx.app.get("max_batch", 8)
    # admit up to max_batch, but only as many as keep est. step time in SLO
    affordable = max(1, int(slo_ms / max(per_seq_ms, 1e-3)))
    admit = max(1, min(queue, max_batch, affordable))
    nodes = tuple(ctx.node_status.total_slots) or (0,)
    return Decision("admit", admit, Schedule("packing", nodes),
                    extras=(("affordable", affordable),))


def batching_decision_node() -> DecisionNode:
    return DecisionNode("batching", batching_decision)


def _wait(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Lockstep continuous-batching engine over the port's ``LM``.

    Runs on the card unless the caller passes ``device="cpu"``; the model
    must already live on that device. ``metrics`` adds to the reference's
    counters the host-clock milliseconds of every decode step
    (``decode_ms``, up to the host read of its argmax) and of every wave's
    prefill (``prefill_ms``, up to a device synchronize)."""

    def __init__(self, cfg: ModelConfig, model: LM, max_batch: int = 4,
                 max_seq: int = 128, gc: GlobalController | None = None,
                 slo_ms: float = 200.0, device=None):
        if cfg.frontend != Frontend.TOKENS.value:
            raise ValueError(
                f"{cfg.name} has the {cfg.frontend!r} stub frontend: the "
                f"engine feeds token ids only, and the model's prefill needs "
                f"its frontend's embeddings too")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        where = {p.device for p in model.parameters()}
        if where != {self.device}:
            raise ValueError(f"the model lives on {sorted(map(str, where))}, "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.model = model
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.slo_ms = slo_ms
        self.gc = gc or GlobalController({0: max_batch})
        self.pc = PrivateController("serving", self.gc, priority=10)
        self.node = batching_decision_node()
        self.queue: list[Request] = []
        self.active: list[Request | None] = [None] * max_batch
        self.state = None
        self.metrics = {"steps": 0, "prefills": 0, "generated": 0,
                        "batch_occupancy": [], "decode_ms": [],
                        "prefill_ms": []}
        self._decode = decode_step
        self._prefill = prefill_step
        self._claims = {}

    # -- API -----------------------------------------------------------------

    def submit(self, req: Request):
        self.queue.append(req)

    def run(self, max_steps: int = 256) -> list[Request]:
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.queue and all(r is None for r in self.active):
                break
            self._admit()
            finished.extend(self._step())
        return finished

    # -- internals -------------------------------------------------------------

    def _admit(self):
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free or not self.queue:
            return
        ctx = self.pc.context(app_info={
            "queue_depth": len(self.queue),
            "slo_ms": self.slo_ms,
            "max_batch": len(free),
        })
        ctx.profile = dict(self.pc.profile)
        decision = self.node.decide(ctx)
        n = min(decision.scale, len(free), len(self.queue))
        if n == 0:
            return
        wave = [self.queue.pop(0) for _ in range(n)]
        self._prefill_wave(wave, free[:n])

    def _prefill_wave(self, wave: list[Request], slots: list[int]):
        # lockstep engine: (re)prefill the whole active set so every
        # sequence shares one state (padded to max_seq)
        for req, slot in zip(wave, slots):
            self.active[slot] = req
            self._claims[req.req_id] = self.pc.enact(
                Decision("serve", 1, Schedule("packing", (0,))),
                tag=f"req{req.req_id}")
        t0 = time.perf_counter()
        self._replay_prefill()
        _wait(self.device)
        self.metrics["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
        self.metrics["prefills"] += 1

    def _replay_prefill(self):
        b = self.max_batch
        prompt = np.zeros((b, self.max_seq), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            toks = (req.tokens + req.output)[-self.max_seq:]
            prompt[i, : len(toks)] = toks
            lengths[i] = len(toks)
        # no autograd graph, whether or not the model's parameters ask for
        # gradients (a trained model serves as a frozen one). With the
        # lengths, prefill leaves each row at its last *real* token, which
        # the next decode step feeds: it rewrites that slot's K/V, steps
        # the recurrent states (which took in no pad) and yields the true
        # next-token logits (the padded-position prefill logits are garbage)
        with torch.inference_mode():
            self.state = init_decode_state(self.cfg, b, self.max_seq,
                                           self.device)
            _, self.state = self._prefill(
                self.model, self.state,
                {"tokens": torch.from_numpy(prompt).to(self.device)},
                lengths=torch.from_numpy(lengths).to(self.device))

    def _step(self) -> list[Request]:
        if all(r is None for r in self.active):
            return []
        t0 = time.perf_counter()
        b = self.max_batch
        last = np.zeros((b, 1), np.int32)
        for i, req in enumerate(self.active):
            if req is None:
                continue
            seq = req.tokens + req.output
            last[i, 0] = seq[-1]
        with torch.inference_mode():
            logits, self.state = self._decode(
                self.model, self.state,
                torch.from_numpy(last).to(self.device))
        # the host read of the argmax ends the step (it waits for the device)
        next_tokens = logits[:, 0].argmax(dim=-1).cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.metrics["steps"] += 1
        self.metrics["batch_occupancy"].append(
            sum(r is not None for r in self.active) / b)
        self.metrics["decode_ms"].append(step_ms)
        self.pc.record_profile(decode_ms_per_step=step_ms)

        finished = []
        for i, req in enumerate(self.active):
            if req is None:
                continue
            req.output.append(int(next_tokens[i]))
            self.metrics["generated"] += 1
            total = len(req.tokens) + len(req.output)
            if len(req.output) >= req.max_new_tokens \
                    or total >= self.max_seq:
                req.done = True
                finished.append(req)
                self.active[i] = None
                claim = self._claims.pop(req.req_id, None)
                if claim is not None:
                    self.gc.release(claim)
        return finished
