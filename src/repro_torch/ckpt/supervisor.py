"""Training supervisor: restart-on-failure, straggler watchdog, elastic hooks
(the port of ``repro/ckpt/supervisor.py``).

The supervisor owns the outer loop of a production run:

  * checkpoint every K steps (async), restore on any step failure
    (simulating node loss — tests inject faults),
  * per-step wall-time watchdog: steps slower than ``straggler_factor`` x the
    trailing median are recorded as straggler events and surfaced to a
    re-layout decision node (the control-plane hook: at scale the decision
    is typically "checkpoint + restart without the slow host"),
  * elastic rescale: because checkpoints hold whole leaves, a restore under
    other sharding rules re-shards onto a different mesh — the
    restart-smaller/-larger path for node failures/additions.

Where the port differs from the reference, and why:

  * **The restart point is a checkpoint this run wrote.** ``run`` writes
    the state it starts from as step ``start_step``'s checkpoint (unless
    that checkpoint is already there: a resumed run) before its first
    step, and a failure restores the newest step this run saved. The
    reference restarts a failure before its first checkpoint from the
    state the failed step left (its ``step = start_step`` keeps
    ``state``), which a step that updates in place, as the port's train
    step does, has already advanced. A host copy of the starting state
    would do too, but would hold a second train state in host memory for
    the whole run (45 GB for llama3.2-3b's), where the checkpoint costs
    one write and survives the process.
  * **A restore copies into the live state in place**
    (``load_checkpoint(like=state)``), so what a step that failed halfway
    through its in-place update left behind is overwritten.
  * **A step is timed to its end on the device.** The port's steps return
    before the card finishes; a step that reads a metric (a logging step)
    would drain the queue and look like a straggler. The watchdog's clock
    stops after a synchronize of the state's device.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.ckpt.checkpoint import AsyncCheckpointer, load_checkpoint
from repro_torch.core.decisions import Decision, DecisionContext, \
    DecisionNode, Schedule
from repro_torch.models.lm import LM
from repro_torch.parallel.sharding import current_rules


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float


def relayout_decision(ctx: DecisionContext) -> Decision:
    """Default straggler response: if slowdowns persist, restart from the
    last checkpoint excluding the slow node (scale-down by one)."""
    events = ctx.profile.get("straggler_events", 0)
    nodes = tuple(ctx.node_status.total_slots)
    if events >= 3:
        return Decision("restart_excluding_stragglers", max(1, len(nodes) - 1),
                        Schedule("round-robin", nodes[:-1] or nodes))
    return Decision("continue", len(nodes), Schedule("round-robin", nodes))


def _device_of(state) -> torch.device | None:
    """The device of the first tensor in ``state`` (``None`` without
    one)."""
    if isinstance(state, LM):
        return next(state.parameters()).device
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, (dict, list, tuple)):
        for v in (state.values() if isinstance(state, dict) else state):
            found = _device_of(v)
            if found is not None:
                return found
    return None


def _sync(state) -> None:
    device = _device_of(state)
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Supervisor:
    step_fn: Callable[[Any, Any], tuple[Any, dict]]
    batch_fn: Callable[[int], Any]
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    max_restarts: int = 5

    step_times: list[float] = field(default_factory=list)
    stragglers: list[StragglerEvent] = field(default_factory=list)
    restarts: int = 0
    # the seconds of each restore's ``load_checkpoint``
    restore_seconds: list[float] = field(default_factory=list)
    relayout_node: DecisionNode = field(
        default_factory=lambda: DecisionNode("relayout", relayout_decision))
    # the sharding rules the state is laid out under (the current
    # ``use_rules`` context's by default); under rules that split it over
    # ranks every rank runs the supervisor, and a fault is raised on every
    # rank at the same step
    rules: Any = None
    # the run's AsyncCheckpointer (its ``stats``), kept after ``run``
    checkpointer: AsyncCheckpointer | None = None

    def run(self, state: Any, num_steps: int, start_step: int = 0,
            fault_hook: Callable[[int], None] | None = None) -> tuple[Any,
                                                                      int]:
        """Run ``num_steps`` with checkpoint/restart. Returns (state, step).

        ``fault_hook(step)`` may raise to simulate node failure; the
        supervisor restores the newest checkpoint this run wrote (the
        starting state's, before the first periodic one) into ``state``
        and continues.
        """
        rules = current_rules() if self.rules is None else self.rules
        ckpt = AsyncCheckpointer(self.ckpt_dir, keep=self.keep, rules=rules)
        self.checkpointer = ckpt
        step = start_step
        saved = start_step
        try:
            if not (Path(self.ckpt_dir) / f"step_{start_step:09d}").is_dir():
                ckpt.save(start_step, state, {"step": start_step})
            while step < num_steps:
                try:
                    if fault_hook is not None:
                        fault_hook(step)
                    t0 = time.perf_counter()
                    batch = self.batch_fn(step)
                    state, metrics = self.step_fn(state, batch)
                    _sync(state)
                    dt = time.perf_counter() - t0
                    self._watch(step, dt)
                    step += 1
                    if step % self.ckpt_every == 0:
                        ckpt.save(step, state, {"step": step})
                        saved = step
                except KeyboardInterrupt:
                    raise
                except Exception:  # noqa: BLE001 - node-failure path
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        raise
                    ckpt.wait()
                    t0 = time.perf_counter()
                    state, extra = load_checkpoint(self.ckpt_dir, step=saved,
                                                   like=state, rules=rules)
                    _sync(state)
                    self.restore_seconds.append(time.perf_counter() - t0)
                    step = extra.get("step", saved)
            if saved != step:
                ckpt.save(step, state, {"step": step})
            ckpt.wait()
        finally:
            ckpt.close()
        return state, step

    def _watch(self, step: int, dt: float):
        self.step_times.append(dt)
        window = self.step_times[-21:-1]
        if len(window) >= 5:
            med = statistics.median(window)
            # ignore sub-50ms jitter: straggler detection targets real steps
            if dt > self.straggler_factor * med and dt > 0.05:
                self.stragglers.append(StragglerEvent(step, dt, med))
