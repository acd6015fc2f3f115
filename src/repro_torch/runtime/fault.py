"""Fault-tolerant training runtime.

  * checkpoint/restart: on a step failure the driver reloads the latest
    committed checkpoint and resumes; the data stream is a pure function
    of step (`data.tokens`), so the replayed stream is bit-identical;
  * failure injection: `FailureInjector` raises at configured steps
    (tests kill the job mid-run and hold the loss curve to an
    uninterrupted run's);
  * straggler mitigation: per-step wall-time watchdog — steps slower
    than ``straggler_factor`` x the running median are counted and
    passed to ``on_straggler``.

A step's wall time ends at the host read of its loss (the reference's
``block_until_ready``), which waits for the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise SimulatedFailure the first time each listed step runs."""
    at_steps: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.at_steps and step not in self.fired:
            self.fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class RunStats:
    steps: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


def train_loop(*, train_step, params, opt_state, data_stream_fn,
               ckpt: CheckpointManager, total_steps: int,
               injector: FailureInjector | None = None,
               straggler_factor: float = 3.0,
               on_straggler=None, max_restarts: int = 10) -> RunStats:
    """Run to ``total_steps`` with restart-on-failure.

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    data_stream_fn(start_step) -> iterator of (step, batch)
    """
    stats = RunStats()
    state = {"params": params, "opt": opt_state}
    start = 0

    restarts = 0
    while True:
        try:
            for step, batch in data_stream_fn(start):
                if step >= total_steps:
                    return stats
                if injector is not None:
                    injector.check(step)
                t0 = time.perf_counter()
                state["params"], state["opt"], metrics = train_step(
                    state["params"], state["opt"], batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                stats.steps += 1
                stats.losses.append(loss)
                stats.step_times.append(dt)
                med = sorted(stats.step_times)[len(stats.step_times) // 2]
                if len(stats.step_times) > 5 and dt > straggler_factor * med:
                    stats.stragglers += 1
                    if on_straggler is not None:
                        on_straggler(step, dt, med)
                ckpt.maybe_save(step + 1,
                                {"params": state["params"],
                                 "opt": state["opt"]},
                                metadata={"loss": loss})
            return stats
        except SimulatedFailure:
            restarts += 1
            stats.restarts += 1
            if restarts > max_restarts:
                raise
            if latest_step(ckpt.directory) is None:
                start = 0          # no checkpoint yet: restart cold
                continue
            restored, _, step = ckpt.restore_latest(
                {"params": state["params"], "opt": state["opt"]})
            state["params"] = restored["params"]
            state["opt"] = restored["opt"]
            start = step
