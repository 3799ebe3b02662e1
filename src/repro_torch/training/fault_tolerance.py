"""Fault tolerance: checkpoint/restart harness + straggler watchdog (the
reference's `training/fault_tolerance.py`).

The strategy is the reference's: (1) frequent async checkpoints, (2) a
watchdog that aborts a stalled step, (3) automatic restart from the latest
checkpoint, (4) deterministic data skipping so restarts neither replay nor
lose batches.  The harness drives that loop in-process; `FailureInjector`
simulates failures and stragglers for the tests and examples.

Train and solve share one failure vocabulary: `SimulatedFailure` is defined
in `resilience.inject` (re-exported here) next to the solver-side
`FaultSpec`, and `FailureInjector.from_specs` builds the step injector from
the same specs.  The reference waits on each step's loss with
`jax.block_until_ready`; here one host read of the loss a step does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from repro_torch.resilience.inject import SimulatedFailure
from repro_torch.training import checkpoint

__all__ = ["SimulatedFailure", "FailureInjector", "run_resilient"]


@dataclass
class FailureInjector:
    """Raises SimulatedFailure at the given step numbers (once each)."""

    fail_at: tuple = ()
    straggle_at: tuple = ()
    straggle_seconds: float = 0.0
    _fired: set = field(default_factory=set)

    @classmethod
    def from_specs(cls, specs: Iterable, straggle_seconds: float = 0.0):
        """Build the step injector from `resilience.inject.FaultSpec`s.

        Point corruptions (nan/bitflip) become hard step failures — at
        training granularity a poisoned output kills the step — and
        `drop_exchange` (a lost message, i.e. a slow or absent peer) becomes
        a straggler at that step.
        """
        specs = tuple(specs)
        return cls(
            fail_at=tuple(s.iteration for s in specs
                          if s.mode != "drop_exchange"),
            straggle_at=tuple(s.iteration for s in specs
                              if s.mode == "drop_exchange"),
            straggle_seconds=straggle_seconds)

    def check(self, step: int):
        """Sleep at a straggler step, raise at a failure step (once each).
        The sleep comes before `run_resilient` starts the step's clock, as
        in the reference, so the watchdog times the step alone."""
        if step in self.straggle_at and ("s", step) not in self._fired:
            self._fired.add(("s", step))
            time.sleep(self.straggle_seconds)   # straggler: slow step
        if step in self.fail_at and ("f", step) not in self._fired:
            self._fired.add(("f", step))
            raise SimulatedFailure(f"injected failure at step {step}")


def run_resilient(train_step: Callable, state: Any, batch_fn: Callable,
                  num_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                  injector: Optional[FailureInjector] = None,
                  max_restarts: int = 10,
                  step_timeout: Optional[float] = None,
                  on_metrics: Optional[Callable] = None):
    """Run `num_steps` of training surviving injected failures/stragglers.

    batch_fn(step) must be deterministic in `step` (resume-safe data order).
    A restart writes the latest checkpoint back into `state` in place.
    Returns (final_state, history) where history records restarts.
    """
    history = {"restarts": 0, "straggler_aborts": 0, "completed_steps": 0}
    start = int(state["step"])
    step = start
    restarts = 0
    if checkpoint.latest_step(ckpt_dir) is None:
        # anchor checkpoint: a restart before the first periodic save must
        # restore the true initial state (not a partially-advanced one)
        checkpoint.save(ckpt_dir, start, state, blocking=True)
    while step < num_steps:
        try:
            while step < num_steps:
                if injector is not None:
                    injector.check(step)
                t0 = time.monotonic()
                state, metrics = train_step(state, batch_fn(step))
                metrics["loss"].item()      # wait for the step's device work
                dt = time.monotonic() - t0
                if step_timeout is not None and dt > step_timeout:
                    # straggler mitigation: abandon the slow slice and
                    # restart from the last checkpoint
                    history["straggler_aborts"] += 1
                    raise SimulatedFailure(
                        f"step {step} exceeded timeout ({dt:.2f}s)")
                step += 1
                history["completed_steps"] += 1
                if on_metrics is not None:
                    on_metrics(step, metrics)
                if step % ckpt_every == 0:
                    checkpoint.save(ckpt_dir, step, state, blocking=False)
        except SimulatedFailure:
            restarts += 1
            history["restarts"] = restarts
            if restarts > max_restarts:
                raise
            checkpoint.wait_pending()
            last = checkpoint.latest_step(ckpt_dir)
            state = checkpoint.restore(ckpt_dir, last, state)
            step = int(last)
    checkpoint.wait_pending()
    return state, history
