"""Fault tolerance / straggler mitigation / elastic scaling, PyTorch port.

* ``ResilientLoop`` — step loop with periodic atomic checkpoints, resume
  from the newest committed step, bounded retry on transient step
  failures, and NaN/inf guards (a poisoned step is retried from the last
  checkpoint rather than committed).
* ``StragglerMonitor`` — per-step duration tracking with a robust (median
  + k*MAD) threshold; it flags and records.
* ``elastic_reshard`` — re-place a tree on another mesh's shardings: the
  checkpoint layer stores host arrays, so a job that lost ranks restores
  onto a smaller ``DeviceMesh`` and keeps training.

The loop's state is the JAX package's ``{"values", "opt"}``: here the
values are ``models.values_tree(model)`` (the model's own storage), the
optimizer state holds ``CholFactor``s and a host-int step, and the
checkpoint (``repro_torch.checkpoint``) writes them under the JAX
package's leaf names, so either package resumes the other's run. A
restore copies into the state's tensors, so it loads the model in place.

The port's train step updates its state in place, so a bad step has
already changed it when its metrics are read: only a checkpoint can undo
it. The loop therefore commits its starting state when the directory
holds no checkpoint, and a bad step is always retried from a committed
state. Where the JAX package retries a bad step before its first
checkpoint from the state the step was given, the port goes back to the
start step and replays the steps since, on the same batches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps whose duration exceeds median + k * MAD."""
    k: float = 5.0
    window: int = 50
    _durations: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        hist = self._durations[-self.window:]
        is_straggler = False
        if len(hist) >= 8:
            med = float(np.median(hist))
            mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
            if seconds > med + self.k * mad:
                is_straggler = True
                self.flagged.append((step, seconds, med))
        self._durations.append(seconds)
        return is_straggler


class ResilientLoop:
    """Checkpointed train loop with retry-from-checkpoint on bad steps."""

    def __init__(
        self,
        step_fn: Callable,            # (state, batch) -> (state, metrics)
        batch_fn: Callable,           # step -> batch
        ckpt_dir,
        *,
        ckpt_every: int = 100,
        keep: int = 3,
        max_retries: int = 2,
        is_bad: Optional[Callable] = None,  # metrics -> bool
        monitor: Optional[StragglerMonitor] = None,
    ):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.max_retries = max_retries
        self.is_bad = is_bad or (
            lambda m: not bool(np.isfinite(m.get("loss", 0.0))))
        self.monitor = monitor or StragglerMonitor()

    def resume_or_init(self, init_state):
        last = ckpt.latest_step(self.ckpt_dir)
        if last is None:
            return init_state, 0
        state = ckpt.restore(self.ckpt_dir, last, init_state)
        return state, last

    def run(self, init_state, num_steps: int, *, on_metrics=None):
        state, start = self.resume_or_init(init_state)
        step = start
        if ckpt.latest_step(self.ckpt_dir) is None and step < num_steps:
            ckpt.save(self.ckpt_dir, step, state, keep=self.keep)
        retries = 0
        while step < num_steps:
            batch = self.batch_fn(step)
            t0 = time.time()
            new_state, metrics = self.step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.time() - t0
            self.monitor.record(step, dt)
            if self.is_bad(metrics):
                # Poisoned step: drop it, reload the last good checkpoint.
                retries += 1
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"step {step}: bad metrics {metrics} after "
                        f"{self.max_retries} retries")
                last = ckpt.latest_step(self.ckpt_dir)
                if last is not None:
                    state = ckpt.restore(self.ckpt_dir, last, state)
                    step = last
                continue
            retries = 0
            state = new_state
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            if step % self.ckpt_every == 0 or step == num_steps:
                ckpt.save(self.ckpt_dir, step, state, keep=self.keep)
        return state, step


def elastic_reshard(tree, new_shardings):
    """Re-place a tree of tensors (plain or ``DTensor``) onto a new mesh's
    shardings (a tree of ``sharding.rules.NamedSharding`` of the same
    dicts): each leaf is gathered whole and distributed anew."""
    if isinstance(tree, dict):
        return {k: elastic_reshard(tree[k], new_shardings[k]) for k in tree}
    return new_shardings.place(tree)
