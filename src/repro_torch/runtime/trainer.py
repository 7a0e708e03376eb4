"""Fault-tolerant training loop, the port of ``repro.runtime.trainer``.

  * Checkpoint/restart: periodic async checkpoints of (train state, loader
    state); on start the trainer resumes from the newest step that restores.
  * Step-level fault tolerance: a failing step (a CUDA error, a non-finite
    loss when ``abort_on_nan``, an injected fault) restores the last
    checkpoint and replays, up to ``max_restarts`` times.
  * Straggler watchdog: steps slower than ``straggler_factor`` x the EMA of
    step time are logged.
  * Preemption: ``request_stop()`` finishes the current step, writes a final
    checkpoint and returns.

The trainer does not know what a step computes: it takes
``step_fn(state, batch) -> (state, metrics)`` and ``next_batch(step)``.
Metrics (a StepMetrics of 0-dim tensors, or a dict) are read with one host
copy per step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager, latest_step
from repro_torch.data.loader import LoaderState


@dataclasses.dataclass
class TrainerConfig:
    """Loop-level knobs only; what a step computes lives in ``step_fn``.

    total_steps: run length in optimizer updates.
    checkpoint_dir/checkpoint_every/keep_checkpoints: periodic async
        checkpoints of (train state, loader state); None disables.
    max_restarts: restore-and-replay budget for failing steps.
    straggler_factor/straggler_warmup/ema_decay: step-time watchdog.
    abort_on_nan: treat a non-finite loss as a step failure (restore).
    log_every: metric print cadence.
    eval_every: cadence of the ``eval_fn(state, step) -> dict`` hook (0
        disables); its results join the step's history row under ``eval/``.
    """

    total_steps: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_warmup: int = 5
    ema_decay: float = 0.9
    abort_on_nan: bool = True
    log_every: int = 10
    eval_every: int = 0


class StepFailure(RuntimeError):
    """Raised inside the loop to trigger restore-and-replay."""


@dataclasses.dataclass
class PeriodicHook:
    """A callback fired after step ``step`` when ``(step + 1) % every == 0``
    (0 disables). ``fn(state, step)`` may return a metric dict, merged into
    the step's history row under ``prefix``. ``advisory`` hooks (eval) never
    consume the restart budget: their exceptions are logged and swallowed;
    the others raise ``StepFailure`` and go through the restore path."""

    every: int
    fn: Callable[[Any, int], Optional[Dict[str, float]]]
    prefix: str = ""
    name: str = "hook"
    advisory: bool = True


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    restarts: int
    stragglers: List[int]
    final_metrics: Dict[str, float]
    history: List[Dict[str, float]]


#: what a failing device step raises (the JAX trainer catches JaxRuntimeError)
_DEVICE_ERRORS = tuple(
    e for e in (getattr(torch, "AcceleratorError", None), torch.cuda.CudaError,
                torch.OutOfMemoryError)
    if e is not None
)


def _metrics_to_host(metrics) -> Dict[str, float]:
    """Scalar metrics as floats, with one device-to-host copy."""
    items = metrics.items() if isinstance(metrics, dict) else metrics._asdict().items()
    names, values = [], []
    for k, v in items:
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                names.append(k)
                values.append(v.detach().float())
        elif np.ndim(v) == 0:
            names.append(k)
            values.append(torch.tensor(float(v)))
    if not values:
        return {}
    dev = next((v.device for v in values if v.device.type != "cpu"), torch.device("cpu"))
    host = torch.stack([v.to(dev) for v in values]).cpu().tolist()
    return dict(zip(names, host))


@contextlib.contextmanager
def priority_stream(device: Union[str, torch.device]) -> Iterator[Optional["torch.cuda.Stream"]]:
    """Run the block's device work on a new high-priority CUDA stream
    (yields it; on the CPU, yields None and changes nothing). Work on
    another stream, such as the miner's re-encode, shares the SMs with it,
    and the block scheduler hands free SMs to this stream's pending blocks
    first, so the training loop's small kernels do not wait behind a wide
    grid. The stream starts after the caller's queued work and the caller's
    stream waits for it at the end."""
    device = torch.device(device)
    if device.type != "cuda":
        yield None
        return
    caller = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device, priority=-1)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        caller.wait_stream(stream)


class Trainer:
    def __init__(
        self,
        cfg: TrainerConfig,
        step_fn: Callable[[Any, Any], Any],
        next_batch: Callable[[int], Any],
        *,
        loader_state: Optional[LoaderState] = None,
        eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
        hooks: Sequence[PeriodicHook] = (),
        aux_state: Optional[Any] = None,
        # test hooks ------------------------------------------------------
        fault_hook: Optional[Callable[[int], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.next_batch = next_batch
        self.loader_state = loader_state or LoaderState()
        self.eval_fn = eval_fn
        # aux_state: a side object riding the checkpoint payload, with
        # state_to_save() -> a fixed-structure tree and load_saved_state(tree)
        self.aux_state = aux_state
        self._hooks: List[PeriodicHook] = list(hooks)
        if eval_fn is not None:
            self._hooks.append(
                PeriodicHook(every=cfg.eval_every, fn=eval_fn, prefix="eval/", name="eval")
            )
        self.fault_hook = fault_hook
        self.clock = clock
        self._stop = False
        self.stragglers: List[int] = []
        self.restarts = 0
        self.history: List[Dict[str, float]] = []
        self._ckpt = (
            CheckpointManager(cfg.checkpoint_dir, keep=cfg.keep_checkpoints, async_save=True)
            if cfg.checkpoint_dir
            else None
        )

    def request_stop(self):
        """Preemption notice: finish the current step, checkpoint, exit."""
        self._stop = True

    def _save(self, step: int, state, *, block: bool = False):
        if self._ckpt is None:
            return
        ls = self.loader_state
        payload = {
            "state": state,
            "loader": np.asarray([ls.epoch, ls.step, ls.mined_step, ls.mined_version], np.int64),
        }
        if self.aux_state is not None:
            payload["aux"] = self.aux_state.state_to_save()
        self._ckpt.save(step, payload, block=block)

    def _restore(self, template_state):
        if self._ckpt is None:
            return None
        self._ckpt.wait()  # a save still being written is the latest step
        if latest_step(self.cfg.checkpoint_dir) is None:
            return None
        payload = {"state": template_state, "loader": np.zeros((4,), np.int64)}
        if self.aux_state is not None:
            payload["aux"] = self.aux_state.state_to_save()
        restored, step = self._ckpt.restore_latest(payload)
        ls = self.loader_state
        ls.epoch, ls.step, ls.mined_step, ls.mined_version = (int(v) for v in restored["loader"])
        if self.aux_state is not None:
            self.aux_state.load_saved_state(restored["aux"])
        return restored["state"], step

    def run(self, state) -> tuple:
        cfg = self.cfg
        start = 0
        resumed = self._restore(state)
        if resumed is not None:
            state, start = resumed
            start += 1

        ema = None
        step = start
        last_metrics: Dict[str, float] = {}
        while step < cfg.total_steps and not self._stop:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)  # may raise (injected fault)
                batch = self.next_batch(step)
                t0 = self.clock()
                state, metrics = self.step_fn(state, batch)
                flat = _metrics_to_host(metrics)  # waits for the step
                dt = self.clock() - t0

                if cfg.abort_on_nan:
                    loss = flat.get("loss", 0.0)
                    if not np.isfinite(loss):
                        raise StepFailure(f"non-finite loss at step {step}: {loss}")

                if ema is not None and step - start >= cfg.straggler_warmup:
                    if dt > cfg.straggler_factor * ema:
                        self.stragglers.append(step)
                ema = dt if ema is None else cfg.ema_decay * ema + (1 - cfg.ema_decay) * dt

                last_metrics = self._log(step, flat, dt)
                for hook in self._hooks:
                    if not hook.every or (step + 1) % hook.every:
                        continue
                    try:
                        res = hook.fn(state, step)
                    except Exception as e:
                        if not hook.advisory:
                            raise StepFailure(f"{hook.name} hook failed at step {step}: {e}") from e
                        print(f"step {step}: {hook.name} failed ({e})", flush=True)
                    else:
                        vals = {f"{hook.prefix}{k}": float(v) for k, v in (res or {}).items()}
                        if vals:
                            last_metrics.update(vals)  # the history row, in place
                            msg = " ".join(f"{k}={v:.4f}" for k, v in vals.items())
                            print(f"step {step}: {msg}", flush=True)
                if cfg.checkpoint_dir and (step + 1) % cfg.checkpoint_every == 0:
                    self._save(step, state)
                step += 1
            except (StepFailure, *_DEVICE_ERRORS, FloatingPointError) as e:
                self.restarts += 1
                if self.restarts > cfg.max_restarts or self._ckpt is None:
                    raise
                resumed = self._restore(state)
                if resumed is None:
                    raise RuntimeError(
                        f"step {step} failed ({e}) with no checkpoint to restore"
                    ) from e
                state, ck_step = resumed
                step = ck_step + 1

        if self._ckpt is not None:
            self._save(max(step - 1, 0), state, block=True)
            self._ckpt.wait()
        return state, TrainerReport(
            steps_run=step - start,
            restarts=self.restarts,
            stragglers=self.stragglers,
            final_metrics=last_metrics,
            history=self.history,
        )

    def _log(self, step: int, flat: Dict[str, float], dt: float) -> Dict[str, float]:
        flat = dict(flat, step=step, step_time_s=dt)
        self.history.append(flat)
        if step % self.cfg.log_every == 0:
            keys = [k for k in ("loss", "accuracy", "grad_norm_ratio") if k in flat]
            msg = " ".join(f"{k}={flat[k]:.4f}" for k in keys)
            print(f"step {step}: {msg} ({dt*1e3:.1f} ms)", flush=True)
        return flat
