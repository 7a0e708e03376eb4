"""Timing helpers of ``chip_smoke.py`` and the kernels' benchmarks, on the
current CUDA device.

- ``device_ms``: the device's time of a call, the calls queued behind a
  sleep kernel so that the events bracket the device's work and not the
  host's time to enqueue it (a call of a small kernel costs the host more
  than the device).
- ``cuda_ms``: the same calls without the sleep: a call's time as a
  caller sees it, the larger of the host's and the device's part.
- ``host_us``: the host's time to enqueue a call, by its clock.
- ``card``: the card's name and power limit, as nvidia-smi gives them.
"""

from __future__ import annotations

import subprocess
import time

import torch

#: about 40 ms of sleep at an H100's clock, longer than the host takes to
#: queue the timed calls of one measurement
SLEEP_CYCLES = 70_000_000


def _events_ms(fn, reps: int, sleep: bool) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if sleep:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up,
    queued behind a sleep kernel."""
    return _events_ms(fn, reps, sleep=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` calls, after one warm-up, with
    the host's enqueue in it."""
    return _events_ms(fn, reps, sleep=False)


def host_us(fn, reps: int) -> float:
    """Mean host time of ``fn()`` over ``reps`` calls, after one warm-up,
    by the host's clock, the device idle at the start (a call that waits
    for the device counts the wait)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    line for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
