"""Straggler detection + data-shard rebalancing (fault-tolerance layer).

At multi-thousand-chip scale the step time is gated by the slowest
participant. The monitor keeps a robust running estimate (median/MAD over a
sliding window) of per-step wall time and of per-host data-loading time, and
flags (a) globally slow steps, (b) persistently slow hosts. The loader
consumes ``plan_shards()`` which re-weights shard assignment away from slow
hosts (work-stealing style) and reassigns the shards of dead hosts.

The reference package's monitor, pure Python and unchanged.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StragglerMonitor:
    n_hosts: int = 1
    window: int = 32
    z_threshold: float = 4.0
    persist_steps: int = 8

    _steps: deque = field(default_factory=lambda: deque(maxlen=256))
    _host_times: dict = field(default_factory=dict)  # host -> deque
    _slow_streak: dict = field(default_factory=dict)
    dead_hosts: set = field(default_factory=set)

    # -- recording --------------------------------------------------------

    def record_step(self, seconds: float) -> bool:
        """Record a global step time; returns True if it's a straggler step."""
        hist = list(self._steps)
        self._steps.append(seconds)
        if len(hist) < 8:
            return False
        med = _median(hist)
        mad = _median([abs(x - med) for x in hist]) or 1e-9
        return (seconds - med) / (1.4826 * mad) > self.z_threshold

    def record_host(self, host: int, seconds: float) -> None:
        dq = self._host_times.setdefault(host, deque(maxlen=self.window))
        dq.append(seconds)

    def mark_dead(self, host: int) -> None:
        self.dead_hosts.add(host)

    def mark_alive(self, host: int) -> None:
        self.dead_hosts.discard(host)
        self._slow_streak.pop(host, None)

    # -- analysis ---------------------------------------------------------

    def slow_hosts(self) -> list[int]:
        """Hosts whose median load time is persistently above the fleet."""
        meds = {
            h: _median(list(dq))
            for h, dq in self._host_times.items()
            if len(dq) >= 4 and h not in self.dead_hosts
        }
        if len(meds) < 2:
            return []
        fleet = _median(list(meds.values()))
        out = []
        for h, m in meds.items():
            if m > 1.5 * fleet:
                self._slow_streak[h] = self._slow_streak.get(h, 0) + 1
            else:
                self._slow_streak[h] = 0
            if self._slow_streak.get(h, 0) >= self.persist_steps:
                out.append(h)
        return out

    # -- shard planning ----------------------------------------------------

    def plan_shards(self, n_shards: int) -> dict[int, list[int]]:
        """Deterministic shard→host assignment skipping dead hosts and
        down-weighting slow ones (they get ⌈half⌉ share)."""
        alive = [h for h in range(self.n_hosts) if h not in self.dead_hosts]
        if not alive:
            raise RuntimeError("no alive hosts")
        slow = set(self.slow_hosts())
        weights = [0.5 if h in slow else 1.0 for h in alive]
        total = sum(weights)
        # largest-remainder apportionment, deterministic
        quota = [n_shards * w / total for w in weights]
        counts = [int(q) for q in quota]
        rem = n_shards - sum(counts)
        order = sorted(
            range(len(alive)), key=lambda i: quota[i] - counts[i], reverse=True
        )
        for i in order[:rem]:
            counts[i] += 1
        plan: dict[int, list[int]] = {h: [] for h in alive}
        s = 0
        for h, c in zip(alive, counts):
            plan[h] = list(range(s, s + c))
            s += c
        return plan


def _median(xs: list[float]) -> float:
    ys = sorted(xs)
    n = len(ys)
    if n == 0:
        return 0.0
    return ys[n // 2] if n % 2 else 0.5 * (ys[n // 2 - 1] + ys[n // 2])


class StepTimer:
    """Context-manager sugar for the train loop. Host clock: the train loop
    reads the step's loss back inside it, so a step on the card is timed
    to its end."""

    def __init__(self, monitor: StragglerMonitor):
        self.monitor = monitor
        self.last: Optional[float] = None
        self.was_straggler = False

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last = time.perf_counter() - self._t0
        self.was_straggler = self.monitor.record_step(self.last)
        return False
