"""Fault tolerance for a training run: stragglers, heartbeats,
preemption.

A copy of the JAX package's pure-Python classes: transport-agnostic
(file-based heartbeats, a SIGTERM flag), so the same objects drive a
fleet's hosts and the one-process trainer, and ``plan_remesh``, the
elastic re-meshing on the surviving cards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import statistics
import time

__all__ = ["StragglerMonitor", "Heartbeat", "PreemptionHandler",
           "plan_remesh"]


# ------------------------------------------------------------ stragglers ---
@dataclasses.dataclass
class StragglerMonitor:
    """Flags hosts whose step time exceeds tau x median of the fleet."""

    tau: float = 1.5
    window: int = 16
    _times: dict[str, list[float]] = dataclasses.field(default_factory=dict)

    def report(self, host: str, step_seconds: float):
        buf = self._times.setdefault(host, [])
        buf.append(step_seconds)
        if len(buf) > self.window:
            buf.pop(0)

    def medians(self) -> dict[str, float]:
        return {h: statistics.median(v) for h, v in self._times.items() if v}

    def stragglers(self) -> list[str]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        return [h for h, m in meds.items() if m > self.tau * fleet]

    def mitigation_plan(self) -> dict:
        """What the launcher should do: checkpoint-evict-restart semantics."""
        bad = self.stragglers()
        return {
            "stragglers": bad,
            "action": "checkpoint_and_evict" if bad else "none",
            "healthy": [h for h in self._times if h not in bad],
        }


# ------------------------------------------------------------ heartbeats ---
class Heartbeat:
    """File-based heartbeat (stand-in for a cluster KV service)."""

    def __init__(self, root: str, host: str, interval_s: float = 5.0):
        self.path = os.path.join(root, f"hb_{host}.json")
        self.host = host
        self.interval_s = interval_s
        os.makedirs(root, exist_ok=True)

    def beat(self, step: int, now: float | None = None):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host, "step": step,
                       "t": now if now is not None else time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def dead_hosts(root: str, timeout_s: float, now: float | None = None):
        now = now if now is not None else time.time()
        dead = []
        for f in os.listdir(root):
            if not f.startswith("hb_"):
                continue
            with open(os.path.join(root, f)) as fh:
                rec = json.load(fh)
            if now - rec["t"] > timeout_s:
                dead.append(rec["host"])
        return sorted(dead)


# ------------------------------------------------------------ preemption ---
class PreemptionHandler:
    """SIGTERM -> request a final checkpoint and a clean exit."""

    def __init__(self, install: bool = True):
        self.requested = False
        if install:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:
                pass  # non-main thread (tests)

    def _on_signal(self, signum, frame):
        self.requested = True

    def trigger_for_test(self):
        self.requested = True


# -------------------------------------------------------------- elastic ----
def plan_remesh(n_healthy_chips: int, *, model_parallel: int = 16,
                min_data: int = 1) -> tuple[int, int]:
    """Largest (data, model) grid on the surviving cards: the model axis
    stays (its degree is a property of the weight layout) and the data
    axis shrinks, the standard elastic data-parallel policy.  Returns
    (data, model)."""
    data = max(min_data, n_healthy_chips // model_parallel)
    return data, model_parallel
