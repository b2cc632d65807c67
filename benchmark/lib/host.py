"""What the host did during a window, read from Linux's own counters: the
machine's CPU time by kind (steal is time the hypervisor gave to other
guests), this process's CPU seconds and its involuntary context switches.
Printed beside each run's numbers, so that a run that reads far off can be
laid beside the load its host carried."""

from __future__ import annotations

import os
import resource
import time

_KINDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")


def _machine_ticks() -> dict:
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:1 + len(_KINDS)]
        return dict(zip(_KINDS, (int(x) for x in fields)))
    except (OSError, ValueError):
        return {}


def counters(since: dict | None = None) -> dict:
    """The counters now; with `since` (an earlier reading), what changed:
    the machine's busy and steal shares of its CPU time in %, this
    process's CPU seconds, its involuntary switches and the seconds between."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    now = dict(t=time.perf_counter(), ticks=_machine_ticks(),
               cpu_s=ru.ru_utime + ru.ru_stime, nivcsw=ru.ru_nivcsw)
    if since is None:
        return now
    d = {k: now["ticks"].get(k, 0) - since["ticks"].get(k, 0) for k in _KINDS}
    total = sum(d.values()) or 1
    return dict(seconds=now["t"] - since["t"],
                machine_busy_pct=100.0 * (total - d["idle"] - d["iowait"]) / total,
                machine_steal_pct=100.0 * d["steal"] / total,
                process_cpu_s=now["cpu_s"] - since["cpu_s"],
                involuntary_switches=now["nivcsw"] - since["nivcsw"],
                cpus=len(os.sched_getaffinity(0)))
