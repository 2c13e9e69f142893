"""Per-stage benchmark logging (the reference's GNU-time TSV contract).

The reference wraps every heavy rule with scripts/benchmark.py, logging
``real_s sys_s user_s percent_CPU max_RAM_kb FS_inputs FS_outputs wall_clock``
rows to logs/benchmarks/{rule}/{wildcards}.txt
(ref: /root/reference/scripts/benchmark.py:17-46, Snakefile:384,418,...).
Same file layout and column spirit here, measured in-process: wall time,
CPU split, peak RSS and block I/O counts (GNU time's FS inputs/outputs)
from resource.getrusage; system RAM from /proc/meminfo.
"""

from __future__ import annotations

import datetime
import os
import resource
import time
from contextlib import contextmanager
from pathlib import Path

HEADER = "real(s)\tsys(s)\tuser(s)\tpercent_CPU\tmax_RAM(kb)\tFS_inputs\tFS_outputs\twall_clock"


def used_ram_kb(meminfo: str | os.PathLike = "/proc/meminfo") -> int:
    """Used system memory in kB: MemTotal - MemAvailable."""
    fields = {}
    with open(meminfo) as f:
        for line in f:
            name, _, rest = line.partition(":")
            fields[name] = int(rest.split()[0])
    return fields["MemTotal"] - fields["MemAvailable"]


class RamSampler:
    """Whole-run system-RAM delta sampler (the reference's psutil poller,
    scripts/get_RAM_usage.py:10-22 + benchmark.py:49-74): samples used system
    memory at ``interval`` seconds and reports max delta from the start."""

    def __init__(self, interval: float = 0.1):
        self.interval = interval
        self._stop = None
        self._thread = None
        self.baseline_kb = 0
        self.max_delta_kb = 0

    def __enter__(self):
        import threading

        self.baseline_kb = used_ram_kb()
        self._stop = threading.Event()

        def poll():
            while not self._stop.wait(self.interval):
                used = used_ram_kb()
                self.max_delta_kb = max(self.max_delta_kb, used - self.baseline_kb)

        self._thread = threading.Thread(target=poll, daemon=True, name="ram-sampler")
        self._thread.start()
        return self

    def __exit__(self, *exc):
        if self._stop is not None:
            self._stop.set()
            self._thread.join(timeout=2)
        return False


@contextmanager
def benchmark(logs_dir: str | os.PathLike, rule: str, wildcards: str):
    """Context manager timing one pipeline unit; appends a TSV row to
    logs/benchmarks/{rule}/{wildcards}.txt."""
    out = Path(logs_dir) / "benchmarks" / rule
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{wildcards}.txt"

    r0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        sys_s = r1.ru_stime - r0.ru_stime
        user_s = r1.ru_utime - r0.ru_utime
        pct = int(100 * (sys_s + user_s) / dt) if dt > 0 else 0
        max_rss_kb = r1.ru_maxrss  # linux: kb
        fs_in = r1.ru_inblock - r0.ru_inblock
        fs_out = r1.ru_oublock - r0.ru_oublock
        wall = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        new = not path.exists()
        with open(path, "a") as f:
            if new:
                f.write(HEADER + "\n")
            f.write(
                f"{dt:.2f}\t{sys_s:.2f}\t{user_s:.2f}\t{pct}%\t{max_rss_kb}\t{fs_in}\t{fs_out}\t{wall}\n"
            )
