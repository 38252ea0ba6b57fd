"""The host around a run: its context line, and host memory sampling."""

from __future__ import annotations

import os
import subprocess
import threading


def mount_fs(path: str) -> str:
    """The filesystem type of the mount that holds ``path`` (from
    ``/proc/mounts``; the longest mount point that prefixes it)."""
    path = os.path.realpath(path)
    best, fs = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                mnt = parts[1].replace("\\040", " ")
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")
                        or mnt == "/") and len(mnt) >= len(best):
                    best, fs = mnt, parts[2]
    except OSError:
        pass
    return fs


def smi() -> dict:
    """The card's name, clocks and power from ``nvidia-smi`` (read only)."""
    q = "name,clocks.sm,clocks.max.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    first = out.splitlines()[0] if out else ""
    return dict(zip(q.split(","), (v.strip() for v in first.split(","))))


def context(root: str, tmpdir: str) -> dict:
    """Host context for diagnosing noise; never a metric."""
    try:
        load = os.getloadavg()
    except OSError:
        load = None
    return {
        "cpus": os.cpu_count(),
        "affinity": len(os.sched_getaffinity(0)),
        "loadavg": load,
        "tmpdir": tmpdir, "tmpdir_fs": mount_fs(tmpdir),
        "checkout_fs": mount_fs(root),
        "smi": smi(),
    }


def rss_bytes() -> int:
    """This process's resident set, from ``/proc/self/statm``."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


class RssSampler:
    """Samples the resident set on a thread of the benchmark's own while
    the block runs; ``growth`` is the peak over the reading at entry."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.before = self.peak = 0
        self._stop = threading.Event()
        self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self.peak = max(self.peak, rss_bytes())

    def __enter__(self):
        self.before = self.peak = rss_bytes()
        self._thread = threading.Thread(target=self._run, name="portbench-rss",
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())
        return False

    @property
    def growth(self) -> int:
        return self.peak - self.before
