"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell is looked up by name in ``BENCHMARK.json``; its
configuration file, its traffic file (``portbench/traffic/<traffic>.json``),
the driver that traffic names (``portbench/drivers/<driver>.py``) and, with
``--trace 1``, one reader per per-layer metric
(``portbench/metrics/<metric>.py``) are all found by name, so a new cell
or metric is new files and entries, never an edit.

Every driver reports, beside ``setup_s``, the end-to-end metric
``compact_rss_mb``: the largest growth of the host's resident set over
one timed unit of its window (a compaction, a cycle), sampled by
``host.RssSampler`` from the benchmark's own thread.  A driver's module
also states its work (``stated(config, traffic)`` and
``measured(config, traffic, seed)``, the counts a run checks) and the
checks that catch a broken timed path (``CONTROL_CHECKS``, every one of
which the control raises above its limit, and ``FAULT_CHECKS``, one of
which each planted fault raises), for the tests under
``portbench/tests``.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number the correctness
comparison produced beside its limit.  Earlier lines on standard error
give the host's context, the work's counts and set-up's split.

Exit codes: 0 a result was printed (correct or not); 2 usage; 3 the
cards the cell asks for are absent; 4 a forbidden module was loaded; 5
the work's counts differ from the configuration's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "crdt_enc_tpu")
# every kernel and build cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")


class Refused(Exception):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entries and files, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise Refused(2, f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    (conf,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(PKG, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return {"cell": cell, "config": config, "traffic": traffic}


def driver(name: str):
    """The driver module ``portbench/drivers/<name>.py``."""
    return load_file_module(os.path.join(PKG, "drivers", name + ".py"),
                            "portbench.drivers." + name)


def metrics_for(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports in this kind of run."""
    def mine(m):
        return m.get("workloads") is None or workload in m["workloads"]

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if mine(m) and (m.get("workloads") is not None or m["moves"] in names)]


class Window:
    """The measured window: ``open()`` while ``seconds`` have not passed
    since entry; with tracing, the device trace spans it."""

    def __init__(self, seconds: float, trace: bool):
        from .devtrace import DeviceTrace

        self.seconds = seconds
        self.trace = DeviceTrace(trace)

    def __enter__(self):
        self.trace.__enter__()
        self.t0 = time.perf_counter()
        return self

    def open(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def __exit__(self, *exc):
        self.trace.__exit__(*exc)
        return False


class Context:
    """What a driver gets: the run's arguments, the cell's files, and the
    harness's services."""

    def __init__(self, args, cell: dict, device: str):
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.config = cell["config"]
        self.traffic = cell["traffic"]
        self.device = device
        self.on_card = device == "cuda"
        self.log = log
        self.setup_s = None
        self.window_obj = None
        self.fault = args.fault
        self._scratch = None
        self.aside_s = 0.0

    def rng(self, *salt: int):
        from .gen import rng_for

        return rng_for(self.seed, 100, *salt)

    def check_counts(self, measured: dict, stated: dict) -> None:
        log(f"counts {json.dumps(measured, sort_keys=True)}")
        off = {k: (measured.get(k), v) for k, v in stated.items()
               if measured.get(k) != v}
        if off:
            raise Refused(5, f"the work differs from the configuration: {off}")

    def scratch_dir(self) -> str:
        """This run's directory under ``$TMPDIR``, removed at exit."""
        if self._scratch is None:
            self._scratch = tempfile.mkdtemp(prefix="portbench-")
        return self._scratch

    def cleanup(self) -> None:
        import shutil

        if self._scratch is not None:
            shutil.rmtree(self._scratch, ignore_errors=True)

    def setup_done(self, split: dict) -> None:
        self.setup_s = time.perf_counter() - T_START - self.aside_s
        log(f"setup_s {self.setup_s:.4f} (host context line {self.aside_s:.4f}"
            " s left out): " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()))

    def window(self) -> Window:
        self.window_obj = Window(self.seconds, self.trace)
        return self.window_obj

    def plant(self, storage):
        """A timed-path storage, with ``--fault``'s reads planted."""
        if not self.fault:
            return storage
        from . import faults

        return faults.wrap(storage, self.fault)

    def fault_scope(self):
        if not self.fault:
            return contextlib.nullcontext()
        from . import faults

        return faults.scope(self.fault)


def card(chips: int, device: str) -> dict:
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(3, f"the cell needs {chips} CUDA device(s); "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                         " present")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def per_layer(entries: list, ctx: Context, out: dict) -> dict:
    from . import peaks

    view = {
        "units": out.get("units", 0),
        "spans": out.get("spans", {}), "counters": out.get("counters", {}),
        "shapes": out.get("shapes", {}),
        "walls": out.get("walls", []), "work": out.get("work", []),
        "trace": ctx.window_obj.trace if ctx.window_obj else None,
        "peaks": peaks,
    }
    metrics = {}
    for m in entries:
        reader = load_file_module(os.path.join(PKG, "metrics", m["name"] + ".py"),
                                  "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(view)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # for the CPU tests: the plain PyTorch path, no card asked for
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    # the control and the planted faults (portbench/faults.py); never in
    # a benchmark run
    p.add_argument("--fault", default=None,
                   choices=("control", "unchanged", "half", "alter"))
    return p.parse_args(argv)


def run(argv) -> dict:
    args = parse(argv)
    os.makedirs(CACHE, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    bench = manifest()
    cell = resolve(bench, args.workload)
    device = card(cell["cell"]["chips"], args.device)
    ctx = Context(args, cell, args.device)
    from . import host

    t = time.perf_counter()
    log("host " + json.dumps(host.context(ROOT, tempfile.gettempdir())))
    # the context line is for reading noise, not set-up: kept out of setup_s
    ctx.aside_s = time.perf_counter() - t
    try:
        out = driver(cell["traffic"]["driver"]).run(ctx)
    finally:
        ctx.cleanup()
    bad = forbidden_loaded()
    if bad:
        raise Refused(4, f"forbidden modules loaded: {bad}")

    entries = metrics_for(bench, args.workload, ctx.trace)
    if ctx.trace:
        metrics = per_layer(entries, ctx, out)
    else:
        metrics = {"setup_s": {"value": ctx.setup_s, "unit": "s"}}
        for m in entries:
            v = out["end_to_end"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": out["limits"][k]}
              for k, v in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {**device, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if ctx.trace:
        red = ctx.window_obj.trace.reduce()
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in red["device_ops"]],
                               "idle_gaps": [list(x) for x in red["idle_gaps"]]}
        log(f"trace: busy {red['busy_s']:.6f} s of {red['window_s']:.4f} s, "
            f"events dropped {red['events_dropped']}")
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    try:
        result = run(sys.argv[1:] if argv is None else argv)
    except Refused as e:
        log(f"refused: {e}")
        return e.code
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
