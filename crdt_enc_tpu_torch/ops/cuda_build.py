"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/lib<name>-<hash>.so``
inside the package, and loads through ``ctypes``.  The hash covers the
source and the flags, so an edited source rebuilds and a stale library is
never loaded.  The build runs at first use (or from :func:`build`, which
starts one ``nvcc`` per source, all at once); importing this module
builds nothing.  ``Core.open`` runs :func:`warm` through
``asyncio.to_thread`` when its accelerator is on a card, so no ``nvcc``
build and no ``dlopen`` runs on the event loop: a ``FoldService`` or a
``FleetDaemon`` folds the tenants of open cores.  Several cores may open
at once, each in its own worker thread: one lock makes a build and its
load happen once a process, and a build's temporary file is named for
its process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("orset_fold", "orset_merge", "lww_fold")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-lineinfo",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

# name -> loaded library; name -> compiler output of its last build
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}
# held by build and warm: one build and one load of a library a process
_lock = threading.Lock()


def nvcc() -> str:
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin``, then ``PATH``,
    then ``/usr/local/cuda/bin``."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names=SOURCES) -> float:
    """Compile every named source whose library is missing, one ``nvcc``
    process per source, all started together.  Returns the wall seconds.
    Raises with the compiler's output if any build fails."""
    with _lock:
        return _build(names)


def _build(names) -> float:
    t0 = time.perf_counter()
    todo = [(n, lib_path(n)) for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name, out in todo:
        # another process may build the same library: the last rename
        # wins with identical bytes
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        procs.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode == 0:
            # atomic: a concurrent build sees all or nothing
            os.replace(tmp, out)  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    dt = time.perf_counter() - t0
    from ..obs import runtime

    runtime.note_build("cuda", dt, len(todo))
    return dt


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        warm((name,))
        lib = _libs[name]
    return lib


def warm(names=SOURCES) -> None:
    """Build every named library that is missing (one ``nvcc`` each, all
    at once) and load them all, so that a later :func:`load` is a dict
    hit; a dict check when they are loaded already.  Threads that call
    it together wait for one build and one load.  Raises with the
    compiler's output if a build fails."""
    if all(n in _libs for n in names):
        return
    with _lock:
        todo = [n for n in names if n not in _libs]
        if todo:
            _build(todo)
            for name in todo:
                _libs[name] = ctypes.CDLL(str(lib_path(name)))


def expect(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless tensor ``t`` has the dtype and shape a kernel takes and
    is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launch entry point of ``lib`` reported a CUDA error."""
    if rc != 0:
        name = lib.cuda_error_string
        name.argtypes = [ctypes.c_int]
        name.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{what}: CUDA error {rc} ({name(rc).decode()}) at launch"
        )
