"""ctypes loaders for the port's two native libraries.

``crypto.cpp``, ``codec.cpp`` and ``io.cpp`` are the port's copies of the
JAX package's native sources (the XChaCha20-Poly1305 AEAD, the columnar
op-payload decoder, the bulk op-file reader).  :func:`load` compiles them
with ``c++`` into ``build/libcrdtnative-<hash>.so`` inside the package at
first use — the hash covers the sources, the flags and what
``-march=native`` means on this host, so an edited source or another CPU
rebuilds and a stale library is never loaded — and binds the entry points
the port calls.  Its calls release the GIL (``ctypes.CDLL``).

``statebuild.cpp`` (the fresh sparse fold, the dict assembly and the
canonical packer) builds the same way into ``build/libcrdtstate-<hash>.so``
through :func:`load_state`, against this interpreter's own headers — the
hash also covers their directory and the interpreter's ABI tag, so
another Python rebuilds.  It creates Python objects, so it is a library of
its own loaded with ``ctypes.PyDLL``, whose calls hold the GIL.

A failed build raises, every time it is asked for: no caller of this
module carries on without a library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD = HERE.parent / "build"
SOURCES = ("crypto.cpp", "codec.cpp", "io.cpp")
STATE_SOURCES = ("statebuild.cpp",)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_state_lib: ctypes.PyDLL | None = None

u8p = ctypes.POINTER(ctypes.c_uint8)
u64p = ctypes.POINTER(ctypes.c_uint64)
i8p = ctypes.POINTER(ctypes.c_int8)
i32p = ctypes.POINTER(ctypes.c_int32)
i64p = ctypes.POINTER(ctypes.c_int64)


def _cxx() -> str:
    cxx = shutil.which("c++")  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
    if cxx is None:
        raise RuntimeError("native build: no c++ compiler on PATH")
    return cxx


def _target() -> bytes:
    """The compiler's predefined macros under the build's ``-march``: its
    identity and the instruction-set features a build on this host may
    use.  A build directory carried to another CPU then hashes apart and
    rebuilds instead of loading code that CPU cannot run."""
    march = [f for f in CXX_FLAGS if f.startswith("-march")]
    proc = subprocess.run(  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
        [_cxx(), *march, "-dM", "-E", "-x", "c++", "-"],
        input="", capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"native build: c++ {' '.join(march)} -dM -E "
                           f"failed:\n{proc.stderr}")
    return proc.stdout.encode()


def _lib_path(stem: str, sources, flags, extra: str = "") -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(extra.encode())
    h.update(_target())
    for name in sources:
        h.update((HERE / name).read_bytes())
    return BUILD / f"{stem}-{h.hexdigest()[:16]}.so"


def lib_path() -> Path:
    return _lib_path("libcrdtnative", SOURCES, CXX_FLAGS)


def state_flags() -> tuple:
    """The state library's flags: the common ones and this interpreter's
    header directory."""
    return (*CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}")


def state_lib_path() -> Path:
    """The name hashes the flags (so the header directory) and the
    interpreter's ABI tag besides what :func:`lib_path` hashes."""
    return _lib_path("libcrdtstate", STATE_SOURCES, state_flags(),
                     sysconfig.get_config_var("SOABI") or "")


def _compile(out: Path, sources=SOURCES, flags=CXX_FLAGS) -> None:
    cxx = _cxx()
    BUILD.mkdir(parents=True, exist_ok=True)
    # a private temporary, renamed into place: concurrent processes each
    # build their own and the last rename wins with identical bytes
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags, "-o", str(tmp), *(str(HERE / s) for s in sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
        cmd, capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native build failed (c++ exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # lint: effect-ok=blocks (one-shot build; Core.open warms it off-loop)
    from ..obs import runtime

    runtime.note_build("native", time.perf_counter() - t0)


def load() -> ctypes.CDLL:
    """The native library, compiled first if its build is missing.
    Raises with the compiler's output if the build fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def load_state() -> ctypes.PyDLL:
    """The C-API state-assembly library (``statebuild.cpp``), compiled
    first if its build is missing.  Raises with the compiler's output if
    the build fails — a missing ``Python.h`` included."""
    global _state_lib
    with _lock:
        if _state_lib is None:
            path = state_lib_path()
            if not path.exists():
                _compile(path, STATE_SOURCES, state_flags())
            lib = ctypes.PyDLL(str(path))
            _bind_state(lib)
            _state_lib = lib
        return _state_lib


def _bind_state(lib) -> None:
    # split fresh fold: a rows handle out (counts = the capacities of the
    # later take), then a sized copy-out that frees it
    lib.orset_fold_rows.argtypes = [
        i8p, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, i32p, i64p,
    ]
    lib.orset_fold_rows.restype = ctypes.c_void_p
    lib.orset_fold_rows_take.argtypes = [
        ctypes.c_void_p, i32p, i32p, i64p, ctypes.c_int64,
        i32p, i32p, i64p, ctypes.c_int64,
    ]
    lib.orset_fold_rows_take.restype = ctypes.c_int
    lib.orset_fold_rows_drop.argtypes = [ctypes.c_void_p]
    lib.orset_fold_rows_drop.restype = None
    lib.dense_clock_dict.argtypes = [i32p, ctypes.c_int64, ctypes.py_object]
    lib.dense_clock_dict.restype = ctypes.py_object
    lib.grouped_rows_dicts.argtypes = [
        i32p, i32p, i64p, ctypes.c_int64,
        ctypes.py_object, ctypes.py_object, ctypes.py_object,
    ]
    lib.grouped_rows_dicts.restype = ctypes.c_int
    lib.canon_pack.argtypes = [ctypes.py_object]
    lib.canon_pack.restype = ctypes.py_object


def _bind(lib) -> None:
    lib.xchacha20poly1305_encrypt.argtypes = [
        u8p, u8p, u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, u8p
    ]
    lib.xchacha20poly1305_encrypt.restype = None
    lib.xchacha20poly1305_decrypt.argtypes = [
        u8p, u8p, u8p, ctypes.c_uint64, u8p, ctypes.c_uint64, u8p
    ]
    lib.xchacha20poly1305_decrypt.restype = ctypes.c_int
    lib.encbox_parse_batch.argtypes = [
        u8p, u64p, ctypes.c_uint64, u8p, u64p, u64p, u64p
    ]
    lib.encbox_parse_batch.restype = ctypes.c_int64
    lib.encbox_decrypt_scatter_mt.argtypes = [
        u8p, u8p, u64p, u64p, u64p, ctypes.c_uint64, u8p, u64p, u8p,
        ctypes.c_int,
    ]
    lib.encbox_decrypt_scatter_mt.restype = ctypes.c_int

    lib.actor_hash_build.argtypes = [u8p, ctypes.c_uint64, i32p, ctypes.c_uint64]
    lib.actor_hash_build.restype = None
    lib.orset_decode_batch_grow.argtypes = [
        u8p, u64p, u64p, ctypes.c_uint64, u8p, ctypes.c_uint64,
        i32p, ctypes.c_uint64, i64p,
    ]
    lib.orset_decode_batch_grow.restype = ctypes.c_void_p
    lib.orset_decode_take.argtypes = [ctypes.c_void_p, i8p, u64p, u64p, i32p, i32p]
    lib.orset_decode_take.restype = None
    lib.orset_decode_drop.argtypes = [ctypes.c_void_p]
    lib.orset_decode_drop.restype = None
    lib.intern_spans_native.argtypes = [
        u8p, u64p, u64p, ctypes.c_int64, i64p, ctypes.c_int64,
        i32p, u64p, u64p, ctypes.c_int64,
    ]
    lib.intern_spans_native.restype = ctypes.c_int64
    lib.counter_decode_batch.argtypes = [
        u8p, u64p, u64p, ctypes.c_uint64, u8p, ctypes.c_uint64, i8p, i32p, i32p,
    ]
    lib.counter_decode_batch.restype = ctypes.c_int64
    lib.map_count_rows_batch.argtypes = [u8p, u64p, u64p, ctypes.c_uint64, i64p]
    lib.map_count_rows_batch.restype = ctypes.c_int64
    lib.map_decode_batch.argtypes = (
        [u8p, u64p, u64p, ctypes.c_uint64, u8p, ctypes.c_uint64]
        + [u64p, u64p, i32p, i32p]  # birth
        + [u64p, u64p, u64p, u64p, i32p, i32p]  # child add
        + [u64p, u64p, u64p, u64p, i32p, i32p, i32p, i32p]  # child rm
        + [u64p, u64p, i32p, i32p, i32p]  # key rm
    )
    lib.map_decode_batch.restype = ctypes.c_int64

    lib.scan_op_sizes.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.scan_op_sizes.restype = ctypes.c_int64
    lib.read_op_files.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, u8p
    ]
    lib.read_op_files.restype = ctypes.c_int64
    lib.probe_op_files.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, u8p]
    lib.probe_op_files.restype = ctypes.c_int64


def in_ptr(b):
    """Zero-copy input pointer for bytes/bytearray/ndarray.  The caller must
    keep the returned array alive across the native call."""
    import numpy as np

    arr = np.frombuffer(b, dtype=np.uint8) if not isinstance(b, np.ndarray) else b
    if arr.size == 0:
        return None, arr
    return arr.ctypes.data_as(u8p), arr


def out_buf(n: int):
    """Writable output buffer of n bytes (numpy-backed)."""
    import numpy as np

    arr = np.empty(n, dtype=np.uint8)
    return (arr.ctypes.data_as(u8p) if n else None), arr
