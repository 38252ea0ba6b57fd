"""Filesystem storage backend — the production port over a synced directory.

The port's copy of ``crdt_enc_tpu/backends/fs.py``.  The op-log scans run through the port's own native library
(``native/io.cpp``); a failed build raises — there is no per-file Python
scan standing in for it.

Rebuilds crdt-enc-tokio (crdt-enc-tokio/src/lib.rs) on asyncio + thread
offload:

* layout: ``local/meta-data.msgpack`` (lib.rs:51), the warm-open
  checkpoint ``local/checkpoint.msgpack``, ``remote/meta/<hash>``
  (lib.rs:79), ``remote/states/<hash>`` (lib.rs:139),
  ``remote/ops/<actor-hex>/<N>`` (lib.rs:247-257), and the sealed delta
  logs ``remote/deltas/<actor-hex>/<N>``;
* immutable content-addressed writes: SHA3-256 of the blob, base32-nopad
  name, ``O_CREAT|O_EXCL`` then fsync of file and directory
  (write_content_addressible_file, lib.rs:403-432) — a replay of the same
  content is a no-op, a name collision with different content is an error;
* op logs scan densely from the first requested version until the first
  missing file (lib.rs:254-269); actors fan out concurrently (lib.rs:274);
* missing directories/files read as empty/None and removes tolerate
  already-gone files (lib.rs:376-401, 434-440) — the sync tool may race us.

Op-file writes go through a same-directory tmp file + fsync + atomic link,
so a crash mid-write can never leave a torn op file where the dense version
scan would find it.

The per-file round trips are counted where they happen, once a batch,
chunk or scan group: ``storage_files_read`` and ``storage_bytes_read``
(op files and snapshots read), ``storage_files_statted`` (op files a
probe or ``stat_ops`` found) and ``storage_files_removed`` (op,
snapshot and delta files unlinked).
"""

from __future__ import annotations

import asyncio
import functools
import logging
import os
import uuid

import numpy as np

from .. import native
from ..core.storage import Storage
from ..models.vclock import Actor
from ..utils import trace
from .memory import content_name

FS_CONCURRENCY = 32  # reference buffer_unordered(32), crdt-enc-tokio lib.rs:112

logger = logging.getLogger("crdt_enc_tpu_torch.fs")


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_tmp(d: str, data: bytes) -> str:
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".tmp-{uuid.uuid4().hex}")
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    try:
        os.write(fd, data)
        os.fsync(fd)
    finally:
        os.close(fd)
    return tmp


def _write_file_atomic(path: str, data: bytes) -> None:
    """tmp + fsync + rename (last-writer-wins — for the mutable local meta)."""
    d = os.path.dirname(path)
    tmp = _write_tmp(d, data)
    os.rename(tmp, path)
    _fsync_dir(d)


def _write_file_new(
    path: str, data: bytes, *, relink_vanished_collider: bool = True
) -> None:
    """Immutable publish: tmp + fsync, then ``os.link`` — which fails with
    EEXIST atomically, unlike an exists-check + rename (TOCTOU) or rename
    itself (silent clobber).  An existing file with identical content is an
    idempotent content-addressed replay; different content is an error.

    Concurrent-GC tolerance: another replica's compactor may remove the
    colliding file — or the whole emptied directory (``remove_ops``
    rmdir's an emptied actor dir) — between any two steps here.  A
    vanished DIRECTORY always retries (``makedirs`` recreates it; the
    name was never observable with other content).  A vanished
    COLLIDER retries only for content-addressed names
    (``relink_vanished_collider=True``: same name ⇒ same bytes, so the
    relink republishes identical content).  Version-addressed op files
    pass False: the collider existed moments ago, so a peer may have
    folded it into a snapshot — republishing DIFFERENT content at that
    version would be invisible to every cursor already past it, a
    silent write loss; the burned version surfaces as
    ``FileExistsError`` and the producer's probe loop picks the next
    one.  The retry is bounded — each round needs a fresh removal, and
    removals need fresh content to collect."""
    d = os.path.dirname(path)
    for _ in range(8):
        try:
            tmp = _write_tmp(d, data)
        except FileNotFoundError:
            continue  # dir rmdir'd between makedirs and the tmp open
        try:
            try:
                os.link(tmp, path)
            except FileExistsError:
                try:
                    with open(path, "rb") as f:
                        if f.read() == data:
                            return
                except FileNotFoundError:
                    if relink_vanished_collider:
                        continue  # content-addressed: relink same bytes
                    raise FileExistsError(
                        f"{path}: version burned by a GC'd concurrent "
                        "write; probe forward"
                    ) from None
                raise FileExistsError(
                    f"{path} exists with different content"
                ) from None
            except FileNotFoundError:
                continue  # dir rmdir'd between the tmp write and link
        finally:
            _remove_quiet(tmp)
        try:
            _fsync_dir(d)
        except FileNotFoundError:
            # the directory — and with it our freshly linked file — was
            # emptied and rmdir'd by a concurrent compactor after the
            # link: the write happened and was legitimately collected,
            # exactly the observable world of write-then-GC.
            pass
        return
    raise OSError(f"could not publish {path}: directory kept vanishing")


def _read_file(path: str) -> bytes | None:
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


def _list_dir(path: str) -> list[str]:
    try:
        return [n for n in os.listdir(path) if not n.startswith(".tmp-")]
    except FileNotFoundError:
        return []


def _remove_quiet(path: str) -> bool:
    """Unlink ``path``; whether it was there to unlink."""
    try:
        os.remove(path)
    except FileNotFoundError:
        return False
    return True


def _count_read(files: list, nbytes: int) -> None:
    """One batch's files and bytes read, counted once for the batch."""
    if files:
        trace.add("storage_files_read", len(files))
        trace.add("storage_bytes_read", nbytes)


def _count_removed(n: int) -> None:
    if n:
        trace.add("storage_files_removed", n)


class FsStorage(Storage):
    def __init__(self, local_path: str, remote_path: str):
        self.local = os.fspath(local_path)
        self.remote = os.fspath(remote_path)
        self._sem = asyncio.Semaphore(FS_CONCURRENCY)

    async def _run(self, fn, *args):
        async with self._sem:
            return await asyncio.to_thread(fn, *args)

    # paths
    def _local_meta_path(self) -> str:
        return os.path.join(self.local, "meta-data.msgpack")

    def _local_checkpoint_path(self) -> str:
        return os.path.join(self.local, "checkpoint.msgpack")

    def _meta_dir(self) -> str:
        return os.path.join(self.remote, "meta")

    def _states_dir(self) -> str:
        return os.path.join(self.remote, "states")

    def _ops_dir(self, actor: Actor | None = None) -> str:
        base = os.path.join(self.remote, "ops")
        return os.path.join(base, actor.hex()) if actor is not None else base

    def _deltas_dir(self, actor: Actor | None = None) -> str:
        base = os.path.join(self.remote, "deltas")
        return os.path.join(base, actor.hex()) if actor is not None else base

    # -- local meta --------------------------------------------------------
    async def load_local_meta(self) -> bytes | None:
        return await self._run(_read_file, self._local_meta_path())

    async def store_local_meta(self, data: bytes) -> None:
        await self._run(_write_file_atomic, self._local_meta_path(), bytes(data))

    # -- local fold checkpoint ---------------------------------------------
    # The local meta's durability discipline: tmp + fsync + atomic rename,
    # so a crash mid-write leaves the previous checkpoint (or none), never
    # a torn blob.
    async def load_local_checkpoint(self) -> bytes | None:
        return await self._run(_read_file, self._local_checkpoint_path())

    async def store_local_checkpoint(self, data: bytes) -> None:
        await self._run(
            _write_file_atomic, self._local_checkpoint_path(), bytes(data)
        )

    async def remove_local_checkpoint(self) -> None:
        await self._run(_remove_quiet, self._local_checkpoint_path())

    # -- content-addressed families ---------------------------------------
    async def _list_ca(self, d: str) -> list[str]:
        return sorted(await self._run(_list_dir, d))

    async def _load_ca(self, d: str, names: list[str]) -> list[tuple[str, bytes]]:
        async def one(n):
            raw = await self._run(_read_file, os.path.join(d, n))
            return (n, raw) if raw is not None else None

        loaded = await asyncio.gather(*(one(n) for n in names))
        return [x for x in loaded if x is not None]

    async def _store_ca(self, d: str, data: bytes) -> str:
        name = content_name(data)
        await self._run(_write_file_new, os.path.join(d, name), bytes(data))
        return name

    async def _remove_ca(self, d: str, names: list[str]) -> int:
        gone = await asyncio.gather(
            *(self._run(_remove_quiet, os.path.join(d, n)) for n in names)
        )
        return sum(gone)

    async def list_remote_meta_names(self) -> list[str]:
        return await self._list_ca(self._meta_dir())

    async def load_remote_metas(self, names: list[str]) -> list[tuple[str, bytes]]:
        return await self._load_ca(self._meta_dir(), names)

    async def store_remote_meta(self, data: bytes) -> str:
        return await self._store_ca(self._meta_dir(), data)

    async def remove_remote_metas(self, names: list[str]) -> None:
        await self._remove_ca(self._meta_dir(), names)

    async def list_state_names(self) -> list[str]:
        return await self._list_ca(self._states_dir())

    async def load_states(self, names: list[str]) -> list[tuple[str, bytes]]:
        out = await self._load_ca(self._states_dir(), names)
        _count_read(out, sum(len(raw) for _, raw in out))
        return out

    async def store_state(self, data: bytes) -> str:
        return await self._store_ca(self._states_dir(), data)

    async def remove_states(self, names: list[str]) -> None:
        _count_removed(await self._remove_ca(self._states_dir(), names))

    # -- op logs -----------------------------------------------------------
    async def list_op_actors(self) -> list[Actor]:
        names = await self._run(_list_dir, self._ops_dir())
        actors = []
        for n in names:
            try:
                actors.append(bytes.fromhex(n))
            except ValueError:
                continue  # foreign junk in the synced dir is not ours to judge
        return sorted(a for a in actors if len(a) == 16)

    # One C++ call scans/reads a whole dense per-actor run — per-file
    # Python open/read costs ~10-20µs of interpreter overhead, which
    # dominates at compaction scale.  Each round is capped in files AND
    # bytes so one gigantic log never demands an unbounded flat buffer;
    # the loop continues where the previous round stopped.
    NATIVE_SCAN_BATCH = 65_536
    NATIVE_SCAN_BYTES = 256 << 20
    # Chunk budget of the pipelined ingest (iter_op_chunks): small enough
    # that a few chunks in flight bound host memory and the read, decrypt
    # and fold stages overlap, large enough that the batched decrypt and
    # decode amortize.
    CHUNK_BYTES = 24 << 20
    # how many actors scan concurrently ahead of the emitter; in-flight
    # memory is bounded by ~window × 2 × CHUNK_BYTES (one queued and one
    # in-progress round per actor)
    CHUNK_SCAN_WINDOW = 4

    class _ScanRace(Exception):
        """A file in the round shrank/vanished/errored between the two
        native passes; the round starting at ``.version`` needs a per-file
        re-probe."""

        def __init__(self, version: int):
            self.version = version

    def _scan_sizes_native(self, lib, d: bytes, v: int):
        """One bounded native size-only pass (``scan_op_sizes``): the
        dense per-file sizes from version ``v``, as ``(sizes[:n],
        exhausted)`` — ``exhausted`` means the directory ran out inside
        this round."""
        sizes = np.zeros(self.NATIVE_SCAN_BATCH, np.int64)
        n = int(lib.scan_op_sizes(
            d, v, self.NATIVE_SCAN_BATCH, sizes.ctypes.data_as(native.i64p)
        ))
        n = max(n, 0)
        return sizes[:n], n < self.NATIVE_SCAN_BATCH

    def _scan_round_native(self, lib, d: bytes, actor: Actor, v: int, max_bytes: int):
        """One bounded native round.  Returns ``(files, next_v, done)``;
        raises :class:`_ScanRace` on a mid-round race (nothing consumed)."""
        sizes, exhausted = self._scan_sizes_native(lib, d, v)
        n = len(sizes)
        if n == 0:
            return [], v, True
        scanned = n
        # byte cap: shrink this round to the prefix that fits (but always
        # take at least one file so progress is guaranteed)
        cum = np.cumsum(sizes)
        if cum[-1] > max_bytes:
            n = max(1, int(np.searchsorted(cum, max_bytes, "right")))
            sizes = sizes[:n]
        offsets = np.zeros(n, np.int64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        buf = np.empty(int(sizes.sum()), np.uint8)
        got = lib.read_op_files(
            d, v, n,
            offsets.ctypes.data_as(native.i64p),
            sizes.ctypes.data_as(native.i64p),
            buf.ctypes.data_as(native.u8p),
        )
        if got != n:
            logger.debug(
                "native bulk read raced at actor %s v%d; "
                "re-probing round per-file", actor.hex(), v,
            )
            raise self._ScanRace(v)
        mv = memoryview(buf)
        bounds = np.append(offsets, offsets[-1] + sizes[-1]).tolist()
        files = [
            (actor, v + i, bytes(mv[bounds[i] : bounds[i + 1]]))
            for i in range(n)
        ]
        done = exhausted and n == scanned
        return files, v + n, done

    def _scan(self, actor: Actor, first: int) -> list[tuple[Actor, int, bytes]]:
        """Dense scan of one actor's log from ``first`` in native rounds.
        A round that raced a concurrent GC re-reads from its start file by
        file, which tells a benign race (file gone → clean dense end) from
        a defect (file present but unreadable → raises)."""
        lib = native.load()
        d = self._ops_dir(actor).encode()
        out: list[tuple[Actor, int, bytes]] = []
        v = first
        while True:
            try:
                files, v, done = self._scan_round_native(
                    lib, d, actor, v, self.NATIVE_SCAN_BYTES
                )
            except self._ScanRace as race:
                v = race.version
                break
            out.extend(files)
            if done:
                return out
        dd = self._ops_dir(actor)
        while True:
            raw = _read_file(os.path.join(dd, str(v)))
            if raw is None:
                return out
            out.append((actor, v, raw))
            v += 1

    def _chunk_round(self, actor: Actor, v: int, max_bytes: int):
        """One bounded round of the chunk iterator: the native round, or,
        after a mid-round race, the same round re-read file by file.
        Returns ``(files, next_v, done)``."""
        lib = native.load()
        d = self._ops_dir(actor).encode()
        try:
            return self._scan_round_native(lib, d, actor, v, max_bytes)
        except self._ScanRace:
            pass
        files: list[tuple[Actor, int, bytes]] = []
        size = 0
        dd = self._ops_dir(actor)
        while size < max_bytes:
            raw = _read_file(os.path.join(dd, str(v)))
            if raw is None:
                return files, v, True
            files.append((actor, v, raw))
            size += len(raw)
            v += 1
        return files, v, False

    def _probe_actors(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int]]:
        """Prefilter for the scan fan-out: keep only actors whose NEXT
        wanted op file exists (one dirfd-relative access per actor in one
        native call), so fully consumed logs cost no per-actor task."""
        n = len(actor_first_versions)
        if n == 0:
            return []
        lib = native.load()
        rel = b"\0".join(
            f"{actor.hex()}/{first}".encode()
            for actor, first in actor_first_versions
        ) + b"\0"
        mask = np.zeros(n, np.uint8)
        got = lib.probe_op_files(
            self._ops_dir().encode(), n, rel, mask.ctypes.data_as(native.u8p)
        )
        if got == -1:
            return []  # no ops directory at all
        kept = [actor_first_versions[i] for i in np.flatnonzero(mask).tolist()]
        if kept:
            trace.add("storage_files_statted", len(kept))
        return kept

    async def load_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        actor_first_versions = await self._run(
            self._probe_actors, actor_first_versions
        )
        per_actor = await asyncio.gather(
            *(self._run(self._scan, a, f) for a, f in actor_first_versions)
        )
        out = [item for chunk in per_actor for item in chunk]
        _count_read(out, sum(len(raw) for *_, raw in out))
        return out

    async def iter_op_chunks(
        self,
        actor_first_versions: list[tuple[Actor, int]],
        max_bytes: int | None = None,
    ):
        """Bounded-memory op reading for the pipelined ingest: yields
        ``(actor, version, raw)`` lists of about ``max_bytes``
        (``CHUNK_BYTES`` by default), per-actor version order preserved
        across chunks (a chunk may end mid-actor).

        Actors scan concurrently (a window of ``CHUNK_SCAN_WINDOW``,
        first in first out) while emission stays in actor order.  A
        scanner's exception is delivered in its actor's position and
        re-raised here, never left for the emitter to wait on."""
        max_bytes = max_bytes if max_bytes is not None else self.CHUNK_BYTES
        actor_first_versions = await self._run(
            self._probe_actors, actor_first_versions
        )
        window = asyncio.Semaphore(self.CHUNK_SCAN_WINDOW)

        async def scan_actor(actor: Actor, first: int, out_q: asyncio.Queue):
            # the semaphore is held for the actor's whole scan; waiters
            # are FIFO, so the window always covers the actor being
            # emitted — no deadlock against the bounded queues
            try:
                async with window:
                    v, done = first, False
                    while not done:
                        files, v, done = await self._run(
                            self._chunk_round, actor, v, max_bytes
                        )
                        if files:
                            await out_q.put(files)
                    await out_q.put(None)
            except Exception as e:
                await out_q.put(e)

        queues: list[asyncio.Queue] = []
        tasks: list[asyncio.Task] = []
        for actor, first in actor_first_versions:
            out_q: asyncio.Queue = asyncio.Queue(maxsize=1)
            queues.append(out_q)
            tasks.append(asyncio.create_task(scan_actor(actor, first, out_q)))
        chunk: list[tuple[Actor, int, bytes]] = []
        size = 0
        try:
            for out_q in queues:
                while True:
                    files = await out_q.get()
                    if files is None:
                        break
                    if isinstance(files, Exception):
                        raise files
                    for item in files:
                        chunk.append(item)
                        size += len(item[2])
                        if size >= max_bytes:
                            _count_read(chunk, size)
                            yield chunk
                            chunk, size = [], 0
            if chunk:
                _count_read(chunk, size)
                yield chunk
        finally:
            for t in tasks:
                t.cancel()

    async def stat_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, int]]:
        """Dense tail sizing without reading: the native ``scan_op_sizes``
        pass, probe-prefiltered like ``load_ops``.  The actors scan in at
        most ``FS_CONCURRENCY`` groups, one thread hop each: a replica
        opening on thousands of logs pays their stat calls, not a hop
        per log, and a latency-bound filesystem still sees that many
        scans in flight."""
        actor_first_versions = await self._run(
            self._probe_actors, actor_first_versions
        )

        def scan(group: list) -> list[tuple[Actor, int, int]]:
            lib = native.load()
            out: list[tuple[Actor, int, int]] = []
            for actor, first in group:
                d = self._ops_dir(actor).encode()
                v = first
                while True:
                    sizes, exhausted = self._scan_sizes_native(lib, d, v)
                    out.extend(
                        (actor, v + i, int(s)) for i, s in enumerate(sizes)
                    )
                    v += len(sizes)
                    if exhausted:
                        break
            if out:
                trace.add("storage_files_statted", len(out))
            return out

        n = len(actor_first_versions)
        width = max(1, -(-n // FS_CONCURRENCY))
        per_group = await asyncio.gather(*(
            self._run(scan, actor_first_versions[i : i + width])
            for i in range(0, n, width)
        ))
        return [item for chunk in per_group for item in chunk]

    async def store_ops(self, actor: Actor, version: int, data: bytes) -> None:
        path = os.path.join(self._ops_dir(actor), str(version))
        # version-addressed: a vanished collider BURNS the version (the
        # caller probes forward) — see _write_file_new's contract
        await self._run(
            functools.partial(
                _write_file_new, path, bytes(data),
                relink_vanished_collider=False,
            )
        )

    async def remove_ops(self, actor_last_versions: list[tuple[Actor, int]]) -> None:
        def rm(actor: Actor, last: int) -> int:
            d = self._ops_dir(actor)
            gone = 0
            for n in _list_dir(d):
                try:
                    v = int(n)
                except ValueError:
                    continue
                if v <= last:
                    gone += _remove_quiet(os.path.join(d, n))
            try:
                os.rmdir(d)  # tidy an emptied actor dir; fails if ops remain
            except OSError:
                pass
            return gone

        gone = await asyncio.gather(
            *(self._run(rm, a, last) for a, last in actor_last_versions)
        )
        _count_removed(sum(gone))

    # -- delta snapshots ---------------------------------------------------
    # Same layout idiom as the op logs (``remote/deltas/<actor-hex>/<N>``)
    # but a simpler read contract: logs are MAX_CHAIN-bounded and files
    # are deltas (small by construction), so a plain listdir+read per
    # actor is the whole fast path — no native scan, no probe prefilter.
    has_deltas = True

    async def list_delta_actors(self) -> list[Actor]:
        names = await self._run(_list_dir, self._deltas_dir())
        actors = []
        for n in names:
            try:
                actors.append(bytes.fromhex(n))
            except ValueError:
                continue  # foreign junk in the synced dir is not ours to judge
        return sorted(a for a in actors if len(a) == 16)

    async def load_deltas(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        def scan(actor: Actor, first: int) -> list[tuple[Actor, int, bytes]]:
            d = self._deltas_dir(actor)
            versions = sorted(
                v for v in (
                    int(n) for n in _list_dir(d) if n.isdigit()
                ) if v >= first
            )
            out = []
            for v in versions:
                raw = _read_file(os.path.join(d, str(v)))
                if raw is not None:  # racing GC may collect mid-walk
                    out.append((actor, v, raw))
            return out

        per_actor = await asyncio.gather(
            *(self._run(scan, a, f) for a, f in actor_first_versions)
        )
        return [item for chunk in per_actor for item in chunk]

    async def store_delta(self, actor: Actor, version: int, data: bytes) -> None:
        path = os.path.join(self._deltas_dir(actor), str(version))
        # version-addressed like op files: a vanished collider burns the
        # version (the producer probes forward) — _write_file_new's contract
        await self._run(
            functools.partial(
                _write_file_new, path, bytes(data),
                relink_vanished_collider=False,
            )
        )

    async def remove_deltas(
        self, actor_last_versions: list[tuple[Actor, int]]
    ) -> None:
        def rm(actor: Actor, last: int) -> int:
            d = self._deltas_dir(actor)
            gone = 0
            for n in _list_dir(d):
                try:
                    v = int(n)
                except ValueError:
                    continue
                if v <= last:
                    gone += _remove_quiet(os.path.join(d, n))
            try:
                os.rmdir(d)
            except OSError:
                pass
            return gone

        gone = await asyncio.gather(
            *(self._run(rm, a, last) for a, last in actor_last_versions)
        )
        _count_removed(sum(gone))
