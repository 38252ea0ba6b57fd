"""Version-tagged byte blobs — the wire-format substrate.

The port's copy of ``crdt_enc_tpu/utils/version_bytes.py``, with
``VersionBytesBuf``, the zero-copy version‖content buffer for vectored
writes.

Every persisted object in the framework (op files, state snapshots, remote
metadata, key material, ciphertext envelopes) is a ``VersionBytes``: a 16-byte
format-version identifier (UUID) followed by an opaque payload.  Formats can
evolve without breaking old replicas because every boundary checks the version
against an explicit supported set before decoding.

Two serializations exist, mirroring the reference's wire surface
(the reference's ``crdt-enc/src/utils/version_bytes.rs``):

* **raw**: 16-byte big-endian UUID ‖ payload (reference ``serialize``/
  ``deserialize``, version_bytes.rs:186-208).  Used for whole files.
* **msgpack**: a 2-element array ``[version_bytes, payload_bytes]`` (reference
  serde tuple form, version_bytes.rs:32).  Used when a VersionBytes is nested
  inside another msgpack document (e.g. MVReg values, EncBox envelopes).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Iterable

VERSION_LEN = 16


class VersionError(Exception):
    """A version tag did not match the expected / supported set."""

    def __init__(self, got: bytes, expected: Iterable[bytes]):
        self.got = bytes(got)
        self.expected = [bytes(e) for e in expected]
        super().__init__(
            f"unsupported version {uuid.UUID(bytes=self.got)}; expected one of "
            f"{[str(uuid.UUID(bytes=e)) for e in self.expected]}"
        )


class DeserializeError(Exception):
    """Raw buffer too short to contain a version tag."""


def _as_version(v: bytes | uuid.UUID) -> bytes:
    if isinstance(v, uuid.UUID):
        return v.bytes
    v = bytes(v)
    if len(v) != VERSION_LEN:
        raise ValueError(f"version must be {VERSION_LEN} bytes, got {len(v)}")
    return v


@dataclass(frozen=True)
class VersionBytes:
    """An owned version-tagged payload."""

    version: bytes  # 16-byte big-endian UUID
    content: bytes

    def __post_init__(self) -> None:
        object.__setattr__(self, "version", _as_version(self.version))
        object.__setattr__(self, "content", bytes(self.content))

    # -- raw form: 16-byte UUID ‖ payload ---------------------------------
    def serialize(self) -> bytes:
        return self.version + self.content

    @classmethod
    def deserialize(cls, raw: bytes) -> "VersionBytes":
        raw = bytes(raw)
        if len(raw) < VERSION_LEN:
            raise DeserializeError(
                f"buffer of {len(raw)} bytes is too short for a "
                f"{VERSION_LEN}-byte version tag"
            )
        return cls(raw[:VERSION_LEN], raw[VERSION_LEN:])

    # -- msgpack form: 2-element array ------------------------------------
    def to_obj(self) -> list:
        """The msgpack-serializable form (2-element array)."""
        return [self.version, self.content]

    @classmethod
    def from_obj(cls, obj) -> "VersionBytes":
        if not isinstance(obj, (list, tuple)) or len(obj) != 2:
            raise DeserializeError(f"expected [version, content] pair, got {obj!r}")
        version, content = obj
        if not isinstance(version, (bytes, bytearray, memoryview)) or not isinstance(
            content, (bytes, bytearray, memoryview)
        ):
            raise DeserializeError(
                f"expected byte fields in [version, content] pair, got "
                f"[{type(version).__name__}, {type(content).__name__}]"
            )
        if len(bytes(version)) != VERSION_LEN:
            raise DeserializeError(
                f"version tag must be {VERSION_LEN} bytes, got {len(bytes(version))}"
            )
        return cls(bytes(version), bytes(content))

    # -- version checks ----------------------------------------------------
    def ensure_version(self, expected: bytes | uuid.UUID) -> "VersionBytes":
        expected = _as_version(expected)
        if self.version != expected:
            raise VersionError(self.version, [expected])
        return self

    def ensure_versions(self, supported: Iterable[bytes | uuid.UUID]) -> "VersionBytes":
        supported = [_as_version(s) for s in supported]
        if self.version not in supported:
            raise VersionError(self.version, supported)
        return self

    @property
    def uuid(self) -> uuid.UUID:
        return uuid.UUID(bytes=self.version)

    def buf(self) -> "VersionBytesBuf":
        return VersionBytesBuf(self.version, self.content)


class VersionBytesBuf:
    """Zero-copy buffer chaining the version tag and the content.

    Implements the chunked-buffer contract (remaining / chunk / advance /
    chunks_vectored) so writers can emit version‖content without concatenating
    (reference ``VersionBytesBuf``, version_bytes.rs:245-309).
    """

    def __init__(self, version: bytes | uuid.UUID, content: bytes):
        self._version = memoryview(_as_version(version))
        self._content = memoryview(bytes(content))
        self._pos = 0  # absolute cursor over version ‖ content

    def __len__(self) -> int:
        return self.remaining()

    def remaining(self) -> int:
        return (VERSION_LEN + len(self._content)) - self._pos

    def chunk(self) -> memoryview:
        """The current contiguous chunk (never straddles the boundary)."""
        if self._pos < VERSION_LEN:
            return self._version[self._pos :]
        off = self._pos - VERSION_LEN
        return self._content[off:]

    def advance(self, n: int) -> None:
        if n < 0:
            raise IndexError(f"cannot advance by negative amount {n}")
        if n > self.remaining():
            raise IndexError(
                f"cannot advance {n} bytes; only {self.remaining()} remaining"
            )
        self._pos += n

    def chunks_vectored(self, limit: int = 64) -> list[memoryview]:
        """All remaining chunks, for vectored (writev-style) I/O."""
        out: list[memoryview] = []
        if limit <= 0 or self.remaining() == 0:
            return out
        if self._pos < VERSION_LEN:
            out.append(self._version[self._pos :])
            if len(out) < limit and len(self._content) > 0:
                out.append(self._content[:])
        else:
            off = self._pos - VERSION_LEN
            if off < len(self._content):
                out.append(self._content[off:])
        return out

    def read_all(self) -> bytes:
        """Drain the buffer into one bytes object."""
        out = bytearray()
        while self.remaining():
            c = self.chunk()
            out += c
            self.advance(len(c))
        return bytes(out)
