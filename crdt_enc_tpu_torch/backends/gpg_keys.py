"""OpenPGP key-cryptor backend — real PGP recipient management.  The port's
copy of ``crdt_enc_tpu/backends/gpg_keys.py``.

The interop the reference's gpgme plugin declared and never shipped: its
``KeyHandler`` holds gpgme context fields and a recipient ``Meta`` CRDT,
but the actual encrypt/decrypt calls are commented out and the installed
transforms are identity functions (crdt-enc-gpgme/src/lib.rs:95-98,
118-121, 131-175).  This backend does the real thing through the ``gpg``
binary: the serialized Keys CRDT is sealed as a standard OpenPGP message
to a set of recipient key fingerprints (and optionally signed), so any
OpenPGP implementation can audit or decrypt the key metadata, and
recipient management is ordinary keyring management.

Each replica needs a GnuPG home with its own secret key and the public
keys of every recipient.  ``recipients`` are fingerprints (or any gpg
user-id selector); the local secret key decrypts inbound blobs.  Trust is
delegated to gpg's keyring (``--trust-model always`` scoped to the given
home): importing a public key into the home IS the authorization act,
playing the roster role the reference's unused ``Meta`` CRDT sketched.

A register may hold concurrent values sealed to recipient sets this
replica is not in — those are tolerated per value (``DECODE_TOLERATES``).
"""

from __future__ import annotations

import asyncio
import os
import shutil
import subprocess

from ..utils.versions import (
    GPG_KEYS_META_VERSION_1,
    SUPPORTED_GPG_KEYS_META_VERSIONS,
)
from .plain_keys import PlainKeyCryptor


class GpgError(Exception):
    """gpg invocation failed (missing binary, bad keyring, agent trouble,
    unknown recipient, …) — an ENVIRONMENTAL problem, never tolerated as
    a per-value skip."""


class NotDecryptable(GpgError):
    """This replica's keyring genuinely cannot open the blob (not a
    recipient / no secret key) or a required signature is missing — the
    only gpg failures the register decode may tolerate per value."""


class _GpgExit(GpgError):
    """Internal: nonzero gpg exit with the machine-readable status kept
    so callers can classify the failure."""

    def __init__(self, msg: str, status: bytes):
        super().__init__(msg)
        self.status = status


def gpg_available() -> bool:
    return shutil.which("gpg") is not None


def _status_has(status: bytes, keyword: str) -> bool:
    """True iff a status LINE carries ``keyword`` — never substring-match
    the whole buffer: parts of it (e.g. the PLAINTEXT filename field) are
    attacker-controlled content."""
    prefix = b"[GNUPG:] " + keyword.encode()
    return any(
        line == prefix or line.startswith(prefix + b" ")
        for line in status.splitlines()
    )


def _run_gpg(
    args: list[str], data: bytes, gnupg_home: str | None
) -> tuple[bytes, bytes]:
    """Run gpg with ``data`` on stdin; returns (stdout, status_bytes).
    ``--status-fd`` goes to a dedicated pipe (drained concurrently — gpg
    must never block on an unread status write) so machine-readable
    status is never confused with human stderr.  Nonzero exit raises
    :class:`_GpgExit` carrying the status for classification."""
    import threading

    env = dict(os.environ)
    if gnupg_home is not None:
        env["GNUPGHOME"] = os.fspath(gnupg_home)
    status_r, status_w = os.pipe()
    chunks: list[bytes] = []

    def drain():
        while True:
            chunk = os.read(status_r, 65536)
            if not chunk:
                return
            chunks.append(chunk)

    reader = threading.Thread(target=drain, daemon=True)
    reader.start()
    try:
        cmd = ["gpg", "--batch", "--yes", "--quiet", "--no-tty",
               "--pinentry-mode", "loopback",
               "--status-fd", str(status_w)] + args
        try:
            proc = subprocess.run(
                cmd, input=data, capture_output=True, env=env, timeout=120,
                pass_fds=(status_w,),
            )
        except FileNotFoundError as e:
            raise GpgError("gpg binary not found") from e
        except subprocess.TimeoutExpired as e:
            raise GpgError("gpg timed out") from e
    finally:
        os.close(status_w)
        reader.join(timeout=10)
        os.close(status_r)
    status = b"".join(chunks)
    if proc.returncode != 0:
        raise _GpgExit(
            f"gpg exited {proc.returncode}: "
            f"{proc.stderr.decode(errors='replace').strip()}",
            status,
        )
    return proc.stdout, status


class GpgKeyCryptor(PlainKeyCryptor):
    """Key management sealed as OpenPGP messages via the ``gpg`` binary.

    ``recipients``: gpg key selectors (fingerprints preferred) the Keys
    blob is encrypted to — include this replica's own key so it can read
    back its own writes.  ``gnupg_home``: the GnuPG home holding this
    replica's secret key and the recipients' public keys (None = gpg's
    default).  ``sign_with``: optional secret-key selector to sign blobs
    with (recipients should then verify; gpg rejects bad signatures on
    decrypt when ``require_signature`` is set)."""

    META_VERSION = GPG_KEYS_META_VERSION_1
    SUPPORTED_META_VERSIONS = SUPPORTED_GPG_KEYS_META_VERSIONS
    DECODE_TOLERATES = (NotDecryptable,)

    def __init__(
        self,
        recipients: list[str],
        gnupg_home: str | None = None,
        sign_with: str | None = None,
        require_signature: bool = False,
    ):
        super().__init__()
        if not recipients:
            raise ValueError("at least one OpenPGP recipient required")
        if require_signature and not sign_with:
            raise ValueError(
                "require_signature without sign_with would reject this "
                "replica's own (unsigned) writes"
            )
        self._recipients = [str(r) for r in recipients]
        self._home = gnupg_home
        self._sign_with = sign_with
        self._require_signature = require_signature

    async def _protect(self, raw: bytes) -> bytes:
        args = ["--encrypt", "--trust-model", "always", "--output", "-"]
        for r in self._recipients:
            args += ["--recipient", r]
        if self._sign_with:
            args += ["--sign", "--local-user", self._sign_with]
        try:
            out, _status = await asyncio.to_thread(
                _run_gpg, args, raw, self._home
            )
        except _GpgExit as e:
            raise GpgError(f"OpenPGP encrypt failed: {e}") from e
        return out

    async def _unprotect(self, vb) -> bytes:
        try:
            clear, status = await asyncio.to_thread(
                _run_gpg, ["--decrypt", "--output", "-"], bytes(vb.content),
                self._home,
            )
        except _GpgExit as e:
            # ONLY genuine can't-open outcomes may be tolerated per value;
            # environmental failures (agent, keyring lock, …) must stay
            # loud or a transient error could silently drop key material
            if _status_has(e.status, "DECRYPTION_FAILED") or _status_has(
                e.status, "NO_SECKEY"
            ):
                raise NotDecryptable(str(e)) from e
            raise GpgError(f"OpenPGP decrypt failed: {e}") from e
        if self._require_signature and not _status_has(status, "GOODSIG"):
            # gpg verifies embedded signatures during --decrypt; this turns
            # an UNSIGNED (or unverifiable-signer) blob from a pass-through
            # into a per-value rejection.  GOODSIG is matched as a status
            # LINE — the status buffer also carries attacker-controlled
            # content (e.g. the PLAINTEXT filename field)
            raise NotDecryptable(
                "blob is not signed by a key this keyring can verify"
            )
        return clear
