"""Crash-consistent checkpoint IO: tmp → fsync → atomic rename + manifest.

The port's copy of the JAX package's `resilience/checkpoint.py`.

The write protocol (cf. CheckFreq, Mohan et al., FAST'21):

1. the writer produces the payload in `path + ".tmp.<pid>"` (same
   directory, so the rename is atomic on POSIX);
2. the tmp file is fsync'd, then `os.replace`'d over the canonical path;
3. the containing directory is fsync'd so the rename itself survives a
   power cut;
4. a sidecar manifest (`path + ".sha256"`) with the payload's sha256 and
   size is written through the same tmp/fsync/rename dance.

A crash at any step leaves either the previous canonical file (+ its
manifest) or the complete new pair — never a torn canonical file that
loads garbage. `verify` checks a file against its manifest at load; a
file without a manifest (pre-resilience checkpoints) verifies as legacy.

This module hosts the `ckpt.write` fault-injection site: mode `fail`
raises mid-write (tmp file only — canonical untouched), mode `torn`
deliberately bypasses the protocol and leaves a truncated canonical file
with a full-payload manifest, which is exactly the corruption `verify`
must catch.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os

from . import fault as _fault

logger = logging.getLogger(__name__)

__all__ = ["atomic_save", "atomic_write_bytes", "manifest_path",
           "read_manifest", "verify"]

MANIFEST_SUFFIX = ".sha256"

_WRITE_METRIC = "mxtpu_ckpt_writes_total"
_WRITE_HELP = ("Checkpoint file writes through resilience.checkpoint, by "
               "outcome (ok, injected-fail, injected-torn).")
_VERIFY_METRIC = "mxtpu_ckpt_verify_failures_total"
_VERIFY_HELP = ("Checkpoint files that failed manifest verification at "
                "load, by reason (missing-file, size, checksum, "
                "bad-manifest).")

_CHUNK = 1 << 20


def manifest_path(path):
    """Sidecar manifest path for a checkpoint file."""
    return str(path) + MANIFEST_SUFFIX


def _sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path):
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # platforms/filesystems that can't open a directory
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replace_atomic(tmp, path):
    with open(tmp, "rb") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(path)


def _write_manifest(path, digest, size):
    m = manifest_path(path)
    tmp = m + f".tmp.{os.getpid()}"
    payload = json.dumps(
        {"file": os.path.basename(str(path)), "sha256": digest,
         "size": size, "version": 1},
        sort_keys=True).encode("utf-8")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, m)
    _fsync_dir(m)


def read_manifest(path):
    """The parsed sidecar manifest for `path`, or None if absent or
    unparseable."""
    try:
        with open(manifest_path(path), "rb") as f:
            m = json.loads(f.read().decode("utf-8"))
    except (OSError, ValueError):
        return None
    return m if isinstance(m, dict) and "sha256" in m else None


def _inc(name, help_, path=None, **labels):
    from .. import telemetry as _telemetry

    _telemetry.inc(name, 1, help=help_, **labels)
    # every write outcome / verify failure also lands in the flight
    # recorder, so a post-mortem dump shows the checkpoint history
    _telemetry.log_event(
        "ckpt_write" if name == _WRITE_METRIC else "ckpt_verify_failure",
        **(dict(labels, path=path) if path else labels))


def atomic_save(path, writer, site="ckpt.write", instance=""):
    """Crash-consistently materialize `path` via `writer(tmp_path)`.

    `writer` produces the full payload at the tmp path it is given (e.g.
    `lambda p: torch.save(state, p)`); this function then runs the
    fsync/rename/manifest protocol. Returns the payload's sha256 hex.
    """
    path = str(path)
    act = _fault.injector().action(site, instance)
    tmp = path + f".tmp.{os.getpid()}"
    if act == "fail":
        # mid-write crash: partial tmp file, canonical + manifest untouched
        with open(tmp, "wb") as f:
            f.write(b"\0" * 64)
        _inc(_WRITE_METRIC, _WRITE_HELP, path=path,
             outcome="injected-fail")
        raise _fault.InjectedIOError(
            f"fault injection: checkpoint write failed at {site!r} "
            f"({path})")
    try:
        writer(tmp)
        digest = _sha256_file(tmp)
        size = os.path.getsize(tmp)
        if act == "torn":
            # deliberately corrupt: truncated canonical + full-size
            # manifest — the torn state verify() exists to catch
            with open(tmp, "rb") as f:
                data = f.read(max(1, size // 2))
            with open(path, "wb") as f:
                f.write(data)
            os.remove(tmp)
            _write_manifest(path, digest, size)
            _inc(_WRITE_METRIC, _WRITE_HELP, path=path,
                 outcome="injected-torn")
            logger.warning("fault injection: torn checkpoint left at %s",
                           path)
            return digest
        _replace_atomic(tmp, path)
    except BaseException:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass
        raise
    _write_manifest(path, digest, size)
    _inc(_WRITE_METRIC, _WRITE_HELP, path=path, outcome="ok")
    return digest


def atomic_write_bytes(path, data, site="ckpt.write", instance=""):
    """`atomic_save` for an in-memory payload."""
    def _writer(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    return atomic_save(path, _writer, site=site, instance=instance)


def verify(path):
    """True iff `path` exists and matches its sidecar manifest.

    A file with no (or unparseable) manifest verifies as legacy-valid —
    pre-resilience checkpoints stay loadable. Missing file, size
    mismatch, or checksum mismatch is a verification failure (counted).
    """
    path = str(path)
    if not os.path.isfile(path):
        _inc(_VERIFY_METRIC, _VERIFY_HELP, path=path, reason="missing-file")
        return False
    m = read_manifest(path)
    if m is None:
        if os.path.exists(manifest_path(path)):
            _inc(_VERIFY_METRIC, _VERIFY_HELP, path=path, reason="bad-manifest")
            return False
        return True  # legacy checkpoint: no manifest was ever written
    size = m.get("size")
    if size is not None and os.path.getsize(path) != size:
        _inc(_VERIFY_METRIC, _VERIFY_HELP, path=path, reason="size")
        logger.warning("checkpoint %s failed verification: size %d != "
                       "manifest %d", path, os.path.getsize(path), size)
        return False
    if _sha256_file(path) != m["sha256"]:
        _inc(_VERIFY_METRIC, _VERIFY_HELP, path=path, reason="checksum")
        logger.warning("checkpoint %s failed verification: checksum "
                       "mismatch", path)
        return False
    return True
