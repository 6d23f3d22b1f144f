"""The port of ``k8s_dra_driver_tpu/plugin/checkpoint.py`` (copied: the port imports
nothing of the JAX package).

Checksummed checkpoint of prepared-claim state.

Mirror of cmd/nvidia-dra-plugin/checkpoint.go (kubelet checkpointmanager
format: versioned schema + checksum, single ``checkpoint.json`` under the
plugin dir — main.go:39-41, device_state.go:94-155).  Restoring across plugin
restarts is what makes Prepare idempotent under kubelet retries.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

from k8s_dra_driver_torch.utils.fileio import write_json_atomic
from k8s_dra_driver_torch.utils.metrics import REGISTRY
from k8s_dra_driver_torch.version import __version__

# Counted at the lowest level so every writer (per-claim immediate writes,
# group-committed batches, orphan cleanup) is visible to the perf-smoke
# budget: each write is an fsync on the kubelet-visible prepare path.
_CHECKPOINT_WRITES = REGISTRY.counter(
    "dra_checkpoint_writes_total",
    "Durable (fsynced) checkpoint file writes",
)

SCHEMA_VERSION = "v2"
# Versions this build can still read.  v1 (round 1/2 deployments) carried
# only {version, checksum, preparedClaims}; v2 adds writerVersion so a
# restore after an upgrade can log WHICH driver build wrote the state —
# the checkpointmanager-style migration path (reference checkpoint.go
# pins a named CheckpointV1 schema for exactly this reason).  Reading a
# v1 file works transparently; the next write() upgrades it in place.
_READABLE_VERSIONS = ("v1", "v2")


class CorruptCheckpoint(RuntimeError):
    pass


def _checksum(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()


class CheckpointFile:
    """``prepared_claims``: claim-uid → JSON-serializable prepared state."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        #: driver version that wrote the file last read, for upgrade-path
        #: logging ("" before the first read / for v1 files, which predate
        #: the field).
        self.writer_version = ""

    def read(self) -> dict[str, Any]:
        if not self.path.exists():
            return {}
        doc = json.loads(self.path.read_text())
        version = doc.get("version")
        if version not in _READABLE_VERSIONS:
            # A FUTURE schema is not guessable: downgrades must fail loudly
            # rather than silently drop fields a newer build depends on.
            raise CorruptCheckpoint(f"unknown checkpoint version {version!r}")
        payload = json.dumps(doc.get("preparedClaims", {}), sort_keys=True)
        if _checksum(payload) != doc.get("checksum"):
            raise CorruptCheckpoint(f"checksum mismatch in {self.path}")
        self.writer_version = doc.get("writerVersion", "")
        return doc["preparedClaims"]

    def write(self, prepared_claims: dict[str, Any]) -> None:
        payload = json.dumps(prepared_claims, sort_keys=True)
        doc = {
            "version": SCHEMA_VERSION,
            "checksum": _checksum(payload),
            "preparedClaims": prepared_claims,
            "writerVersion": __version__,
        }
        write_json_atomic(self.path, doc, indent=1)
        _CHECKPOINT_WRITES.inc()
