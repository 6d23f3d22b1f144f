"""The port of ``k8s_dra_driver_tpu/utils/fileio.py`` (copied: the port imports
nothing of the JAX package).

Atomic file-write helper shared by checkpoint and CDI spec writers."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any


def write_json_atomic(path: Path, doc: Any, indent: int = 2) -> Path:
    """Write JSON via tmp-file + rename so readers never see a torn file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=indent, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
