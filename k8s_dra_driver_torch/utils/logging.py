"""The port of ``k8s_dra_driver_tpu/utils/logging.py`` (lines 1-64; copied: the port
imports nothing of the JAX package).

Structured logging setup (klog/logsapi analog, pkg/flags/logging.go).

Supports text and JSON formats like the reference's ``--logging-format``
bridge (logging.go:33-48); JSON output makes the driver's logs ingestible by
the same pipelines the k8s components feed.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
import traceback


class JSONFormatter(logging.Formatter):
    """JSON lines with full exception fidelity: ``logger.exception(...)``
    must not lose its traceback in JSON mode (the whole point of the
    format is machine-ingestible post-mortems), so ``exc_info`` is
    serialized structured — type, message, and traceback frames — and
    ``stack_info=True`` call-site stacks ride along as ``stack``."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            etype, exc, tb = record.exc_info
            doc["exc"] = {
                "type": etype.__name__ if etype else "",
                "message": str(exc),
                "traceback": [
                    ln.rstrip("\n")
                    for ln in traceback.format_exception(etype, exc, tb)
                ],
            }
        elif record.exc_text:
            # A text-format handler on the same record caches the rendered
            # traceback here; keep it rather than drop the exception.
            doc["exc"] = {"type": "", "message": "", "traceback": record.exc_text.splitlines()}
        if record.stack_info:
            doc["stack"] = record.stack_info.splitlines()
        return json.dumps(doc)


def get_logger(name: str, level: str | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("LOG_FORMAT", "text") == "json":
            handler.setFormatter(JSONFormatter())
        else:
            handler.setFormatter(
                logging.Formatter("%(asctime)s %(levelname).1s %(name)s] %(message)s")
            )
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel((level or os.environ.get("LOG_LEVEL", "INFO")).upper())
    return logger
