"""Structured, leveled logging for the launchers, ported from ``repro.obs.log``.

The launchers historically reported through raw ``print()`` — fine on a
terminal, useless to anything that wants to parse a run (CI log scrapers,
the dashboard replayer, fleet aggregation).  This module is the smallest
structured replacement that keeps the human-readable shape:

* ``get_logger("train")`` returns a named :class:`ObsLogger` whose
  ``info``/``warning``/... methods take one *event* string plus keyword
  *fields* — the machine-readable payload.
* Text mode renders ``[train] event key=value ...`` (what the launchers
  printed by hand); ``--json-logs`` switches every record to one JSON
  object per line; ``--quiet`` raises the threshold to warnings.
* Configuration is ambient (one process = one launcher run) and explicit:
  ``configure(...)`` or the shared argparse helpers ``add_flags`` /
  ``configure_from_args`` that every launcher routes through.

Deliberately not :mod:`logging`: no handler graph, no global registry
mutation that could collide with a host application embedding the
library — records go straight to the configured stream.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_CONFIG: Dict[str, Any] = {"level": LEVELS["info"], "json": False, "stream": None}


def configure(level: str = "info", json_logs: bool = False,
              stream: Optional[TextIO] = None) -> None:
    """Set the ambient log configuration (level threshold, format, stream).

    ``stream=None`` resolves to ``sys.stdout`` at emit time, so pytest's
    capsys and shell redirection both see the records.
    """
    if level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; one of {sorted(LEVELS)}")
    _CONFIG["level"] = LEVELS[level]
    _CONFIG["json"] = bool(json_logs)
    _CONFIG["stream"] = stream


def add_flags(parser) -> None:
    """Install the shared launcher flags (``--quiet``, ``--json-logs``)."""
    parser.add_argument("--quiet", action="store_true",
                        help="only warnings and errors on stdout")
    parser.add_argument("--json-logs", action="store_true",
                        help="one JSON object per log line (machine-parseable)")


def configure_from_args(args) -> None:
    configure(level="warning" if getattr(args, "quiet", False) else "info",
              json_logs=getattr(args, "json_logs", False))


def _fmt_value(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, str) and (" " in v or not v):
        return repr(v)
    return str(v)


class ObsLogger:
    """One named logger; see the module docstring for the record shapes."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def _emit(self, level: str, event: str, fields: Dict[str, Any]) -> None:
        if LEVELS[level] < _CONFIG["level"]:
            return
        stream = _CONFIG["stream"] or sys.stdout
        if _CONFIG["json"]:
            rec = {"t": time.time(), "lvl": level, "logger": self.name,
                   "event": event}
            if fields:
                rec["fields"] = fields
            stream.write(json.dumps(rec, default=str) + "\n")
        else:
            parts = [f"[{self.name}]"]
            if level not in ("info", "debug"):
                parts.append(level.upper())
            parts.append(event)
            parts.extend(f"{k}={_fmt_value(v)}" for k, v in fields.items())
            stream.write(" ".join(parts) + "\n")
        stream.flush()

    def debug(self, event: str, **fields: Any) -> None:
        self._emit("debug", event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit("info", event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit("warning", event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit("error", event, fields)


def get_logger(name: str) -> ObsLogger:
    return ObsLogger(name)
