"""Engine exceptions.

The port's own copy of the reference package's ``core/exceptions.py``.

Reference behavior: parser-core/.../core/exceptions/*.java — DissectionFailure is
the recoverable per-line failure; the others are configuration/API errors raised
during parser assembly.
"""
from __future__ import annotations


class DissectionFailure(Exception):
    """A single line could not be dissected (recoverable; callers skip/count)."""


class OracleEngineError:
    """Per-line MARKER (not an exception): the host oracle itself failed
    on this line — an engine bug or a pathological input tripping a code
    path no DissectionFailure covers.  Batched rescue (``parse_many``)
    returns it in place of the record so ONE such line costs itself, not
    the whole rescue batch, and downstream consumers surface it as a
    counted, reasoned reject (``reason="oracle_error"``) instead of a
    silent ``None`` or a batch-aborting raise.  Picklable — it rides the
    spawn-pool result path."""

    __slots__ = ("error",)

    def __init__(self, error: str):
        self.error = error

    def __repr__(self) -> str:  # pragma: no cover - debugging surface
        return f"OracleEngineError({self.error!r})"


class MissingDissectorsException(Exception):
    """Requested fields cannot be produced by any dissector chain."""


class InvalidDissectorException(Exception):
    """A dissector is malformed (no input type, no outputs, ...)."""


class InvalidFieldMethodSignature(Exception):
    """A parse-target callable has an unsupported signature."""


class FatalErrorDuringCallOfSetterMethod(Exception):
    """A record setter raised, or no setter accepted a stored value."""
