"""Cast sets: which typed representations a produced field value supports.

The port's own copy of the reference package's ``core/casts.py``.

Reference behavior: parser-core/src/main/java/nl/basjes/parse/core/Casts.java:22-31
(enum STRING/LONG/DOUBLE plus canned EnumSets). We use frozensets of a small enum.
"""
from __future__ import annotations

import enum


class Cast(enum.Enum):
    STRING = "STRING"
    LONG = "LONG"
    DOUBLE = "DOUBLE"

    def __repr__(self) -> str:  # terse in test failure tables
        return self.value


NO_CASTS: frozenset[Cast] = frozenset()
STRING_ONLY: frozenset[Cast] = frozenset({Cast.STRING})
LONG_ONLY: frozenset[Cast] = frozenset({Cast.LONG})
DOUBLE_ONLY: frozenset[Cast] = frozenset({Cast.DOUBLE})
STRING_OR_LONG: frozenset[Cast] = frozenset({Cast.STRING, Cast.LONG})
STRING_OR_DOUBLE: frozenset[Cast] = frozenset({Cast.STRING, Cast.DOUBLE})
LONG_OR_DOUBLE: frozenset[Cast] = frozenset({Cast.LONG, Cast.DOUBLE})
STRING_OR_LONG_OR_DOUBLE: frozenset[Cast] = frozenset(
    {Cast.STRING, Cast.LONG, Cast.DOUBLE}
)
