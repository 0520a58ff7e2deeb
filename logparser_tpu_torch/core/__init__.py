"""Engine-agnostic core runtime: Parser, Parsable, Dissector SPI, field identity.

The port's own copy of the reference package's ``core/`` (the rebuild of
the Java parser-core layer) -- the per-line host engine the batch
parser's oracle runs.  The reference's compiled line programs
(``core/fastline.py``) are not copied: ``Parser.parse`` and
``parse_many`` run the generic engine, which gives the same records.
"""
from .casts import (
    Cast,
    DOUBLE_ONLY,
    LONG_ONLY,
    LONG_OR_DOUBLE,
    NO_CASTS,
    STRING_ONLY,
    STRING_OR_DOUBLE,
    STRING_OR_LONG,
    STRING_OR_LONG_OR_DOUBLE,
)
from .dissector import Dissector, SimpleDissector
from .exceptions import (
    DissectionFailure,
    FatalErrorDuringCallOfSetterMethod,
    InvalidDissectorException,
    InvalidFieldMethodSignature,
    MissingDissectorsException,
)
from .fields import ParsedField, SetterPolicy, cleanup_field_value, field, make_field_id
from .parsable import Parsable
from .parser import Parser
from .value import Value

__all__ = [
    "Cast",
    "NO_CASTS",
    "STRING_ONLY",
    "LONG_ONLY",
    "DOUBLE_ONLY",
    "STRING_OR_LONG",
    "STRING_OR_DOUBLE",
    "LONG_OR_DOUBLE",
    "STRING_OR_LONG_OR_DOUBLE",
    "Dissector",
    "SimpleDissector",
    "DissectionFailure",
    "MissingDissectorsException",
    "InvalidDissectorException",
    "InvalidFieldMethodSignature",
    "FatalErrorDuringCallOfSetterMethod",
    "ParsedField",
    "SetterPolicy",
    "field",
    "cleanup_field_value",
    "make_field_id",
    "Parsable",
    "Parser",
    "Value",
]
