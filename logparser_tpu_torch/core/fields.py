"""Field identity, parsed-field triple, setter policies, and the @field decorator.

The port's own copy of the reference package's ``core/fields.py``.

Reference behavior:
- Field ids are ``TYPE:dotted.path`` strings; TYPE uppercased, path lowercased
  (parser-core/.../core/Parser.java:681-691 cleanupFieldValue).
- ParsedField = (type, name, Value); id via makeId (ParsedField.java:53).
- @Field annotation marks record setters with wanted paths + SetterPolicy
  (Field.java:31-35, Parser.java:51-60).  Here: a decorator that tags methods.
"""
from __future__ import annotations

import enum
from typing import Callable, Iterable, List, Optional, Sequence, Union

from .value import Value


class SetterPolicy(enum.Enum):
    """When a setter is invoked relative to null/empty values.

    Reference: Parser.java:51-60 — ALWAYS calls with whatever value (possibly
    None); NOT_NULL skips None; NOT_EMPTY skips None and empty strings.
    """

    ALWAYS = "ALWAYS"
    NOT_NULL = "NOT_NULL"
    NOT_EMPTY = "NOT_EMPTY"


def cleanup_field_value(field_value: str) -> str:
    """Normalize ``TYPE:path`` — TYPE upper, path lower (Parser.java:681-691)."""
    colon = field_value.find(":")
    if colon == -1:
        return field_value.lower()
    return field_value[:colon].upper() + ":" + field_value[colon + 1 :].lower()


def make_field_id(ftype: str, name: str) -> str:
    return f"{ftype}:{name}"


class ParsedField:
    """(type, name, value) triple; identity is the ``TYPE:name`` id string."""

    __slots__ = ("type", "name", "value", "id")

    def __init__(self, ftype: str, name: str, value: Union[Value, str, int, float, None]):
        if not isinstance(value, Value):
            value = Value(value)
        self.type = ftype
        self.name = name
        self.value = value
        self.id = make_field_id(ftype, name)

    def __repr__(self) -> str:
        return f"ParsedField({self.id}={self.value!r})"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, ParsedField) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)


_FIELD_ATTR = "__logparser_fields__"
_POLICY_ATTR = "__logparser_setter_policy__"


def field(
    *paths: Union[str, Sequence[str]],
    setter_policy: SetterPolicy = SetterPolicy.ALWAYS,
) -> Callable:
    """Decorator marking a record method as a parse target for the given paths.

    Python analogue of the reference's ``@Field`` annotation (Field.java:31-35)::

        class MyRecord:
            @field("IP:connection.client.host")
            def set_ip(self, value: str): ...

            @field("STRING:request.firstline.uri.query.*")
            def set_query_param(self, name: str, value: str): ...

    The value-parameter's type annotation (str/int/float) selects which cast is
    delivered, mirroring the Java setter-signature dispatch (Parser.java:590-603).
    """
    flat: List[str] = []
    for p in paths:
        if isinstance(p, str):
            flat.append(p)
        else:
            flat.extend(p)

    def mark(fn: Callable) -> Callable:
        setattr(fn, _FIELD_ATTR, flat)
        setattr(fn, _POLICY_ATTR, setter_policy)
        return fn

    return mark


def get_field_paths(fn: Callable) -> Optional[List[str]]:
    return getattr(fn, _FIELD_ATTR, None)


def get_field_policy(fn: Callable) -> SetterPolicy:
    return getattr(fn, _POLICY_ATTR, SetterPolicy.ALWAYS)
