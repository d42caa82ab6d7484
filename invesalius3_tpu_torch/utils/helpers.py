"""Small general helpers (port of invesalius3_tpu/utils/helpers.py;
reference invesalius/utils.py).

``Singleton`` metaclass (:164), ``TwoWaysDictionary`` (:183),
``next_copy_name`` (:88), ``timing`` decorator (:392).
"""

from __future__ import annotations

import functools
import re
import time
from typing import Callable, Sequence


class Singleton(type):
    """Metaclass: one shared instance per class (reference utils.py:164)."""

    def __init__(cls, name, bases, dic):
        super().__init__(name, bases, dic)
        cls.instance = None

    def __call__(cls, *args, **kw):
        if cls.instance is None:
            cls.instance = super().__call__(*args, **kw)
        return cls.instance


class TwoWaysDictionary(dict):
    """Dict searchable by value as well as key (reference utils.py:183)."""

    def get_key(self, value):
        keys = self.get_keys(value)
        return keys[0] if keys else None

    def get_keys(self, value) -> list:
        return [k for k, v in self.items() if v == value]

    def get_value(self, key):
        return self.get(key, None)

    def remove(self, key) -> None:
        self.pop(key, None)


def next_copy_name(original_name: str, names_list: Sequence[str]) -> str:
    """Name for a duplicate, following the reference pattern
    `name` -> `name copy` -> `name copy#1` -> `name copy#2` (utils.py:88):
    a numbered input `... copy#N` continues from N+1."""
    m = re.match(r"^(.*) copy#(\d+)$", original_name)
    if m:
        base = f"{m.group(1)} copy"
        i = int(m.group(2)) + 1
    elif original_name.endswith(" copy"):
        base = original_name
        i = 1
    else:
        base = f"{original_name} copy"
        if base not in names_list:
            return base
        i = 1
    while f"{base}#{i}" in names_list:
        i += 1
    return f"{base}#{i}"


def timing(fn: Callable) -> Callable:
    """Wall-clock a call, stashing the duration on ``wrapper.last_seconds``
    (reference utils.py:392).  It does not wait for the card: see device
    work in a ``utils.logging.trace``."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        wrapper.last_seconds = time.perf_counter() - t0
        return out

    wrapper.last_seconds = None
    return wrapper
