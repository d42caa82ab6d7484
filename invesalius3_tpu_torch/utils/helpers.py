"""Small general helpers (port of invesalius3_tpu/utils/helpers.py, the
part the slice uses)."""

from __future__ import annotations

import re
from typing import Sequence


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
