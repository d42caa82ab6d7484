"""``tr``, the translation of user-facing messages (the part of
invesalius3_tpu/utils/i18n.py the app calls; reference invesalius/i18n.py
lazy ``tr`` :95-108).

The port ships no message catalogs yet, so ``tr`` returns the message id;
the gettext lookup and the language choice come with the catalogs.
"""

from __future__ import annotations


def tr(message: str) -> str:
    return message
