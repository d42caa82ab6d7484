"""Translation of user-facing messages (port of
invesalius3_tpu/utils/i18n.py; reference invesalius/i18n.py:
``InstallLanguage`` :74, the lazy ``tr`` :95-108).

The catalogs are the port's own copy under ``invesalius3_tpu_torch/locale/``
(24 languages, gettext domain ``invesalius3_tpu``, a .po source and its .mo
each).  The language is ``$INV3_LANGUAGE`` when set, else the process
locale's; English, and any language without a catalog, is the identity.
"""

from __future__ import annotations

import gettext
import locale as locale_mod
import os
import re
import struct
from pathlib import Path
from typing import Callable, List, Optional

DOMAIN = "invesalius3_tpu"

_translator: Optional[Callable[[str], str]] = None


def locale_dirs() -> List[Path]:
    """Where the catalogs are looked up: the package's ``locale/`` only."""
    return [Path(__file__).resolve().parent.parent / "locale"]


def get_locales() -> list:
    """Available language codes (directories containing LC_MESSAGES)."""
    out = {"en"}
    for root in locale_dirs():
        if root.is_dir():
            for child in root.iterdir():
                if (child / "LC_MESSAGES").is_dir():
                    out.add(child.name)
    return sorted(out)


def parse_po(text: str) -> dict:
    """Minimal .po parser (msgid/msgstr pairs, quoted-string continuation);
    untranslated ids are dropped, the "" header entry kept."""
    entries = {}
    msgid = msgstr = None
    mode = None

    def unquote(line):
        return re.match(r'\s*"(.*)"\s*$', line).group(1).encode(
            "raw_unicode_escape").decode("unicode_escape")

    for line in text.splitlines():
        s = line.strip()
        if s.startswith("#") or not s:
            continue
        if s.startswith("msgid "):
            if msgid is not None and msgstr is not None:
                entries[msgid] = msgstr
            msgid = unquote(s[6:])
            msgstr = None
            mode = "id"
        elif s.startswith("msgstr "):
            msgstr = unquote(s[7:])
            mode = "str"
        elif s.startswith('"'):
            if mode == "id":
                msgid += unquote(s)
            elif mode == "str":
                msgstr += unquote(s)
    if msgid is not None and msgstr is not None:
        entries[msgid] = msgstr
    return {k: v for k, v in entries.items() if v or k == ""}


def compile_po_to_mo(po_path: Path, mo_path: Path) -> None:
    """Tiny msgfmt: write a GNU .mo from a .po (no plural forms)."""
    entries = parse_po(Path(po_path).read_text(encoding="utf-8"))
    keys = sorted(entries)
    offsets = []
    ids = strs = b""
    for k in keys:
        kid = k.encode("utf-8")
        val = entries[k].encode("utf-8")
        offsets.append((len(ids), len(kid), len(strs), len(val)))
        ids += kid + b"\x00"
        strs += val + b"\x00"
    n = len(keys)
    keystart = 7 * 4 + 16 * n
    valuestart = keystart + len(ids)
    koffsets = []
    voffsets = []
    for o1, l1, o2, l2 in offsets:
        koffsets += [l1, o1 + keystart]
        voffsets += [l2, o2 + valuestart]
    out = struct.pack("<7I", 0x950412DE, 0, n, 7 * 4, 7 * 4 + n * 8, 0, 0)
    out += struct.pack(f"<{2 * n}I", *koffsets)
    out += struct.pack(f"<{2 * n}I", *voffsets)
    out += ids + strs
    mo_path.parent.mkdir(parents=True, exist_ok=True)
    mo_path.write_bytes(out)


def _ensure_compiled(root: Path, language: str) -> None:
    """Compile a language's .po when its .mo is missing (a catalog added
    as a .po alone)."""
    po = root / language / "LC_MESSAGES" / f"{DOMAIN}.po"
    mo = po.with_suffix(".mo")
    if po.is_file() and not mo.is_file():
        try:
            compile_po_to_mo(po, mo)
        except (OSError, ValueError, AttributeError):
            pass


def install_language(language: str = "") -> Callable[[str], str]:
    """Install the translator for ``language`` (the current language when
    empty) and return it; it is also what ``tr`` calls."""
    global _translator
    if not language:
        language = current_language()
    for root in locale_dirs():
        for lang in (language, language.split("_")[0]):
            _ensure_compiled(root, lang)
        try:
            t = gettext.translation(DOMAIN, localedir=str(root), languages=[language])
            _translator = t.gettext
            return _translator
        except (FileNotFoundError, OSError):
            continue
    _translator = lambda s: s  # noqa: E731 -- no catalog: the identity
    return _translator


def tr(message: str) -> str:
    """Lazy translation (reference Translator ``tr`` :95-108)."""
    if _translator is None:
        install_language()
    return _translator(message)


def current_language() -> str:
    lang = os.environ.get("INV3_LANGUAGE", "")
    if lang:
        return lang
    try:
        lang = (locale_mod.getlocale()[0] or "en").split("_")[0]
    except ValueError:
        return "en"
    return "en" if lang in ("C", "POSIX") else lang


def current_catalog(language: str = "") -> dict:
    """msgid -> msgstr of ``language`` (the web client fetches it through
    GET /api/i18n and localises its strings)."""
    language = language or current_language()
    for root in locale_dirs():
        for lang in (language, language.split("_")[0]):
            po = root / lang / "LC_MESSAGES" / f"{DOMAIN}.po"
            if po.is_file():
                cat = parse_po(po.read_text(encoding="utf-8"))
                cat.pop("", None)
                return cat
    return {}
