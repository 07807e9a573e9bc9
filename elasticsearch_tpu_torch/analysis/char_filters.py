"""Char filters (pre-tokenization text transforms).

Reference: org/elasticsearch/index/analysis/HtmlStripCharFilterFactory.java,
MappingCharFilterFactory.java, PatternReplaceCharFilterFactory.java.
"""
from __future__ import annotations

import functools
import re
from typing import Callable

_TAG_RE = re.compile(r"<[^>]*>")
_ENTITIES = {"&amp;": "&", "&lt;": "<", "&gt;": ">", "&quot;": '"', "&apos;": "'", "&nbsp;": " "}


_ENTITY_RE = re.compile(r"&(amp|lt|gt|quot|apos|nbsp|#\d+);")


def _decode_entity(m: re.Match) -> str:
    body = m.group(1)
    if body.startswith("#"):
        return chr(int(body[1:]))
    return _ENTITIES["&" + body + ";"]


def html_strip(text: str) -> str:
    text = _TAG_RE.sub(" ", text)
    # single pass so decoded output is never re-decoded ("&amp;lt;" -> "&lt;")
    return _ENTITY_RE.sub(_decode_entity, text)


def mapping_char_filter(text: str, mappings=()) -> str:
    """mappings: list of "from => to" rules."""
    for rule in mappings:
        src, dst = rule.split("=>")
        text = text.replace(src.strip(), dst.strip())
    return text


def pattern_replace(text: str, pattern: str = "", replacement: str = "") -> str:
    # Joda/Java regex $1 backrefs -> python \1
    replacement = re.sub(r"\$(\d+)", r"\\\1", replacement)
    return re.sub(pattern, replacement, text)


CHAR_FILTERS: dict = {
    "html_strip": html_strip,
    "mapping": mapping_char_filter,
    "pattern_replace": pattern_replace,
}


def get_char_filter(name: str, **params) -> Callable[[str], str]:
    try:
        fn = CHAR_FILTERS[name]
    except KeyError:
        raise ValueError(f"unknown char filter [{name}]")
    params = {k: v for k, v in params.items() if k not in ("type", "version")}
    return functools.partial(fn, **params) if params else fn
