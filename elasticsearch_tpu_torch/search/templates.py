"""Search templates: mustache-lite rendering of search bodies.

Copy of elasticsearch_tpu/search/templates.py: the rendering behind the
``template`` query (REST ``_search/template`` and stored templates wait
for the port's REST layer). Reference: org/elasticsearch/script/mustache/
(MustacheScriptEngineService) — templates are JSON bodies with
{{param}} placeholders.

Supported mustache subset (what the reference's own rest tests exercise):
- {{var}}                      scalar substitution (string/number/bool)
- "{{#toJson}}var{{/toJson}}"  splice a whole object/array param
Sections ({{#var}}...{{/var}}) and inverted sections are not supported
(documented gap; R3).
"""
from __future__ import annotations

import json
import re
from typing import Any, Dict, Optional

from elasticsearch_tpu_torch.utils.errors import SearchParseException

# ONE alternation, ONE substitution pass: substituted parameter values are
# never re-scanned, so values containing literal "{{...}}" survive verbatim.
# Quoted alternatives first — a quoted token that is exactly one placeholder
# splices raw JSON ("size": "{{n}}" with n=5 renders to "size": 5).
_PLACEHOLDER = re.compile(
    r'"\{\{#toJson\}\}\s*(?P<tjq>[\w.]+)\s*\{\{/toJson\}\}"'
    r"|\{\{#toJson\}\}\s*(?P<tjb>[\w.]+)\s*\{\{/toJson\}\}"
    r'|"\{\{\s*(?P<varq>[\w.]+)\s*\}\}"'
    r"|\{\{\s*(?P<varb>[\w.]+)\s*\}\}"
)


def render_template(template: Any, params: Optional[Dict[str, Any]] = None) -> dict:
    """Render a template (dict or JSON string) + params into a search body."""
    params = params or {}
    text = template if isinstance(template, str) else json.dumps(template)

    def _lookup(name: str):
        cur: Any = params
        for part in name.split("."):
            if not isinstance(cur, dict) or part not in cur:
                raise SearchParseException(f"missing template parameter [{name}]")
            cur = cur[part]
        return cur

    def _sub(m: "re.Match") -> str:
        g = m.groupdict()
        if g["tjq"] or g["tjb"]:
            return json.dumps(_lookup(g["tjq"] or g["tjb"]))
        if g["varq"]:
            # whole quoted token: strings stay quoted, others splice raw
            return json.dumps(_lookup(g["varq"]))
        v = _lookup(g["varb"])
        if isinstance(v, str):
            # lands inside a JSON string literal: escape, drop added quotes
            return json.dumps(v)[1:-1]
        return json.dumps(v)

    text = _PLACEHOLDER.sub(_sub, text)
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise SearchParseException(f"template rendered to invalid JSON: {e}")
