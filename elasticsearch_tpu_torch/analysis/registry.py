"""Per-index analysis registry.

Reference: org/elasticsearch/index/analysis/AnalysisService.java — resolves
named analyzers from index settings (`settings.analysis.*`), falling back to
built-ins; fields then bind `analyzer` / `search_analyzer` by name.
"""
from __future__ import annotations

from elasticsearch_tpu_torch.analysis.analyzer import (
    Analyzer,
    build_custom_analyzer,
    get_analyzer,
)


class AnalysisRegistry:
    def __init__(self, index_settings: dict | None = None):
        self._cache: dict[str, Analyzer] = {}
        analysis = (index_settings or {}).get("analysis", {})
        self._shared = {
            "tokenizer": analysis.get("tokenizer", {}),
            "filter": analysis.get("filter", {}),
            "char_filter": analysis.get("char_filter", {}),
        }
        self._custom = analysis.get("analyzer", {})

    def get(self, name: str) -> Analyzer:
        if name == "default" and "default" not in self._custom:
            # `analyzer: default` names the index default analyzer
            # (reference: AnalysisService resolves "default" specially)
            name = "standard"
        if name in self._cache:
            return self._cache[name]
        if name in self._custom:
            cfg = dict(self._custom[name])
            typ = cfg.pop("type", "custom")
            if typ == "custom":
                an = build_custom_analyzer(name, cfg, self._shared)
            else:
                # e.g. {"type": "snowball", "language": "German"}
                an = get_analyzer(typ, language=cfg.get("language"))
        else:
            # builtins + per-language analyzers ('german', 'french', …);
            # raises ValueError for unknown names
            an = get_analyzer(name)
        self._cache[name] = an
        return an

    def validate(self) -> None:
        """Eagerly resolve every declared custom analyzer AND every shared
        tokenizer/filter/char_filter — referenced or not — so an index
        creation with a broken analysis config fails up front (reference:
        AnalysisService's constructor builds all configured components and
        index creation propagates the failure). Raises ValueError /
        KeyError / TypeError on broken definitions."""
        for name in self._custom:
            self.get(name)
        # probe each shared component through the same resolution path a
        # referencing analyzer would take
        for tok in self._shared["tokenizer"]:
            build_custom_analyzer("_probe", {"tokenizer": tok}, self._shared)
        for filt in self._shared["filter"]:
            build_custom_analyzer("_probe", {"tokenizer": "standard",
                                             "filter": [filt]}, self._shared)
        for cf in self._shared["char_filter"]:
            build_custom_analyzer("_probe", {"tokenizer": "standard",
                                             "char_filter": [cf]},
                                  self._shared)

    @property
    def default(self) -> Analyzer:
        if "default" in self._custom:
            return self.get("default")
        return self.get("standard")
