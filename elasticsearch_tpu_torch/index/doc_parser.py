"""Document parsing: JSON source → ParsedDocument.

Reference: org/elasticsearch/index/mapper/DocumentMapper.java +
DocumentParser-era logic inside FieldMapper.parse — walks the JSON tree,
flattens objects to dotted paths, applies analyzers for analyzed fields,
collects doc values, handles arrays (multi-values), copy_to, and dynamic
mapping of unseen fields.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.mappings import (
    KEYWORD_TYPES, NUMERIC_TYPES, TEXT_TYPES, FieldMapping, Mappings)
from elasticsearch_tpu_torch.utils.errors import MapperParsingException

Token = Tuple[str, int]


@dataclass
class ParsedDocument:
    doc_id: str
    source: dict
    # text field -> list of (term, position)
    text_tokens: Dict[str, List[Token]] = field(default_factory=dict)
    # keyword/numeric/bool/date/ip field -> list of values (multi-valued)
    doc_values: Dict[str, List[Any]] = field(default_factory=dict)
    # dense_vector field -> vector
    vectors: Dict[str, List[float]] = field(default_factory=dict)
    # field -> raw values for stored fields
    stored: Dict[str, List[Any]] = field(default_factory=dict)
    routing: Optional[str] = None
    # block-join (reference: mapper/object/ObjectMapper nested=true → Lucene
    # block indexing): nested sub-docs indexed immediately before their root
    children: List["ParsedDocument"] = field(default_factory=list)
    nested_path: Optional[str] = None  # set on child docs
    nested_ord: int = -1  # index within the parent's array at nested_path
    # _type / _parent meta (parent-child joins) + anything merge must replay
    meta: Dict[str, Any] = field(default_factory=dict)

    def field_length(self, fname: str) -> int:
        return len(self.text_tokens.get(fname, ()))


def _ttl_to_millis(t) -> int:
    """_ttl value → millis: bare numbers (REST delivers them as strings)
    are millis; unit strings go through interval parsing; anything else is
    a 400 mapper error, never a raw ValueError."""
    from elasticsearch_tpu_torch.utils.dates import interval_to_millis

    if isinstance(t, (int, float)):
        return int(t)
    s = str(t).strip()
    if s.replace(".", "", 1).isdigit():
        return int(float(s))
    try:
        ms = interval_to_millis(s)
    except ValueError:
        ms = None
    if ms is None:
        raise MapperParsingException(f"failed to parse ttl value [{t}]")
    return int(ms)


class DocumentParser:
    def __init__(self, mappings: Mappings, analysis: AnalysisRegistry):
        self.mappings = mappings
        self.analysis = analysis

    def parse(self, doc_id: str, source: dict, routing: Optional[str] = None,
              doc_type: Optional[str] = None, parent: Optional[str] = None,
              timestamp: Optional[Any] = None, ttl: Optional[Any] = None,
              ttl_expiry: Optional[int] = None) -> ParsedDocument:
        if not isinstance(source, dict):
            raise MapperParsingException("document source must be a JSON object")
        parsed = ParsedDocument(doc_id=doc_id, source=source, routing=routing)
        if doc_type:
            # _type/_parent as ordinary keyword doc-value columns (reference:
            # mapper/internal/TypeFieldMapper, ParentFieldMapper) — the
            # has_child/has_parent join reads them back from the segment
            parsed.doc_values["_type"] = [str(doc_type)]
            parsed.meta["_type"] = str(doc_type)
        if parent:
            parsed.doc_values["_parent"] = [str(parent)]
            parsed.meta["_parent"] = str(parent)
        if routing:
            parsed.meta["routing"] = str(routing)
        self._walk(source, "", parsed)
        self._index_meta_fields(parsed, source, timestamp, ttl, ttl_expiry)
        return parsed

    def _index_meta_fields(self, parsed: ParsedDocument, source: dict,
                           timestamp, ttl, ttl_expiry) -> None:
        """Opt-in meta fields (reference: mapper/internal/
        TimestampFieldMapper.java:1-336, TTLFieldMapper.java:1-228,
        SizeFieldMapper, FieldNamesFieldMapper). Resolved values land in
        parsed.meta so merges and translog replay reproduce them exactly."""
        import json as _json
        import time as _time

        from elasticsearch_tpu_torch.utils.dates import parse_date

        m = self.mappings
        now_ms = int(_time.time() * 1000)
        if m._timestamp_enabled:
            if timestamp is not None:
                ts = (int(timestamp) if isinstance(timestamp, (int, float))
                      else int(parse_date(
                          timestamp, "strict_date_optional_time||epoch_millis")))
            elif m._timestamp_default not in (None, "now"):
                ts = int(parse_date(
                    m._timestamp_default,
                    "strict_date_optional_time||epoch_millis"))
            else:
                ts = now_ms
            parsed.doc_values["_timestamp"] = [ts]
            parsed.meta["timestamp"] = ts
        if m._ttl_enabled:
            if ttl_expiry is not None:
                expiry = int(ttl_expiry)
            else:
                t = ttl if ttl is not None else m._ttl_default
                if t is None:
                    expiry = None
                else:
                    ttl_ms = _ttl_to_millis(t)
                    # the expiry base is the op's timestamp even when the
                    # _timestamp meta field itself is disabled (reference:
                    # TTLFieldMapper reads the IndexRequest timestamp)
                    base = parsed.meta.get("timestamp")
                    if base is None and timestamp is not None:
                        base = (int(timestamp)
                                if isinstance(timestamp, (int, float))
                                else int(parse_date(
                                    timestamp,
                                    "strict_date_optional_time"
                                    "||epoch_millis")))
                    if base is None:
                        base = now_ms
                    expiry = int(base + ttl_ms)
                    if ttl is not None and expiry <= now_ms:
                        # an explicit ttl whose expiry (timestamp + ttl) is
                        # already past is a request error (reference:
                        # AlreadyExpiredException from TTLFieldMapper)
                        from elasticsearch_tpu_torch.utils.errors import \
                            AlreadyExpiredException

                        raise AlreadyExpiredException(
                            parsed.doc_id if hasattr(parsed, "doc_id")
                            else "", base, ttl_ms)
            if expiry is not None:
                parsed.doc_values["_ttl"] = [expiry]
                parsed.meta["ttl_expiry"] = expiry
        if m._size_enabled:
            parsed.doc_values["_size"] = [
                len(_json.dumps(source, separators=(",", ":")))]
        if m._field_names_enabled:
            names = (set(parsed.text_tokens) | set(parsed.doc_values)
                     | set(parsed.vectors))
            names -= {"_all", "_timestamp", "_ttl", "_size"}
            if names:
                parsed.doc_values["_field_names"] = sorted(names)

    def _nested_children(self, full: str, items: List[dict], parsed: ParsedDocument):
        """Each object under a nested path becomes its own block doc with
        fields at the full dotted path; searched via NestedQuery's
        child→parent scatter join."""
        for i, item in enumerate(items):
            child = ParsedDocument(
                doc_id=f"{parsed.doc_id}|{full}|{i}",
                source=None,  # child _source lives inside the root's _source
                nested_path=full,
                nested_ord=i,
            )
            if isinstance(item, dict):
                self._walk(item, f"{full}.", child)
            parsed.children.append(child)

    def _walk(self, obj: dict, prefix: str, parsed: ParsedDocument):
        for key, value in obj.items():
            full = f"{prefix}{key}"
            if isinstance(value, dict):
                fm = self.mappings.get(full)
                if full in self.mappings.nested_paths:
                    self._nested_children(full, [value], parsed)
                    continue
                if fm is None or fm.type in ("object", "nested", "geo_point",
                                             "geo_shape"):
                    if fm is not None and fm.type in ("geo_point",
                                                      "geo_shape"):
                        self._index_value(fm, value, parsed)
                    else:
                        self._walk(value, f"{full}.", parsed)
                    continue
                self._index_value(fm, value, parsed)
                continue
            if isinstance(value, list) and value and isinstance(value[0], dict):
                fm = self.mappings.get(full)
                if fm is not None and fm.type == "completion":
                    self._index_value(fm, value, parsed)
                    continue
                if fm is not None and fm.type == "geo_shape":
                    # array of shapes: each indexed, not object-flattened
                    for shape in value:
                        self._index_value(fm, shape, parsed)
                    continue
                if full in self.mappings.nested_paths:
                    self._nested_children(full, value, parsed)
                    continue
                # array of objects (non-nested): flatten each — values from
                # different objects mingle, the documented ES object-array
                # semantics that nested mappings exist to avoid
                for item in value:
                    self._walk(item, f"{full}.", parsed)
                continue
            fm = self.mappings.get(full)
            if fm is None:
                fm = self.mappings.dynamic_map(full, value)
                if fm is None:
                    continue
            self._index_value(fm, value, parsed)
            # multi-fields/copy_to re-index the same value — the _all stream
            # gets it once, from the root field only
            for sub in fm.fields.values():
                self._index_value(sub, value, parsed, to_all=False)
            for target in fm.copy_to:
                tfm = self.mappings.get(target) or self.mappings.dynamic_map(target, value)
                if tfm is not None:
                    self._index_value(tfm, value, parsed, to_all=False)

    _ALL_TYPES = TEXT_TYPES | KEYWORD_TYPES | NUMERIC_TYPES | {
        "date", "boolean", "ip", "text", "keyword"}

    def _append_to_all(self, parsed: ParsedDocument, raw: Any):
        """Feed one value into the _all token stream (reference:
        mapper/internal/AllFieldMapper.java — every included field's value
        re-analyzed with the index default analyzer, values separated by a
        position gap so phrases don't cross field boundaries)."""
        analyzer = self.analysis.get(self.mappings.default_analyzer)
        toks = analyzer.analyze(str(raw))
        if not toks:
            return
        bucket = parsed.text_tokens.setdefault("_all", [])
        offset = (bucket[-1][1] + 100) if bucket else 0
        bucket.extend((t, p + offset) for t, p in toks)

    def _index_value(self, fm: FieldMapping, value: Any, parsed: ParsedDocument,
                     to_all: bool = True):
        values = value if isinstance(value, list) and not fm.is_vector else [value]
        if (to_all and self.mappings._all_enabled and fm.include_in_all is not False
                and fm.index and not fm.name.startswith("_")
                and fm.type in self._ALL_TYPES):
            for v in values:
                if v is not None:
                    self._append_to_all(parsed, v)
        if fm.type == "completion":
            # completion entries ({input, output, weight, payload} or plain
            # strings) are kept verbatim on host; the suggester builds its
            # per-segment sorted prefix array from them (search/suggest.py)
            parsed.stored.setdefault(fm.name, []).extend(values)
            return
        if fm.store:
            parsed.stored.setdefault(fm.name, []).extend(values)
        if fm.is_vector:
            norm = self.mappings.normalize_value(fm, value)
            if norm is not None:
                parsed.vectors[fm.name] = norm
            return
        for v in values:
            norm = self.mappings.normalize_value(fm, v)
            if norm is None:
                continue
            if fm.is_text:
                if not fm.index:
                    continue
                analyzer = self.analysis.get(fm.analyzer)
                toks = analyzer.analyze(str(norm))
                bucket = parsed.text_tokens.setdefault(fm.name, [])
                # multi-valued text: position gap of 100 between values (ES
                # position_increment_gap default) so phrases don't cross values
                offset = (bucket[-1][1] + 100) if bucket else 0
                bucket.extend((t, p + offset) for t, p in toks)
            elif fm.type == "token_count":
                analyzer = self.analysis.get(fm.analyzer)
                parsed.doc_values.setdefault(fm.name, []).append(len(analyzer.analyze(str(v))))
            else:
                if fm.is_keyword and fm.ignore_above and len(str(norm)) > fm.ignore_above:
                    continue
                if fm.type == "boolean":
                    norm = 1 if norm else 0
                if fm.type == "geo_point":
                    parsed.doc_values.setdefault(fm.name + ".lat", []).append(norm[0])
                    parsed.doc_values.setdefault(fm.name + ".lon", []).append(norm[1])
                    continue
                if fm.type == "geo_shape":
                    # covering-cell tokens under `<field>.__cells`: freeze
                    # builds their keyword postings, which the geo_shape
                    # query filters on (search/geo.py)
                    from elasticsearch_tpu_torch.search.geo import \
                        shape_index_tokens
                    from elasticsearch_tpu_torch.utils.errors import \
                        QueryParsingException

                    if not isinstance(norm, dict):
                        raise MapperParsingException(
                            f"geo_shape field [{fm.name}] expects a GeoJSON "
                            "object")
                    try:
                        toks = shape_index_tokens(norm)
                    except QueryParsingException as e:
                        # an index-time parse failure is a mapper error
                        raise MapperParsingException(
                            f"failed to parse [{fm.name}]: {e}") from e
                    parsed.doc_values.setdefault(
                        fm.name + ".__cells", []).extend(toks)
                    continue
                parsed.doc_values.setdefault(fm.name, []).append(norm)
