"""Field mappings.

Reference: org/elasticsearch/index/mapper/ — MapperService.java,
DocumentMapper.java, and core field mappers (core/StringFieldMapper.java,
LongFieldMapper.java, IntegerFieldMapper.java, ShortFieldMapper.java,
ByteFieldMapper.java, DoubleFieldMapper.java, FloatFieldMapper.java,
BooleanFieldMapper.java, DateFieldMapper.java, BinaryFieldMapper.java,
TokenCountFieldMapper.java, Murmur3FieldMapper.java), geo/GeoPointFieldMapper.java,
ip/IpFieldMapper.java, object/ObjectMapper.java.

ES 2.0 uses `string` with `index: analyzed|not_analyzed`; we support both that
legacy form and the modern `text`/`keyword` split, plus `dense_vector` (the
north-star addition). Object fields flatten to dotted paths like ES's
ObjectMapper.

The port serves every type of the reference: text, keyword, numeric,
date, boolean, ip, token_count, murmur3, dense_vector (with its ``dims``,
``similarity`` and ``index_options``), nested, geo_point, geo_shape,
completion (with its ``context`` config) and percolator.
"""
from __future__ import annotations

import ipaddress
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from elasticsearch_tpu_torch.utils.errors import MapperParsingException
from elasticsearch_tpu_torch.utils.dates import parse_date

# canonical families
TEXT_TYPES = {"text", "string_analyzed"}
KEYWORD_TYPES = {"keyword", "string_not_analyzed"}
NUMERIC_TYPES = {"long", "integer", "short", "byte", "double", "float", "half_float"}
INT_TYPES = {"long", "integer", "short", "byte", "token_count", "murmur3"}


@dataclass
class FieldMapping:
    name: str  # full dotted path
    type: str  # canonical type
    analyzer: str = "standard"
    search_analyzer: Optional[str] = None
    index: bool = True  # indexed (searchable)
    doc_values: bool = True  # column store for agg/sort
    store: bool = False
    boost: float = 1.0
    null_value: Any = None
    fmt: str = "strict_date_optional_time||epoch_millis"  # date format
    dims: int = 0  # dense_vector
    similarity: str = "cosine"  # dense_vector: cosine|dot_product|l2_norm
    copy_to: List[str] = field(default_factory=list)
    fields: Dict[str, "FieldMapping"] = field(default_factory=dict)  # multi-fields
    nested: bool = False  # direct child of a nested object
    nested_path: Optional[str] = None
    ignore_above: int = 0  # keyword: ignore long values
    scaling_factor: float = 1.0  # scaled_float
    # None = inherit the _all default (include); False = excluded
    include_in_all: Optional[bool] = None
    # dense_vector ANN config, e.g. {"type": "ivf"} (no ES 2.0 counterpart;
    # north-star addition — ES 8 uses {"type": "hnsw"} the same way)
    index_options: Optional[dict] = None
    # the field was declared with the 2.0 spelling `type: string`; to_json
    # echoes it back that way (internally it is text/keyword)
    legacy_string: bool = False
    # completion suggester context mappings ({name: {type: category|geo,
    # default, path, precision}}) — search/suggest.py filters on them
    context: Optional[dict] = None

    @property
    def is_text(self) -> bool:
        return self.type == "text"

    @property
    def is_keyword(self) -> bool:
        return self.type == "keyword"

    @property
    def is_numeric(self) -> bool:
        return self.type in NUMERIC_TYPES or self.type in ("date", "token_count", "murmur3", "scaled_float")

    @property
    def is_vector(self) -> bool:
        return self.type == "dense_vector"


def _canonical_type(props: dict) -> str:
    t = props.get("type", "object")
    if t == "string":  # ES 2.0 legacy
        if props.get("index") in ("not_analyzed", "no"):
            return "keyword"
        return "text"
    return t


class Mappings:
    """Parsed mapping for one index (single-type, like ES ≥6 semantics; the
    reference's multi-type `_type` is carried as a meta field)."""

    def __init__(self, mapping_json: dict | None = None, default_analyzer: str = "standard"):
        self.fields: Dict[str, FieldMapping] = {}
        self.dynamic: Any = True  # True | False | "strict"
        self.default_analyzer = default_analyzer
        self.nested_paths: List[str] = []
        self._source_enabled = True
        # _all is ON by default (reference: mapper/internal/AllFieldMapper.java
        # — `enabled` defaults true in ES 2.0; query_string with no default
        # field searches it)
        self._all_enabled = True
        self._all_fm: Optional[FieldMapping] = None
        # meta-field toggles (reference: mapper/internal/ —
        # TimestampFieldMapper.java, TTLFieldMapper.java, SizeFieldMapper,
        # FieldNamesFieldMapper). _field_names is on by default like the
        # reference; the others are opt-in.
        self._timestamp_enabled = False
        self._timestamp_default: Any = None  # "now" | fixed value
        self._ttl_enabled = False
        self._ttl_default: Any = None  # e.g. "5m"
        self._size_enabled = False
        self._field_names_enabled = True
        self.dynamic_templates: List[dict] = []
        self.meta: dict = {}
        # type names seen in 2.0 typed-mapping bodies (response echo /
        # exists_type); the field model itself stays single-type
        self.type_names: List[str] = []
        # child type -> parent type (from `_parent: {type: X}` blocks);
        # writes of these types require parent/routing
        self.parent_types: Dict[str, str] = {}
        # `_routing: {required: true}` — ops without routing are rejected
        self.routing_required = False
        if mapping_json:
            self.merge(mapping_json)

    # -- parsing ---------------------------------------------------------------

    _DIRECTIVES = frozenset({
        "properties", "dynamic", "dynamic_templates", "date_detection",
        "numeric_detection"})

    def _is_type_block(self, key: str, val: Any) -> bool:
        """ES 2.0 typed-mapping form: {"my_type": {...}}. A block is a type
        when its value is a dict that is empty or holds mapping directives
        — `{"title": {"type": "text"}}` (a field shorthand) is NOT."""
        if key in ("_doc", "_default_"):
            return isinstance(val, dict)
        if key.startswith("_") or key in self._DIRECTIVES:
            return False
        if not isinstance(val, dict):
            return False
        return (not val or "properties" in val or "dynamic" in val
                or any(k.startswith("_") for k in val)
                or bool(self._DIRECTIVES & set(val)))

    def merge(self, mapping_json: dict):
        """Merge a mapping JSON body: {"properties": {...}} or the 2.0
        typed form {"<type>": {...}, ...} — every type block's fields merge
        into the single-type field map (the deliberate single-type model;
        `_type` is a queryable meta field), and the names are remembered in
        `self.type_names` for response echo / exists_type."""
        body = mapping_json
        blocks = {k: v for k, v in body.items()
                  if self._is_type_block(k, v)}
        if blocks and "properties" not in body:
            for tname, tbody in blocks.items():
                if tname not in self.type_names:
                    self.type_names.append(tname)
                if isinstance(tbody, dict) and "_parent" in tbody:
                    pt = (tbody["_parent"] or {}).get("type")
                    if pt:
                        self.parent_types[tname] = pt
                self.merge(tbody if tbody else {"properties": {}})
            rest = {k: v for k, v in body.items() if k not in blocks}
            if not rest:
                return
            body = rest
        if "dynamic" in body:
            self.dynamic = body["dynamic"]
        if "_source" in body:
            self._source_enabled = body["_source"].get("enabled", True)
        if "_all" in body:
            self._all_enabled = body["_all"].get("enabled", True)
        if "_meta" in body:
            self.meta = body["_meta"]
        if "_timestamp" in body:
            self._timestamp_enabled = body["_timestamp"].get("enabled", False)
            self._timestamp_default = body["_timestamp"].get("default", "now")
        if "_ttl" in body:
            self._ttl_enabled = body["_ttl"].get("enabled", False)
            self._ttl_default = body["_ttl"].get("default")
        if "_size" in body:
            self._size_enabled = body["_size"].get("enabled", False)
        if "_routing" in body:
            self.routing_required = bool(
                (body["_routing"] or {}).get("required", False))
        if "_field_names" in body:
            self._field_names_enabled = body["_field_names"].get("enabled", True)
        if "dynamic_templates" in body:
            self.dynamic_templates = list(body["dynamic_templates"])
        self._parse_properties(body.get("properties", {}), prefix="", nested_path=None)

    def _parse_properties(self, props: dict, prefix: str, nested_path: Optional[str]):
        for name, p in props.items():
            if not isinstance(p, dict):
                raise MapperParsingException(f"invalid mapping for field [{name}]")
            full = f"{prefix}{name}"
            t = _canonical_type(p)
            if t in ("object", "nested") or ("properties" in p and "type" not in p):
                np = nested_path
                if t == "nested":
                    np = full
                    if full not in self.nested_paths:
                        self.nested_paths.append(full)
                self._parse_properties(p.get("properties", {}), prefix=f"{full}.", nested_path=np)
                continue
            self.fields[full] = self._parse_field(full, t, p, nested_path)

    def _parse_field(self, full: str, t: str, p: dict, nested_path: Optional[str]) -> FieldMapping:
        if t == "multi_field":
            # pre-2.0 legacy form: the sub-field sharing the root's name
            # BECOMES the root, the rest stay multi-fields
            # (reference: TypeParsers.parseMultiField upgrade path)
            subs = dict(p.get("fields") or {})
            short = full.rpartition(".")[2]
            rootp = dict(subs.pop(short, {}) or {})
            rootp["fields"] = subs
            return self._parse_field(
                full, _canonical_type(rootp) if rootp.get("type")
                else "text", rootp, nested_path)
        fm = FieldMapping(
            name=full,
            type=t,
            analyzer=p.get("analyzer", self.default_analyzer),
            search_analyzer=p.get("search_analyzer"),
            index=p.get("index", True) not in (False, "no", "false"),
            doc_values=p.get("doc_values", t != "text"),
            store=p.get("store", False) in (True, "yes", "true"),
            boost=float(p.get("boost", 1.0)),
            null_value=p.get("null_value"),
            fmt=p.get("format", "strict_date_optional_time||epoch_millis"),
            dims=int(p.get("dims", p.get("dimension", 0) or 0)),
            similarity=p.get("similarity", "cosine"),
            copy_to=list(p.get("copy_to", []) if isinstance(p.get("copy_to", []), list) else [p["copy_to"]]),
            nested=nested_path is not None,
            nested_path=nested_path,
            ignore_above=int(p.get("ignore_above", 0)),
            scaling_factor=float(p.get("scaling_factor", 1.0)),
            include_in_all=p.get("include_in_all"),
            index_options=p.get("index_options") if t == "dense_vector" else None,
            legacy_string=p.get("type") == "string",
            context=p.get("context") if t == "completion" else None,
        )
        if t == "dense_vector" and fm.dims <= 0:
            raise MapperParsingException(f"dense_vector field [{full}] requires [dims]")
        if t == "dense_vector" and fm.index_options:
            ann = (fm.index_options.get("type")
                   if isinstance(fm.index_options, dict) else None)
            if ann not in ("ivf", "ivf_flat", "ivf_pq"):
                raise MapperParsingException(
                    f"dense_vector field [{full}] has unsupported "
                    f"index_options type [{ann}]; use one of "
                    f"[ivf, ivf_flat, ivf_pq]")
        for sub, subp in p.get("fields", {}).items():
            st = _canonical_type(subp)
            fm.fields[sub] = self._parse_field(f"{full}.{sub}", st, subp, nested_path)
        return fm

    # -- dynamic mapping -------------------------------------------------------

    def dynamic_map(self, name: str, value: Any) -> Optional[FieldMapping]:
        """Infer a mapping for an unseen field (DocumentMapper dynamic mapping)."""
        if self.dynamic == "strict":
            raise MapperParsingException(f"mapping set to strict, dynamic introduction of [{name}] not allowed")
        if self.dynamic in (False, "false"):
            return None
        for tmpl in self.dynamic_templates:
            ((_, spec),) = tmpl.items()
            match = spec.get("match", "*")
            mm = spec.get("match_mapping_type")
            import fnmatch

            if fnmatch.fnmatch(name.split(".")[-1], match) and (
                mm is None or mm == _json_type(value) or mm == "*"
            ):
                p = dict(spec.get("mapping", {}))
                t = _canonical_type(p) if "type" in p else _infer_type(value)
                fm = self._parse_field(name, t, p, None)
                self.fields[name] = fm
                return fm
        t = _infer_type(value)
        if t is None:
            return None
        fm = self._parse_field(name, t, {}, None)
        if t == "text":
            # ES dynamic strings get a `.keyword` sub-field (modern default)
            fm.fields["keyword"] = self._parse_field(f"{name}.keyword", "keyword", {"ignore_above": 256}, None)
        self.fields[name] = fm
        return fm

    _META_SYNTHETIC = {"_timestamp": "date", "_ttl": "long",
                       "_size": "integer", "_field_names": "keyword"}

    def get(self, name: str) -> Optional[FieldMapping]:
        if name in self._META_SYNTHETIC:
            enabled = {"_timestamp": self._timestamp_enabled,
                       "_ttl": self._ttl_enabled,
                       "_size": self._size_enabled,
                       "_field_names": self._field_names_enabled}[name]
            if not enabled:
                return None
            return FieldMapping(name=name, type=self._META_SYNTHETIC[name])
        if name == "_all":
            # synthetic mapping (kept out of `fields` so it never leaks into
            # to_json/wildcard field expansion); analyzed with the index
            # default analyzer like AllFieldMapper
            if not self._all_enabled:
                return None
            if self._all_fm is None:
                self._all_fm = FieldMapping(
                    name="_all", type="text",
                    analyzer=self.default_analyzer, doc_values=False)
            return self._all_fm
        fm = self.fields.get(name)
        if fm is not None:
            return fm
        # multi-field lookup: "title.keyword"
        if "." in name:
            parent, _, sub = name.rpartition(".")
            pf = self.fields.get(parent)
            if pf and sub in pf.fields:
                return pf.fields[sub]
        return None

    def all_fields(self) -> List[FieldMapping]:
        out = []
        for fm in self.fields.values():
            out.append(fm)
            out.extend(fm.fields.values())
        return out

    # -- value normalization ---------------------------------------------------

    def normalize_value(self, fm: FieldMapping, value: Any):
        """Normalize a JSON value for indexing/doc-values per field type."""
        if value is None:
            value = fm.null_value
            if value is None:
                return None
        t = fm.type
        try:
            if t == "token_count":
                return value  # counted against the analyzer in DocumentParser
            if t in ("long", "integer", "short", "byte"):
                return int(value)
            if t in ("double", "float", "half_float"):
                return float(value)
            if t == "scaled_float":
                return float(value)
            if t == "boolean":
                if isinstance(value, str):
                    return value in ("true", "True", "1", "on", "yes")
                return bool(value)
            if t == "date":
                return parse_date(value, fm.fmt)
            if t == "ip":
                addr = ipaddress.ip_address(value)
                if addr.version != 4:
                    # ES 2.0's ip type is IPv4-only (IpFieldMapper stores a long)
                    raise ValueError("ip fields accept IPv4 only")
                return int(addr)
            if t == "murmur3":
                return _murmur3(str(value))
            if t == "geo_point":
                return _parse_geo_point(value)
            if t == "dense_vector":
                vec = [float(x) for x in value]
                if len(vec) != fm.dims:
                    raise MapperParsingException(
                        f"dense_vector [{fm.name}] has {len(vec)} dims, mapping says {fm.dims}"
                    )
                return vec
            return value
        except (ValueError, TypeError) as e:
            raise MapperParsingException(f"failed to parse field [{fm.name}] of type [{t}]: {e}")

    def to_json(self) -> dict:
        # rebuild the object/nested tree from the flat dotted field map —
        # the gateway re-parses this on restart, so losing structure here
        # means losing `nested` semantics (and with them block-join
        # queries) after every restart
        props: dict = {}
        for fm in self.fields.values():
            parts = fm.name.split(".")
            cur, path = props, ""
            for part in parts[:-1]:
                path = f"{path}.{part}" if path else part
                node = cur.setdefault(part, {})
                if path in self.nested_paths:
                    node["type"] = "nested"
                cur = node.setdefault("properties", {})
            cur[parts[-1]] = _field_to_json(fm)
        # echo parity: defaults stay implicit (an empty typed block reads
        # back as {}, like the reference) — the gateway re-parse treats
        # missing keys as the same defaults
        out: dict = {}
        if props:
            out["properties"] = props
        if self.dynamic is not True:
            out["dynamic"] = self.dynamic
        if self.dynamic_templates:
            out["dynamic_templates"] = list(self.dynamic_templates)
        if not self._all_enabled:
            out["_all"] = {"enabled": False}
        # meta-field toggles must round-trip: the gateway re-parses this on
        # restart, and translog replay re-resolves _timestamp/_ttl from it
        if self._timestamp_enabled:
            out["_timestamp"] = {"enabled": True}
            if self._timestamp_default not in (None, "now"):
                out["_timestamp"]["default"] = self._timestamp_default
        if self._ttl_enabled:
            out["_ttl"] = {"enabled": True}
            if self._ttl_default is not None:
                out["_ttl"]["default"] = self._ttl_default
        if self._size_enabled:
            out["_size"] = {"enabled": True}
        if not self._field_names_enabled:
            out["_field_names"] = {"enabled": False}
        return out


def _field_to_json(fm: FieldMapping) -> dict:
    """Inverse of _parse_field: every attribute the parser reads must
    survive the round-trip, or restarts silently shed mapping config (the
    r4 IVF-cache test caught index_options vanishing this way)."""
    out: dict = {"type": fm.type}
    if fm.legacy_string:  # echo the 2.0 spelling it was declared with
        out["type"] = "string"
        if fm.is_keyword:
            out["index"] = "not_analyzed"
    if fm.is_text and fm.analyzer != "standard":
        # defaults stay implicit: GET _mapping echoes only declared
        # analyzers (re-parse re-derives the standard default)
        out["analyzer"] = fm.analyzer
    if fm.search_analyzer is not None:
        out["search_analyzer"] = fm.search_analyzer
    if not fm.index:
        out["index"] = False
    if fm.doc_values != (not fm.is_text):
        out["doc_values"] = fm.doc_values
    if fm.store:
        out["store"] = True
    if fm.boost != 1.0:
        out["boost"] = fm.boost
    if fm.null_value is not None:
        out["null_value"] = fm.null_value
    if fm.type == "date":
        out["format"] = fm.fmt
    if fm.type == "completion" and fm.context is not None:
        out["context"] = fm.context
    if fm.type == "dense_vector":
        out["dims"] = fm.dims
        out["similarity"] = fm.similarity
        if fm.index_options is not None:
            out["index_options"] = fm.index_options
    if fm.copy_to:
        out["copy_to"] = list(fm.copy_to)
    if fm.ignore_above:
        out["ignore_above"] = fm.ignore_above
    if fm.scaling_factor != 1.0:
        out["scaling_factor"] = fm.scaling_factor
    if fm.include_in_all is not None:
        out["include_in_all"] = fm.include_in_all
    if fm.fields:
        out["fields"] = {sub.rpartition(".")[2] if "." in sub else sub: _field_to_json(sf)
                        for sub, sf in fm.fields.items()}
    return out


def _json_type(value: Any) -> str:
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, int):
        return "long"
    if isinstance(value, float):
        return "double"
    if isinstance(value, str):
        return "string"
    return "object"


def _infer_type(value: Any):
    if isinstance(value, bool):
        return "boolean"
    if isinstance(value, int):
        return "long"
    if isinstance(value, float):
        return "double"
    if isinstance(value, str):
        # date detection like DocumentMapper.dateDetection
        try:
            parse_date(value, "strict_date_optional_time")
            return "date"
        except ValueError:
            return "text"
    if isinstance(value, list):
        return _infer_type(value[0]) if value else None
    return None


def _murmur3(s: str) -> int:
    """murmur3 x86 32-bit over utf-8 (Murmur3FieldMapper stores the hash)."""
    from elasticsearch_tpu_torch.utils.hashing import murmur3_32

    return murmur3_32(s)


def _parse_geo_point(value: Any):
    """Accept {"lat":..,"lon":..}, "lat,lon", [lon, lat] (GeoJSON order)."""
    if isinstance(value, dict):
        return (float(value["lat"]), float(value["lon"]))
    if isinstance(value, str):
        lat, lon = value.split(",")
        return (float(lat), float(lon))
    if isinstance(value, (list, tuple)):
        lon, lat = value[0], value[1]
        return (float(lat), float(lon))
    raise ValueError(f"cannot parse geo_point [{value}]")
