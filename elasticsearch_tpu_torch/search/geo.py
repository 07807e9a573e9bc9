"""Geo queries over lat/lon doc-value columns, and the geo math the geo
aggregations and the ``_geo_distance`` sort share.

Port of elasticsearch_tpu/search/geo.py (GeoDistanceQueryBuilder,
GeoBoundingBoxQueryBuilder, GeoPolygonQueryBuilder, GeoShapeQueryBuilder;
haversine from GeoDistance.java). A ``geo_point`` field indexes as two
numeric columns ``<field>.lat`` / ``<field>.lon``, so every point
predicate is elementwise tensor math over the segment.

Division by a constant divides by a 0-d tensor on the operand's device
(``_div``): a float tensor over a Python scalar may run as a product with
the reciprocal, one ulp off the true quotient on some inputs, and one ulp
moves a point across a geohash cell or a polygon edge. The reference runs
these as IEEE divisions.

A ``geo_shape`` field indexes the covering cells of each shape (a fixed
3-level grid of 8, 1 and 0.125 degrees) as keyword tokens under
``<field>.__cells`` with their coarser ancestors; the query filters on
those postings, then refines each candidate on the host from its
``_source`` (intersects, within, disjoint). Polygon holes are ignored and
circles are 32-gons, as in the reference.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.index.mappings import _parse_geo_point
from elasticsearch_tpu_torch.search.queries import Query, _empty
from elasticsearch_tpu_torch.utils.errors import QueryParsingException

EARTH_RADIUS_M = 6371008.8

_DIST_RE = re.compile(r"^([\d.]+)\s*(mm|cm|m|km|mi|miles|yd|ft|in|nmi|NM)?$")
_UNIT_M = {
    None: 1.0, "m": 1.0, "mm": 0.001, "cm": 0.01, "km": 1000.0,
    "mi": 1609.344, "miles": 1609.344, "yd": 0.9144, "ft": 0.3048,
    "in": 0.0254, "nmi": 1852.0, "NM": 1852.0,
}


def parse_distance(s) -> float:
    """Distance string → meters ("1km", "500m", 2.5 → meters)."""
    if isinstance(s, (int, float)):
        return float(s)
    m = _DIST_RE.match(str(s).strip())
    if not m:
        raise QueryParsingException(f"cannot parse distance [{s}]")
    return float(m.group(1)) * _UNIT_M[m.group(2)]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / f32(b)`` as an IEEE division on every device."""
    return torch.div(a, _f32(b, a))


def _latlon(ctx, field: str):
    lat = ctx.col(f"{field}.lat")
    lon = ctx.col(f"{field}.lon")
    if lat is None or lon is None:
        return None
    return lat, lon


def haversine_device(lat_deg, lon_deg, lat0: float, lon0: float):
    """f32 distance in meters from (lat0, lon0) for f32 tensors of
    degrees, op for op as the reference computes it."""
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    la0 = torch.deg2rad(_f32(lat0, lat_deg))
    lo0 = torch.deg2rad(_f32(lon0, lat_deg))
    dlat = lat - la0
    dlon = lon - lo0
    a = torch.sin(dlat / 2) ** 2 \
        + torch.cos(lat) * torch.cos(la0) * torch.sin(dlon / 2) ** 2
    return 2.0 * EARTH_RADIUS_M * torch.arcsin(
        torch.sqrt(torch.clip(a, 0.0, 1.0)))


def haversine_f64(lat_deg, lon_deg, lat0: float, lon0: float):
    """f64 distance in meters for f64 tensors of degrees (the
    ``_geo_distance`` sort's key)."""
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    la0, lo0 = np.deg2rad(lat0), np.deg2rad(lon0)
    a = torch.sin((lat - la0) / 2) ** 2 \
        + torch.cos(lat) * np.cos(la0) * torch.sin((lon - lo0) / 2) ** 2
    return 2.0 * EARTH_RADIUS_M * torch.arcsin(
        torch.sqrt(torch.clip(a, 0.0, 1.0)))


def haversine_np(lat_deg, lon_deg, lat0: float, lon0: float):
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    la0, lo0 = np.deg2rad(lat0), np.deg2rad(lon0)
    a = (np.sin((lat - la0) / 2) ** 2
         + np.cos(lat) * np.cos(la0) * np.sin((lon - lo0) / 2) ** 2)
    return 2.0 * EARTH_RADIUS_M * np.arcsin(np.sqrt(np.clip(a, 0.0, 1.0)))


class GeoDistanceQuery(Query):
    def __init__(self, field: str, center: Tuple[float, float],
                 distance_m: float):
        self.field = field
        self.center = center
        self.distance_m = distance_m

    def execute(self, ctx):
        cols = _latlon(ctx, self.field)
        if cols is None:
            return _empty(ctx)
        latc, lonc = cols
        d = haversine_device(latc.values, lonc.values, *self.center)
        return None, (d <= self.distance_m) & latc.exists


class GeoBoundingBoxQuery(Query):
    def __init__(self, field: str, top: float, left: float, bottom: float,
                 right: float):
        self.field = field
        self.top, self.left, self.bottom, self.right = top, left, bottom, right

    def execute(self, ctx):
        cols = _latlon(ctx, self.field)
        if cols is None:
            return _empty(ctx)
        latc, lonc = cols
        lat, lon = latc.values, lonc.values
        m = (lat <= self.top) & (lat >= self.bottom) & latc.exists
        if self.left <= self.right:
            m = m & (lon >= self.left) & (lon <= self.right)
        else:  # a box across the antimeridian
            m = m & ((lon >= self.left) | (lon <= self.right))
        return None, m


class GeoPolygonQuery(Query):
    def __init__(self, field: str, points: List[Tuple[float, float]]):
        self.field = field
        self.points = points

    def execute(self, ctx):
        cols = _latlon(ctx, self.field)
        if cols is None:
            return _empty(ctx)
        latc, lonc = cols
        y, x = latc.values, lonc.values
        inside = torch.zeros_like(y, dtype=torch.bool)
        n = len(self.points)
        # even-odd ray casting over every doc; the constants round to f32
        # where the reference's do: the edge's dx and the f32 dy
        for i in range(n):
            y1, x1 = self.points[i]
            y2, x2 = self.points[(i + 1) % n]
            xs = _div((x2 - x1) * (y - y1),
                      (y2 - y1) if y2 != y1 else 1e-12) + x1
            inside = inside ^ (((y1 > y) != (y2 > y)) & (x < xs))
        return None, inside & latc.exists


# ---------------------------------------------------------------------------
# geohash cells
# ---------------------------------------------------------------------------

_BASE32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def geohash_bits(precision: int) -> Tuple[int, int]:
    """(lat_bits, lon_bits) for a geohash of ``precision`` chars (5 bits a
    char, interleaved lon-first: lon takes the extra bit of an odd
    total)."""
    total = precision * 5
    return total // 2, (total + 1) // 2


def geohash_cell_device(lat_deg, lon_deg, precision: int):
    """Per-doc int64 cell ids ``lon_cell * 2^lat_bits + lat_cell`` on the
    device, the two quantizations as the reference's (f32 arithmetic,
    truncation, clip)."""
    lat_bits, lon_bits = geohash_bits(precision)
    nlat, nlon = 1 << lat_bits, 1 << lon_bits
    lat_cell = torch.clip((_div(lat_deg + 90.0, 180.0) * nlat)
                          .to(torch.int32), 0, nlat - 1)
    lon_cell = torch.clip((_div(lon_deg + 180.0, 360.0) * nlon)
                          .to(torch.int32), 0, nlon - 1)
    return (lon_cell.to(torch.int64) << lat_bits) + lat_cell.to(torch.int64)


def geohash_encode_cell(cell_id: int, precision: int) -> str:
    """Cell id (from ``geohash_cell_device``) → base32 geohash string."""
    lat_bits, lon_bits = geohash_bits(precision)
    nlat = 1 << lat_bits
    lon_cell = int(cell_id) // nlat
    lat_cell = int(cell_id) % nlat
    val = 0
    li, bi = lon_bits - 1, lat_bits - 1
    for i in range(precision * 5):
        val <<= 1
        if i % 2 == 0:
            val |= (lon_cell >> li) & 1
            li -= 1
        else:
            val |= (lat_cell >> bi) & 1
            bi -= 1
    return "".join(_BASE32[(val >> ((precision - 1 - i) * 5)) & 31]
                   for i in range(precision))


def geohash_decode(gh: str) -> Tuple[float, float]:
    """Geohash string → (lat, lon) of the cell center."""
    val = 0
    for ch in gh:
        val = (val << 5) | _BASE32.index(ch)
    lat_bits, lon_bits = geohash_bits(len(gh))
    lon_cell = lat_cell = 0
    total = len(gh) * 5
    for i in range(total):
        bit = (val >> (total - 1 - i)) & 1
        if i % 2 == 0:
            lon_cell = (lon_cell << 1) | bit
        else:
            lat_cell = (lat_cell << 1) | bit
    lat = (lat_cell + 0.5) / (1 << lat_bits) * 180.0 - 90.0
    lon = (lon_cell + 0.5) / (1 << lon_bits) * 360.0 - 180.0
    return lat, lon


# ---------------------------------------------------------------------------
# geo_shape: covering cells at index time, exact refinement at query time
# ---------------------------------------------------------------------------

GEO_SHAPE_LEVELS = (8.0, 1.0, 0.125)
MAX_COVER_CELLS = 512


def _shape_prims(shape: dict) -> List[Tuple[str, list]]:
    """GeoJSON-ish shape → primitives: ("poly", ring), ("line", pts),
    ("point", (lon, lat)). Exterior rings only; circles become 32-gons."""
    typ = str(shape.get("type", "")).lower()
    coords = shape.get("coordinates")
    if typ == "point":
        return [("point", tuple(coords))]
    if typ == "multipoint":
        return [("point", tuple(c)) for c in coords]
    if typ == "linestring":
        return [("line", [tuple(c) for c in coords])]
    if typ == "multilinestring":
        return [("line", [tuple(c) for c in line]) for line in coords]
    if typ == "polygon":
        return [("poly", [tuple(c) for c in coords[0]])]
    if typ == "multipolygon":
        return [("poly", [tuple(c) for c in poly[0]]) for poly in coords]
    if typ == "envelope":
        (left, top), (right, bottom) = coords
        return [("poly", [(left, bottom), (right, bottom), (right, top),
                          (left, top), (left, bottom)])]
    if typ == "circle":
        lon, lat = coords
        r_m = parse_distance(shape.get("radius", "0m"))
        r_lat = r_m / 111_195.0
        r_lon = r_lat / max(np.cos(np.radians(lat)), 1e-6)
        ang = np.linspace(0, 2 * np.pi, 33)
        return [("poly", [(lon + r_lon * np.cos(a), lat + r_lat * np.sin(a))
                          for a in ang])]
    if typ == "geometrycollection":
        out: List[Tuple[str, list]] = []
        for g in shape.get("geometries", []):
            out.extend(_shape_prims(g))
        return out
    raise QueryParsingException(f"geo_shape type [{typ}] not supported")


def _pip(lon: float, lat: float, ring) -> bool:
    """Ray-cast point-in-polygon (ring = [(lon, lat), ...])."""
    inside = False
    for i in range(len(ring) - 1):
        x1, y1 = ring[i]
        x2, y2 = ring[i + 1]
        if (y1 > lat) != (y2 > lat):
            if x1 + (lat - y1) / (y2 - y1) * (x2 - x1) > lon:
                inside = not inside
    return inside


def _orient(p, q, r) -> float:
    return (q[0] - p[0]) * (r[1] - p[1]) - (q[1] - p[1]) * (r[0] - p[0])


def _seg_int(p1, p2, p3, p4) -> bool:
    """Closed-segment intersection by orientations (a collinear overlap
    counts when an endpoint lies on the other segment)."""
    d1, d2 = _orient(p3, p4, p1), _orient(p3, p4, p2)
    d3, d4 = _orient(p1, p2, p3), _orient(p1, p2, p4)
    if ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0)):
        return True

    def on(a, b, c):
        return (_orient(a, b, c) == 0
                and min(a[0], b[0]) <= c[0] <= max(a[0], b[0])
                and min(a[1], b[1]) <= c[1] <= max(a[1], b[1]))

    return on(p3, p4, p1) or on(p3, p4, p2) or on(p1, p2, p3) \
        or on(p1, p2, p4)


def _edges(prim):
    kind, pts = prim
    if kind == "point":
        return []
    return [(pts[i], pts[i + 1]) for i in range(len(pts) - 1)]


def _prim_contains_point(prim, pt) -> bool:
    kind, pts = prim
    if kind == "poly":
        return _pip(pt[0], pt[1], pts)
    if kind == "line":
        return any(_seg_int(a, b, pt, pt) for a, b in _edges(prim))
    return abs(pts[0] - pt[0]) < 1e-9 and abs(pts[1] - pt[1]) < 1e-9


def _prims_intersect(a, b) -> bool:
    ka, pa = a
    kb, pb = b
    if ka == "point":
        return _prim_contains_point(b, pa)
    if kb == "point":
        return _prim_contains_point(a, pb)
    for e1 in _edges(a):
        for e2 in _edges(b):
            if _seg_int(e1[0], e1[1], e2[0], e2[1]):
                return True
    # no edge crossing: one inside the other
    if ka == "poly" and _pip(pb[0][0], pb[0][1], pa):
        return True
    return kb == "poly" and _pip(pa[0][0], pa[0][1], pb)


def shape_intersects(prims_a, prims_b) -> bool:
    return any(_prims_intersect(a, b) for a in prims_a for b in prims_b)


def shape_within(prims_a, prims_b) -> bool:
    """Every part of A inside B's polygons, with no boundary crossing."""
    polys_b = [p for p in prims_b if p[0] == "poly"]
    if not polys_b:
        return False
    for a in prims_a:
        pts = [a[1]] if a[0] == "point" else a[1]
        for pt in pts:
            if not any(_pip(pt[0], pt[1], pb[1]) for pb in polys_b):
                return False
        for e1 in _edges(a):
            for pb in polys_b:
                for e2 in _edges(pb):
                    if _seg_int(e1[0], e1[1], e2[0], e2[1]):
                        return False
    return True


def _prims_bbox(prims):
    xs, ys = [], []
    for kind, pts in prims:
        pl = [pts] if kind == "point" else pts
        xs.extend(p[0] for p in pl)
        ys.extend(p[1] for p in pl)
    return min(xs), min(ys), max(xs), max(ys)


def _cell_prim(li: int, yi: int, xi: int):
    s = GEO_SHAPE_LEVELS[li]
    x0, y0 = xi * s - 180.0, yi * s - 90.0
    return ("poly", [(x0, y0), (x0 + s, y0), (x0 + s, y0 + s),
                     (x0, y0 + s), (x0, y0)])


def cover_cells(prims) -> Tuple[int, List[Tuple[int, int]]]:
    """(level, [(yi, xi), ...]): the finest level whose bbox grid stays
    under MAX_COVER_CELLS, narrowed to the cells the shape intersects (a
    near-global shape over the cap even at the coarsest level keeps its
    whole bbox grid; refinement removes the slack)."""
    x0, y0, x1, y1 = _prims_bbox(prims)
    level = 0
    grid = None
    for li, s in enumerate(GEO_SHAPE_LEVELS):
        nx = int(x1 // s) - int(x0 // s) + 1
        ny = int(y1 // s) - int(y0 // s) + 1
        if nx * ny <= MAX_COVER_CELLS:
            level = li
            grid = nx * ny
    s = GEO_SHAPE_LEVELS[level]
    exact = grid is not None
    cells = []
    for yi in range(int((y0 + 90) // s), int((y1 + 90) // s) + 1):
        for xi in range(int((x0 + 180) // s), int((x1 + 180) // s) + 1):
            if not exact or shape_intersects([_cell_prim(level, yi, xi)],
                                             prims):
                cells.append((yi, xi))
    return level, cells


def _cell_tokens(level: int, cells) -> List[str]:
    """Tokens of the covering cells and their coarser ancestors (the
    closure gives any two intersecting shapes a shared token)."""
    toks = set()
    s = GEO_SHAPE_LEVELS[level]
    for yi, xi in cells:
        toks.add(f"g{level}:{yi}:{xi}")
        for lj in range(level):
            sj = GEO_SHAPE_LEVELS[lj]
            toks.add(f"g{lj}:{int((yi * s) // sj)}:{int((xi * s) // sj)}")
    return sorted(toks)


def shape_index_tokens(shape: dict) -> List[str]:
    """Cell tokens to index for one stored shape (the doc parser's)."""
    level, cells = cover_cells(_shape_prims(shape))
    return _cell_tokens(level, cells)


def _dotted_get(src, path: str):
    cur = src
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


class GeoShapeQuery(Query):
    """On a ``geo_shape`` field: the cell prefilter over the
    ``<field>.__cells`` postings, then exact refinement of each candidate
    from its ``_source``. On a ``geo_point`` field: point-in-shape on the
    device (point, circle, envelope, polygon, multipolygon)."""

    def __init__(self, field: str, shape: dict, relation: str = "intersects"):
        self.field = field
        self.shape = shape
        self.relation = relation
        if relation not in ("intersects", "within", "disjoint"):
            raise QueryParsingException(
                f"geo_shape relation [{relation}] not supported")

    def execute(self, ctx):
        inv = ctx.inv(f"{self.field}.__cells")
        fm = ctx.mappings.get(self.field)
        if inv is not None or (fm is not None and fm.type == "geo_shape"):
            # the mapping decides: a segment without shape docs answers
            # empty, not with an error
            return self._execute_indexed(ctx, inv)
        if self.relation == "disjoint":
            raise QueryParsingException(
                "geo_shape relation [disjoint] requires a geo_shape-mapped "
                "field")
        typ = str(self.shape.get("type", "")).lower()
        coords = self.shape.get("coordinates")
        if typ == "point":
            lon, lat = coords
            return GeoDistanceQuery(self.field, (lat, lon), 1.0).execute(ctx)
        if typ == "circle":
            lon, lat = coords
            radius = parse_distance(self.shape.get("radius", "0m"))
            return GeoDistanceQuery(self.field, (lat, lon),
                                    radius).execute(ctx)
        if typ == "envelope":
            (left, top), (right, bottom) = coords
            return GeoBoundingBoxQuery(self.field, top, left, bottom,
                                       right).execute(ctx)
        if typ == "polygon":
            pts = [(lat, lon) for lon, lat in coords[0]]
            return GeoPolygonQuery(self.field, pts).execute(ctx)
        if typ == "multipolygon":
            mask = torch.zeros(ctx.D, dtype=torch.bool, device=ctx.device)
            for poly in coords:
                pts = [(lat, lon) for lon, lat in poly[0]]
                mask = mask | GeoPolygonQuery(self.field, pts).execute(ctx)[1]
            return None, mask
        raise QueryParsingException(f"geo_shape type [{typ}] not supported")

    def _execute_indexed(self, ctx, inv):
        """The candidates' postings are read on the host (a candidate set
        is small and doc-local), each refined against its ``_source``; the
        mask goes to the device once."""
        matched = np.zeros(ctx.D, dtype=bool)
        if inv is None:
            return None, torch.from_numpy(matched).to(ctx.device)
        qprims = _shape_prims(self.shape)
        cand = set()
        for tok in _cell_tokens(*cover_cells(qprims)):
            s, ln = inv.term_slice(tok)
            if ln:
                cand.update(int(d) for d in inv.doc_ids_host[s:s + ln])
        sources = ctx.segment.sources or []
        for local in cand:
            src = sources[local] if local < len(sources) else None
            val = _dotted_get(src, self.field) if src else None
            if val is None:
                # no source to refine against: the cell overlap is all
                # that is known; it stands for intersects, never within
                matched[local] = self.relation != "within"
                continue
            try:
                prims = []
                for v in (val if isinstance(val, list) else [val]):
                    prims.extend(_shape_prims(v))
            except (QueryParsingException, AttributeError, TypeError):
                continue
            if self.relation == "within":
                matched[local] = shape_within(prims, qprims)
            else:
                matched[local] = shape_intersects(prims, qprims)
        if self.relation == "disjoint":
            kw = ctx.segment.keywords.get(f"{self.field}.__cells")
            exists = (np.asarray(kw.exists_host) if kw is not None
                      and kw.exists_host is not None
                      else np.zeros(ctx.D, bool))
            matched = exists & ~matched
        return None, torch.from_numpy(matched).to(ctx.device)


def parse_geo_query(qtype: str, body: dict) -> Query:
    body = dict(body)
    if qtype == "geo_distance":
        distance = parse_distance(body.pop("distance"))
        body.pop("distance_type", None)
        body.pop("validation_method", None)
        (field, point), = body.items()
        return GeoDistanceQuery(field, _parse_geo_point(point), distance)
    if qtype == "geo_bounding_box":
        body.pop("validation_method", None)
        body.pop("type", None)
        (field, box), = body.items()
        if "top_left" in box:
            top_lat, left_lon = _parse_geo_point(box["top_left"])
            bot_lat, right_lon = _parse_geo_point(box["bottom_right"])
        else:
            top_lat, left_lon = box["top"], box["left"]
            bot_lat, right_lon = box["bottom"], box["right"]
        return GeoBoundingBoxQuery(field, top_lat, left_lon, bot_lat,
                                   right_lon)
    if qtype == "geo_polygon":
        (field, spec), = body.items()
        return GeoPolygonQuery(field, [_parse_geo_point(p)
                                       for p in spec["points"]])
    if qtype == "geo_shape":
        body.pop("ignore_unmapped", None)
        (field, spec), = body.items()
        ind = spec.get("indexed_shape")
        if isinstance(ind, dict) and "shape" not in spec:
            # rewrite_mlt_in_body resolves indexed_shape before the
            # search; still seeing it means the shape doc is missing
            raise QueryParsingException(
                f"indexed shape [{ind.get('index')}/{ind.get('type')}/"
                f"{ind.get('id')}] not found")
        shape = spec.get("shape")
        if shape is None or "type" not in shape:
            raise QueryParsingException(
                "geo_shape requires an inline [shape]")
        return GeoShapeQuery(field, shape, spec.get("relation", "intersects"))
    raise QueryParsingException(f"unknown geo query [{qtype}]")
