"""The geo slice of the port (``search/geo.py``, the geo aggs, the
``_geo_distance`` sort) against the reference's ``Node`` on the CPU.

Every case of ``tests/unit/test_geo.py`` and ``tests/unit/test_geo_shape.py``
with its stated answers, then 2,000 seeded points over 2 shards and
several refreshes, plus points placed exactly on geohash cell edges, box
edges and polygon edges (an f32 division by a constant must be a true
division there, not a product with the reciprocal).

Bars: exact for everything without a transcendental (boxes, polygons,
geohash cells, shapes, bounds); where a haversine decides (geo_distance,
its agg, the sort's selection), exact outside a band: docs whose f64
distance lies within a relative 1e-5 of a radius or ring edge may fall
either way (the f32 sin/cos/arcsin of XLA and torch may differ in the
last bit), and each test prints how many there are. The port's two routes
byte-identical (the mesh declines every geo query and serves ``exists``).
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import geo as RG
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import geo as G
from elasticsearch_tpu_torch.utils.errors import (ElasticsearchTpuException,
                                                  MapperParsingException)

CITIES = {
    "paris": (48.8566, 2.3522),
    "london": (51.5074, -0.1278),
    "berlin": (52.5200, 13.4050),
    "madrid": (40.4168, -3.7038),
    "rome": (41.9028, 12.4964),
    "nyc": (40.7128, -74.0060),
    "tokyo": (35.6762, 139.6503),
}
PT_MAPPING = {"properties": {"loc": {"type": "geo_point"},
                             "name": {"type": "keyword"}}}
SHAPE_MAPPING = {"properties": {"area": {"type": "geo_shape"},
                                "name": {"type": "keyword"}}}


def _poly(*pts):
    ring = [list(p) for p in pts] + [list(pts[0])]
    return {"type": "polygon", "coordinates": [ring]}


SHAPES = {
    "sq_origin": _poly((-1, -1), (1, -1), (1, 1), (-1, 1)),
    "sq_far": _poly((40, 40), (42, 40), (42, 42), (40, 42)),
    "big": _poly((-20, -20), (20, -20), (20, 20), (-20, 20)),
    "pt_inside": {"type": "point", "coordinates": [0.5, 0.5]},
    "pt_outside": {"type": "point", "coordinates": [10, 10]},
    "line_cross": {"type": "linestring", "coordinates": [[-2, 0], [2, 0]]},
    "envelope": {"type": "envelope", "coordinates": [[3, 6], [6, 3]]},
}
SHAPE_QUERIES = [
    _poly((-2, -2), (2, -2), (2, 2), (-2, 2)),
    _poly((39, 39), (43, 39), (43, 43), (39, 43)),
    {"type": "point", "coordinates": [0, 0]},
    {"type": "envelope", "coordinates": [[-25, 25], [25, -25]]},
    {"type": "linestring", "coordinates": [[-30, 0], [30, 0]]},
    {"type": "circle", "coordinates": [0.5, 0.5], "radius": "10km"},
]
BAND = 1e-5
N_POINTS = 2000


def seeded_points(n: int, seed: int = 11):
    """[(id, source)]: points clustered around 20 centres, every 13th doc
    without a point, then the edge points: on geohash cell edges at
    precisions 3 and 6, on the boxes' and the polygon's edges."""
    rng = np.random.default_rng(seed)
    cent = np.stack([rng.uniform(-60, 60, 20), rng.uniform(-170, 170, 20)], 1)
    docs = []
    for i in range(n):
        src = {"name": f"n{i % 9}"}
        if i % 13:
            c = cent[int(rng.integers(0, 20))]
            src["loc"] = {"lat": float(np.clip(c[0] + rng.normal(0, 4), -89,
                                               89)),
                          "lon": float((c[1] + rng.normal(0, 6) + 180) % 360
                                       - 180)}
        docs.append((f"p{i}", src))
    for lat, lon in edge_points():
        docs.append((f"e{len(docs)}", {"loc": {"lat": lat, "lon": lon},
                                       "name": "edge"}))
    return docs


def edge_points():
    """Points exactly on cell edges (-90 + 180 j / 2^bits lies on an f32
    value, and so does its lon twin) and on the test boxes' and polygon's
    edges and corners."""
    pts = []
    for prec in (3, 6):
        lat_bits, lon_bits = G.geohash_bits(prec)
        for j in (1, 3, 7, 100, (1 << lat_bits) // 2 + 5):
            j = j % (1 << lat_bits)
            lon_j = (j * 37) % (1 << lon_bits)
            pts.append((-90.0 + 180.0 * j / (1 << lat_bits),
                        -180.0 + 360.0 * lon_j / (1 << lon_bits)))
    for lat in (40.0, -10.0, 12.5):
        for lon in (170.0, -170.0, 0.0, 179.5):
            pts.append((lat, lon))
    pts += [(0.0, 0.0), (10.0, 5.0), (20.0, 30.0), (5.0, 20.0), (0.0, 15.0)]
    return pts


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _load(node, name, docs, mapping, shards=1, every=None):
    node.create_index(name, {"settings": {"index": {
        "number_of_shards": shards}}, "mappings": copy.deepcopy(mapping)})
    svc = node.indices[name]
    for j, (doc_id, src) in enumerate(docs):
        svc.index_doc(doc_id, copy.deepcopy(src))
        if every and (j + 1) % every == 0:
            svc.refresh()
    svc.refresh()


@pytest.fixture(scope="module")
def nodes():
    from elasticsearch_tpu.parallel import aot

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        cities = [(k, {"loc": {"lat": a, "lon": b}, "name": k})
                  for k, (a, b) in CITIES.items()] + [("noloc",
                                                       {"name": "noloc"})]
        for node in (ref, port):
            _load(node, "g", cities, PT_MAPPING)
            _load(node, "shapes", [(str(i), {"area": s, "name": k})
                                   for i, (k, s) in enumerate(SHAPES.items())],
                  SHAPE_MAPPING)
            _load(node, "pts", seeded_points(N_POINTS), PT_MAPPING,
                  shards=2, every=300)
    yield ref, port
    ref.close()
    port.close()


def _host(port, index, body):
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        return port.search(index, copy.deepcopy(body))
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


def both(nodes, index, body, route="mesh_fallback_total"):
    """(the port's host-loop response, the reference's): the port's mesh
    route first, byte-identical to its host loop, its route counted."""
    ref, port = nodes
    kernels.reset()
    mesh = port.search(index, copy.deepcopy(body))
    assert kernels.snapshot().get(route) == 1, kernels.snapshot()
    got = _host(port, index, body)
    assert _strip(mesh) == _strip(got)
    return got, ref.search(index, copy.deepcopy(body))


def same(nodes, index, body, route="mesh_fallback_total"):
    """Exact parity: hits (ids, order, scores, sort values), total and
    aggregations."""
    got, want = both(nodes, index, body, route)
    for r in (got, want):
        r.pop("took")
    assert _strip(got) == _strip(want), body
    return got


def hit_ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


# -- tests/unit/test_geo.py ---------------------------------------------------------

def test_geohash_roundtrip():
    for lat, lon in CITIES.values():
        for p in (1, 3, 5, 7):
            lat_bits, lon_bits = G.geohash_bits(p)
            nlat, nlon = 1 << lat_bits, 1 << lon_bits
            lat_cell = min(int((lat + 90.0) / 180.0 * nlat), nlat - 1)
            lon_cell = min(int((lon + 180.0) / 360.0 * nlon), nlon - 1)
            cell = lon_cell * nlat + lat_cell
            gh = G.geohash_encode_cell(cell, p)
            assert gh == RG.geohash_encode_cell(cell, p)
            assert G.geohash_decode(gh) == RG.geohash_decode(gh)
            dec_lat, dec_lon = G.geohash_decode(gh)
            assert abs(dec_lat - lat) <= 180.0 / nlat
            assert abs(dec_lon - lon) <= 360.0 / nlon


def test_known_geohash():
    lat, lon = CITIES["paris"]
    lat_bits, lon_bits = G.geohash_bits(4)
    nlat, nlon = 1 << lat_bits, 1 << lon_bits
    lat_cell = min(int((lat + 90.0) / 180.0 * nlat), nlat - 1)
    lon_cell = min(int((lon + 180.0) / 360.0 * nlon), nlon - 1)
    assert G.geohash_encode_cell(lon_cell * nlat + lat_cell, 4) == "u09t"


@pytest.mark.parametrize("precision", [1, 4, 12])
def test_geohash_grid_agg(nodes, precision):
    r = same(nodes, "g", {"size": 0, "aggs": {"grid": {"geohash_grid": {
        "field": "loc", "precision": precision}}}}, route="mesh_search")
    buckets = r["aggregations"]["grid"]["buckets"]
    assert sum(b["doc_count"] for b in buckets) == len(CITIES)
    if precision == 12:
        assert len(buckets) == len(CITIES)
        assert all(len(b["key"]) == 12 for b in buckets)


def test_geo_distance_agg(nodes):
    origin = CITIES["paris"]
    r = same(nodes, "g", {"size": 0, "aggs": {"rings": {"geo_distance": {
        "field": "loc", "origin": {"lat": origin[0], "lon": origin[1]},
        "unit": "km", "ranges": [{"to": 500}, {"from": 500, "to": 1500},
                                 {"from": 1500}]}}}}, route="mesh_search")
    by_key = {b["key"]: b["doc_count"]
              for b in r["aggregations"]["rings"]["buckets"]}
    want = {"*-500.0": 0, "500.0-1500.0": 0, "1500.0-*": 0}
    for lat, lon in CITIES.values():
        d = G.haversine_np(lat, lon, *origin) / 1000.0
        want["*-500.0" if d < 500 else "500.0-1500.0" if d < 1500
             else "1500.0-*"] += 1
    assert by_key == want


def test_geo_distance_sort_keeps_docs_without_a_point(nodes):
    """ROADMAP C: the reference drops a doc without a point from a
    ``_geo_distance``-sorted page (its preselection keeps finite keys
    only); the port sorts it last with a null sort value, as it sorts a
    missing field value. The located docs agree exactly."""
    origin = CITIES["paris"]
    body = {"query": {"exists": {"field": "name"}}, "size": 10,
            "sort": [{"_geo_distance": {"loc": {"lat": origin[0],
                                                "lon": origin[1]},
                                        "order": "asc", "unit": "km"}}]}
    got, want = both(nodes, "g", body)
    oracle = sorted(CITIES, key=lambda c: G.haversine_np(*CITIES[c],
                                                         *origin))
    assert hit_ids(want) == oracle  # the reference: noloc dropped
    assert hit_ids(got) == oracle + ["noloc"]
    assert got["hits"]["hits"][-1]["sort"] == [None]
    assert [h["sort"] for h in got["hits"]["hits"][:-1]] == \
        [h["sort"] for h in want["hits"]["hits"]]
    assert got["hits"]["total"] == want["hits"]["total"] == len(CITIES) + 1


def test_geo_shape_on_geo_points(nodes):
    q = {"type": "envelope", "coordinates": [[-5.0, 53.0], [15.0, 40.0]]}
    r = same(nodes, "g", {"query": {"geo_shape": {"loc": {"shape": q}}},
                          "size": 10})
    assert set(hit_ids(r)) == {"paris", "london", "berlin", "madrid", "rome"}
    q = {"type": "polygon", "coordinates": [[[-1.5, 43.0], [7.0, 43.0],
                                             [8.0, 49.5], [2.0, 51.0],
                                             [-4.0, 48.5], [-1.5, 43.0]]]}
    r = same(nodes, "g", {"query": {"geo_shape": {"loc": {"shape": q}}},
                          "size": 10})
    assert hit_ids(r) == ["paris"]
    q = {"type": "circle", "coordinates": [-0.1278, 51.5074],
         "radius": "400km"}
    r = same(nodes, "g", {"query": {"geo_shape": {"loc": {"shape": q}}},
                          "size": 10})
    assert set(hit_ids(r)) == {"london", "paris"}
    q = {"type": "multipolygon", "coordinates": [
        [[[-1, 48], [4, 48], [4, 50], [-1, 50], [-1, 48]]],
        [[[12, 41], [13, 41], [13, 42.5], [12, 42.5], [12, 41]]]]}
    r = same(nodes, "g", {"query": {"geo_shape": {"loc": {"shape": q}}},
                          "size": 10})
    assert set(hit_ids(r)) == {"paris", "rome"}


# -- tests/unit/test_geo_shape.py ---------------------------------------------------

def _shape_oracle(shape, relation):
    qp = G._shape_prims(shape)
    out = []
    for name, s in SHAPES.items():
        sp = G._shape_prims(s)
        hit = G.shape_intersects(sp, qp)
        if relation == "within":
            hit = G.shape_within(sp, qp)
        elif relation == "disjoint":
            hit = not hit
        if hit:
            out.append(name)
    return sorted(out)


def _shape_names(resp):
    return sorted(h["_source"]["name"] for h in resp["hits"]["hits"])


@pytest.mark.parametrize("qi", range(len(SHAPE_QUERIES)))
@pytest.mark.parametrize("relation", ["intersects", "within", "disjoint"])
def test_shapes_match_geometry_oracle(nodes, qi, relation):
    r = same(nodes, "shapes", {"query": {"geo_shape": {"area": {
        "shape": SHAPE_QUERIES[qi], "relation": relation}}}, "size": 20})
    assert _shape_names(r) == _shape_oracle(SHAPE_QUERIES[qi], relation)


def test_cross_level_matching(nodes):
    tiny = _poly((-0.01, -0.01), (0.01, -0.01), (0.01, 0.01), (-0.01, 0.01))
    got = _shape_names(same(nodes, "shapes", {"query": {"geo_shape": {
        "area": {"shape": tiny}}}, "size": 20}))
    assert "big" in got and "sq_origin" in got


def test_index_tokens_equal_the_reference():
    for shape in list(SHAPES.values()) + SHAPE_QUERIES:
        assert G.shape_index_tokens(shape) == RG.shape_index_tokens(shape)
    toks = G.shape_index_tokens(SHAPES["big"])
    assert "g0" in {t.split(":")[0] for t in toks}
    small = G.shape_index_tokens(SHAPES["pt_inside"])
    assert any(t.startswith("g2:") for t in small)
    assert any(t.startswith("g0:") for t in small)
    world = {"type": "envelope", "coordinates": [[-179, 89], [179, -89]]}
    toks = G.shape_index_tokens(world)
    assert len(toks) < 1200 and all(t.startswith("g0:") for t in toks)


def test_geo_point_path_and_disjoint_refusal():
    ref, port = RefNode(name="r3"), Node(name="p3", device="cpu")
    try:
        docs = [("a", {"loc": {"lat": 0.5, "lon": 0.5}}),
                ("b", {"loc": {"lat": 30.0, "lon": 30.0}})]
        for node in (ref, port):
            _load(node, "pts", docs, PT_MAPPING)
        sq = _poly((-1, -1), (1, -1), (1, 1), (-1, 1))
        r = same((ref, port), "pts", {"query": {"geo_shape": {"loc": {
            "shape": sq}}}})
        assert hit_ids(r) == ["a"]
        for node in (ref, port):
            with pytest.raises(Exception) as e:
                node.search("pts", {"query": {"geo_shape": {"loc": {
                    "shape": sq, "relation": "disjoint"}}}})
            assert type(e.value).__name__ == "QueryParsingException"
        with pytest.raises(ElasticsearchTpuException):
            port.search("pts", {"query": {"geo_shape": {"loc": {
                "shape": sq, "relation": "disjoint"}}}})
    finally:
        ref.close()
        port.close()


def test_shape_array_and_segment_without_shapes():
    ref, port = RefNode(name="r4"), Node(name="p4", device="cpu")
    try:
        for node in (ref, port):
            node.create_index("arr", {"mappings": copy.deepcopy(
                SHAPE_MAPPING)})
            svc = node.indices["arr"]
            svc.index_doc("multi", {"area": [
                {"type": "point", "coordinates": [1, 1]},
                {"type": "point", "coordinates": [50, 50]}]})
            svc.refresh()
            svc.index_doc("noshape", {"other": "x"})
            svc.refresh()
        q = _poly((49, 49), (51, 49), (51, 51), (49, 51))
        r = same((ref, port), "arr", {"query": {"geo_shape": {"area": {
            "shape": q}}}})
        assert hit_ids(r) == ["multi"]
        r = same((ref, port), "arr", {"query": {"geo_shape": {"area": {
            "shape": q, "relation": "disjoint"}}}})
        assert r["hits"]["total"] == 0
    finally:
        ref.close()
        port.close()


def test_bad_shape_is_a_mapper_error():
    port = Node(name="p5", device="cpu")
    try:
        port.create_index("bad", {"mappings": copy.deepcopy(SHAPE_MAPPING)})
        with pytest.raises(MapperParsingException):
            port.indices["bad"].index_doc("1", {"area": {"type": "nope"}})
        with pytest.raises(MapperParsingException):
            port.indices["bad"].index_doc("2", {"area": "not-geojson"})
    finally:
        port.close()


def test_exists_on_composite_geo_fields(nodes):
    """exists on a geo_shape (its ``.__cells``) and a geo_point (its
    ``.lat``): the mesh serves it, byte for byte with the host loop."""
    r = same(nodes, "shapes", {"query": {"exists": {"field": "area"}},
                               "size": 20}, route="mesh_search")
    assert r["hits"]["total"] == len(SHAPES)
    r = same(nodes, "g", {"query": {"exists": {"field": "loc"}},
                          "size": 20}, route="mesh_search")
    assert sorted(hit_ids(r)) == sorted(CITIES)
    r = same(nodes, "pts", {"query": {"bool": {"must_not": [
        {"exists": {"field": "loc"}}]}}, "size": 500}, route="mesh_search")
    assert r["hits"]["total"] == len(range(0, N_POINTS, 13))


def test_shape_in_bool_filter(nodes):
    r = same(nodes, "shapes", {"query": {"bool": {"filter": [
        {"geo_shape": {"area": {"shape": SHAPE_QUERIES[0]}}},
        {"term": {"name": "pt_inside"}}]}}})
    assert [h["_source"]["name"] for h in r["hits"]["hits"]] == ["pt_inside"]


# -- seeded points, edge points and the bands --------------------------------------

def _points(port):
    """(ids, lat f64, lon f64) of every located doc of the seeded index."""
    ids, lat, lon = [], [], []
    for sh in port.indices["pts"].shards:
        for seg in sh.engine.segments:
            la, lo = seg.numerics["loc.lat"], seg.numerics["loc.lon"]
            for i in np.nonzero(la.exists_host[: seg.num_docs])[0]:
                ids.append(seg.ids[i])
                lat.append(la.exact[i])
                lon.append(lo.exact[i])
    return ids, np.asarray(lat), np.asarray(lon)


def _banded_hits(nodes, body, band_ids):
    """The hit sets may differ only inside the band; the totals by the
    band's docs that differ."""
    got, want = both(nodes, "pts", dict(body, size=10_000))
    g, w = set(hit_ids(got)), set(hit_ids(want))
    assert g ^ w <= band_ids, sorted(g ^ w)
    assert got["hits"]["total"] - want["hits"]["total"] == \
        len(g - w) - len(w - g)
    return got


@pytest.mark.parametrize("radius_km", [150, 900, 4000])
def test_seeded_geo_distance_banded(nodes, radius_km):
    _ref, port = nodes
    ids, lat, lon = _points(port)
    center = (lat[5], lon[5])
    d = G.haversine_np(lat, lon, *center)
    r = radius_km * 1000.0
    band = {i for i, x in zip(ids, d) if abs(x - r) <= BAND * r}
    print(f"geo_distance {radius_km} km: {len(band)} docs in the band")
    got = _banded_hits(nodes, {"query": {"geo_distance": {
        "distance": f"{radius_km}km",
        "loc": {"lat": float(center[0]), "lon": float(center[1])}}}}, band)
    inside = {i for i, x in zip(ids, d) if x <= r} - band
    assert inside <= set(hit_ids(got))


BOXES = [
    {"top_left": {"lat": 40.0, "lon": -170.0},
     "bottom_right": {"lat": -10.0, "lon": 0.0}},
    # across the antimeridian
    {"top_left": {"lat": 40.0, "lon": 170.0},
     "bottom_right": {"lat": -10.0, "lon": -170.0}},
    {"top": 12.5, "left": 0.0, "bottom": -10.0, "right": 179.5},
]


@pytest.mark.parametrize("bi", range(len(BOXES)))
def test_seeded_bounding_boxes_exact(nodes, bi):
    r = same(nodes, "pts", {"query": {"geo_bounding_box": {
        "loc": BOXES[bi]}}, "size": 10_000})
    assert r["hits"]["total"] > 0


POLYGONS = [
    [(0.0, 0.0), (10.0, 5.0), (20.0, 30.0), (5.0, 20.0), (0.0, 15.0)],
    [(-40, -100), (-10, -60), (30, -80), (55, -20), (20, 10), (-5, -20),
     (-30, -40), (-45, -70)],
    [(10, 100), (50, 120), (30, 160), (-10, 150), (0, 120), (5, 110)],
]


@pytest.mark.parametrize("pi", range(len(POLYGONS)))
def test_seeded_polygons_exact(nodes, pi):
    pts = [{"lat": a, "lon": b} for a, b in POLYGONS[pi]]
    same(nodes, "pts", {"query": {"geo_polygon": {"loc": {"points": pts}}},
                        "size": 10_000})


def test_seeded_geo_aggs(nodes):
    """geohash_grid at precisions 3 and 6 (the edge points included) and
    geo_bounds exact; the geo_distance rings within the band."""
    _ref, port = nodes
    body = {"size": 0, "aggs": {
        "g3": {"geohash_grid": {"field": "loc", "precision": 3}},
        "g6": {"geohash_grid": {"field": "loc", "precision": 6,
                                "size": 50}},
        "b": {"geo_bounds": {"field": "loc"}},
        "by_name": {"terms": {"field": "name"}, "aggs": {
            "g": {"geohash_grid": {"field": "loc", "precision": 2}},
            "b": {"geo_bounds": {"field": "loc"}}}}}}
    same(nodes, "pts", body, route="mesh_search")
    ids, lat, lon = _points(port)
    edges_km = (500.0, 2000.0, 6000.0)
    d = G.haversine_np(lat, lon, 10.0, 20.0) / 1000.0
    band = sum(int(np.sum(np.abs(d - e) <= BAND * e)) for e in edges_km)
    print(f"geo_distance agg: {band} docs in the band")
    rings = {"size": 0, "aggs": {"r": {"geo_distance": {
        "field": "loc", "origin": "10,20", "unit": "km",
        "ranges": [{"to": 500}, {"from": 500, "to": 2000},
                   {"from": 2000, "to": 6000}, {"from": 6000}]}}}}
    got, want = both(nodes, "pts", rings, route="mesh_search")
    gb = got["aggregations"]["r"]["buckets"]
    wb = want["aggregations"]["r"]["buckets"]
    assert [b["key"] for b in gb] == [b["key"] for b in wb]
    assert sum(abs(a["doc_count"] - b["doc_count"])
               for a, b in zip(gb, wb)) <= 2 * band


def test_edge_points_cells_are_true_divisions():
    """On cell edges the port's cells equal the reference's and the exact
    cell (a reciprocal product would land one cell low)."""
    pts = np.asarray(edge_points(), np.float32)
    lat, lon = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    for prec in (3, 6, 12):
        lat_bits, lon_bits = G.geohash_bits(prec)
        got = G.geohash_cell_device(lat, lon, prec).numpy()
        rl, ro = RG.geohash_cell_device(pts[:, 0], pts[:, 1], prec)
        want = (np.asarray(ro).astype(np.int64) << lat_bits) \
            + np.asarray(rl).astype(np.int64)
        np.testing.assert_array_equal(got, want)
        if prec == 12:
            continue
        # the cell-edge points (the first ten) in their exact f64 cells
        got, pts64 = got[:10], pts[:10].astype(np.float64)
        exact = (np.clip(np.floor((pts64[:, 1] + 180) / 360
                                  * (1 << lon_bits)), 0,
                         (1 << lon_bits) - 1).astype(np.int64) << lat_bits) \
            + np.clip(np.floor((pts64[:, 0] + 90) / 180 * (1 << lat_bits)),
                      0, (1 << lat_bits) - 1).astype(np.int64)
        np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("order", ["asc", "desc"])
@pytest.mark.parametrize("size", [10, 100])
def test_seeded_geo_distance_sort(nodes, order, size):
    """The located docs in the reference's order with its f64 sort values;
    the port adds the pointless docs after them (ROADMAP C)."""
    body = {"query": {"exists": {"field": "loc"}}, "size": size,
            "sort": [{"_geo_distance": {"loc": [20.0, 10.0], "order": order,
                                        "unit": "mi"}}, {"name": "asc"}]}
    got, want = both(nodes, "pts", body)
    assert hit_ids(got) == hit_ids(want)
    assert [h["sort"] for h in got["hits"]["hits"]] == \
        [h["sort"] for h in want["hits"]["hits"]]
    assert got["hits"]["total"] == want["hits"]["total"]
