"""The document APIs and by-query over HTTP: the port's server against the
reference's, the same requests to both (``tests/_torch_rest.py``).

Index, create, get, head, ``_source``, delete, ``_update`` (partial doc,
script, upsert), ``_mget``, ``_bulk`` NDJSON with every item type and
failing items, termvectors and mtermvectors, ``_delete_by_query`` and
``_update_by_query``, over a seeded corpus (``_torch_parity.corpus``).
Every answer is held exactly (statuses, versions, ``found``, ``_shards``,
bulk item statuses, sources) but for the volatile keys the harness masks.
"""
import pytest

from _torch_parity import corpus
from _torch_rest import Pair, ndjson

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "price": {"type": "double"},
}}
SETTINGS = {"index": {"number_of_shards": 2, "search": {"mesh": "false"}}}
DOCS = corpus(120, seed=11)


@pytest.fixture(scope="module")
def pair():
    p = Pair()
    yield p
    p.close()


@pytest.fixture
def idx(pair):
    pair.wipe()
    pair.same("PUT", "/docs", {"settings": SETTINGS, "mappings": MAPPING})
    lines = []
    for doc_id, src in DOCS:
        lines += [{"index": {"_index": "docs", "_id": doc_id}}, src]
    pair.same("POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    return pair


def test_index_get_head_source_delete(idx):
    s = idx.same
    s("PUT", "/docs/_doc/new1", {"body": "a new doc", "n": 5})
    s("PUT", "/docs/_doc/new1", {"body": "a newer doc", "n": 6})
    s("GET", "/docs/_doc/new1")
    s("GET", "/docs/_doc/d7")
    s("HEAD", "/docs/_doc/d7")
    s("HEAD", "/docs/_doc/nope")
    s("GET", "/docs/_doc/nope")
    s("GET", "/docs/_source/d9")
    s("GET", "/docs/_source/nope")
    s("GET", "/docs/_doc/d9?_source=tag,n")
    s("GET", "/docs/_doc/d9?fields=tag,n")
    s("GET", "/docs/_doc/d9?version=1")
    s("GET", "/docs/_doc/d9?version=3")
    s("DELETE", "/docs/_doc/d9")
    s("GET", "/docs/_doc/d9")
    s("DELETE", "/docs/_doc/d9")
    s("GET", "/nope/_doc/d1")


def test_auto_id_and_create(idx):
    # an auto id is random, so is its shard: it goes to an index of its
    # own, whose one shard keeps the seq-nos equal
    idx.same("PUT", "/auto", {"settings": {"number_of_shards": 1}})
    (rs, rb), (ps, pb) = idx.both("POST", "/auto/_doc", {"body": "auto"})
    assert rs == ps == 201
    assert rb["_version"] == pb["_version"] == 1
    assert rb["created"] is pb["created"] is True
    assert len(rb["_id"]) == len(pb["_id"]) == 20
    idx.same("POST", "/auto/article", {"body": "typed auto"},
             ignore=("_id",))
    idx.same("PUT", "/docs/_create/c1", {"body": "created once"})
    idx.same("PUT", "/docs/_create/c1", {"body": "created twice"})
    idx.same("PUT", "/docs/t1/c2/_create", {"body": "typed create"})
    idx.same("PUT", "/docs/_doc/d3?version=1", {"body": "checked"})
    idx.same("PUT", "/docs/_doc/d3?version=1", {"body": "stale"})
    idx.same("PUT", "/docs/_doc/d4?op_type=create", {"body": "exists"})
    idx.same("PUT", "/docs/_doc/x9?version=7&version_type=external",
             {"body": "external"})
    idx.same("GET", "/docs/_doc/x9")


def test_typed_routes(idx):
    s = idx.same
    s("PUT", "/docs/article/t1", {"body": "typed doc", "tag": "tt"})
    s("GET", "/docs/article/t1")
    s("GET", "/docs/other/t1")
    s("HEAD", "/docs/article/t1")
    s("GET", "/docs/article/t1/_source")
    s("DELETE", "/docs/article/t1")
    s("GET", "/docs/_bad/t1")


def test_update(idx):
    s = idx.same
    s("POST", "/docs/_update/d5", {"doc": {"tag": "changed"}})
    s("GET", "/docs/_doc/d5")
    s("POST", "/docs/_update/d5", {"doc": {"tag": "changed"}})
    s("POST", "/docs/_update/d6",
      {"script": "ctx._source.n += 1"})
    s("POST", "/docs/_update/d6",
      {"script": {"inline": "ctx._source.n += p", "params": {"p": 3}}})
    s("GET", "/docs/_doc/d6")
    s("POST", "/docs/_update/missing", {"doc": {"tag": "x"}})
    s("POST", "/docs/_update/missing",
      {"doc": {"tag": "x"}, "upsert": {"tag": "fresh", "n": 1}})
    s("POST", "/docs/_update/missing2",
      {"doc": {"tag": "y"}, "doc_as_upsert": True})
    s("GET", "/docs/_doc/missing2")
    s("POST", "/docs/_update/d8?fields=tag,_source",
      {"doc": {"tag": "with fields"}})
    s("POST", "/docs/_update/d8?version=1", {"doc": {"tag": "stale"}})
    s("POST", "/docs/_update/d8?refresh=true", {"doc": {"n": 99}})
    s("POST", "/docs/_search", {"query": {"term": {"n": 99}}})


def test_mget(idx):
    s = idx.same
    s("POST", "/docs/_mget", {"ids": ["d1", "d2", "nope", "d3"]})
    s("POST", "/_mget", {"docs": [
        {"_index": "docs", "_id": "d10"},
        {"_index": "docs", "_id": "d11", "_source": ["tag"]},
        {"_index": "nope", "_id": "d12"},
        {"_index": "docs", "_id": "d13", "fields": ["n", "price"]}]})
    s("GET", "/docs/_mget?refresh=true", {"ids": ["d20"]})
    s("POST", "/_mget", {"docs": [{"_id": "d1"}]})
    s("POST", "/docs/_mget", {})
    s("POST", "/docs/article/_mget", {"ids": ["d1"]})


def test_bulk_every_item_type(idx):
    lines = [
        {"index": {"_index": "docs", "_id": "b1"}}, {"body": "bulk one"},
        {"create": {"_index": "docs", "_id": "b1"}}, {"body": "dup"},
        {"create": {"_index": "docs", "_id": "b2"}}, {"body": "bulk two"},
        {"update": {"_index": "docs", "_id": "b2"}},
        {"doc": {"tag": "u"}},
        {"update": {"_index": "docs", "_id": "zz"}},
        {"doc": {"tag": "missing"}},
        {"delete": {"_index": "docs", "_id": "d1"}},
        {"delete": {"_index": "docs", "_id": "nope"}},
        {"index": {"_index": "fresh", "_id": "f1"}}, {"x": 1},
        {"index": {"_index": "docs", "_id": "b3", "_version": 4,
                   "_version_type": "external"}}, {"body": "ext"},
    ]
    idx.same("POST", "/_bulk?refresh=true", ndjson=ndjson(lines))
    idx.same("POST", "/docs/_bulk", ndjson=ndjson([
        {"index": {"_id": "b4"}}, {"body": "default index"}]))
    idx.same("POST", "/docs/article/_bulk?refresh=true", ndjson=ndjson([
        {"index": {"_id": "b5"}}, {"body": "typed bulk"}]))
    idx.same("GET", "/docs/article/b5")
    # unsorted: a sort on `n` would meet the reference's first sort
    # fault (docs without the key are dropped; ROADMAP's known differences)
    idx.same("POST", "/docs/_search",
             {"query": {"match_all": {}}, "size": 200})
    idx.same("GET", "/fresh/_doc/f1")


def test_bulk_malformed(idx):
    idx.same("POST", "/_bulk", ndjson="{not json}\n{}\n")


def test_termvectors(idx):
    s = idx.same
    s("GET", "/docs/_termvectors/d14")
    s("GET", "/docs/_termvectors/d14?term_statistics=true&fields=body")
    s("POST", "/docs/_termvectors/d15", {"offsets": False,
                                         "field_statistics": False})
    s("GET", "/docs/_termvectors/nope")
    s("GET", "/docs/article/d16/_termvectors")
    s("POST", "/docs/_mtermvectors", {"ids": ["d17", "d18", "nope"]})
    s("POST", "/_mtermvectors", {"docs": [
        {"_index": "docs", "_id": "d19"},
        {"_index": "nope", "_id": "d19"}]})
    s("GET", "/docs/_mtermvectors?ids=d20,d21")


def test_delete_by_query(idx):
    idx.same("POST", "/docs/_delete_by_query",
             {"query": {"term": {"tag": "t3"}}})
    idx.same("POST", "/docs/_refresh")
    idx.same("POST", "/docs/_count", {"query": {"match_all": {}}})
    idx.same("DELETE", "/docs/_query", {"query": {"range": {"n": {
        "lt": 100_000_000}}}})
    idx.same("POST", "/docs/_count")
    idx.same("POST", "/nope/_delete_by_query", {"query": {"match_all": {}}})


def test_update_by_query(idx):
    idx.same("POST", "/docs/_update_by_query", {
        "query": {"term": {"tag": "t2"}},
        "script": "ctx._source.n = 7"})
    idx.same("POST", "/docs/_refresh")
    idx.same("POST", "/docs/_search", {"query": {"term": {"n": 7}},
                                       "size": 100, "sort": ["_doc"]})
    idx.same("POST", "/docs/_update_by_query",
             {"query": {"term": {"tag": "t5"}}})
    idx.same("POST", "/docs/_update_by_query",
             {"query": {"term": {"tag": "t6"}},
              "script": "ctx._source.nope.deeper = 1"})
