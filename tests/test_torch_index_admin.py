"""The index admin surface of the port's ``Node`` against the reference on
the CPU: mappings PUT, aliases (filter and routing), templates applied by
order, and the ``stats`` surface (the request key's groups and
``IndexService.stats()``).

Mappings, templates and the stored alias specs equal the reference's.
The reference stores an alias's ``filter`` and routings and applies
neither (ROADMAP C13, pinned here as its own answer); the port applies
them as ES 2.0 does: the filter narrows the hits, ``search_routing`` the
shards searched, ``index_routing`` places a doc written through the
alias. The search, suggest, scroll, refresh and flush counters of
``stats()`` equal the reference's on the same writes and bodies.
"""
import copy

import pytest

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.utils.errors import \
    ElasticsearchTpuException as RefError
from elasticsearch_tpu_torch.cluster.routing import shard_id_for
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException

from _torch_parity import MAPPING, corpus

QUERY = {"match": {"body": "fox river dog"}}


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def pair(shards=3, n=150, names=("a",), data=None):
    ref = RefNode(name="r")
    port = Node(name="p", device="cpu", data_path=data)
    for node in (ref, port):
        for name in names:
            node.create_index(name, {"settings": {"number_of_shards": shards},
                                     "mappings": MAPPING})
            for doc_id, src in corpus(n, seed=len(name)):
                node.indices[name].index_doc(doc_id, copy.deepcopy(src))
            node.indices[name].refresh()
    return ref, port


def _ids(resp):
    return [h["_id"] for h in resp["hits"]["hits"]]


# -- mappings PUT ----------------------------------------------------------------

def test_put_mapping_matches_the_reference_and_persists(tmp_path):
    ref, port = pair(data=str(tmp_path / "p"))
    try:
        put = {"properties": {"extra": {"type": "keyword"},
                              "words": {"type": "text",
                                        "analyzer": "english"}}}
        for node in (ref, port):
            assert node.put_mapping("a", copy.deepcopy(put)) == \
                {"acknowledged": True}
            node.indices["a"].index_doc("x", {"body": "fox", "extra": "k1",
                                              "words": "running foxes"})
            node.indices["a"].refresh()
        assert port.get_mapping("a") == ref.get_mapping("a")
        body = {"query": {"bool": {"must": [{"match": {"words": "fox"}}],
                                   "filter": [{"term": {"extra": "k1"}}]}}}
        assert _ids(port.search("a", copy.deepcopy(body))) == \
            _ids(ref.search("a", copy.deepcopy(body))) == ["x"]
        # a refused merge changes no index, in either package
        bad = {"properties": {"w2": {"type": "text", "analyzer": "nope"}}}
        for node in (ref, port):
            before = node.get_mapping("a")
            with pytest.raises((RefError, ElasticsearchTpuException)):
                node.put_mapping("a", copy.deepcopy(bad))
            assert node.get_mapping("a") == before
        port.close()
        again = Node(name="p2", device="cpu", data_path=str(tmp_path / "p"))
        try:
            assert again.get_mapping("a") == ref.get_mapping("a")
        finally:
            again.close()
    finally:
        ref.close()


# -- aliases -----------------------------------------------------------------------

ALIASES = [
    {"add": {"index": "a", "alias": "plain"}},
    {"add": {"index": "a", "alias": "t3", "filter": {"term": {"tag": "t3"}}}},
    {"add": {"index": "a", "alias": "r1", "routing": 1}},
    {"add": {"index": "a", "alias": "ir", "index_routing": "k",
             "search_routing": "k,q"}},
    {"add": {"index": "a,b", "alias": "both"}},
    {"add": {"index": "b", "alias": "bt", "filter": {"term": {"tag": "t1"}}}},
]


def test_alias_specs_match_the_reference():
    ref, port = pair(names=("a", "b"))
    try:
        for node in (ref, port):
            node.update_aliases(copy.deepcopy(ALIASES))
            node.update_aliases([{"remove": {"index": "a",
                                             "alias": "plain"}}])
        for name in ("a", "b"):
            assert port.indices[name].aliases == ref.indices[name].aliases
        for alias in ("t3", "both", "bt", "r1"):
            assert port.resolve_indices(alias) == ref.resolve_indices(alias)
            assert port.index_exists(alias) and ref.index_exists(alias)
        assert not port.index_exists("plain")
        # ES's list form of ``indices`` (the reference resolves the list's
        # repr and adds the alias nowhere)
        port.update_aliases([{"add": {"indices": ["a", "b"],
                                      "alias": "listed"}}])
        assert port.resolve_indices("listed") == ["a", "b"]
    finally:
        ref.close()
        port.close()


def test_alias_filter_narrows_the_hits_and_the_reference_ignores_it():
    ref, port = pair(names=("a", "b"))
    try:
        for node in (ref, port):
            node.update_aliases(copy.deepcopy(ALIASES))
        body = {"query": QUERY, "size": 50}
        filtered = {"query": {"bool": {"must": [QUERY], "filter": [
            {"term": {"tag": "t3"}}]}}, "size": 50}
        got = port.search("t3", copy.deepcopy(body))
        want = port.search("a", copy.deepcopy(filtered))
        assert _ids(got) == _ids(want) and got["hits"]["total"] == \
            want["hits"]["total"] > 0
        assert [h["_score"] for h in got["hits"]["hits"]] == \
            [h["_score"] for h in want["hits"]["hits"]]
        # the reference's answer through the alias is the unfiltered one
        r = ref.search("t3", copy.deepcopy(body))
        assert r["hits"]["total"] == \
            ref.search("a", copy.deepcopy(body))["hits"]["total"] \
            > got["hits"]["total"]
        # several indices: each keeps its own alias's filter
        got = port.search("t3,bt", {"query": QUERY, "size": 100})
        want = {("a", i) for i in _ids(port.search("a", copy.deepcopy(
            filtered)))} | {("b", h["_id"]) for h in port.search("b", {
                "query": {"bool": {"must": [QUERY], "filter": [
                    {"term": {"tag": "t1"}}]}}, "size": 100})["hits"]["hits"]}
        assert {(h["_index"], h["_id"]) for h in got["hits"]["hits"]} == want
        assert got["hits"]["total"] == len(want)
        # an index named directly beside its filtered alias is unfiltered
        assert port.search("a,t3", copy.deepcopy(body))["hits"]["total"] == \
            port.search("a", copy.deepcopy(body))["hits"]["total"]
    finally:
        ref.close()
        port.close()


def test_alias_routing_places_and_searches_shards():
    ref, port = pair(shards=4)
    try:
        port.update_aliases(copy.deepcopy(ALIASES[:4]))
        r = port.index("ir", "routed", {"body": "fox unique", "tag": "t0"})
        assert r["created"]
        shard = shard_id_for("routed", 4, "k")
        assert port.indices["a"].shards[shard].engine.exists("routed")
        assert port.get("ir", "routed")["found"]
        assert not port.get("a", "routed")["found"]  # routed by its id
        assert port.get("a", "routed", routing="k")["found"]
        port.refresh("a")
        # search routing k,q: only those values' shards are searched
        want = {shard_id_for("", 4, "k"), shard_id_for("", 4, "q")}
        body = {"query": {"match_all": {}}, "size": 0}
        got = port.search("ir", body)
        assert got["_shards"]["total"] == len(want)
        assert got["hits"]["total"] == sum(
            port.indices["a"].shards[s].engine.num_docs for s in want)
        assert port.search("r1", body)["_shards"]["total"] == 1
        port.delete("ir", "routed")
        assert not port.get("ir", "routed")["found"]
        # the reference searches every shard through a routed alias
        ref.update_aliases(copy.deepcopy(ALIASES[:4]))
        assert ref.search("ir", body)["_shards"]["total"] == 4
    finally:
        ref.close()
        port.close()


def test_aliases_persist_across_a_restart(tmp_path):
    d = str(tmp_path / "p")
    port = Node(name="p", device="cpu", data_path=d)
    port.create_index("a", {"mappings": MAPPING,
                            "aliases": {"t3": {"filter": {"term": {
                                "tag": "t3"}}}}})
    port.update_aliases([{"add": {"index": "a", "alias": "r",
                                  "routing": "x"}}])
    port.close()
    for node in (Node(name="p2", device="cpu", data_path=d),
                 RefNode(data_path=d)):
        try:
            assert node.indices["a"].aliases == {
                "t3": {"filter": {"term": {"tag": "t3"}}},
                "r": {"index_routing": "x", "search_routing": "x"}}
        finally:
            node.close()


# -- templates ---------------------------------------------------------------------

TEMPLATES = {
    "late": {"template": "logs-*", "order": 2,
             "settings": {"number_of_shards": 2},
             "mappings": {"properties": {"b": {"type": "long"}}},
             "aliases": {"recent": {"routing": 3}}},
    "early": {"template": "logs-*", "order": 0,
              "settings": {"number_of_shards": 5,
                           "refresh_interval": "5s"},
              "mappings": {"properties": {"a": {"type": "keyword"},
                                          "b": {"type": "text"}}}},
    "other": {"template": "metrics-*", "order": 9,
              "settings": {"number_of_shards": 7}},
}


def test_templates_apply_lowest_order_first():
    ref, port = RefNode(name="r"), Node(name="p", device="cpu")
    try:
        for node in (ref, port):
            for name, t in TEMPLATES.items():
                node.put_template(name, copy.deepcopy(t))
            node.create_index("logs-1", {"mappings": {"properties": {
                "c": {"type": "double"}}}})
            node.create_index("plain")
            with pytest.raises((RefError, ElasticsearchTpuException)):
                node.put_template("late", {"template": "x"}, create=True)
        for name in ("logs-1", "plain"):
            assert port.indices[name].settings == ref.indices[name].settings
            assert port.get_mapping(name) == ref.get_mapping(name)
            assert port.indices[name].aliases == ref.indices[name].aliases
            assert port.indices[name].num_shards == \
                ref.indices[name].num_shards
        assert port.indices["logs-1"].num_shards == 2
        assert port.indices["logs-1"].mappings.get("b").type == "long"
        # the port keeps each template as it was put; the reference's
        # create_index merges into the stored template's own dicts, so a
        # later index of the pattern inherits the first one's fields
        assert port.cluster_state.templates["early"] == TEMPLATES["early"]
        assert "c" in ref.cluster_state.templates["early"]["mappings"][
            "properties"]
        for node in (ref, port):
            node.delete_template("late")
            node.create_index("logs-2")
            with pytest.raises((RefError, ElasticsearchTpuException)):
                node.delete_template("late")
        assert port.indices["logs-2"].num_shards == \
            ref.indices["logs-2"].num_shards == 5
        assert "c" not in port.indices["logs-2"].mappings.fields
        assert "c" in ref.indices["logs-2"].mappings.fields
    finally:
        ref.close()
        port.close()


# -- the stats surface ---------------------------------------------------------------

STATS_BODIES = [
    {"query": QUERY, "stats": ["g1"]},
    {"query": QUERY, "stats": ["g1", "g2"], "size": 3},
    {"query": {"term": {"tag": "t2"}}, "stats": ["g2"], "size": 0},
    {"query": {"match": {"body": "zzz"}}, "stats": ["g3"]},
    {"query": QUERY, "sort": [{"n": "desc"}], "stats": ["g1"]},
    {"query": QUERY, "aggs": {"t": {"terms": {"field": "tag"}}},
     "stats": ["g2"]},
    {"query": QUERY},
    {"query": QUERY, "suggest": {"s": {"text": "foxx",
                                       "term": {"field": "body"}}}},
]
COUNTERS = ("query_total", "fetch_total", "suggest_total", "scroll_total")


def _stats_view(svc):
    st = svc.stats()
    out = []
    for sh in sorted(st["shards"], key=int):
        s = st["shards"][sh]
        out.append({
            "search": {k: s["search"][k] for k in COUNTERS},
            "groups": {g: {k: v for k, v in c.items() if "time" not in k}
                       for g, c in s["search"].get("groups", {}).items()},
            "refresh": s["refresh"]["total"], "flush": s["flush"]["total"],
            "docs": s["docs"]["count"],
            "indexing": (s["indexing"]["index_total"],
                         s["indexing"]["delete_total"])})
    return out


@pytest.mark.parametrize("mesh", [True, False])
def test_stats_groups_match_the_reference(mesh, monkeypatch):
    if not mesh:
        monkeypatch.setenv("ESTPU_DISABLE_MESH", "1")
    ref, port = pair(shards=3, n=180)
    try:
        for node in (ref, port):
            svc = node.indices["a"]
            for b in STATS_BODIES:
                node.search("a", copy.deepcopy(b))
            node.msearch([({"index": "a"}, {"query": {"match": {
                "body": w}}}) for w in ("fox", "river", "dog")])
            svc.suggest({"s": {"text": "rivr", "term": {"field": "body"}}})
            node.search("a", {"query": QUERY, "scroll": "1m", "size": 5})
            svc.index_doc("new", {"body": "fox", "tag": "t1"})
            svc.delete_doc("d4")
            svc.flush()
            svc.refresh()  # nothing new: no refresh counted
        got, want = _stats_view(port.indices["a"]), \
            _stats_view(ref.indices["a"])
        assert got == want
        total = port.indices["a"].stats()["primaries"]["search"]
        assert total["groups"]["g1"]["query_total"] == 3 * 3
        assert total["suggest_total"] == 2 * 3 and total["scroll_total"] == 3
        assert sum(s["flush"] for s in got) == 3
    finally:
        ref.close()
        port.close()


def test_a_string_stats_value_is_one_group():
    _ref, port = pair(shards=2, n=60)
    try:
        port.search("a", {"query": QUERY, "stats": "solo"})
        groups = port.indices["a"].stats()["primaries"]["search"]["groups"]
        assert list(groups) == ["solo"] and groups["solo"]["query_total"] == 2
    finally:
        _ref.close()
        port.close()


# -- dynamic settings, blocks and health -----------------------------------------

def test_settings_blocks_and_health_match_the_reference(tmp_path):
    from elasticsearch_tpu.cluster import metadata as ref_md

    ref, port = pair(shards=2, n=30, data=str(tmp_path / "p"))
    try:
        updates = [({"index": {"blocks.write": True}}, None),
                   ({"index.refresh_interval": "2s"}, None),
                   ({"number_of_shards": 3}, "not dynamically updateable"),
                   ({"settings": {"index": {"blocks": {"read": "true"}}}},
                    None)]
        for body, err in updates:
            out = []
            for node in (ref, port):
                try:
                    if node is ref:
                        ref_md.update_index_settings(ref.indices["a"],
                                                     copy.deepcopy(body),
                                                     node=ref)
                    else:
                        port.update_index_settings("a", copy.deepcopy(body))
                    out.append(None)
                except (RefError, ElasticsearchTpuException) as e:
                    out.append((e.status, e.error_type, str(e)))
            assert out[0] == out[1]
            assert (out[0] is None) == (err is None)
        assert port.indices["a"].settings == ref.indices["a"].settings
        for node in (ref, port):
            with pytest.raises((RefError, ElasticsearchTpuException)) as e:
                node.indices["a"].index_doc("z", {"body": "x"})
            assert e.value.error_type == "cluster_block_exception"
            with pytest.raises((RefError, ElasticsearchTpuException)) as e:
                node.search("a", {"query": QUERY})
            assert "blocks.read" in str(e.value)
        keep = ("status", "number_of_nodes", "active_primary_shards",
                "active_shards", "unassigned_shards")
        assert {k: port.cluster_state.health()[k] for k in keep} == \
            {k: ref.cluster_state.health()[k] for k in keep}
        port.close()
        again = Node(name="p2", device="cpu", data_path=str(tmp_path / "p"))
        try:
            assert again.indices["a"].settings == ref.indices["a"].settings
        finally:
            again.close()
    finally:
        ref.close()
