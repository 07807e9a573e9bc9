"""The suggesters of the port (``search/suggest.py``) against the
reference on the CPU.

- ``batched_edit_distance`` against the reference's on random strings
  with ASCII, Latin-1, CJK and astral-plane codepoints: exact.
- ``segment_bigrams`` against the reference's ``_segment_bigrams`` on a
  corpus with a synonym filter (two tokens at one position) and deleted
  docs: the same counts, exactly.
- Every option of the term, phrase and completion suggesters on a
  seeded two-shard index of several segments, through ``IndexService``
  and embedded in ``_search`` on the mesh and on the host loop, in the
  request cache and in ``_msearch``: the responses equal the
  reference's exactly (texts, rounded scores, freqs, payloads).
- ``execute_suggest_multi``, ``merge_suggest``, the multi-index
  ``Node.search`` (the reference drops ``suggest`` there: ROADMAP C10),
  and the typed errors of malformed bodies.
"""
import copy
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.search import suggest as RS
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.search import suggest as PS

from _torch_parity import WORDS, corpus

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "plain": {"type": "text"},
    "tag": {"type": "keyword"},
    "sug": {"type": "completion", "context": {
        "cc": {"type": "category", "default": "none"},
        "color": {"type": "category", "path": "tag"},
        "loc": {"type": "geo", "precision": "200km"},
        "cell": {"type": "geo", "precision": 4}}}}}
SYN_SETTINGS = {"analysis": {
    "filter": {"syn": {"type": "synonym",
                       "synonyms": ["quick, fast", "fox, vixen"]}},
    "analyzer": {"syn": {"tokenizer": "standard",
                         "filter": ["lowercase", "syn"]}}}}
OUTPUTS = ["Ünïcode Ünïcode", "北京 city", "emoji \U0001F600 go",
           "\U00010400 deseret"]


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def suggest_docs(n=240, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for j, (doc_id, src) in enumerate(corpus(n, seed)):
        words = src["body"].split()
        entry = {"input": words[:2] + ([OUTPUTS[j % 4]] if j % 5 == 0
                                       else []),
                 "weight": int(rng.integers(0, 9)),
                 "context": {"loc": {"lat": float(rng.uniform(-60, 60)),
                                     "lon": float(rng.uniform(-120, 120))},
                             "cell": [float(rng.uniform(-20, 20)),
                                      float(rng.uniform(-20, 20))]}}
        if j % 3:
            entry["context"]["cc"] = [f"c{j % 4}", f"c{(j + 1) % 4}"]
        if j % 7 == 0:
            entry["output"] = f"Out {words[0]}"
        if j % 11 == 0:
            entry["payload"] = {"id": j}
        sug = entry if j % 6 else [entry, words[-1]]
        out.append((doc_id, {"body": src["body"], "plain": src["body"],
                             "tag": src["tag"], "sug": sug}))
    return out


@pytest.fixture(scope="module")
def nodes():
    """Both packages over the same writes: two shards, a refresh every
    60 docs (several segments), deletes after the last refresh."""
    from elasticsearch_tpu.parallel import aot

    docs = suggest_docs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aot, "_ENABLED", False)
        ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
        for node in (ref, port):
            node.create_index("s", {"settings": {"number_of_shards": 2},
                                    "mappings": MAPPING})
            node.create_index("t", {"settings": {"number_of_shards": 1},
                                    "mappings": MAPPING})
            svc = node.indices["s"]
            for i, (doc_id, src) in enumerate(docs):
                svc.index_doc(doc_id, copy.deepcopy(src))
                if i % 60 == 59:
                    svc.refresh()
            for i in range(0, len(docs), 13):
                svc.delete_doc(f"d{i}")
            svc.refresh()
            other = node.indices["t"]
            for doc_id, src in suggest_docs(60, seed=9):
                other.index_doc(doc_id, copy.deepcopy(src))
            other.refresh()
    yield ref, port
    ref.close()
    port.close()


def _same_json(got, want):
    assert json.dumps(got, sort_keys=True, ensure_ascii=False) == \
        json.dumps(want, sort_keys=True, ensure_ascii=False)


def check(nodes, body, index="s"):
    ref, port = nodes
    want = ref.indices[index].suggest(copy.deepcopy(body))
    got = port.indices[index].suggest(copy.deepcopy(body))
    _same_json(got, want)
    return got


# -- batched edit distance -------------------------------------------------------

ALPHABETS = {
    "ascii": "abcde",
    "latin1": "aeéèüß",
    "cjk": "北京上海东西",
    "astral": "a\U0001F600\U0001F601\U00010400z",
}


@pytest.mark.parametrize("alpha", sorted(ALPHABETS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_edit_distance_equals_the_reference(alpha, seed):
    rng = np.random.default_rng(seed)
    chars = list(ALPHABETS[alpha])

    def word(lo, hi):
        return "".join(rng.choice(chars, size=int(rng.integers(lo, hi))))

    terms = [word(0, 9) for _ in range(300)]
    rmat, rlens = RS.pack_terms(terms)
    pmat, plens = PS.pack_terms(terms)
    np.testing.assert_array_equal(pmat, rmat.astype(np.int32))
    np.testing.assert_array_equal(plens, rlens)
    for _ in range(8):
        q = word(0, 8)
        want = RS.batched_edit_distance(q, rmat, rlens)
        got = PS.batched_edit_distance(q, torch.from_numpy(pmat),
                                       torch.from_numpy(plens))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_edit_distance_of_an_empty_vocabulary():
    mat, lens = PS.pack_terms([])
    got = PS.batched_edit_distance("abc", torch.from_numpy(mat),
                                   torch.from_numpy(lens))
    assert got.shape == (0,)


# -- bigrams ------------------------------------------------------------------------

def _port_bigrams(seg, field):
    keys, counts, V = PS.segment_bigrams(seg, field)
    inv = seg.inverted[field]
    return {(inv.terms[k // V], inv.terms[k % V]): c
            for k, c in zip(keys.tolist(), counts.tolist())}


@pytest.mark.parametrize("deletes", [False, True])
def test_segment_bigrams_equal_the_reference(deletes):
    """Stacked positions (a synonym at the same position) and deleted
    docs: the same counts as the reference's per-doc walk."""
    mapping = {"properties": {"body": {"type": "text", "analyzer": "syn"}}}
    ref, port = RefNode(name="ref"), Node(name="port", device="cpu")
    rng = np.random.default_rng(5)
    words = WORDS[:20]
    docs = [(f"b{i}", {"body": " ".join(rng.choice(
        words, size=int(rng.integers(1, 14))))}) for i in range(150)]
    for node in (ref, port):
        node.create_index("g", {"settings": SYN_SETTINGS,
                                "mappings": mapping})
        svc = node.indices["g"]
        for doc_id, src in docs:
            svc.index_doc(doc_id, src)
        svc.refresh()
        if deletes:
            for i in range(0, 150, 4):
                svc.delete_doc(f"b{i}")
    rseg = ref.indices["g"].shards[0].segments[0]
    pseg = port.indices["g"].shards[0].segments[0]
    want = RS._segment_bigrams(rseg, "body")
    got = _port_bigrams(pseg, "body")
    assert got == want
    stacked = [t for t, _ in port.indices["g"].analysis.get("syn").analyze(
        "quick fox")]
    assert len(stacked) == 4  # two synonyms at each position
    # cached on the segment and charged to fielddata
    fd = port.breakers.breaker("fielddata").used
    assert PS.segment_bigrams(pseg, "body") is pseg._bigrams["body"]
    assert pseg.fielddata_bytes() >= sum(
        t.numel() * 8 for t in pseg._bigrams["body"][:2])
    port.close()
    assert port.breakers.breaker("fielddata").used == 0 < fd
    ref.close()


def test_bigrams_of_a_field_without_positions(nodes):
    _ref, port = nodes
    seg = port.indices["s"].shards[0].segments[0]
    assert PS.segment_bigrams(seg, "tag") is None
    assert PS.segment_bigrams(seg, "absent") is None


# -- term suggester -----------------------------------------------------------------

TERM_OPTS = {
    "default": {},
    "missing_sort_frequency": {"sort": "frequency"},
    "popular": {"suggest_mode": "popular"},
    "always": {"suggest_mode": "always", "size": 3},
    "always_frequency": {"suggest_mode": "always", "sort": "frequency"},
    "max_edits_1": {"suggest_mode": "always", "max_edits": 1},
    "prefix_0": {"prefix_length": 0, "suggest_mode": "always"},
    "prefix_2": {"prefix_len": 2},
    "min_word_length": {"min_word_length": 6},
    "min_doc_freq_ratio": {"min_doc_freq": 0.05, "suggest_mode": "always"},
    "min_doc_freq_count": {"min_doc_freq": 20},
    "max_term_freq": {"max_term_freq": 0.5, "suggest_mode": "popular"},
    "max_term_freq_count": {"max_term_freq": 30, "suggest_mode": "popular"},
    "analyzer": {"analyzer": "standard", "field": "plain"},
}
TERM_TEXTS = ["quikc brwn foxx jumsp", "the lazzy dgo runing",
              "serch engnie indx", "Quick BROWN fox", "xyzzy ünïcode"]


@pytest.mark.parametrize("opt", sorted(TERM_OPTS))
def test_term_suggester(nodes, opt):
    for text in TERM_TEXTS:
        spec = dict({"field": "body"}, **TERM_OPTS[opt])
        check(nodes, {"t": {"text": text, "term": spec}})


# -- phrase suggester ---------------------------------------------------------------

PHRASE_OPTS = {
    "default": {},
    "highlight": {"highlight": {"pre_tag": "<b>", "post_tag": "</b>"}},
    "confidence_0": {"confidence": 0},
    "confidence_2": {"confidence": 2.0},
    "max_errors_2": {"max_errors": 2},
    "max_errors_ratio": {"max_errors": 0.5},
    "rwel": {"real_word_error_likelihood": 0.5},
    "size_1": {"size": 1, "confidence": 0},
    "direct_generator": {"direct_generator": [
        {"field": "body", "suggest_mode": "always", "max_edits": 1,
         "size": 3}], "confidence": 0.5},
    "analyzer_plain": {"field": "plain", "analyzer": "standard"},
}
PHRASE_TEXTS = ["quikc brown fox", "the quick brwn fox jumps",
                "serch engine", "lazy dgo", "shard segmnt score token",
                "river mountan"]


@pytest.mark.parametrize("opt", sorted(PHRASE_OPTS))
def test_phrase_suggester(nodes, opt):
    for text in PHRASE_TEXTS:
        spec = dict({"field": "body"}, **PHRASE_OPTS[opt])
        check(nodes, {"p": {"text": text, "phrase": spec}})


def test_phrase_of_no_tokens(nodes):
    got = check(nodes, {"p": {"text": "!!", "phrase": {"field": "body"}}})
    assert got["p"][0]["options"] == []


def test_phrase_lm_reads_bigrams_per_pair(nodes):
    """The LM's bigram counts equal the reference's merged dict, pair by
    pair, summed over the shards' segments."""
    ref, port = nodes
    rlm = RS.PhraseLM(ref.indices["s"].shards, "body")
    plm = PS.PhraseLM(port.indices["s"].shards, "body")
    pairs = [(a, b) for a in WORDS[:12] for b in WORDS[:12]] + \
        [("zzz", "fox"), ("fox", "zzz")]
    plm.prefetch(pairs)
    for a, b in pairs:
        assert plm.bigram(a, b) == rlm.bigrams.get((a, b), 0), (a, b)
        assert plm.logp(a, b) == rlm.logp(a, b)
    assert sum(plm.bigram(a, b) for a, b in pairs) > 0


# -- completion suggester -----------------------------------------------------------

COMPLETION = {
    "prefix": {"text": "qu"},
    "prefix_upper": {"text": "SE", "size": 3},
    "empty_prefix": {"text": "", "size": 10},
    "unicode": {"text": "ün", "size": 10},
    "astral": {"text": "\U00010400", "size": 10},
    "cjk": {"text": "北", "size": 10},
    "no_match": {"text": "qqq"},
    "fuzzy_true": {"text": "qvick", "fuzzy": True},
    "fuzzy_empty": {"text": "brwn", "fuzzy": {}},
    "fuzzy_2": {"text": "qikc", "fuzzy": {"fuzziness": 2}, "size": 8},
    "category": {"text": "b", "size": 10, "context": {"cc": "c1"}},
    "category_list": {"text": "", "size": 20,
                      "context": {"cc": ["c0", "c3"]}},
    "category_default": {"text": "", "size": 20, "context": {"cc": "none"}},
    "category_path": {"text": "", "size": 20, "context": {"color": "t2"}},
    "geo_distance_precision": {"text": "", "size": 20,
                               "context": {"loc": {"lat": 10.0,
                                                   "lon": 20.0}}},
    "geo_int_precision": {"text": "", "size": 20,
                          "context": {"cell": [1.0, 2.0]}},
    "both_contexts": {"text": "", "size": 20,
                      "context": {"cc": "c2", "loc": [30.0, -15.0]}},
}


@pytest.mark.parametrize("case", sorted(COMPLETION))
def test_completion_suggester(nodes, case):
    spec = dict(COMPLETION[case])
    text = spec.pop("text")
    got = check(nodes, {"c": {"text": text,
                              "completion": dict(field="sug", **spec)}})
    if case in ("prefix", "fuzzy_true", "category_list"):
        assert got["c"][0]["options"], got


def test_completion_geo_cells_match_the_reference():
    rng = np.random.default_rng(4)
    for _ in range(200):
        lat, lon = float(rng.uniform(-90, 90)), float(rng.uniform(-180, 180))
        ln = int(rng.integers(1, 13))
        assert PS._geohash(lat, lon, ln) == RS._geohash(lat, lon, ln)
    for p in (1, 7, 12, 40, "5000km", "200km", "1km", "10m", "1cm", 0.5):
        assert PS._geo_len(p) == RS._geo_len(p)


def test_completion_skips_deleted_docs(nodes):
    ref, port = nodes
    for node in (ref, port):
        node.indices["t"].index_doc("gone", {"sug": {"input": "zebra",
                                                     "weight": 99}})
        node.indices["t"].refresh()
    body = {"c": {"text": "zeb", "completion": {"field": "sug"}}}
    assert check(nodes, body, "t")["c"][0]["options"][0]["text"] == "zebra"
    for node in (ref, port):
        node.indices["t"].delete_doc("gone")
    assert check(nodes, body, "t")["c"][0]["options"] == []


# -- the suggest request key --------------------------------------------------------

MIXED = {"text": "quikc brwn",
         "t": {"term": {"field": "body", "suggest_mode": "always"}},
         "p": {"phrase": {"field": "body"}},
         "c": {"text": "br", "completion": {"field": "sug", "size": 4}}}


def _host(port, index, body):
    os.environ["ESTPU_DISABLE_MESH"] = "1"
    try:
        return port.search(index, copy.deepcopy(body))
    finally:
        del os.environ["ESTPU_DISABLE_MESH"]


def _strip(resp):
    return json.dumps({k: v for k, v in resp.items() if k != "took"},
                      sort_keys=True)


@pytest.mark.parametrize("with_query", [False, True])
def test_suggest_embedded_in_search_on_both_routes(nodes, with_query):
    ref, port = nodes
    body = {"suggest": MIXED, "size": 3}
    if with_query:
        body["query"] = {"match": {"body": "fox"}}
    want = ref.search("s", copy.deepcopy(body))
    kernels.reset()
    mesh = port.search("s", copy.deepcopy(body))
    assert kernels.snapshot().get("mesh_search") == 1, kernels.snapshot()
    host = _host(port, "s", body)
    assert _strip(mesh) == _strip(host)
    _same_json(mesh["suggest"], want["suggest"])
    assert mesh["hits"]["total"] == want["hits"]["total"]
    assert [h["_id"] for h in mesh["hits"]["hits"]] == \
        [h["_id"] for h in want["hits"]["hits"]]


def test_suggest_in_the_request_cache(nodes):
    ref, port = nodes
    body = {"size": 0, "suggest": MIXED, "_query_cache": True}
    svc = port.indices["s"]
    before = dict(svc.query_cache_stats)
    first = port.search("s", copy.deepcopy(body))
    again = port.search("s", copy.deepcopy(body))
    after = svc.query_cache_stats
    assert after["misses"] == before["misses"] + 1
    assert after["hits"] == before["hits"] + 1
    assert _strip(first) == _strip(again)
    want = ref.search("s", copy.deepcopy(body))
    _same_json(again["suggest"], want["suggest"])
    other = port.search("s", dict(copy.deepcopy(body), suggest={
        "c": {"text": "qu", "completion": {"field": "sug"}}}))
    assert other["suggest"] != first["suggest"]


def test_suggest_in_msearch(nodes):
    """A body with ``suggest`` leaves the batch tiers (their keys are
    ``query``, ``size``, ``from`` and ``_source``) and answers through the
    sequential search, on both packages."""
    ref, port = nodes
    pairs = [({"index": "s"}, {"query": {"match": {"body": "fox"}},
                               "suggest": MIXED}),
             ({"index": "s"}, {"query": {"match": {"body": "dog"}}}),
             ({"index": "s"}, {"suggest": {"bad": "x"}})]
    want = ref.msearch(copy.deepcopy(pairs))["responses"]
    got = port.msearch(copy.deepcopy(pairs))["responses"]
    _same_json(got[0]["suggest"], want[0]["suggest"])
    assert "suggest" not in got[1] and "suggest" not in want[1]
    assert got[1]["hits"]["total"] == want[1]["hits"]["total"]
    assert "error" in got[2] and "error" in want[2]


def test_multi_index_search_merges_suggestions(nodes):
    """ROADMAP C10: the reference's multi-index route drops ``suggest``;
    the port merges the indices' suggestions as ES 2.0 does, equal to
    the reference's own ``execute_suggest_multi``."""
    ref, port = nodes
    body = {"suggest": MIXED, "size": 2}
    want = ref.search("s,t", copy.deepcopy(body))
    got = port.search("s,t", copy.deepcopy(body))
    assert "suggest" not in want
    merged = RS.execute_suggest_multi(
        [(ref.indices[n].shards, ref.indices[n].analysis,
          ref.indices[n].mappings) for n in ("s", "t")], copy.deepcopy(MIXED))
    _same_json(got["suggest"], merged)
    assert got["hits"]["total"] == want["hits"]["total"]
    single = port.indices["s"].suggest(copy.deepcopy(MIXED))
    assert got["suggest"] != single


def test_execute_suggest_multi_and_merge_suggest(nodes):
    ref, port = nodes
    body = {"t": {"text": "quikc brwn", "term": {
        "field": "body", "suggest_mode": "always", "sort": "frequency"}},
        "c": {"text": "b", "completion": {"field": "sug", "size": 6}}}
    groups = lambda node: [(node.indices[n].shards, node.indices[n].analysis,
                            node.indices[n].mappings) for n in ("s", "t")]
    _same_json(PS.execute_suggest_multi(groups(port), copy.deepcopy(body)),
               RS.execute_suggest_multi(groups(ref), copy.deepcopy(body)))
    # per-shard-set payloads of one index: freqs sum, scores take the max
    payloads = [port.indices["s"].suggest(copy.deepcopy(body), shard_ids=[i])
                for i in (0, 1)]
    rpay = [ref.indices["s"].suggest(copy.deepcopy(body), shard_ids=[i])
            for i in (0, 1)]
    _same_json(payloads, rpay)
    _same_json(PS.merge_suggest(body, copy.deepcopy(payloads)),
               RS.merge_suggest(body, copy.deepcopy(rpay)))


BAD = {
    "not_a_dict": {"x": "text"},
    "no_text": {"x": {"term": {"field": "body"}}},
    "no_kind": {"x": {"text": "a", "fuzzy": {}}},
    "term_no_field": {"x": {"text": "a", "term": {}}},
    "phrase_no_field": {"x": {"text": "a", "phrase": {"size": 1}}},
    "completion_no_field": {"x": {"text": "a", "completion": {"size": 1}}},
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_suggest_bodies(nodes, case):
    ref, port = nodes
    msgs = []
    for node in (ref, port):
        with pytest.raises(Exception) as e:
            node.search("s", {"suggest": copy.deepcopy(BAD[case])})
        assert type(e.value).__name__ == "ElasticsearchTpuException"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and msgs[1].startswith("suggester [")
    if case in ("not_a_dict", "no_text", "no_kind"):
        with pytest.raises(Exception, match="suggester \\[x\\]"):
            PS.validate_suggest_body(BAD[case])


def test_field_vocab_cache_is_an_lru_of_16(nodes, monkeypatch):
    _ref, port = nodes
    monkeypatch.setattr(PS, "_VOCAB_CACHE", type(PS._VOCAB_CACHE)())
    shards = port.indices["s"].shards
    first = PS.field_vocab(shards, "body")
    assert PS.field_vocab(shards, "body") is first
    for i in range(16):
        PS.field_vocab(shards, f"f{i}")
    assert len(PS._VOCAB_CACHE) == 16
    assert PS.field_vocab(shards, "body") is not first
    fv = PS.field_vocab(shards, "body")
    assert fv.num_docs == sum(seg.inverted["body"].num_docs
                              for sh in shards for seg in sh.segments)


def _fresh_port(n=60):
    port = Node(name="port", device="cpu")
    port.create_index("f", {"settings": {"number_of_shards": 1},
                            "mappings": MAPPING})
    for doc_id, src in suggest_docs(n, seed=5):
        port.indices["f"].index_doc(doc_id, src)
    port.indices["f"].refresh()
    return port, port.indices["f"].shards[0].segments[0]


#: each suggester device cache: (the call that builds it on a segment,
#: the module function its build goes through, the segment's dict)
CACHES = {
    "bigrams": (lambda seg: PS.segment_bigrams(seg, "body"),
                "positional_device", "_bigrams"),
    "vocab": (lambda seg: PS.segment_vocab(seg, "body"),
              "pack_terms", "_vocab_packed"),
    "cuts": (lambda seg: PS._cut_packed(
        seg, "sug", PS._segment_completions(seg, "sug")[0], 3),
        "pack_terms", "_completion_cuts"),
}


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_a_cold_cache_is_built_and_charged_once(cache, monkeypatch):
    """Two requests reaching a cold segment together (the threaded
    serving frontend): one table is built and charged, the fielddata
    breaker holds what the segment counts, and the close returns it."""
    build, slow_fn, attr = CACHES[cache]
    port, seg = _fresh_port()
    fd = port.breakers.breaker("fielddata")
    real, calls = getattr(PS, slow_fn), []

    def slow(*a, **k):
        calls.append(1)
        time.sleep(0.2)  # both threads reach the build before either ends
        return real(*a, **k)

    monkeypatch.setattr(PS, slow_fn, slow)
    gate, got = threading.Barrier(2), []

    def run():
        gate.wait()
        got.append(build(seg))

    threads = [threading.Thread(target=run) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1 and got[0] is got[1] is not None
    assert len(getattr(seg, attr)) == 1
    assert fd.used == seg.fielddata_bytes() > 0
    port.close()
    assert fd.used == 0


def test_suggester_caches_are_charged_and_released():
    """The term suggester's packed vocabularies, the phrase LM's bigram
    tables and fuzzy completion's cut inputs live on the segments,
    charged to fielddata and counted by ``fielddata_bytes``: a merge
    releases the retired segments' and the close the rest. The shared
    ``FieldVocab`` LRU keeps host dicts only."""
    port = Node(name="port", device="cpu")
    port.create_index("f", {"settings": {"number_of_shards": 2},
                            "mappings": MAPPING})
    svc = port.indices["f"]
    for i, (doc_id, src) in enumerate(suggest_docs(120, seed=6)):
        svc.index_doc(doc_id, src)
        if i % 40 == 39:
            svc.refresh()
    svc.refresh()
    fd = port.breakers.breaker("fielddata")

    def held():
        return sum(seg.fielddata_bytes() for sh in svc.shards
                   for seg in sh.segments)

    body = {"t": {"text": "quikc brwn", "term": {"field": "body"}},
            "p": {"text": "quikc brown", "phrase": {"field": "body"}},
            "c": {"text": "qiu", "completion": {"field": "sug",
                                                "fuzzy": True}}}
    svc.suggest(copy.deepcopy(body))
    segs = [seg for sh in svc.shards for seg in sh.segments]
    assert len(segs) > 2
    assert all(seg._vocab_packed and seg._bigrams and seg._completion_cuts
               for seg in segs)
    assert fd.used == held() > 0
    fv = PS.field_vocab(svc.shards, "body")
    assert not any(isinstance(v, torch.Tensor) for v in vars(fv).values())
    svc.force_merge(1)
    assert fd.used == held()
    svc.suggest(copy.deepcopy(body))
    assert fd.used == held() > 0
    port.close()
    assert fd.used == 0


def test_bigrams_through_the_key_by_key_sort(monkeypatch):
    """Past ``_PACK_LIMIT`` the (doc, position, term) order comes from one
    stable sort a key: the same counts as the packed sort's."""
    mapping = {"properties": {"body": {"type": "text", "analyzer": "syn"}}}
    port = Node(name="port", device="cpu")
    port.create_index("g", {"settings": SYN_SETTINGS, "mappings": mapping})
    rng = np.random.default_rng(8)
    for i in range(80):
        port.indices["g"].index_doc(str(i), {"body": " ".join(rng.choice(
            WORDS[:16], size=int(rng.integers(1, 12))))})
    port.indices["g"].refresh()
    seg = port.indices["g"].shards[0].segments[0]
    packed = _port_bigrams(seg, "body")
    seg._bigrams.clear()
    monkeypatch.setattr(PS, "_PACK_LIMIT", 0)
    assert _port_bigrams(seg, "body") == packed and packed
    port.close()


@pytest.mark.parametrize("value", [
    "plain input", {"input": ["a b", "c"], "output": "A", "weight": 3},
    ["one", "two"], [{"input": "x", "context": {"cc": "c1"}}, "y"],
    {"input": "solo", "payload": {"k": [1, 2]}}])
def test_doc_parser_keeps_completion_entries(value):
    """A completion value as a string, an object, a list of strings or a
    list of objects is stored as the reference's parser stores it."""
    from elasticsearch_tpu.analysis.registry import \
        AnalysisRegistry as RefAnalysis
    from elasticsearch_tpu.index.doc_parser import \
        DocumentParser as RefParser
    from elasticsearch_tpu.index.mappings import Mappings as RefMappings
    from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
    from elasticsearch_tpu_torch.index.doc_parser import DocumentParser
    from elasticsearch_tpu_torch.index.mappings import Mappings

    src = {"body": "x", "sug": copy.deepcopy(value)}
    want = RefParser(RefMappings(MAPPING), RefAnalysis({})).parse("1", src)
    got = DocumentParser(Mappings(MAPPING), AnalysisRegistry({})).parse(
        "1", copy.deepcopy(src))
    assert got.stored == want.stored and "sug" in got.stored
