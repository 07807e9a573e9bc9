"""Write-side parity of the PyTorch port: analyzers, mappings, and the
frozen segment the same documents build in both packages."""
import numpy as np
import pytest
import torch

from elasticsearch_tpu.analysis.registry import AnalysisRegistry as RefAnalysis
from elasticsearch_tpu.index.doc_parser import DocumentParser as RefParser
from elasticsearch_tpu.index.mappings import Mappings as RefMappings
from elasticsearch_tpu.index.segment import SegmentBuilder as RefBuilder
from elasticsearch_tpu.index.segment import build_dense_impact as ref_dense
from elasticsearch_tpu_torch.analysis.registry import AnalysisRegistry
from elasticsearch_tpu_torch.index.convert import segment_from_arrays
from elasticsearch_tpu_torch.index.doc_parser import DocumentParser
from elasticsearch_tpu_torch.index.mappings import Mappings
from elasticsearch_tpu_torch.index.segment import SegmentBuilder, build_dense_impact
from elasticsearch_tpu_torch.resources.residency import Residency
from elasticsearch_tpu_torch.utils.errors import MapperParsingException

from _torch_parity import MAPPING, corpus, reference_arrays

TEXTS = [
    "The QUICK brown foxes jumped over the lazy dogs' backs!",
    "Running runners ran; a runner runs. Stemming isn't stemmed?",
    "e-mail me at jo.doe@example.com or visit https://ex.am/ple?q=1",
    "Ünïcödé façade naïve café — 42 apples, 3.14 pies",
    "",
]


@pytest.mark.parametrize("analyzer", ["standard", "english", "simple",
                                      "whitespace", "keyword", "stop"])
def test_analyzers_match_token_for_token(analyzer):
    ref = RefAnalysis({}).get(analyzer)
    port = AnalysisRegistry({}).get(analyzer)
    for text in TEXTS:
        assert port.analyze(text) == ref.analyze(text), text


@pytest.fixture(scope="module")
def both_segments():
    docs = corpus(600, seed=1)
    ref_an, ref_map = RefAnalysis({}), RefMappings(MAPPING)
    rb = RefBuilder(ref_map)
    rp = RefParser(ref_map, ref_an)
    an, mp = AnalysisRegistry({}), Mappings(MAPPING)
    pb = SegmentBuilder(mp, Residency(torch.device("cpu")))
    pp = DocumentParser(mp, an)
    for doc_id, src in docs:
        rb.add(rp.parse(doc_id, src))
        pb.add(pp.parse(doc_id, src))
    return rb.freeze(), pb.freeze()


def test_segment_shapes_and_ids(both_segments):
    ref, port = both_segments
    assert port.max_docs == ref.max_docs == 1024
    assert port.num_docs == ref.num_docs
    assert port.ids == list(ref.ids)
    assert np.array_equal(port.live_host, ref.live_host)
    assert set(port.inverted) == set(ref.inverted)


@pytest.mark.parametrize("field", ["body", "tag"])
def test_inverted_field_parity(both_segments, field):
    ref, port = both_segments
    r, p = ref.inverted[field], port.inverted[field]
    assert p.terms == list(r.terms) and p.vocab == dict(r.vocab)
    for name in ("df", "cf", "offsets", "doc_ids_host", "tf_host",
                 "tfnorm_host"):
        if getattr(r, name) is None:  # keyword fields keep no tf mirror
            continue
        np.testing.assert_array_equal(getattr(p, name), getattr(r, name),
                                      err_msg=name)
    for name in ("doc_ids", "tf", "tfnorm", "term_ids"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    assert (p.nnz, p.num_docs, p.total_terms) == (r.nnz, r.num_docs,
                                                  r.total_terms)
    assert p.avg_len == r.avg_len
    if field == "body":
        np.testing.assert_array_equal(port.field_lengths[field].numpy(),
                                      np.asarray(ref.field_lengths[field]))


def test_columns_parity(both_segments):
    ref, port = both_segments
    r, p = ref.keywords["tag"], port.keywords["tag"]
    np.testing.assert_array_equal(p.ords.numpy(), np.asarray(r.ords))
    np.testing.assert_array_equal(p.exists.numpy(), np.asarray(r.exists))
    assert p.host_values == r.host_values
    for f in ("n", "price"):
        r, p = ref.numerics[f], port.numerics[f]
        assert (p.kind, p.offset) == (r.kind, r.offset)
        np.testing.assert_array_equal(p.values.numpy(), np.asarray(r.values))
        np.testing.assert_array_equal(p.exists.numpy(), np.asarray(r.exists))
        np.testing.assert_array_equal(p.exact, r.exact)
        assert p.has_pair == (r.hi is not None)
        if p.has_pair:
            np.testing.assert_array_equal(p.hi.numpy(), np.asarray(r.hi))
            np.testing.assert_array_equal(p.lo.numpy(), np.asarray(r.lo))


@pytest.mark.parametrize("threshold", [None, 40, 128])
def test_dense_impact_bit_equal(both_segments, threshold):
    ref, port = both_segments
    r, p = ref.inverted["body"], port.inverted["body"]
    want = ref_dense(r.doc_ids_host, r.tfnorm_host, r.offsets, r.df,
                     ref.max_docs, df_threshold=threshold)
    got = build_dense_impact(p.doc_ids_host, p.tfnorm_host, p.offsets, p.df,
                             port.max_docs, df_threshold=threshold)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()


def test_lazy_dense_block_bit_equal(both_segments):
    ref, port = both_segments
    rrows, rimp = ref.inverted["body"].dense_block()
    prows, pimp = port.inverted["body"].dense_block()
    np.testing.assert_array_equal(prows, rrows)
    assert pimp.numpy().tobytes() == np.asarray(rimp).tobytes()


def test_convert_round_trip_of_reference_segment(both_segments):
    """segment_from_arrays on a reference segment's host mirrors gives the
    same device state the port's own freeze builds."""
    ref, port = both_segments
    conv = segment_from_arrays(reference_arrays(ref),
                               Residency(torch.device("cpu")))
    assert conv.max_docs == port.max_docs and conv.ids == port.ids
    for f, inv in port.inverted.items():
        for name in ("doc_ids", "tfnorm", "tf", "term_ids"):
            assert torch.equal(getattr(conv.inverted[f], name),
                               getattr(inv, name)), (f, name)
    assert torch.equal(conv.field_lengths["body"], port.field_lengths["body"])
    assert torch.equal(conv.numerics["n"].hi, port.numerics["n"].hi)
    assert torch.equal(conv.keywords["tag"].ords, port.keywords["tag"].ords)


@pytest.mark.parametrize("ftype", ["completion", "percolator"])
def test_unported_mapping_type_raises_typed(ftype):
    """The A9d mapping types are served: they parse as the reference's
    do (a completion's ``context`` config kept)."""
    spec = {"type": ftype}
    if ftype == "completion":
        spec["context"] = {"cc": {"type": "category"}}
    m, ref = Mappings({"properties": {"f": spec}}), \
        RefMappings({"properties": {"f": spec}})
    assert m.get("f").type == ref.get("f").type == ftype
    assert m.get("f").context == ref.get("f").context
    assert m.to_json() == ref.to_json()


@pytest.mark.parametrize("ftype", ["nested", "geo_point", "geo_shape"])
def test_join_and_geo_mapping_types_are_served(ftype):
    """The A9c mapping types parse: a nested path, a geo_point's lat/lon
    columns, a geo_shape's cell tokens."""
    m = Mappings({"properties": {"f": {"type": ftype}}})
    if ftype == "nested":
        assert m.nested_paths == ["f"]
    else:
        assert m.get("f").type == ftype


def _vector_segments(index_options=None):
    spec = {"type": "dense_vector", "dims": 4, "similarity": "l2_norm"}
    if index_options:
        spec["index_options"] = index_options
    mapping = {"properties": {"v": spec, "tag": {"type": "keyword"}}}
    rng = np.random.default_rng(2)
    docs = []
    for i in range(300):
        src = {"tag": f"t{i % 3}"}
        if i % 7:
            src["v"] = [float(a) for a in rng.standard_normal(4)]
        docs.append((f"d{i}", src))
    ref_map, mp = RefMappings(mapping), Mappings(mapping)
    rb, rp = RefBuilder(ref_map), RefParser(ref_map, RefAnalysis({}))
    pb = SegmentBuilder(mp, Residency(torch.device("cpu")))
    pp = DocumentParser(mp, AnalysisRegistry({}))
    for doc_id, src in docs:
        rb.add(rp.parse(doc_id, src))
        pb.add(pp.parse(doc_id, src))
    return rb.freeze(), pb.freeze(), (rp, pp)


def test_vector_column_parity():
    ref, port, _ = _vector_segments()
    r, p = ref.vectors["v"], port.vectors["v"]
    np.testing.assert_array_equal(p.vecs.numpy(), np.asarray(r.vecs_host))
    np.testing.assert_array_equal(p.exists.numpy(), np.asarray(r.exists_host))
    assert (p.dims, p.similarity) == (r.dims, r.similarity) == (4, "l2_norm")
    assert p._ivf is None and p._pq is None  # no index_options: no ANN build


def test_vector_freeze_builds_ann_tiers():
    ref, port, _ = _vector_segments({"type": "ivf_pq"})
    vc = port.vectors["v"]
    ivf, pq = vc._ivf, vc._pq
    assert ivf and pq, "freeze builds IVF and PQ for ivf_pq"
    assert (ivf.C, ivf.Lmax) == (ref.vectors["v"]._ivf.C,
                                 ref.vectors["v"]._ivf.Lmax)
    assert (pq.M, pq.K, pq.dsub) == (ref.vectors["v"]._pq.M,
                                     ref.vectors["v"]._pq.K,
                                     ref.vectors["v"]._pq.dsub)
    codes = pq.codes_dev()
    assert codes.dtype == torch.uint8 and codes.shape == (512, 2)
    # the always-resident quantizer joins the segments-breaker charge
    base = port.max_docs + sum(inv.nnz_pad * 16
                               for inv in port.inverted.values())
    assert port.memory_bytes() == base + ivf.nbytes()


def test_dense_vector_dims_mismatch_raises_like_reference():
    _ref, _port, (rp, pp) = _vector_segments()
    bad = {"v": [1.0, 2.0, 3.0]}
    with pytest.raises(Exception, match="3 dims") as ref_exc:
        rp.parse("x", bad)
    with pytest.raises(MapperParsingException, match="3 dims") as port_exc:
        pp.parse("x", bad)
    assert type(ref_exc.value).__name__ == type(port_exc.value).__name__
    assert str(port_exc.value) == str(ref_exc.value)
