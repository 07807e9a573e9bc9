"""Shared inputs for the parity tests of the PyTorch port: a seeded corpus
both packages index, and the host arrays pulled off a JAX-package segment
for ``elasticsearch_tpu_torch.index.convert.segment_from_arrays``."""
import numpy as np

MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "n": {"type": "long"},
    "price": {"type": "double"},
}}

# Zipf-weighted vocabulary: the head words reach df >= 128 in a few
# hundred docs (dense impact rows, the fused path); the tail stays CSR
WORDS = ("the quick brown fox jumps over lazy dog search engine index "
         "query shard segment score token running runs runner stemming "
         "apple banana cherry delta echo foxtrot golf hotel india juliet "
         "kilo lima mike november oscar papa quebec romeo sierra tango "
         "uniform victor whiskey xray yankee zulu alpha bravo charlie "
         "river mountain valley ocean forest desert island").split()


def corpus(n_docs: int, seed: int = 0):
    """[(doc id, source)] with a text body, a keyword, a long and a
    double; every 17th doc leaves the numerics out (exists / range)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    docs = []
    for i in range(n_docs):
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 16)), p=p))
        src = {"body": body, "tag": f"t{int(rng.integers(0, 7))}"}
        if i % 17:
            src["n"] = int(rng.integers(-50, 1000)) * 1_000_003
            src["price"] = float(np.round(rng.random() * 100, 2))
        docs.append((f"d{i}", src))
    return docs


def reference_arrays(seg) -> dict:
    """The host mirrors of a JAX-package segment in convert's layout."""
    fields = {}
    for name, inv in seg.inverted.items():
        lens = seg.field_lengths.get(name)
        fields[name] = {
            "terms": list(inv.terms), "vocab": dict(inv.vocab),
            "df": inv.df, "cf": inv.cf, "offsets": inv.offsets,
            "doc_ids_host": inv.doc_ids_host, "tfnorm_host": inv.tfnorm_host,
            # keyword fields keep no tf mirror: every tf there is 1
            "tf_host": (np.ones(inv.nnz, np.float32) if inv.tf_host is None
                        else inv.tf_host),
            "avg_len": inv.avg_len,
            "num_docs": inv.num_docs, "total_terms": inv.total_terms,
            "lengths": None if lens is None else np.asarray(lens),
            "positions": inv.positions, "pos_offsets": inv.pos_offsets,
        }
    keywords = {
        name: {"ords": np.asarray(c.ords_host), "exists": c.exists_host,
               "host_values": c.host_values}
        for name, c in seg.keywords.items()}
    numerics = {
        name: {"exact": c.exact, "exists": c.exists_host, "kind": c.kind}
        for name, c in seg.numerics.items()}
    vectors = {name: reference_vectors(c)
               for name, c in getattr(seg, "vectors", {}).items()}
    blocks = None
    if seg.has_nested:
        blocks = {"parent_of": np.asarray(seg.parent_id_host),
                  "nested_paths": dict(seg.nested_paths),
                  "nested_code": np.asarray(seg.nested_code_host),
                  "nested_ord": np.asarray(seg.nested_ord_host)}
    return {"num_docs": seg.num_docs, "max_docs": seg.max_docs,
            "ids": list(seg.ids), "sources": list(seg.sources),
            "live": np.array(seg.live_host), "fields": fields,
            "keywords": keywords, "numerics": numerics, "vectors": vectors,
            "blocks": blocks, "metas": list(seg.metas)}


def reference_vectors(vc) -> dict:
    """A JAX-package VectorColumn in convert's ``vectors`` layout, with
    the IVF quantizer and PQ tier it has built, if any."""
    out = {"vecs": np.asarray(vc.vecs_host), "exists": vc.exists_host,
           "dims": vc.dims, "similarity": vc.similarity}
    ivf = vc._ivf or None
    if ivf is not None:
        out["ivf"] = {"centroids": np.asarray(ivf.centroids),
                      "lists": np.asarray(ivf.lists),
                      "list_lens": np.asarray(ivf.list_lens), "C": ivf.C,
                      "Lmax": ivf.Lmax, "avg_len": ivf.avg_len,
                      "metric": ivf.metric}
    pq = vc._pq or vc._pq_parts
    if pq is not None:
        books = getattr(pq, "codebooks_host", None)
        codes = getattr(pq, "codes_host", None)
        out["pq"] = {
            "codebooks": np.asarray(pq.codebooks if books is None else books),
            "codes": np.asarray(pq.codes if codes is None else codes),
            "M": pq.M, "K": pq.K, "dsub": pq.dsub, "metric": pq.metric}
    return out


def clustered(n: int, dims: int, n_clusters: int, seed: int = 0,
              spread: float = 1.0):
    """[n, dims] f32 vectors around n_clusters Gaussian centres (the
    reference's IVF/PQ test recipe)."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((n_clusters, dims)).astype(np.float32) * 3
    assign = rng.integers(0, n_clusters, n)
    return (cents[assign] + spread * rng.standard_normal((n, dims))
            ).astype(np.float32)


AGG_MAPPING = {"properties": {
    "body": {"type": "text", "analyzer": "english"},
    "tag": {"type": "keyword"},
    "labels": {"type": "keyword"},
    "n": {"type": "long"},
    "qty": {"type": "integer"},
    "price": {"type": "double"},
    "ts": {"type": "date"},
    "addr": {"type": "ip"},
}}

LABELS = ("red", "green", "blue", "gold", "grey")
#: 2015-01-01T00:00:00Z in epoch millis
TS_BASE = 1_420_070_400_000


def agg_corpus(n_docs: int, seed: int = 0):
    """[(doc id, source)] for the aggregation tests: ``corpus``'s text and
    keyword, a multi-valued keyword (``labels``, 0-3 values), a long, an
    integer, a double, a date over 120 days and an ip, each numeric left
    out of some docs (missing, exists)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 1.1
    p /= p.sum()
    docs = []
    for i in range(n_docs):
        body = " ".join(rng.choice(WORDS, size=int(rng.integers(4, 16)), p=p))
        src = {"body": body, "tag": f"t{int(rng.integers(0, 7))}"}
        k = int(rng.integers(0, 4))
        if k:
            src["labels"] = [str(x) for x in rng.choice(LABELS, size=k,
                                                        replace=False)]
        if i % 11:
            src["n"] = int(rng.integers(-50, 1000)) * 1_000_003
        if i % 3:
            src["qty"] = int(rng.integers(0, 20))
        if i % 7:
            src["price"] = float(np.round(rng.random() * 100, 2))
        if i % 5:
            src["ts"] = TS_BASE + int(rng.integers(0, 120 * 86_400_000))
        src["addr"] = f"10.0.{int(rng.integers(0, 4))}." \
                      f"{int(rng.integers(0, 256))}"
        docs.append((f"d{i}", src))
    return docs
