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
        }
    keywords = {
        name: {"ords": np.asarray(c.ords_host), "exists": c.exists_host,
               "host_values": c.host_values}
        for name, c in seg.keywords.items()}
    numerics = {
        name: {"exact": c.exact, "exists": c.exists_host, "kind": c.kind}
        for name, c in seg.numerics.items()}
    return {"num_docs": seg.num_docs, "max_docs": seg.max_docs,
            "ids": list(seg.ids), "sources": list(seg.sources),
            "live": np.array(seg.live_host), "fields": fields,
            "keywords": keywords, "numerics": numerics}
