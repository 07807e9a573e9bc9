"""The port's positional layer (``elasticsearch_tpu_torch/ops/positional.py``)
against the reference's (``elasticsearch_tpu/ops/positional.py``).

Both read the same seeded positional CSR (numpy: term-major postings,
each posting's positions in order), the reference through its own input
builders (``doc_runs``/``run_starts``/``run_lens`` and bounded binary
searches), the port through its packed (doc, position) keys. Bars:
whole-number frequencies (exact phrase, span_not counts) equal; the
fractional sums of the sloppy and span-near modes within rtol 1e-6 (the
reference adds a doc's weights in f32 in anchor order, the port in
fixed point, exactly, then rounds once); BM25 phrase scores within rtol
1e-6. ``segment_from_arrays`` carries a reference segment's CSR bit for
bit.
"""
import copy
import threading

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.index.segment import make_inverted
from elasticsearch_tpu_torch.ops import positional as P
from elasticsearch_tpu_torch.resources.residency import Residency

from _torch_parity import MAPPING, corpus, reference_arrays


def _jax():
    import jax.numpy as jnp

    from elasticsearch_tpu.ops import positional as R

    return jnp, R


# -- a seeded CSR, as both packages' segment builders lay it out -------------

def make_csr(seed, n_docs=300, vocab=8, max_len=40, p_head=0.35):
    """Token lists over ``vocab`` words (word 0 takes ``p_head`` of the
    tokens, so a doc holds it up to tens of times) and the CSR: terms in
    first-seen order, postings by doc, positions ascending."""
    rng = np.random.default_rng(seed)
    p = np.full(vocab, (1.0 - p_head) / (vocab - 1))
    p[0] = p_head
    docs = [[f"w{int(t)}" for t in rng.choice(vocab, size=int(
        rng.integers(1, max_len)), p=p)] for _ in range(n_docs)]
    docs[7] = ["w0"] * 64  # one doc of maximal anchor multiplicity
    terms, vocab_map, post = [], {}, []
    for d, toks in enumerate(docs):
        per = {}
        for pos, t in enumerate(toks):
            if t not in vocab_map:
                vocab_map[t] = len(terms)
                terms.append(t)
                post.append([])
            per.setdefault(vocab_map[t], []).append(pos)
        for tid, poss in per.items():
            post[tid].append((d, poss))
    offsets, doc_ids, pos_offsets, positions = [0], [], [0], []
    for runs in post:
        for d, poss in runs:
            doc_ids.append(d)
            positions += poss
            pos_offsets.append(len(positions))
        offsets.append(len(doc_ids))
    return {"docs": docs, "terms": terms, "vocab": vocab_map,
            "offsets": np.asarray(offsets, np.int64),
            "doc_ids": np.asarray(doc_ids, np.int32),
            "pos_offsets": np.asarray(pos_offsets, np.int64),
            "positions": np.asarray(positions, np.int32),
            "D": 1 << (n_docs - 1).bit_length()}


class RefInv:
    """What the reference's positional builders read of an InvertedField."""

    def __init__(self, csr):
        self.vocab = csr["vocab"]
        self.offsets = csr["offsets"]
        self.doc_ids_host = csr["doc_ids"]
        self.positions = csr["positions"]
        self.pos_offsets = csr["pos_offsets"]
        self._pos_dev = None

    def term_slice(self, term):
        tid = self.vocab.get(term, -1)
        if tid < 0:
            return 0, 0
        s = int(self.offsets[tid])
        return s, int(self.offsets[tid + 1]) - s


def port_inv(csr, residency=None):
    V = len(csr["terms"])
    df = np.diff(csr["offsets"]).astype(np.int32)
    nnz = int(csr["doc_ids"].shape[0])
    return make_inverted(
        "t", vocab=dict(csr["vocab"]), terms=list(csr["terms"]), df=df,
        cf=df.astype(np.int64), offsets=csr["offsets"],
        doc_ids_host=csr["doc_ids"], tf_host=np.ones(nnz, np.float32),
        tfnorm_host=np.ones(nnz, np.float32), num_docs=len(csr["docs"]),
        total_terms=int(csr["positions"].shape[0]), avg_len=10.0,
        max_docs=csr["D"], residency=residency or Residency("cpu"),
        pos_offsets=csr["pos_offsets"], positions=csr["positions"])


def _phrase(words):
    return [(w, i) for i, w in enumerate(words)]


# two to four terms, repeated terms, a head-term anchor of high
# multiplicity (each distinct shape is one compile of the reference)
PHRASES = [["w0", "w1"], ["w0", "w0"], ["w2", "w0", "w2"],
           ["w3", "w0", "w0", "w5"]]
MODES = ["phrase", "ordered", "unordered"]


@pytest.fixture(scope="module")
def csr():
    return make_csr(11)


def ref_freq(csr, words, slop, mode):
    import jax

    jnp, R = _jax()
    inputs = R.build_phrase_inputs(RefInv(csr), _phrase(words), csr["D"])
    # op by op: one XLA compile per (shape, slop, mode) costs more here
    with jax.disable_jit():
        return np.asarray(R.phrase_freq_program(
            *inputs, slop=slop, D=csr["D"], ordered=mode == "ordered",
            unordered=mode == "unordered"))


def port_freq(inv, csr, words, slop, mode):
    inputs = P.build_phrase_inputs(inv, _phrase(words), csr["D"])
    return P.phrase_freq_program(
        *inputs, slop=slop, D=csr["D"], ordered=mode == "ordered",
        unordered=mode == "unordered").numpy()


def hold_freq(got, want, whole: bool, what):
    if whole:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                   err_msg=what)
    assert ((got > 0) == (want > 0)).all(), what


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("slop", [0, 1, 2, 3])
def test_phrase_freq_matches_reference(csr, mode, slop):
    inv = port_inv(csr)
    n_hit = 0
    for words in PHRASES:
        want = ref_freq(csr, words, slop, mode)
        got = port_freq(inv, csr, words, slop, mode)
        hold_freq(got, want, mode == "phrase" and slop == 0,
                  f"{mode} slop {slop} {words}")
        n_hit += int((want > 0).sum())
    assert n_hit > 0


def test_exact_phrase_frequencies_count_occurrences(csr):
    """A float64 oracle independent of both packages: the exact-phrase
    frequency is the number of the phrase's occurrences in the doc."""
    inv = port_inv(csr)
    for words in PHRASES:
        got = port_freq(inv, csr, words, 0, "phrase")
        want = np.zeros(csr["D"], np.float64)
        for d, toks in enumerate(csr["docs"]):
            want[d] = sum(toks[i: i + len(words)] == words
                          for i in range(len(toks) - len(words) + 1))
        np.testing.assert_array_equal(got, want.astype(np.float32))


def test_high_multiplicity_anchor_set():
    """The rollup under heavy per-doc anchor multiplicity, unsorted anchors
    and padding (the reference's own test's shape): against the
    reference's scatter-free rollup and ``np.add.at``, whole-number
    weights exactly."""
    jnp, R = _jax()
    rng = np.random.default_rng(13)
    D, A = 256, 2048
    docs = rng.integers(0, 40, A).astype(np.int32)
    w = (rng.random(A) * 2).astype(np.float32)
    match = rng.random(A) > 0.3
    want = np.zeros(D, np.float32)
    np.add.at(want, docs[match], w[match])
    ref = np.asarray(R._freq_segmented(jnp.asarray(docs), jnp.asarray(match),
                                       jnp.asarray(w), D=D))
    got = P._freq_segmented(torch.from_numpy(docs), torch.from_numpy(match),
                            torch.from_numpy(w), D=D).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    ones = np.ones(A, np.float32)
    got1 = P._freq_segmented(torch.from_numpy(docs), torch.from_numpy(match),
                             torch.from_numpy(ones), D=D).numpy()
    want1 = np.zeros(D, np.float32)
    np.add.at(want1, docs[match], 1.0)
    np.testing.assert_array_equal(got1, want1)
    # padded anchors (doc D) and an all-masked set fall out
    pad = np.concatenate([docs, np.full(64, D, np.int32)])
    got2 = P._freq_segmented(
        torch.from_numpy(pad), torch.ones(A + 64, dtype=torch.bool),
        torch.ones(A + 64), D=D).numpy()
    np.testing.assert_array_equal(got2, np.bincount(docs, minlength=D))
    got0 = P._freq_segmented(torch.from_numpy(docs), torch.zeros(
        A, dtype=torch.bool), torch.from_numpy(w), D=D).numpy()
    assert not got0.any()


@pytest.mark.parametrize("mode", MODES)
def test_padded_anchor_set_matches_reference(mode):
    """The reference pads anchors to a power of two with anchor_valid
    False; given the same padded set, the port answers the same."""
    jnp, R = _jax()
    csr = make_csr(21, n_docs=200, vocab=5, p_head=0.5)
    rinv = RefInv(csr)
    inputs = R.build_phrase_inputs(rinv, _phrase(["w0", "w1"]), csr["D"])
    adoc, apos, aval = (np.array(a) for a in inputs[:3])
    assert not aval.all()  # padded
    pinv = port_inv(csr)
    _, _, _, keys, deltas = P.build_phrase_inputs(
        pinv, _phrase(["w0", "w1"]), csr["D"])
    for slop in (0, 2):
        want = np.asarray(R.phrase_freq_program(
            *inputs, slop=slop, D=csr["D"], ordered=mode == "ordered",
            unordered=mode == "unordered"))
        got = P.phrase_freq_program(
            torch.from_numpy(adoc), torch.from_numpy(apos),
            torch.from_numpy(aval), keys, deltas, slop=slop, D=csr["D"],
            ordered=mode == "ordered", unordered=mode == "unordered").numpy()
        hold_freq(got, want, mode == "phrase" and slop == 0,
                  f"{mode} slop {slop}")


def test_build_phrase_inputs_matches_reference(csr):
    """Anchors, deltas and each term's packed keys hold what the
    reference's inputs hold: its anchors, and for every term the (doc,
    position) pairs of its run's entries."""
    jnp, R = _jax()
    words = ["w3", "w0", "w0", "w5"]
    rin = R.build_phrase_inputs(RefInv(csr), _phrase(words), csr["D"])
    (adoc, apos, aval, runs, rstart, rlen, deltas) = (
        np.asarray(a) for a in rin[:7])
    pin = P.build_phrase_inputs(port_inv(csr), _phrase(words), csr["D"])
    n = int(aval.sum())
    np.testing.assert_array_equal(pin[0].numpy(), adoc[:n])
    np.testing.assert_array_equal(pin[1].numpy(), apos[:n])
    assert pin[2] is None
    np.testing.assert_array_equal(pin[4], deltas)
    keys = pin[3].numpy()
    po = csr["pos_offsets"]
    for j in range(len(words) - 1):
        want = []
        for i in range(int(rlen[j])):
            e = int(rstart[j]) + i
            want += [(int(runs[j, i]) << 32) | int(p)
                     for p in csr["positions"][po[e]: po[e + 1]]]
        row = keys[j][keys[j] != np.iinfo(np.int64).max]
        np.testing.assert_array_equal(row, np.asarray(want, np.int64))
    # a missing term or a one-term phrase gives no inputs, as there
    assert P.build_phrase_inputs(port_inv(csr), _phrase(["w0", "zz"]),
                                 csr["D"]) is None
    assert R.build_phrase_inputs(RefInv(csr), _phrase(["w0", "zz"]),
                                 csr["D"]) is None
    assert P.build_phrase_inputs(port_inv(csr), _phrase(["w0"]),
                                 csr["D"]) is None


def test_phrase_score_matches_reference():
    jnp, R = _jax()
    rng = np.random.default_rng(5)
    D = 512
    freq = np.where(rng.random(D) < 0.4, rng.integers(1, 9, D) /
                    rng.integers(1, 4, D), 0).astype(np.float32)
    lengths = rng.integers(1, 60, D).astype(np.float32)
    for avg, idf in ((11.37, 3.25), (1.0, 0.5), (47.5, 9.125)):
        want = np.asarray(R.phrase_score(
            jnp.asarray(freq), jnp.asarray(lengths), jnp.float32(avg),
            jnp.float32(idf), D=D))
        got = P.phrase_score(torch.from_numpy(freq),
                             torch.from_numpy(lengths), avg, idf).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        assert ((got > 0) == (freq > 0)).all()


@pytest.mark.parametrize("pre,post", [(0, 0), (1, 0), (0, 2), (2, 3)])
def test_span_not_matches_reference(csr, pre, post):
    """span_not over union anchors (two include terms, the anchors not
    doc-sorted) and two exclude terms: surviving counts equal."""
    jnp, R = _jax()
    D = csr["D"]
    rin = R.build_union_anchor_inputs(RefInv(csr), ["w1", "w2"],
                                      ["w0", "w3"], D)
    want = np.asarray(R.span_not_program(*rin, pre, post, D=D))
    adoc, apos, aval, keys = P.build_union_anchor_inputs(
        port_inv(csr), ["w1", "w2"], ["w0", "w3"], D)
    got = P.span_not_program(adoc, apos, aval, keys, pre, post,
                             D=D).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


@pytest.mark.parametrize("mode", ["ordered", "unordered"])
def test_union_anchor_near_matches_reference(csr, mode):
    """span_near whose first clause is a term disjunction: union anchors
    into the ordered and unordered programs."""
    jnp, R = _jax()
    D = csr["D"]
    rin = R.build_union_anchor_inputs(RefInv(csr), ["w1", "w2"],
                                      ["w0", "w3"], D)
    adoc, apos, aval, keys = P.build_union_anchor_inputs(
        port_inv(csr), ["w1", "w2"], ["w0", "w3"], D)
    for slop in (0, 1, 3):
        want = np.asarray(R.phrase_freq_program(
            *rin[:6], jnp.zeros(2, jnp.int32), *rin[6:], slop=slop, D=D,
            ordered=mode == "ordered", unordered=mode == "unordered"))
        got = P.phrase_freq_program(
            adoc, apos, aval, keys, np.zeros(2, np.int64), slop=slop, D=D,
            ordered=mode == "ordered", unordered=mode == "unordered").numpy()
        hold_freq(got, want, False, f"{mode} slop {slop}")


def test_positional_device_charges_and_caches(csr):
    res = Residency("cpu")
    inv = port_inv(csr, res)
    fd = res.breakers.breaker("fielddata")
    used0 = fd.used
    dev = P.positional_device(inv)
    assert P.positional_device(inv) is dev  # placed once
    n = P.positional_bytes(inv)
    assert n == 4 * (csr["positions"].size * 2 + csr["pos_offsets"].size)
    assert fd.used - used0 == n
    np.testing.assert_array_equal(dev[0].numpy(), csr["positions"])
    np.testing.assert_array_equal(
        dev[2].numpy(), np.repeat(csr["doc_ids"], np.diff(csr["pos_offsets"])))
    # positions missing: no CSR, no charge
    bare = port_inv(csr, res)
    bare.positions = None
    assert P.positional_device(bare) is None and fd.used - used0 == n


def test_positional_device_denied_charge_leaks_nothing(csr):
    res = Residency("cpu")
    fd = res.breakers.breaker("fielddata")
    fd.limit = fd.used + 4 * csr["positions"].size + 8  # only positions fit
    inv = port_inv(csr, res)
    used0 = fd.used
    from elasticsearch_tpu_torch.utils.errors import CircuitBreakingException
    with pytest.raises(CircuitBreakingException):
        P.positional_device(inv)
    assert fd.used == used0 and inv._pos_dev is None


def test_segment_from_arrays_carries_positions():
    """A reference segment's positional CSR crosses bit for bit, and a
    phrase on the carried segment gives the reference's frequencies."""
    from elasticsearch_tpu.node import Node as RefNode
    from elasticsearch_tpu_torch.index.convert import segment_from_arrays

    jnp, R = _jax()
    ref = RefNode(name="ref")
    try:
        ref.create_index("p", {"mappings": copy.deepcopy(MAPPING)})
        svc = ref.indices["p"]
        for doc_id, src in corpus(200, seed=9):
            svc.index_doc(doc_id, src)
        svc.refresh()
        (rseg,) = [seg for g in svc.groups for seg in
                   g.reader(None).searcher.segments]
        pseg = segment_from_arrays(reference_arrays(rseg), Residency("cpu"))
        rinv, pinv = rseg.inverted["body"], pseg.inverted["body"]
        assert pinv.positions.dtype == np.int32
        assert pinv.pos_offsets.dtype == np.int64
        np.testing.assert_array_equal(pinv.positions, rinv.positions)
        np.testing.assert_array_equal(pinv.pos_offsets, rinv.pos_offsets)
        D = rseg.max_docs
        for words in (["quick", "brown"], ["fox", "jump"], ["lazi", "dog"]):
            terms = _phrase(words)
            rin = R.build_phrase_inputs(rinv, terms, D)
            pin = P.build_phrase_inputs(pinv, terms, D)
            if rin is None:
                assert pin is None
                continue
            want = np.asarray(R.phrase_freq_program(*rin, slop=0, D=D))
            got = P.phrase_freq_program(*pin, slop=0, D=D).numpy()
            np.testing.assert_array_equal(got, want)
    finally:
        ref.close()


def test_rollup_is_deterministic_across_threads(csr):
    """Sloppy frequencies are sums of fractions; the fixed-point rollup
    gives the same bits on every run (here: threads racing the same
    program), where an unordered float accumulation need not."""
    inv = port_inv(csr)
    P.positional_device(inv)
    outs = []

    def run():
        outs.append(port_freq(inv, csr, ["w0", "w1", "w0"], 3, "phrase"))

    ts = [threading.Thread(target=run) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
