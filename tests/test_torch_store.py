"""The port's host codec (``native``), its blob forms (``index/store.py``)
and the content-addressed blob cache (``index/ivf_cache.py``) against the
JAX package's, on the CPU.

The compiled codec and its numpy/zlib twin write the same bytes, and both
equal the reference's. A postings, IVF or PQ blob that either package
writes loads in the other and writes back byte for byte; a damaged blob
raises ``CorruptStoreException`` and the cache treats it as a miss (the
file is deleted, the counters do not move).
"""
import os

import numpy as np
import pytest
import torch

from elasticsearch_tpu import native as ref_native
from elasticsearch_tpu.index import ivf_cache as ref_cache
from elasticsearch_tpu.index import store as ref_store
from elasticsearch_tpu.node import Node as RefNode
from elasticsearch_tpu.ops import ivf as ref_ivf
from elasticsearch_tpu.ops import pq as ref_pq
from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.index import ivf_cache, store
from elasticsearch_tpu_torch.monitor import kernels
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops.ivf import build_ivf
from elasticsearch_tpu_torch.ops.pq import build_pq

from _torch_parity import MAPPING, clustered, corpus

VALUES = [
    np.zeros(0, np.int64),
    np.array([0, 1, -1, 63, 64, -64, -65, 127, 128, 300, -300], np.int64),
    np.array([np.iinfo(np.int64).max, np.iinfo(np.int64).min, 2 ** 40,
              -(2 ** 40)], np.int64),
    np.random.default_rng(0).integers(-2 ** 33, 2 ** 33, 500),
    np.cumsum(np.random.default_rng(1).integers(0, 1000, 500)),
]


@pytest.fixture(autouse=True)
def _fresh_cache():
    ivf_cache.reset()
    ref_cache.reset()
    yield
    ivf_cache.reset()
    ref_cache.reset()


@pytest.mark.parametrize("case", range(len(VALUES)))
@pytest.mark.parametrize("kind", ["vbyte", "delta"])
def test_codec_native_twin_and_reference_agree(case, kind):
    a = VALUES[case]
    enc = getattr(native, f"{kind}_encode")
    dec = getattr(native, f"{kind}_decode")
    twin_enc = getattr(native, f"_py_{kind}_encode")
    twin_dec = getattr(native, f"_py_{kind}_decode")
    blob = enc(a)
    assert blob == twin_enc(np.asarray(a, np.int64))
    assert blob == getattr(ref_native, f"{kind}_encode")(a)
    np.testing.assert_array_equal(dec(blob, a.size), a)
    np.testing.assert_array_equal(twin_dec(blob, a.size), a)
    if blob:  # a truncated varint stops the decode cleanly in both
        cut = blob[:-1]
        np.testing.assert_array_equal(dec(cut, a.size),
                                      twin_dec(cut, a.size))


def test_codec_is_compiled_and_crc_matches_zlib():
    import shutil
    import zlib

    # built at first use wherever g++ is; the twins serve without it
    assert native.native_available() == (shutil.which("g++") is not None)
    for data in (b"", b"a", bytes(range(256)) * 7):
        for seed in (0, 12345):
            want = zlib.crc32(data, seed) & 0xFFFFFFFF
            assert native.crc32(data, seed) == want
            assert ref_native.crc32(data, seed) == want


def _segments(docs):
    """Both packages' one segment over ``docs``."""
    ref, port = RefNode(name="r"), Node(name="p", device="cpu")
    for node in (ref, port):
        node.create_index("i", {"mappings": MAPPING})
        for doc_id, src in docs:
            node.indices["i"].index_doc(doc_id, dict(src))
        node.indices["i"].refresh()
    segs = (ref.indices["i"].shards[0].segments[0],
            port.indices["i"].shards[0].segments[0])
    return ref, port, segs


def test_postings_blobs_are_byte_identical():
    ref, port, (rseg, pseg) = _segments(corpus(300, seed=4))
    try:
        for field in ("body", "tag"):
            rb = ref_store.write_postings(rseg.inverted[field])
            pb = store.write_postings(pseg.inverted[field])
            assert pb == rb, field
            got = store.read_postings(rb)
            want = ref_store.read_postings(pb)
            assert got["terms"] == want["terms"]
            assert got["stats"] == want["stats"]
            for k in ("offsets", "df", "cf", "doc_ids", "tf",
                      "pos_offsets", "positions"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("metric", ["cosine", "l2_norm"])
def test_ivf_and_pq_blobs_load_in_both_directions(metric):
    vecs = clustered(700, 16, 7, seed=2)
    D = 1024
    pad = np.zeros((D, 16), np.float32)
    pad[:700] = vecs
    exists = np.zeros(D, bool)
    exists[:700] = True
    # the reference's quantizer into the port and back
    r_ivf = ref_ivf.build_ivf(pad, exists, D, metric=metric)
    r_blob = ref_store.write_ivf(r_ivf)
    p_ivf = store.read_ivf(r_blob)
    assert isinstance(p_ivf.lists, torch.Tensor)
    assert store.write_ivf(p_ivf) == r_blob
    np.testing.assert_array_equal(p_ivf.lists.numpy(), np.asarray(r_ivf.lists))
    # the port's quantizer into the reference and back
    pi = build_ivf(torch.from_numpy(pad), torch.from_numpy(exists), D,
                   metric=metric)
    p_blob = store.write_ivf(pi)
    assert ref_store.write_ivf(ref_store.read_ivf(p_blob)) == p_blob
    # PQ parts, both ways
    r_parts = ref_pq.build_pq(pad, exists, metric)
    rp_blob = ref_store.write_pq(r_parts)
    got = store.read_pq(rp_blob)
    assert store.write_pq(got) == rp_blob
    np.testing.assert_array_equal(got.codes, np.asarray(r_parts.codes))
    p_parts = build_pq(torch.from_numpy(pad), torch.from_numpy(exists),
                       metric)
    pp_blob = store.write_pq(p_parts)
    assert ref_store.write_pq(ref_store.read_pq(pp_blob)) == pp_blob


def test_content_key_matches_the_reference():
    vecs = clustered(200, 8, 3, seed=1)
    exists = np.ones(200, bool)
    exists[::7] = False
    for metric, md in (("cosine", 256), ("dot_product", 512)):
        assert ivf_cache.content_key(vecs, exists, metric, md) == \
            ref_cache.content_key(vecs, exists, metric, md)


@pytest.mark.parametrize("damage", ["flip", "truncate", "header"])
def test_a_damaged_blob_raises_and_is_a_cache_miss(tmp_path, damage):
    vecs = clustered(300, 8, 4, seed=5)
    ex = np.ones(300, bool)
    ivf = build_ivf(torch.from_numpy(vecs), torch.from_numpy(ex), 300)
    blob = bytearray(store.write_ivf(ivf))
    if damage == "flip":
        blob[-3] ^= 0xFF
    elif damage == "truncate":
        del blob[-10:]
    else:
        blob[4] = ord("}")
    with pytest.raises(store.CorruptStoreException):
        store.read_ivf(bytes(blob))
    d = str(tmp_path / "_ivf")
    ivf_cache.register(d)
    os.makedirs(d)
    path = os.path.join(d, "k.ivf")
    with open(path, "wb") as f:
        f.write(bytes(blob))
    kernels.reset()
    assert ivf_cache.load("k") is None
    assert not os.path.exists(path)  # deleted: the build writes it anew
    assert kernels.snapshot().get("ivf_cache_hit", 0) == 0
    ivf_cache.store("k", ivf, d)
    ivf_cache._MEM.clear()  # the disk layer alone
    got = ivf_cache.load("k")
    assert kernels.snapshot()["ivf_cache_hit"] == 1
    assert torch.equal(got.lists, ivf.lists)


def test_generic_blob_tier(tmp_path):
    d = str(tmp_path / "_ivf")
    ivf_cache.register(d)
    payload = {"a": 1, "b": [1, 2]}
    framed = ivf_cache.frame_blob(payload)
    assert framed == ref_cache.frame_blob(payload)
    ivf_cache.store_blob("census_i", framed, "census")
    ivf_cache.store_blob("census_j", framed, "census")
    assert ivf_cache.list_blob_keys("census") == ["census_i", "census_j"]
    ivf_cache._MEM.clear()
    assert ivf_cache.unframe_blob(ivf_cache.load_blob("census_i",
                                                      "census")) == payload
    assert ivf_cache.unframe_blob(framed[:-1]) is None
    ivf_cache.delete_blob("census_i", "census")
    assert ivf_cache.load_blob("census_i", "census") is None
    ivf_cache.unregister(d)
    assert ivf_cache.load_blob("census_j", "census") is None
