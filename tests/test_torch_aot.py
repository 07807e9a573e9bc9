"""The kernel-library blob tier (``parallel/aot.py``), driven through the
``g++`` host codec (``native/``): the one library of the port that
builds on the CPU.

- a fresh build is stored in the registered data directory, and a new
  process (an emptied memo and build directory) loads it from there
  (``aot_hit``) with no compiler run, its output bit-equal;
- a corrupt blob, one with another fingerprint and one ``dlopen``
  refuses are each deleted, counted and rebuilt from source;
- ROADMAP C26: a blob or a census keyed ``n=1`` is refused under
  ``n=4`` in the port, where the reference's key carries no device
  count.
"""
import os

import numpy as np
import pytest

from elasticsearch_tpu.monitor import compile_cache as ref_compile_cache
from elasticsearch_tpu.monitor import programs as ref_programs
from elasticsearch_tpu_torch import native
from elasticsearch_tpu_torch.index import ivf_cache
from elasticsearch_tpu_torch.monitor import compile_cache, programs
from elasticsearch_tpu_torch.ops import build
from elasticsearch_tpu_torch.parallel import aot
from elasticsearch_tpu_torch.resources import census
from elasticsearch_tpu_torch.tracing import retrace

VALUES = np.cumsum(np.random.default_rng(5).integers(0, 900, 4096))


def _new_process(monkeypatch, build_dir):
    """What a new process starts with: no opened library, an empty (or
    given) build directory."""
    aot.reset()
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(build, "_BUILD_DIR", str(build_dir))


@pytest.fixture
def tier(tmp_path, monkeypatch):
    compile_cache.reset()
    ivf_cache.reset()
    d = tmp_path / "data" / "_ivf"
    ivf_cache.register(str(d))
    _new_process(monkeypatch, tmp_path / "build0")
    yield d
    ivf_cache.reset()
    aot.reset()
    compile_cache.reset()


def _events():
    return {k: v for k, v in compile_cache.events_snapshot().items() if v}


def _encode():
    assert native.native_available()
    return native.delta_encode(VALUES), native.vbyte_encode(VALUES - 2000)


def _blob_path(tier):
    (name,) = [f for f in os.listdir(tier) if f.endswith(".kso")]
    return tier / name


def test_fresh_then_stored_then_loaded_in_a_new_process(tier, tmp_path,
                                                        monkeypatch):
    want = _encode()
    assert want == (native._py_delta_encode(VALUES),
                    native._py_vbyte_encode(VALUES - 2000))
    assert _events() == {"fresh": 1, "store": 1}
    rec = aot.stats()["codec"]
    assert rec["source"] == "fresh" and rec["seconds"] > 0
    assert _blob_path(tier).name == rec["key"] + ".kso"
    assert compile_cache.seconds_snapshot()["compile"] > 0
    # a new process, an empty build directory: loaded, never built
    _new_process(monkeypatch, tmp_path / "build1")
    snap = retrace.snapshot()
    assert _encode() == want
    assert _events() == {"fresh": 1, "store": 1, "aot_hit": 1}
    assert aot.stats()["codec"]["source"] == "aot_hit"
    assert retrace.traces_since(snap) == 1  # the load: a first touch
    assert os.path.exists(aot.stats()["codec"]["path"])
    # a third, over the build directory the second wrote
    _new_process(monkeypatch, tmp_path / "build1")
    assert _encode() == want
    assert _events()["build_dir_hit"] == 1
    assert compile_cache.counter_values()["compile_cache.aot_hit"] == 1.0


def _rebuilds(monkeypatch, tmp_path, tier, event, want):
    _new_process(monkeypatch, tmp_path / "build_again")
    before = _events()
    assert _encode() == want
    after = _events()
    assert after[event] == before.get(event, 0) + 1
    assert after["fresh"] == before["fresh"] + 1
    assert after["store"] == before["store"] + 1  # stored anew
    assert aot.stats()["codec"]["source"] == "fresh"
    assert aot.unframe(_blob_path(tier).read_bytes()) is not None


def test_a_corrupt_blob_is_deleted_counted_and_rebuilt(tier, tmp_path,
                                                      monkeypatch):
    want = _encode()
    path = _blob_path(tier)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    _rebuilds(monkeypatch, tmp_path, tier, "corrupt_miss", want)


def test_a_foreign_blob_is_deleted_counted_and_rebuilt(tier, tmp_path,
                                                      monkeypatch):
    """A blob carried over from a four-card machine, hand-moved under
    this machine's key: its header's fingerprint does not match."""
    want = _encode()
    path = _blob_path(tier)
    header, data = aot.unframe(path.read_bytes())
    header["backend"] = header["backend"].replace("n=1", "n=4")
    path.write_bytes(aot.frame(header, data))
    _rebuilds(monkeypatch, tmp_path, tier, "mismatch_miss", want)


def test_a_blob_dlopen_refuses_is_deleted_counted_and_rebuilt(
        tier, tmp_path, monkeypatch):
    want = _encode()
    path = _blob_path(tier)
    header, _data = aot.unframe(path.read_bytes())
    path.write_bytes(aot.frame(header, b"\x7fELF not a library"))
    _rebuilds(monkeypatch, tmp_path, tier, "deserialize_error", want)


def test_without_a_data_directory_nothing_is_stored_until_close(
        tmp_path, monkeypatch):
    compile_cache.reset()
    ivf_cache.reset()
    _new_process(monkeypatch, tmp_path / "b")
    try:
        want = _encode()
        assert _events() == {"fresh": 1, "store_skipped": 1}
        # a node's data path registered later: its close stores what the
        # process loaded
        d = tmp_path / "late" / "_ivf"
        ivf_cache.register(str(d))
        aot.store_loaded()
        assert _events()["store"] == 1
        aot.store_loaded()  # already there: no second store
        assert _events()["store"] == 1
        _new_process(monkeypatch, tmp_path / "b2")
        assert _encode() == want
        assert _events()["aot_hit"] == 1
    finally:
        ivf_cache.reset()
        aot.reset()
        compile_cache.reset()


def test_c26_a_blob_keyed_n1_is_not_served_under_n4(tier, tmp_path,
                                                    monkeypatch):
    want = _encode()
    key_n1 = aot.stats()["codec"]["key"]
    assert programs.backend_fingerprint() == "cpu/cpu/n=1"
    monkeypatch.setattr(programs, "_FP", "cpu/cpu/n=4")
    _new_process(monkeypatch, tmp_path / "build_n4")
    assert native.spec().key != key_n1  # the count is in the key
    assert _encode() == want
    assert aot.stats()["codec"]["source"] == "fresh"  # never the n=1 blob
    # the n=1 blob hand-moved under the n=4 key: refused by its header
    n4 = aot.stats()["codec"]["key"]
    (tier / f"{n4}.kso").write_bytes((tier / f"{key_n1}.kso").read_bytes())
    _new_process(monkeypatch, tmp_path / "build_n4b")
    assert _encode() == want
    assert _events()["mismatch_miss"] == 1


def test_c26_a_census_keyed_n1_is_refused_under_n4(tier, monkeypatch):
    from elasticsearch_tpu_torch.node import Node

    import jax

    rows = [{"program": "mesh_dsl", "shapes": "D=512|S=1|k=5",
             "field": "", "hits": 3}]
    census._DECAYED.clear()
    census.store_census("c26", keys=rows,
                        bodies=[{"body": '{"size": 1}', "hits": 3}],
                        merge=False)
    payload = census.load_census("c26")
    assert payload["backend"] == "cpu/cpu/n=1"
    monkeypatch.setattr(programs, "_FP", "cpu/cpu/n=4")
    assert census.adopt_census("c26", dict(payload)) is False
    node = Node(name="c26", device="cpu")
    try:
        node.create_index("c26", {})
        run = node.serving.warmup.run_index("c26", "boot")
        assert run["status"] == "backend_mismatch"
        assert run["census_backend"] == "cpu/cpu/n=1"
    finally:
        node.close()
    # the reference's fingerprint, the whole of its key's device part,
    # has no device count, though its process sees several devices
    assert jax.device_count() > 1
    assert ref_programs.backend_fingerprint() == "cpu/cpu"


def test_frames_and_ledger_names():
    header = {"version": aot.VERSION, "library": "x", "key": "k"}
    blob = aot.frame(header, b"\x00\x01\n\x02")
    assert aot.unframe(blob) == (header, b"\x00\x01\n\x02")
    assert aot.unframe(blob[:-1]) is None
    assert aot.unframe(b"junk") is None
    # the reference's ledger names where the meaning holds: its
    # xla_dir_hit is the port's build_dir_hit; call_fallback has no
    # counterpart (a library loads or its launch raises)
    port, ref = set(compile_cache.EVENTS), set(ref_compile_cache.EVENTS)
    assert ref - port == {"xla_dir_hit", "call_fallback"}
    assert port - ref == {"build_dir_hit"}
    assert compile_cache.PHASES == ref_compile_cache.PHASES
    compile_cache.reset()
    assert set(compile_cache.counter_values().values()) == {-1.0}
