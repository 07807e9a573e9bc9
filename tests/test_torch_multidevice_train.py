"""Training's ``dp x tp`` and the ring encoder's ``sp`` over several
devices: the port's mesh step (``models/mesh_step.py``) and ring
(``models/ring_encoder.py``) against the port's one-device forms and the
reference's sharded programs on its eight virtual CPU devices.

A device list that names the CPU several times (``["cpu"] * 8``) gives
eight mesh devices, each position's parameter shard and each sequence
slot's blocks on its own entry, the stand-in for the reference's eight
virtual devices (C36: distinct cards are not available here). Widths are
``tests/test_torch_models.py``'s (vocab 512, d_model 64, 4 heads, 2
layers, d_ff 128, embed 32, max_len 32), the ring's
``tests/test_torch_ring_encoder.py``'s (max_len 64).

Bars. The step, three f32 AdamW steps: losses within rtol 1e-4 and the
parameters within rtol 1e-4 (atol 1e-5 of each tensor's largest entry)
wherever the gradient stayed clear of the rounding floor
(``test_three_adamw_steps_match_optax``'s rule), against the port's
``training_mesh(1)`` step and the reference's step under its
``training_mesh(n)`` with ``param_shardings``. The ring: f32 within atol
1e-6 of the port's one-device ring; against the reference's ring the
bars of ``test_torch_ring_encoder.py`` (f32 atol 1e-5; bf16 cosine >
0.999 and atol 3e-2). Two mesh runs and a checkpoint's round trip: bit
for bit. The reference's AOT executable cache is off (ROADMAP C,
reference note).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from elasticsearch_tpu.models import dual_encoder as R
from elasticsearch_tpu.models import ring_encoder as RR
from elasticsearch_tpu.parallel import mesh as rmesh
from elasticsearch_tpu_torch.models import dual_encoder as P
from elasticsearch_tpu_torch.models import mesh_step
from elasticsearch_tpu_torch.models import ring_encoder as PR
from elasticsearch_tpu_torch.parallel import mesh as pmesh
from elasticsearch_tpu_torch.parallel.mesh import training_mesh

SMALL = dict(vocab_size=512, max_len=32, d_model=64, n_heads=4, n_layers=2,
             d_ff=128, embed_dim=32)
RING = dict(SMALL, max_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

#: (name, device list, n, tp): dp 2 x tp 4 a device a position; dp only;
#: tp only; training_mesh(8) wrapped over four devices
MESHES = [("dp2xtp4", ["cpu"] * 8, 8, None), ("dp", ["cpu"] * 2, 2, 1),
          ("tp", ["cpu"] * 4, 4, 4), ("wrap", ["cpu"] * 4, 8, None)]


@pytest.fixture(autouse=True)
def _no_reference_aot_cache(monkeypatch):
    from elasticsearch_tpu.parallel import aot

    monkeypatch.setattr(aot, "_ENABLED", False)


def _cfgs(dt="f32", **kw):
    j, t = DTYPES[dt]
    args = dict(SMALL, **kw)
    return R.DualEncoderConfig(dtype=j, **args), \
        P.DualEncoderConfig(dtype=t, **args)


def _batch(rng, B, L, vocab=512):
    ids = rng.integers(1, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    for i in range(B):
        n = int(rng.integers(1, L + 1))
        ids[i, n:] = 0
        mask[i, n:] = 0.0
    return ids, mask


def _pairs(rng, B, L=32):
    return _batch(rng, B, L) + _batch(rng, B, L)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _mesh_step(pc, model, n, devices, tp=None):
    mesh = training_mesh(n, device=devices, tp=tp)
    step, _opt = P.make_train_step(pc, model=model, mesh=mesh)
    return step


def _model(pc, params):
    model = P.build_model(pc)
    model.load_state_dict(P.params_from_flax(params, pc))
    return model


def _hold_params(got: dict, want: dict, noisy: dict, what: str):
    for k, a in want.items():
        ok = ~noisy[k]
        np.testing.assert_allclose(
            got[k][ok], a[ok], rtol=1e-4,
            atol=1e-5 * float(np.abs(a).max()), err_msg=f"{what}: {k}")
    n_noisy = sum(int(v.sum()) for v in noisy.values())
    assert n_noisy < 0.01 * sum(v.size for v in noisy.values()), n_noisy


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,tp,n_dev,want", [
    (8, None, 4, [[0, 1, 2, 3], [0, 1, 2, 3]]),
    (8, None, 8, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (2, None, 4, [[0, 1]]),
    (6, 2, 4, [[0, 1], [2, 3], [0, 1]]),
    (4, 1, 8, [[0], [1], [2], [3]])])
def test_training_mesh_lays_positions_dp_major(monkeypatch, n, tp, n_dev,
                                               want):
    """Position p = dp_rank * tp + tp_rank on device p % min(n, devices):
    the reference's ``reshape(n // tp, tp)`` filled dp-major, wrapped
    over the devices there are; ``device`` is the first position's."""
    devs = tuple(torch.device("cuda", i) for i in range(n_dev))
    monkeypatch.setattr(pmesh, "resolve_devices", lambda d=None: devs)
    mesh = training_mesh(n, tp=tp)
    assert [[d.index for d in row] for row in mesh.grid] == want
    assert mesh.shape == {"dp": len(want), "tp": len(want[0])}
    assert mesh.device == devs[0]
    for g, row in enumerate(want):
        for r, d in enumerate(row):
            assert mesh.device_of(g, r) == devs[d]


def test_training_mesh_shape_over_a_list_equals_the_reference(eight_devices):
    for n in range(1, 9):
        assert training_mesh(n, device=["cpu"] * 8).shape == dict(
            rmesh.training_mesh(n).shape)


# ---------------------------------------------------------------------------
# the step against the port's one-device step and the reference's
# ---------------------------------------------------------------------------

def _reference_mesh_steps(rc, params, n, tp, batches, lr):
    """The reference's losses and parameters after its jitted step under
    ``training_mesh(n)`` with ``param_shardings``, the batch over 'dp'."""
    rstep, tx = R.make_train_step(rc, lr=lr)
    mesh = rmesh.training_mesh(n, tp=tp)
    p = jax.device_put(jax.tree_util.tree_map(jnp.array, params),
                       R.param_shardings(mesh, params))
    opt = tx.init(p)
    bs = R.batch_sharding(mesh)
    losses = []
    for batch in batches:
        b = tuple(jax.device_put(x, bs) for x in batch)
        with mesh:
            p, opt, loss = rstep(p, opt, b)
        losses.append(float(loss))
    return losses, dict(_flat(jax.device_get(p)["params"]))


@pytest.fixture(scope="module")
def baseline():
    """What every mesh is held to: the reference's weights, three
    batches, the port's ``training_mesh(1)`` losses and parameters after
    them, and the entries whose gradient sat at the rounding floor in
    some step (the reference's unsharded gradients)."""
    rc, pc = _cfgs("f32")
    params = R.init_params(rc, seed=3)
    rng = np.random.default_rng(6)
    batches = [_pairs(rng, 8) for _ in range(3)]
    one, _opt = P.make_train_step(pc, lr=1e-3, model=_model(pc, params),
                                  mesh=training_mesh(1, device="cpu"))
    rmodel = R.build_model(rc)
    noisy = {k: np.zeros(v.shape, bool) for k, v in _flat(params["params"])}
    losses = []
    for q, qm, d, dm in batches:
        rp = jax.tree_util.tree_map(jnp.array, P.params_to_flax(one.model))
        g = jax.grad(lambda p: R.contrastive_loss(
            rmodel.apply(p, q, qm), rmodel.apply(p, d, dm)))(rp)
        for k, a in _flat(g["params"]):
            noisy[k] |= (a != 0) & (np.abs(a) < 1e-5)
        losses.append(float(one(q, qm, d, dm)))
    return dict(rc=rc, pc=pc, params=params, batches=batches, noisy=noisy,
                losses=losses,
                one=dict(_flat(P.params_to_flax(one.model)["params"])))


@pytest.mark.parametrize("name,devices,n,tp", MESHES,
                         ids=[m[0] for m in MESHES])
def test_mesh_step_matches_one_device_and_the_reference(
        name, devices, n, tp, baseline, eight_devices):
    """Three f32 steps under the mesh against the port's
    ``training_mesh(1)`` step and the reference's sharded step: the
    losses, then the gathered parameters, within the bars."""
    b = baseline
    pc = b["pc"]
    mesh = _mesh_step(pc, _model(pc, b["params"]), n, devices, tp)
    assert isinstance(mesh, mesh_step.MeshTrainStep)
    rlosses, rparams = _reference_mesh_steps(b["rc"], b["params"], n, tp,
                                             b["batches"], 1e-3)
    for batch, one, rloss in zip(b["batches"], b["losses"], rlosses):
        got = float(mesh(*batch))
        np.testing.assert_allclose(got, one, rtol=1e-4)
        np.testing.assert_allclose(got, rloss, rtol=1e-4)
    got = dict(_flat(P.params_to_flax(mesh.model)["params"]))
    _hold_params(got, b["one"], b["noisy"], "mesh vs training_mesh(1)")
    _hold_params(got, rparams, b["noisy"], "mesh vs the reference's mesh")


def test_training_mesh_1_is_the_step_without_a_mesh():
    """``training_mesh(1)`` is one position: the step without a mesh, bit
    for bit."""
    _rc, pc = _cfgs("bf16")
    rng = np.random.default_rng(7)
    batch = _pairs(rng, 4)
    out = []
    for mesh in (training_mesh(1, device="cpu"), None):
        step, _opt = P.make_train_step(
            pc, model=P.init_params(pc, seed=11, device="cpu"), mesh=mesh)
        out.append(([step(*batch) for _ in range(2)],
                    step.model.state_dict()))
    (la, sa), (lb, sb) = out
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    assert all(torch.equal(sa[k], sb[k]) for k in sb)


# ---------------------------------------------------------------------------
# the loss, determinism, the shards, checkpoints
# ---------------------------------------------------------------------------

def test_mesh_loss_is_the_global_in_batch_infonce():
    """Under dp 2 the loss is InfoNCE over the whole batch (every group's
    rows are each other's negatives), not the mean of each group's own:
    on this batch the two differ by far more than the bar."""
    _rc, pc = _cfgs("f32")
    model = P.init_params(pc, seed=4, device="cpu")
    rng = np.random.default_rng(12)
    q, qm, d, dm = (torch.as_tensor(x) for x in _pairs(rng, 8))
    with torch.no_grad():
        zq, zd = model(q.long(), qm), model(d.long(), dm)
        whole = float(P.contrastive_loss(zq, zd))
        halves = float((P.contrastive_loss(zq[:4], zd[:4])
                        + P.contrastive_loss(zq[4:], zd[4:])) / 2)
    assert abs(whole - halves) > 1e-2 * abs(whole)
    step = _mesh_step(pc, model, 8, ["cpu"] * 8)
    loss = float(step(q, qm, d, dm))
    np.testing.assert_allclose(loss, whole, rtol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mesh_step_is_deterministic(dt):
    """Two runs of the dp 2 x tp 4 step from the same weights: losses and
    every shard bit for bit."""
    _rc, pc = _cfgs(dt)
    rng = np.random.default_rng(13)
    batches = [_pairs(rng, 8) for _ in range(3)]
    runs = []
    for _ in range(2):
        step = _mesh_step(pc, P.init_params(pc, seed=5, device="cpu"), 8,
                          ["cpu"] * 8)
        losses = [step(*b) for b in batches]
        runs.append((losses, [{k: v.detach().clone() for k, v in sh.items()}
                              for row in step.shards for sh in row]))
    (la, sa), (lb, sb) = runs
    assert all(torch.equal(a, b) for a, b in zip(la, lb))
    for a, b in zip(sa, sb):
        assert all(torch.equal(a[k], b[k]) for k in a)


def _want_shape(kind, full_shape, spec, tp):
    """The port tensor's shape for the reference's spec of its kernel."""
    shape = list(full_shape)
    if "tp" not in spec:
        return tuple(shape)
    ax = spec.index("tp")
    # the reference kernel's dim -> the port tensor's
    dim = {"copy": ax, "dense": 1 - ax, "qkv": 0, "out": 1}[kind]
    shape[dim] //= tp
    return tuple(shape)


@pytest.mark.parametrize("n,tp,split", [(8, None, {"emb", "attn", "mlp"}),
                                        (8, 8, {"emb", "mlp"})])
def test_each_position_holds_only_its_slice(n, tp, split, eight_devices):
    """Each position's leaves: for every kernel its slice per the
    reference's ``param_shardings`` (q/k/v and ``wi``: rows, whole heads;
    ``out`` and ``wo``: input columns; the embeddings: d_model columns),
    the column-parallel layers' biases sliced with their rows, the rest
    whole; each leaf the rank's chunk of the whole tensor, on its
    position's device. Under tp 8 the 4 heads do not divide: attention
    stays whole on every rank (the reference's per-dim fallback), and
    the step still equals the one-device step."""
    _rc, pc = _cfgs("f32")
    model = P.init_params(pc, seed=2, device="cpu")
    mesh = training_mesh(n, device=["cpu"] * 8, tp=tp)
    step, _opt = P.make_train_step(pc, model=model, mesh=mesh)
    specs = P.param_shardings(mesh, model)
    full = model.state_dict()
    kinds = {name: (path, kind) for path, name, kind in P._layout(pc)}
    dims = mesh_step.split_dims(pc, mesh.tp)
    assert {k for k, d in dims.items() if d is not None} == {
        k for k in full if (("emb" in split and "_emb" in k)
                            or ("attn" in split and ".attn." in k
                                and not k.endswith("out.bias"))
                            or ("mlp" in split and (".wi." in k
                                                    or "wo.weight" in k)))}
    for g in range(mesh.dp):
        for r in range(mesh.tp):
            for name, leaf in step.shards[g][r].items():
                path, kind = kinds[name]
                if kind in ("qkv_bias",) or name.endswith("wi.bias"):
                    want = list(full[name].shape)
                    if dims[name] is not None:
                        want[0] //= mesh.tp
                    want = tuple(want)
                else:
                    want = _want_shape(kind, full[name].shape, specs[path],
                                       mesh.tp)
                assert tuple(leaf.shape) == want, (name, g, r)
                assert leaf.device == mesh.device_of(g, r)
                d = dims[name]
                whole = full[name] if d is None else torch.chunk(
                    full[name], mesh.tp, d)[r]
                assert torch.equal(leaf.detach(), whole), (name, g, r)
    one, _ = P.make_train_step(pc, model=P.init_params(pc, seed=2,
                                                       device="cpu"))
    rng = np.random.default_rng(14)
    batch = _pairs(rng, 8)
    np.testing.assert_allclose(float(step(*batch)), float(one(*batch)),
                               rtol=1e-4)


def test_mesh_step_refuses_a_batch_that_does_not_divide_dp():
    _rc, pc = _cfgs("f32")
    step = _mesh_step(pc, P.init_params(pc, seed=1, device="cpu"), 8,
                      ["cpu"] * 8)
    with pytest.raises(ValueError, match="does not divide dp"):
        step(*_pairs(np.random.default_rng(0), 3))


def test_a_mesh_checkpoint_loads_under_training_mesh_1(tmp_path):
    """Saved from the gathered model after a dp 2 x tp 4 step, loaded into
    a ``training_mesh(1)`` step: every parameter bit-equal to the shards
    concatenated in rank order, and the same embeddings."""
    _rc, pc = _cfgs("bf16")
    rng = np.random.default_rng(15)
    step = _mesh_step(pc, P.init_params(pc, seed=6, device="cpu"), 8,
                      ["cpu"] * 8)
    step(*_pairs(rng, 8))
    path = str(tmp_path / "mesh.pt")
    P.save_checkpoint(path, step.model, step=1, cfg=pc)
    got = P.load_checkpoint(path)
    one, _opt = P.make_train_step(
        P.config_from_dict(got["config"]),
        model=P.build_model(pc), mesh=training_mesh(1, device="cpu"))
    one.model.load_state_dict(got["params"])
    for name, d in mesh_step.split_dims(pc, 4).items():
        row = step.shards[0]
        want = row[0][name] if d is None else torch.cat(
            [sh[name] for sh in row], d)
        assert torch.equal(one.model.state_dict()[name], want.detach()), name
        for g in range(step.mesh.dp):  # every replica holds the same
            for r in range(step.mesh.tp):
                slc = want if d is None else torch.chunk(want, 4, d)[r]
                assert torch.equal(step.shards[g][r][name].detach(), slc)
    ids, mask = _batch(rng, 4, 32)
    assert torch.equal(P.encode(one.model, ids, mask),
                       P.encode(step.model, ids, mask))


# ---------------------------------------------------------------------------
# the ring over devices
# ---------------------------------------------------------------------------

def _ring_pair(dt, seed=3, **kw):
    j, t = DTYPES[dt]
    args = dict(RING, **kw)
    rc = R.DualEncoderConfig(dtype=j, **args)
    pc = P.DualEncoderConfig(dtype=t, **args)
    params = R.init_params(rc, seed=seed)
    return rc, params, pc, _model(pc, params)


def _ring_batch(rng, B, L):
    ids = rng.integers(1, 512, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    for i in range(B):
        n = int(rng.integers(L // 3, L + 1))
        ids[i, n:] = 0
        mask[i, n:] = 0.0
    return ids, mask


@pytest.mark.parametrize("devices", [["cpu"] * 8, ["cpu"] * 4],
                         ids=["8dev", "4dev"])
@pytest.mark.parametrize("dt,L", [("f32", 64), ("bf16", 64), ("f32", 60)])
def test_ring_over_devices(devices, dt, L, eight_devices):
    """8 slots over the devices (a slot a device, or two a device),
    ragged rows: against the port's one-device ring (f32 atol 1e-6, bf16
    bit for bit) and the reference's ring on its 8 devices
    (``test_torch_ring_encoder.py``'s bars). L = 60 is no multiple of 8:
    the padding crosses max_len."""
    kw = {"max_len": 60} if L == 60 else {}
    rc, params, pc, model = _ring_pair(dt, **kw)
    rng = np.random.default_rng(16)
    ids, mask = _ring_batch(rng, 4, L)
    mesh = PR.build_sp_mesh(8, devices)
    assert mesh.slots == 8 and mesh.n_devices == len(devices)
    got = PR.ring_encode(pc, model, ids, mask, mesh).numpy()
    one = PR.ring_encode(pc, model, ids, mask,
                         PR.build_sp_mesh(8, "cpu")).numpy()
    ref = np.asarray(RR.ring_encode(rc, params, ids, mask,
                                    RR.build_sp_mesh(8)))
    if dt == "f32":
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, one)
        assert np.all(np.sum(got * ref, axis=-1) > 0.999)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2)


def test_ring_over_devices_holds_one_block_a_slot(monkeypatch):
    """8 slots over four devices: each device's activations cover its two
    slots only; every product of the ring is one slot's ``[B, H, n, n]``
    scores or ``[B, H, n, Dh]`` values, S * S of each a layer, and the
    ring step is the outer loop: each step visits every slot's query
    block before the next step starts."""
    _rc, _params, pc, model = _ring_pair("bf16")
    rng = np.random.default_rng(17)
    ids, mask = _ring_batch(rng, 2, 64)
    shapes, queries, norms = [], [], []
    real_einsum, real_ln = torch.einsum, PR._layer_norm

    def spy(eq, *ops):
        out = real_einsum(eq, *ops)
        shapes.append(tuple(out.shape))
        if eq == "bhqd,bhkd->bhqk":
            queries.append(ops[0].data_ptr())
        return out

    def ln_spy(x, *a):
        norms.append(tuple(x.shape))
        return real_ln(x, *a)

    monkeypatch.setattr(torch, "einsum", spy)
    monkeypatch.setattr(PR, "_layer_norm", ln_spy)
    S, B, H, n, Dh = 8, 2, 4, 8, 16
    PR.ring_encode(pc, model, ids, mask, PR.build_sp_mesh(S, ["cpu"] * 4))
    assert set(shapes) == {(B, H, n, n), (B, H, n, Dh)}
    assert len(shapes) == 2 * S * S * pc.n_layers
    assert set(norms) == {(B, 2 * n, pc.d_model)}
    for layer in range(pc.n_layers):
        qs = queries[layer * S * S:(layer + 1) * S * S]
        cycle = qs[:S]
        assert len(set(cycle)) == S
        assert qs == cycle * S


def test_dryrun_over_eight_cpu_devices(capsys):
    from elasticsearch_tpu_torch.entry import dryrun

    dryrun(8, ["cpu"] * 8)
    out = capsys.readouterr().out
    assert "dryrun(n=8): mesh={'dp': 2, 'tp': 4} B=4" in out
    assert "over 8 mesh devices" in out
    assert "sp ring encode: mesh=(sp=8) over 8 mesh devices" in out
    assert "distributed search round: shards=8 over 8 mesh devices" in out
