"""The port's dual encoder against the reference's (models/dual_encoder.py).

Small configs (vocab 512, d_model 64, 4 heads, 2 layers, d_ff 128, embed
32, max_len 32) with the reference's seeded ``init_params`` carried
across by ``params_from_flax``. The bars, each stated where it is held:

- embeddings at f32 within atol 1e-5 of ``model.apply``; at bf16 cosine
  > 0.999 and atol 3e-2 (the reference's own ring-vs-dense bar);
- gradients of the symmetric InfoNCE loss at f32 within rtol 1e-4 of
  ``jax.value_and_grad``, with atol 1e-5 of each tensor's largest entry
  (entries near zero differ by the order of the sums, ~1e-7 absolute);
- three AdamW steps against optax: losses within rtol 1e-4, parameters
  within rtol 1e-4 (atol 1e-5 of each tensor's largest entry) wherever
  the gradient stayed clear of the rounding floor;
- the tokenizer's ids and mask equal; the checkpoint round trip bit for
  bit; the C34 mesh step within the f32 bars, ``training_mesh(1)`` bit
  for bit.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from elasticsearch_tpu.models import dual_encoder as R
from elasticsearch_tpu.parallel import mesh as rmesh
from elasticsearch_tpu_torch.models import dual_encoder as P
from elasticsearch_tpu_torch.parallel.mesh import training_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=512, max_len=32, d_model=64, n_heads=4, n_layers=2,
             d_ff=128, embed_dim=32)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dt="f32", **kw):
    j, t = DTYPES[dt]
    args = dict(SMALL, **kw)
    return R.DualEncoderConfig(dtype=j, **args), \
        P.DualEncoderConfig(dtype=t, **args)


def _pair(dt="f32", seed=3, **kw):
    """(reference config, its params, port config, the port's model with
    the same weights on the CPU)."""
    rc, pc = _cfgs(dt, **kw)
    params = R.init_params(rc, seed=seed)
    model = P.build_model(pc)
    model.load_state_dict(P.params_from_flax(params, pc))
    return rc, params, pc, model


def _batch(rng, B, L, vocab=512, ragged=True):
    ids = rng.integers(1, vocab, size=(B, L)).astype(np.int32)
    mask = np.ones((B, L), np.float32)
    if ragged:
        for i in range(B):
            n = int(rng.integers(1, L + 1))
            ids[i, n:] = 0
            mask[i, n:] = 0.0
    return ids, mask


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _close_per_tensor(got: dict, ref: dict, rtol: float, scale_atol: float,
                      skip=()):
    """Each tensor within rtol, with atol ``scale_atol`` times its largest
    reference entry."""
    assert sorted(got) == sorted(ref)
    for k in ref:
        if any(s in k for s in skip):
            continue
        a = ref[k]
        np.testing.assert_allclose(
            got[k], a, rtol=rtol,
            atol=scale_atol * float(np.abs(a).max(initial=0.0)), err_msg=k)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def test_encode_matches_flax_f32():
    """f32: within atol 1e-5 of ``model.apply``, ragged masks and a row
    with no token included."""
    rc, params, _pc, model = _pair("f32")
    rng = np.random.default_rng(0)
    ids, mask = _batch(rng, 8, 32)
    mask[3] = 0.0
    ref = np.asarray(R.build_model(rc).apply(params, ids, mask))
    got = P.encode(model, ids, mask).numpy()
    assert got.shape == (8, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_encode_matches_flax_bf16():
    """bf16 (the default dtype): cosine > 0.999 and atol 3e-2."""
    rc, params, _pc, model = _pair("bf16")
    rng = np.random.default_rng(1)
    ids, mask = _batch(rng, 16, 32)
    ref = np.asarray(R.build_model(rc).apply(params, ids, mask))
    got = P.encode(model, ids, mask).numpy()
    cos = np.sum(ref * got, axis=-1)
    assert np.all(cos > 0.999), cos
    np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-3)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_encode_matches_flax_when_sqrt_depth_is_inexact(dt):
    """Two heads of 32: the query scale sqrt(32) rounds in the compute
    dtype, as flax rounds it (f32 atol 1e-5; bf16 cosine > 0.999 and
    atol 3e-2)."""
    rc, params, _pc, model = _pair(dt, n_heads=2)
    rng = np.random.default_rng(11)
    ids, mask = _batch(rng, 8, 32)
    ref = np.asarray(R.build_model(rc).apply(params, ids, mask))
    got = P.encode(model, ids, mask).numpy()
    if dt == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        assert np.all(np.sum(ref * got, axis=-1) > 0.999)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-2)


@pytest.mark.parametrize("dt,atol", [("f32", 1e-6), ("bf16", 1e-2)])
def test_padding_does_not_change_embedding(dt, atol):
    """Garbage under the mask changes nothing (the reference's test,
    atol 1e-2 at bf16; 1e-6 at f32), and the reference agrees on the
    garbage batch (1e-5 at f32; cosine > 0.999 at bf16)."""
    rc, params, _pc, model = _pair(dt)
    rng = np.random.default_rng(2)
    ids, mask = _batch(rng, 4, 32, ragged=False)
    mask[:, 20:] = 0.0
    z1 = P.encode(model, ids, mask).numpy()
    ids2 = ids.copy()
    ids2[:, 20:] = 77
    z2 = P.encode(model, ids2, mask).numpy()
    np.testing.assert_allclose(z1, z2, rtol=0, atol=atol)
    ref = np.asarray(R.build_model(rc).apply(params, ids2, mask))
    if dt == "f32":
        np.testing.assert_allclose(z2, ref, rtol=0, atol=1e-5)
    else:
        assert np.all(np.sum(ref * z2, axis=-1) > 0.999)


def test_over_max_len_is_refused():
    _rc, _params, _pc, model = _pair("f32")
    ids = np.ones((1, 33), np.int32)
    with pytest.raises(ValueError, match="exceeds cfg.max_len"):
        P.encode(model, ids, np.ones((1, 33), np.float32))


def test_tokenizer_ids_equal():
    """crc32 buckets: the same ids and mask for the same texts, long,
    upper-case, unicode and empty ones included."""
    rc, pc = _cfgs()
    rng = np.random.default_rng(4)
    words = ["fox", "Dog", "RIVER", "naïve", "東京", "t123", "a-b", "x"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(0, 50))))
             for _ in range(64)] + ["", "   ", "one"]
    for max_len in (None, 8, 64):
        ri, rm = R.SimpleTokenizer(rc)(texts, max_len=max_len)
        pi, pm = P.SimpleTokenizer(pc)(texts, max_len=max_len)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pm, rm)
        assert pi.dtype == ri.dtype and pm.dtype == rm.dtype


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_round_trip_through_the_flax_layout():
    """``params_to_flax(params_from_flax(tree))`` is the tree, bit for
    bit, every leaf's shape included."""
    _rc, params, _pc, model = _pair("f32")
    ref = dict(_flat(params["params"]))
    got = dict(_flat(P.params_to_flax(model)["params"]))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_init_params_uses_flaxs_distributions():
    """Same seed, same weights; per tensor the std of the reference's
    init within 10% (kernels: truncated lecun normal; embeddings: normal
    of variance 1/d_model), zero biases, unit scales, and kernels inside
    the truncation at two deviations."""
    rc, pc = _cfgs(d_model=128, d_ff=256)
    a = P.init_params(pc, seed=5, device="cpu")
    b = P.init_params(pc, seed=5, device="cpu")
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    ref = dict(_flat(R.init_params(rc, seed=5)["params"]))
    got = dict(_flat(P.params_to_flax(a)["params"]))
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, k
        if k.endswith("bias"):
            assert not g.any(), k
        elif k.endswith("scale"):
            assert (g == 1).all(), k
        else:
            assert abs(g.std() / r.std() - 1) < 0.1, (k, g.std(), r.std())
            if k.endswith("kernel"):
                assert np.abs(g).max() <= np.abs(r).max() * 1.01, k


def test_init_params_without_a_device_raises_when_no_card(monkeypatch):
    _rc, pc = _cfgs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.init_params(pc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training_mesh(2)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _pairs(rng, B):
    q, qm = _batch(rng, B, 32)
    d, dm = _batch(rng, B, 32)
    return q, qm, d, dm


def test_gradients_match_jax_f32():
    """The loss within rtol 1e-6 and every gradient within rtol 1e-4
    (atol 1e-5 of the tensor's largest entry). The attention key bias's
    gradient is zero in exact arithmetic (a bias on every key shifts a
    query's scores by one constant, which the softmax drops): in both
    packages it is rounding noise under 1e-6."""
    rc, params, pc, model = _pair("f32")
    rng = np.random.default_rng(5)
    q, qm, d, dm = _pairs(rng, 8)
    rmodel = R.build_model(rc)

    def loss_fn(p):
        return R.contrastive_loss(rmodel.apply(p, q, qm),
                                  rmodel.apply(p, d, dm))

    rloss, rgrad = jax.value_and_grad(loss_fn)(params)
    loss = P.contrastive_loss(model(torch.as_tensor(q).long(),
                                    torch.as_tensor(qm)),
                              model(torch.as_tensor(d).long(),
                                    torch.as_tensor(dm)))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(rloss), rtol=1e-6)
    grads = P.build_model(pc)
    grads.load_state_dict({n: p.grad for n, p in model.named_parameters()})
    got = dict(_flat(P.params_to_flax(grads)["params"]))
    ref = dict(_flat(rgrad["params"]))
    _close_per_tensor(got, ref, rtol=1e-4, scale_atol=1e-5,
                      skip=("attn/key/bias",))
    for k in ref:
        if "attn/key/bias" in k:
            assert np.abs(ref[k]).max() < 1e-6 and np.abs(got[k]).max() < 1e-6


def test_three_adamw_steps_match_optax():
    """``make_train_step`` against the reference's jitted optax step,
    three times on three batches: the losses within rtol 1e-4, then the
    parameters through ``params_to_flax`` within rtol 1e-4 (atol 1e-5 of
    the tensor's largest entry). Adam divides each gradient by its own
    root mean square, so an entry whose gradient sits near the rounding
    floor (nonzero and under 1e-5 in some step, where the gradients of
    the two packages differ by ~1e-7 absolute: the key biases, whose
    gradient is zero in exact arithmetic, and a few embedding entries)
    takes a step set by that noise; those entries are held by the losses
    only, and they are under 1% of the parameters."""
    rc, params, pc, model = _pair("f32")
    lr = 1e-3
    rstep, tx = R.make_train_step(rc, lr=lr)
    ropt = tx.init(params)
    rmodel = R.build_model(rc)
    step, _opt = P.make_train_step(pc, lr=lr, model=model)
    assert step.model is model
    rng = np.random.default_rng(6)
    rparams = jax.tree_util.tree_map(jnp.array, params)
    noisy = {k: np.zeros(v.shape, bool) for k, v in _flat(params["params"])}
    for _ in range(3):
        q, qm, d, dm = batch = _pairs(rng, 8)
        g = jax.grad(lambda p: R.contrastive_loss(
            rmodel.apply(p, q, qm), rmodel.apply(p, d, dm)))(rparams)
        for k, a in _flat(g["params"]):
            noisy[k] |= (a != 0) & (np.abs(a) < 1e-5)
        rparams, ropt, rloss = rstep(rparams, ropt, batch)
        loss = step(*batch)
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-4)
    got = dict(_flat(P.params_to_flax(model)["params"]))
    ref = dict(_flat(rparams["params"]))
    for k, a in ref.items():
        ok = ~noisy[k]
        np.testing.assert_allclose(
            got[k][ok], a[ok], rtol=1e-4,
            atol=1e-5 * float(np.abs(a).max()), err_msg=k)
        if "attn/key/bias" in k:
            assert noisy[k].all(), k
    n_noisy = sum(int(v.sum()) for v in noisy.values())
    assert n_noisy < 0.01 * sum(v.size for v in noisy.values()), n_noisy


def test_optimizer_is_optax_adamw():
    """betas 0.9/0.999, eps 1e-8, decay 0.01 on every parameter."""
    _rc, _params, _pc, model = _pair("f32")
    opt = P.make_optimizer(model.parameters())
    (group,) = opt.param_groups
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-3, (0.9, 0.999), 1e-8, 0.01)
    assert len(group["params"]) == len(list(model.parameters()))


def test_train_step_reduces_loss():
    """The reference's test at bf16: five steps on one batch of
    identical pairs, lr 3e-3, the loss falls."""
    _rc, pc = _cfgs("bf16", vocab_size=128, max_len=12, d_model=32,
                    n_heads=2, n_layers=1, d_ff=64, embed_dim=16)
    step, _opt = P.make_train_step(pc, lr=3e-3, device="cpu")
    rng = np.random.default_rng(2)
    q, qm = _batch(rng, 8, 12, vocab=128, ragged=False)
    losses = [float(step(q, qm, q.copy(), qm)) for _ in range(5)]
    assert losses[-1] < losses[0], losses


# ---------------------------------------------------------------------------
# meshes and sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_training_mesh_shapes_equal_the_reference(n, eight_devices):
    assert training_mesh(n, device="cpu").shape == dict(
        rmesh.training_mesh(n).shape)


@pytest.mark.parametrize("n,tp", [(1, None), (2, None), (4, None),
                                  (8, None), (6, None), (8, 8), (4, 1)])
def test_tp_specs_equal_param_shardings(n, tp, eight_devices):
    """Per parameter the axis of each dim, 'tp' or replicated, as the
    reference's ``param_shardings`` PartitionSpecs; an undivided dim
    falls back to replication (d_model 64 over tp 8 divides, 4 heads
    over tp 8 do not)."""
    rc, params, _pc, model = _pair("f32")
    rm = rmesh.training_mesh(n, tp=tp)
    ref = {"/".join(str(getattr(k, "key", k)) for k in path)[len("params/"):]:
           tuple(s.spec) + (None,) * (leaf.ndim - len(s.spec))
           for (path, s), leaf in zip(
               jax.tree_util.tree_flatten_with_path(
                   R.param_shardings(rm, params))[0],
               jax.tree_util.tree_leaves(params))}
    got = P.param_shardings(training_mesh(n, device="cpu", tp=tp), model)
    assert got == ref
    assert P.batch_sharding(training_mesh(n, device="cpu")) == \
        tuple(R.batch_sharding(rm).spec)
    if rm.shape["tp"] > 1:
        assert any("tp" in s for s in got.values())


def test_training_mesh_refuses_a_tp_that_does_not_divide():
    with pytest.raises(ValueError, match="must divide"):
        training_mesh(6, device="cpu", tp=4)


def test_c34_a_step_under_training_mesh_8_equals_mesh_1():
    """C34, closed by A1: ``training_mesh(8)`` (dp 2, tp 4, every
    position on the CPU) runs the sharded step, whose row-parallel sums
    and gradient sums add in another order than one device's: two f32
    steps equal ``training_mesh(1)``'s within the f32 bars (losses rtol
    1e-4; parameters rtol 1e-4, atol 1e-5 of each tensor's largest
    entry, where the gradient stayed clear of the rounding floor).
    ``training_mesh(1)`` is the step without a mesh, bit for bit; a
    batch that does not divide dp is refused as the reference's sharded
    batch is."""
    _rc, pc = _cfgs("f32")
    rng = np.random.default_rng(7)
    batch = _pairs(rng, 4)
    out = []
    for mesh in (training_mesh(8, device="cpu"),
                 training_mesh(1, device="cpu"), None):
        step, _opt = P.make_train_step(
            pc, model=P.init_params(pc, seed=11, device="cpu"), mesh=mesh)
        losses, noisy = [], None
        for _ in range(2):
            losses.append(step(*batch))
            if mesh is None:
                g = {n: p.grad for n, p in step.model.named_parameters()}
                step_noisy = {n: (x != 0) & (x.abs() < 1e-5)
                              for n, x in g.items()}
                noisy = step_noisy if noisy is None else {
                    n: noisy[n] | step_noisy[n] for n in noisy}
        out.append((losses, step.model.state_dict(), noisy))
    (l8, sd8, _), (l1, sd1, _), (l0, sd0, noisy) = out
    np.testing.assert_allclose([float(x) for x in l8],
                               [float(x) for x in l1], rtol=1e-4)
    for k, a in sd1.items():
        ok = ~noisy[k]
        np.testing.assert_allclose(
            sd8[k][ok].numpy(), a[ok].numpy(), rtol=1e-4,
            atol=1e-5 * float(a.abs().max()), err_msg=k)
    assert sum(int(v.sum()) for v in noisy.values()) < 0.01 * sum(
        v.numel() for v in noisy.values())
    assert all(torch.equal(a, b) for a, b in zip(l1, l0))
    assert all(torch.equal(sd1[k], sd0[k]) for k in sd0)
    step, _opt = P.make_train_step(pc, mesh=training_mesh(8, device="cpu"))
    with pytest.raises(ValueError, match="does not divide dp"):
        step(*_pairs(rng, 3))
    with pytest.raises(ValueError, match="pass no device"):
        P.make_train_step(pc, mesh=training_mesh(8, device="cpu"),
                          device="cpu")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_bit_equal(tmp_path):
    """Params, step, optimizer state and config through one torch file:
    params bit-equal, embeddings identical, and a step after the load
    equals the step the saved run takes next, bit for bit."""
    _rc, pc = _cfgs("bf16")
    rng = np.random.default_rng(8)
    batch = _pairs(rng, 8)
    step, opt = P.make_train_step(pc, device="cpu")
    step(*batch)
    path = str(tmp_path / "ckpt" / "model.pt")
    P.save_checkpoint(path, step.model, opt, step=1, cfg=pc)
    got = P.load_checkpoint(path)
    assert got["step"] == 1
    cfg2 = P.config_from_dict(got["config"])
    assert cfg2 == pc and got["config"]["dtype"] == "bfloat16"
    model2 = P.build_model(cfg2)
    model2.load_state_dict(got["params"])
    for k, v in step.model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k
    ids, mask = _batch(rng, 4, 32)
    assert torch.equal(P.encode(model2, ids, mask),
                       P.encode(step.model, ids, mask))
    step2, opt2 = P.make_train_step(cfg2, model=model2)
    opt2.load_state_dict(got["opt_state"])
    assert torch.equal(step2(*batch), step(*batch))
    for k, v in step.model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k


def test_c33_a_reference_checkpoint_comes_across_in_process(tmp_path):
    """C33: the port's checkpoint is a ``torch.save`` file, which
    ``torch.load(weights_only=True)`` reads; the reference's is an orbax
    directory, which it does not. A reference checkpoint comes across in
    process: its ``load_checkpoint`` then ``params_from_flax``, whose
    embeddings equal the reference's at f32 within atol 1e-5. The
    reference refuses to store a config with its dtype set; the port
    keeps the dtype's name (previous test)."""
    rc, pc = _cfgs("f32")
    params = R.init_params(rc, seed=9)
    rpath = str(tmp_path / "ref")
    # the reference cannot store a config whose dtype is set (orbax has
    # no handler for a jnp dtype); the port stores the dtype's name
    with pytest.raises(ValueError, match="TypeHandler lookup failed"):
        R.save_checkpoint(str(tmp_path / "refused"), params, cfg=rc)
    R.save_checkpoint(rpath, params, step=4,
                      cfg=dataclasses.replace(rc, dtype=None))
    assert os.path.isdir(rpath)
    with pytest.raises(Exception):
        torch.load(rpath, weights_only=True)
    restored = R.load_checkpoint(rpath)
    assert restored["step"] == 4
    model = P.build_model(pc)
    model.load_state_dict(P.params_from_flax(restored["params"], pc))
    rng = np.random.default_rng(9)
    ids, mask = _batch(rng, 4, 32)
    ref = np.asarray(R.build_model(rc).apply(params, ids, mask))
    np.testing.assert_allclose(P.encode(model, ids, mask).numpy(), ref,
                               rtol=0, atol=1e-5)
    ppath = str(tmp_path / "port.pt")
    P.save_checkpoint(ppath, model, step=4, cfg=pc)
    assert os.path.isfile(ppath)
    assert torch.load(ppath, weights_only=True)["step"] == 4


# ---------------------------------------------------------------------------
# first touches, entry points, imports
# ---------------------------------------------------------------------------

def test_first_dispatches_count_as_first_touches():
    """encode, the train step and the ring encode record first-dispatch
    keys as the search programs do: the first call of a shape is one
    first touch on this thread, the next none (C32)."""
    from elasticsearch_tpu_torch.models.ring_encoder import (build_sp_mesh,
                                                             ring_encode)
    from elasticsearch_tpu_torch.tracing import retrace

    _rc, _params, pc, model = _pair("f32")
    retrace.reset()
    rng = np.random.default_rng(10)
    ids, mask = _batch(rng, 3, 32)
    step, _opt = P.make_train_step(pc, model=model)
    mesh = build_sp_mesh(4, device="cpu")
    calls = [lambda: P.encode(model, ids, mask),
             lambda: step(ids, mask, ids, mask),
             lambda: ring_encode(pc, model, ids, mask, mesh)]
    for fn in calls:
        for want in (1, 0):
            snap = retrace.snapshot()
            fn()
            assert retrace.traces_since(snap) == want


def test_entry_on_the_cpu():
    from elasticsearch_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    z = fn(*args)
    assert z.shape == (8, 32) and torch.isfinite(z).all()
    np.testing.assert_allclose(torch.linalg.norm(z, dim=1).numpy(), 1.0,
                               atol=1e-3)


def test_dryrun_2_on_the_cpu(capsys):
    from elasticsearch_tpu_torch.entry import dryrun

    dryrun(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun(n=2): mesh={'dp': 1, 'tp': 2} B=2" in out
    assert "sp ring encode: mesh=(sp=2)" in out
    assert "distributed search round: shards=2" in out


def test_entry_without_a_device_raises_when_no_card(monkeypatch):
    from elasticsearch_tpu_torch.entry import dryrun, entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun(2)


def test_models_load_no_jax_flax_optax_or_orbax():
    """In a fresh interpreter: the models, the ring encoder and the entry
    points run without the JAX stack or the JAX package."""
    probe = (
        "import sys\n"
        "from elasticsearch_tpu_torch.entry import dryrun, entry\n"
        "from elasticsearch_tpu_torch.models import ring_encoder\n"
        "fn, args = entry(device='cpu'); fn(*args)\n"
        "dryrun(2, device='cpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in (\n"
        "    'jax', 'jaxlib', 'flax', 'optax', 'orbax', 'elasticsearch_tpu'))\n"
        "print('LOADED', bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout, out.stdout
