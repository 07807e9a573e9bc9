"""The port's script engine (``search/scripting.py``) against the
reference's ``compile_script`` on the same numpy-made columns.

- Every operator (``+ - * / // % **``, the comparisons, unary minus) on
  f32 and int32 columns and Python scalars: the same dtype kind and the
  same values, exactly; ``**`` with an integer exponent exactly, with a
  float or column exponent (a transcendental pow) within rtol 1e-6.
- Every ``Math`` function within rtol 1e-6, on columns and on scalars
  (``Math.round`` rounds half to even in both).
- Ternaries (nested too, the reference's regression case), ``&&``,
  ``||`` and ``!``, ``_score``, ``params``, stored scripts by id with
  their versioning.
- Every disallowed construct, and the two sources the reference's
  translation cannot compile, raise the reference's ``ScriptException``
  message.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from elasticsearch_tpu.search import scripting as ref_scripting
from elasticsearch_tpu.utils import errors as ref_errors
from elasticsearch_tpu_torch.search import scripting
from elasticsearch_tpu_torch.utils import errors

N = 64


def _columns():
    rng = np.random.default_rng(0)
    f = (rng.standard_normal(N) * 40).astype(np.float32)
    g = (rng.random(N) * 9 + 0.5).astype(np.float32)
    i = rng.integers(-50, 50, N).astype(np.int32)
    j = rng.integers(1, 9, N).astype(np.int32)  # a non-zero divisor
    f[:4] = [0.0, -0.0, 2.5, -2.5]
    exists = rng.random(N) > 0.2
    return {"f": f, "g": g, "i": i, "j": j}, exists


COLS, EXISTS = _columns()


def _ref_run(src, params=None, score=None):
    def resolve(field):
        return ref_scripting._DocField(jnp.asarray(COLS[field]),
                                       jnp.asarray(EXISTS))
    cs = ref_scripting.compile_script(src)
    return cs.run(resolve, score=None if score is None else jnp.asarray(score),
                  params=params)


def _port_run(src, params=None, score=None):
    def resolve(field):
        return scripting._DocField(torch.from_numpy(COLS[field]),
                                   torch.from_numpy(EXISTS))
    cs = scripting.compile_script(src)
    return cs.run(resolve, score=None if score is None
                  else torch.from_numpy(score), params=params)


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def _both(src, params=None, score=None):
    ref = _ref_run(src, params, score)
    port = _port_run(src, params, score)
    scalar_ref = isinstance(ref, (bool, int, float))
    assert scalar_ref == isinstance(port, (bool, int, float)), \
        (src, type(ref), type(port))
    if scalar_ref:
        assert type(ref) is type(port), (src, ref, port)
    return _as_np(ref), _as_np(port)


def _kind(a):
    return "f" if a.dtype.kind == "f" else a.dtype.kind


OPERANDS = ["doc['f'].value", "doc['g'].value", "doc['i'].value",
            "doc['j'].value", "3", "2.5", "doc['f'].length",
            "doc['f'].empty"]
BINARY = ["+", "-", "*", "/", "//", "%", "**", "<", "<=", ">", ">=", "==",
          "!="]


def _cases():
    out = []
    for op in BINARY:
        for a in OPERANDS:
            for b in OPERANDS:
                if op in ("/", "//", "%") and b in ("doc['i'].value",
                                                     "doc['f'].length",
                                                     "doc['f'].empty"):
                    continue  # zero divisors: int division by 0 raises
                if op == "**" and b != "3":
                    continue  # test_power_matches_the_reference
                out.append(f"{a} {op} {b}")
    out += [f"-{a}" for a in OPERANDS] + ["7 // -2", "-7 % 3", "2 ** 10"]
    return out


@pytest.mark.parametrize("src", _cases())
def test_operator_matches_the_reference(src):
    try:
        _ref_run(src)
    except ref_errors.ScriptException:
        # jnp refuses it (a bool negated or subtracted from a bool)
        with pytest.raises(errors.ScriptException, match="runtime error"):
            _port_run(src)
        return
    ref, port = _both(src)
    assert ref.shape == port.shape, src
    assert _kind(ref) == _kind(port), (src, ref.dtype, port.dtype)
    if ref.dtype.kind == "f":
        assert ref.dtype.itemsize == port.dtype.itemsize, src
    np.testing.assert_array_equal(port, ref, err_msg=src)


POWERS = ["doc['f'].value ** 2", "doc['f'].value ** -2", "doc['i'].value ** 2",
          "doc['f'].empty ** 2",
          "doc['g'].value ** 5", "doc['g'].value ** 0", "doc['j'].value ** 4",
          "2 ** doc['j'].value", "3 ** doc['j'].value",
          "doc['f'].length ** 3", "doc['g'].value ** -1"]
#: a float or column exponent is a transcendental pow (XLA's and
#: torch's may differ in the last bit), held at Math's rtol
FLOAT_POWERS = ["doc['f'].value ** 2.5", "doc['i'].value ** 2.5",
                "doc['j'].value ** doc['g'].value", "2.5 ** doc['g'].value",
                "doc['g'].value ** doc['g'].value", "doc['g'].value ** 0.5",
                "doc['g'].value ** doc['j'].value"]


@pytest.mark.parametrize("src", POWERS)
def test_integer_power_matches_the_reference(src):
    """An integer exponent is exact: XLA's order of products."""
    ref, port = _both(src)
    assert _kind(ref) == _kind(port), (src, ref.dtype, port.dtype)
    np.testing.assert_array_equal(port, ref, err_msg=src)


@pytest.mark.parametrize("src", FLOAT_POWERS)
def test_float_power_matches_the_reference(src):
    ref, port = _both(src)
    assert _kind(ref) == _kind(port), (src, ref.dtype, port.dtype)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, err_msg=src)


MATH = ["Math.log(doc['g'].value)", "Math.log10(doc['g'].value)",
        "Math.log1p(doc['g'].value)", "Math.exp(doc['g'].value)",
        "Math.sqrt(doc['g'].value)", "Math.abs(doc['f'].value)",
        "Math.abs(doc['i'].value)", "Math.floor(doc['f'].value)",
        "Math.ceil(doc['f'].value)", "Math.floor(doc['i'].value)",
        "Math.min(doc['f'].value, doc['g'].value)",
        "Math.max(doc['f'].value, 3)", "Math.min(2.5, doc['i'].value)",
        "Math.pow(doc['g'].value, 2)", "Math.pow(doc['g'].value, 0.5)",
        "Math.pow(2, doc['j'].value)", "Math.sin(doc['f'].value)",
        "Math.cos(doc['f'].value)", "Math.tan(doc['g'].value)",
        "Math.round(doc['f'].value)", "Math.round(doc['f'].value / 2)",
        "Math.log(2)", "Math.sqrt(9)", "Math.abs(-3)", "Math.min(3, 4)",
        "Math.max(3, 4.5)", "Math.pow(2, 3)", "Math.pow(2, 0.5)",
        "Math.round(2.5)", "Math.round(3.5)", "Math.floor(7)",
        "Math.E * doc['g'].value", "Math.PI", "Math.log(doc['j'].length)",
        "Math.log10(doc['g'].value + 2)"]


@pytest.mark.parametrize("src", MATH)
def test_math_function_matches_the_reference(src):
    ref, port = _both(src)
    assert ref.shape == port.shape, src
    assert _kind(ref) == _kind(port), (src, ref.dtype, port.dtype)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0, err_msg=src)


def test_round_is_half_to_even():
    ref, port = _both("Math.round(doc['f'].value)")
    assert port[2] == 2.0 and port[3] == -2.0
    np.testing.assert_array_equal(port, ref)


TERNARIES = [
    "doc['f'].value > 10 ? 2.0 : doc['f'].value > 5 ? 1.0 : 0.5",
    "doc['f'].value > 0 ? doc['g'].value : -1",
    "doc['i'].value > 0 ? 2 : 1",
    "doc['f'].empty ? 0 : doc['f'].value",
    "(doc['f'].value > 0 && doc['g'].value < 5) ? 1 : 0",
    "doc['f'].value > 0 || doc['i'].value < 0",
    "doc['f'].value > 0 && !(doc['g'].value > 3)",
    "doc['f'].value > 0 && !doc['f'].empty",
    "true ? 3 : 4",
    "doc['g'].value > 5 ? doc['g'].value > 8 ? 3 : 2 : 1",
    "doc['f'].value != 0 ? 1.0 / doc['f'].value : 0.0",
    "1 < 2 < 3",
]
#: sources the reference's translation cannot compile (a leading ``!``
#: leaves an indent; a ternary in parentheses stays a ``?``): the port
#: raises the same error
NOT_COMPILED = ["!(doc['f'].value > 0)",
                "doc['g'].value > 5 ? (doc['g'].value > 8 ? 3 : 2) : 1"]


@pytest.mark.parametrize("src", NOT_COMPILED)
def test_translation_quirks_raise_as_the_reference(src):
    with pytest.raises(ref_errors.ScriptException) as r:
        ref_scripting.CompiledScript(src)
    with pytest.raises(errors.ScriptException) as p:
        scripting.CompiledScript(src)
    assert str(p.value) == str(r.value)


@pytest.mark.parametrize("src", TERNARIES)
def test_ternaries_and_boolean_operators(src):
    ref, port = _both(src)
    assert _kind(ref) == _kind(port), (src, ref.dtype, port.dtype)
    np.testing.assert_array_equal(port, ref, err_msg=src)


def test_nested_ternary_regression_case():
    """The reference's ``test_nested_ternary_script``, on the port."""
    cs = scripting.compile_script(
        "doc['p'].value > 10 ? 2.0 : doc['p'].value > 5 ? 1.0 : 0.5")
    vals = torch.tensor([20.0, 7.0, 1.0])
    out = cs.run(lambda f: scripting._DocField(vals, torch.ones(3,
                                                                dtype=bool)))
    assert out.tolist() == [2.0, 1.0, 0.5]


def test_score_and_params():
    score = (np.arange(N, dtype=np.float32) / 7).astype(np.float32)
    params = {"factor": 1.1, "cut": 3, "names": [2, 4]}
    for src in ("_score * params.factor + doc['g'].value",
                "doc['f'].value > params.cut ? _score : 0",
                "params['factor'] * params.names[1]",
                "_score + 1",
                "Math.log(_score + 1) * params.get('factor')"):
        ref, port = _both(src, params=params, score=score)
        np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0,
                                   err_msg=src)
    # the default _score is an f32 zero
    ref, port = _both("_score + 1")
    assert port.dtype == np.float32 and port == ref == 1.0


def test_missing_param_raises_the_reference_message():
    with pytest.raises(ref_errors.ScriptException) as r:
        _ref_run("params.nope + 1", params={})
    with pytest.raises(errors.ScriptException) as p:
        _port_run("params.nope + 1", params={})
    assert str(p.value) == str(r.value)


DISALLOWED = [
    "__import__('os')", "doc.__class__", "[x for x in params.y]",
    "lambda: 1", "open('f')", "foo + 1", "params.__dict__",
    "doc['f'].value.__class__", "print(1)", "{'a': 1}", "(1, 2)",
    "Math.sqrt.__call__(4)", "doc['f'].value.sum()", "len(params)",
    "x = 1", "a if b", "params.x(", "doc['f'].value; 1 +",
    "import os", "f'{1}'", "globals()", "doc['f'].value[0:2]",
]


@pytest.mark.parametrize("src", DISALLOWED)
def test_disallowed_construct_raises_the_reference_message(src):
    with pytest.raises(ref_errors.ScriptException) as r:
        ref_scripting.CompiledScript(src)
    with pytest.raises(errors.ScriptException) as p:
        scripting.CompiledScript(src)
    assert str(p.value) == str(r.value), src


def test_builtins_are_empty_at_run_time():
    """The script's own frame has no builtins: a name the whitelist lets
    through only when bound (an extra var) resolves against the env."""
    cs = scripting.compile_script("len + 1", extra_vars=("len",))
    assert cs.run(lambda f: None, params={"len": 2}) == 3
    with pytest.raises(errors.ScriptException, match="runtime error"):
        cs.run(lambda f: None, params={})


def test_stored_scripts_and_their_versions():
    """store/get/version/delete on both registries: the same versions,
    the same conflicts (class and message)."""
    steps = [
        ("store", ("painless", "s1", "doc['g'].value * 2"), {}),
        ("store", ("painless", "s1", "doc['g'].value * 3"), {}),
        ("store", ("painless", "s1", "doc['g'].value * 4"),
         {"version": 2}),
        ("store", ("painless", "s1", "doc['g'].value * 5"),
         {"version": 2}),
        ("store", ("painless", "s2", "1"), {"version": 7,
                                             "version_type": "external"}),
        ("store", ("painless", "s2", "2"), {"version": 7,
                                             "version_type": "external"}),
        ("store", ("painless", "s2", "3"), {"version": 7,
                                             "version_type": "external_gte"}),
        ("store", ("painless", "s2", "4"), {"version": 3,
                                             "version_type": "force"}),
        ("store", ("painless", "s3", "1"), {"version_type": "bogus"}),
        ("store", ("painless", "s4", "doc.__class__"), {}),
        ("delete", ("painless", "s1"), {"version": 1}),
        ("delete", ("painless", "s2"), {"version": 1,
                                        "version_type": "external"}),
        ("delete", ("painless", "s2"), {"version": 9,
                                        "version_type": "external"}),
        ("delete", ("painless", "s9"), {}),
    ]

    def run(mod):
        out = []
        for op, args, kw in steps:
            args = (args[0], "torch-parity-" + args[1]) + args[2:]
            try:
                if op == "store":
                    got = mod.store_script(*args, **kw)
                else:
                    got = mod.delete_stored_script(*args, **kw)
                out.append(("ok", got, mod.stored_script_version(*args[:2]),
                            mod.get_stored_script(*args[:2])))
            except Exception as e:  # noqa: BLE001 - compared by name
                out.append((type(e).__name__, str(e)))
        return out

    assert run(scripting) == run(ref_scripting)


def test_script_source_resolves_ids():
    for mod in (scripting, ref_scripting):
        mod.store_script("painless", "torch-parity-src", "doc['g'].value")
    spec = {"id": "torch-parity-src", "params": {"a": 1}}
    assert scripting.script_source(spec) == \
        ref_scripting.script_source(spec) == "doc['g'].value"
    assert scripting.script_source({"inline": "1"}) == "1"
    assert scripting.script_source({"source": "2"}) == "2"
    for bad in ({"id": "torch-parity-nothing"}, {"lang": "x"}, 3):
        with pytest.raises(ref_errors.ScriptException) as r:
            ref_scripting.script_source(bad)
        with pytest.raises(errors.ScriptException) as p:
            scripting.script_source(bad)
        assert str(p.value) == str(r.value)


def test_extra_vars_bind_params():
    src = "bar * 2 + doc['g'].value"
    ref = ref_scripting.compile_script(src, extra_vars=("bar",)).run(
        lambda f: ref_scripting._DocField(jnp.asarray(COLS[f]),
                                          jnp.asarray(EXISTS)),
        params={"bar": 3})
    port = scripting.compile_script(src, extra_vars=("bar",)).run(
        lambda f: scripting._DocField(torch.from_numpy(COLS[f]),
                                      torch.from_numpy(EXISTS)),
        params={"bar": 3})
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
