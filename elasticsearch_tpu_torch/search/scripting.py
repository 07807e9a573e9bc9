"""Script engine: a safe expression DSL compiled to tensor ops.

Port of elasticsearch_tpu/search/scripting.py (reference:
org/elasticsearch/script/ScriptService.java). Scripts are the
reference's "painless-lite" expression language:

    doc['price'].value * params.factor + Math.log(_score + 1)
    doc['ts'].value > params.cutoff ? 2.0 : 0.5

Compilation is the reference's: the source is translated (``&&`` →
``and``, ``?:`` → a conditional, ``true`` → ``True``), parsed with
``ast.parse``, checked against the same node whitelist (Math and params
calls only, no ``_`` attributes, a fixed set of names, no builtins), and
ternaries and boolean operators are rewritten to elementwise forms. It
evaluates over the segment's tensors on its device, so one run yields a
value for every doc.

The types follow the reference's JAX arithmetic with 64-bit types off:
every column a script reads is f32 (keyword ordinals and field lengths
too), ``.length`` is int32, and a Python scalar a ``Math`` function or a
ternary meets becomes a 0-d tensor on the script's device, int32 for an
int and f32 for a float, as ``jnp`` makes it. The functions that
``jnp`` promotes to a float (log, exp, sqrt, the trig functions) take an
integer argument as f32. Every operator runs through a function of this
module (``_Rewriter``): there the torch forms of ``/ // % **`` are made
to round as jnp's do, and torch's own imports see the module's builtins
rather than the script's empty ones. A script that touches no
``doc`` and calls nothing returns a Python scalar; its callers turn it
into a full column.
"""
from __future__ import annotations

import ast
import re
from typing import Any, Dict, Optional

import torch

from elasticsearch_tpu_torch.utils.errors import ScriptException

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.IfExp, ast.Call, ast.Attribute, ast.Subscript, ast.Name,
    ast.Constant, ast.Load, ast.Add, ast.Sub, ast.Mult, ast.Div,
    ast.FloorDiv, ast.Mod, ast.Pow, ast.USub, ast.UAdd, ast.Not,
    ast.And, ast.Or, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
)


def _tensor(x, device):
    """A tensor as it is; a Python scalar as the 0-d tensor ``jnp`` makes
    of it (bool, int32 or f32) on ``device``, filled there (no copy)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return torch.full((), x, dtype=torch.bool, device=device)
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int32, device=device)
    return torch.full((), float(x), dtype=torch.float32, device=device)


def _inexact(x, device):
    """``_tensor``, an integer or bool tensor cast to f32 (jnp's promotion
    of a float function's argument)."""
    t = _tensor(x, device)
    return t if t.is_floating_point() else t.to(torch.float32)


class _Math:
    """The ``Math`` table: the reference's jnp functions on tensors."""

    E = 2.718281828459045
    PI = 3.141592653589793

    def __init__(self, device):
        d = device
        un = {"log": torch.log, "log10": torch.log10, "log1p": torch.log1p,
              "exp": torch.exp, "sqrt": torch.sqrt, "sin": torch.sin,
              "cos": torch.cos, "tan": torch.tan}
        fns = {name: (lambda x, f=f: f(_inexact(x, d)))
               for name, f in un.items()}
        # an integer stays itself; round is half to even, as jnp.round
        for name, f in (("abs", torch.abs), ("floor", torch.floor),
                        ("ceil", torch.ceil), ("round", torch.round)):
            fns[name] = lambda x, f=f: f(_tensor(x, d))
        fns["min"] = lambda a, b: torch.minimum(_tensor(a, d), _tensor(b, d))
        fns["max"] = lambda a, b: torch.maximum(_tensor(a, d), _tensor(b, d))
        fns["pow"] = lambda a, b: _pow(a, b, d)
        self._fns = fns

    def __getattr__(self, name):
        try:
            return self.__dict__["_fns"][name]
        except KeyError:
            raise ScriptException(f"unknown Math function [{name}]")


def _operands(a, b, device=None):
    """Both operands as tensors on the device of the tensor among them
    (``device`` when neither is one), with jnp's promotion: a Python
    scalar takes the tensor's kind where that is as wide (an int beside
    an integer tensor, a float beside a float one)."""
    if device is None:
        t = a if isinstance(a, torch.Tensor) else b
        device = t.device if isinstance(t, torch.Tensor) else None

    def conv(x, other):
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(other, torch.Tensor) and not isinstance(x, bool) \
                and other.dtype != torch.bool \
                and (isinstance(x, int) or other.is_floating_point()):
            return torch.full((), x, dtype=other.dtype, device=device)
        return _tensor(x, device)

    return conv(a, b), conv(b, a)


def _both_scalars(a, b) -> bool:
    return not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor)


def _round_away(x):
    """Round half away from zero (lax.round's default): trunc, then one
    step where the exact fraction reaches a half."""
    t = torch.trunc(x)
    return t + torch.where(torch.abs(x - t) >= 0.5, torch.sign(x), 0.0)


def _div(a, b):
    """``/``: jnp.true_divide, f32 for integer operands."""
    if _both_scalars(a, b):
        return a / b
    a, b = _operands(a, b)
    if not a.is_floating_point():
        a = a.to(torch.float32)
    if not b.is_floating_point():
        b = b.to(torch.float32)
    return torch.div(a, b)


def _promote(a, b):
    a, b = _operands(a, b)
    if a.is_floating_point() != b.is_floating_point() \
            or a.dtype == torch.bool or b.dtype == torch.bool:
        dt = torch.promote_types(a.dtype, b.dtype)
        if dt == torch.bool:
            dt = torch.int32
        a, b = a.to(dt), b.to(dt)
    return a, b


def _floordiv(a, b):
    """``//``: jnp.floor_divide. Integers floor; floats take CPython's
    float_divmod (fmod, the adjusted quotient, rounded half away)."""
    if _both_scalars(a, b):
        return a // b
    a, b = _promote(a, b)
    if not a.is_floating_point():
        return torch.floor_divide(a, b)
    mod = torch.fmod(a, b)
    div = torch.div(a - mod, b)
    ind = (mod != 0) & (torch.sign(b) != torch.sign(mod))
    div = torch.where(ind, div - 1, div)
    return _round_away(div)


def _mod(a, b):
    """``%``: jnp.remainder, the truncated remainder moved to the
    divisor's sign."""
    if _both_scalars(a, b):
        return a % b
    a, b = _promote(a, b)
    if not a.is_floating_point():
        b = torch.where(b == 0, torch.ones_like(b), b)
    trunc = torch.fmod(a, b)
    plus = ((trunc < 0) != (b < 0)) & (trunc != 0)
    return torch.where(plus, trunc + b, trunc)


def _integer_pow(x, y: int):
    """lax.integer_pow: binary exponentiation in XLA's order of
    products; a negative power is the reciprocal."""
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if y == 0:
        return torch.ones_like(x)
    recip = y < 0
    y = -y if recip else y
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return torch.div(torch.ones_like(acc), acc) if recip else acc


def _pow(a, b, device=None):
    """``**`` and Math.pow: jnp.power. A Python int exponent of a tensor
    is an integer power; anything else is pow (a transcendental for a
    float exponent, which may differ from XLA's in the last bits)."""
    if isinstance(a, torch.Tensor) and isinstance(b, int) \
            and not isinstance(b, bool):
        return _integer_pow(a, b)
    if _both_scalars(a, b) and device is None:
        return a ** b
    return torch.pow(*_promote(*_operands(a, b, device)))


def _where_fn(device):
    def where(c, a, b):
        c = _tensor(c, device)
        if c.dtype != torch.bool:
            c = c != 0
        return torch.where(c, _tensor(a, device), _tensor(b, device))
    return where


class _DocField:
    """doc['f'] handle: .value is the per-doc column; .empty is the missing mask."""

    def __init__(self, values, exists):
        self.value = values
        self.empty = ~exists
        self.length = exists.to(torch.int32)


class _Doc:
    def __init__(self, resolver):
        self._resolver = resolver

    def __getitem__(self, field):
        return self._resolver(field)


class _Params:
    def __init__(self, d: Dict[str, Any]):
        self._d = d

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._d[name]
        except KeyError:
            raise ScriptException(f"missing script param [{name}]")

    def __getitem__(self, name):
        return getattr(self, name)

    def get(self, name, default=None):
        return self._d.get(name, default)


def _split_ternary(s: str):
    """Find the first top-level `?` and its matching `:` (Java ternaries are
    right-associative; nested ternaries in the then/else branches handled by
    recursion). Returns (cond, then, else) or None."""
    depth = 0
    q_at = -1
    for i, ch in enumerate(s):
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "?" and depth == 0:
            q_at = i
            break
    if q_at < 0:
        return None
    nested = 0
    depth = 0
    for j in range(q_at + 1, len(s)):
        ch = s[j]
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "?" and depth == 0:
            nested += 1
        elif ch == ":" and depth == 0:
            if nested == 0:
                return s[:q_at], s[q_at + 1: j], s[j + 1:]
            nested -= 1
    return None


def _rewrite_ternaries(s: str) -> str:
    parts = _split_ternary(s)
    if parts is None:
        return s
    cond, then, other = parts
    return (
        f"(({_rewrite_ternaries(then.strip())}) if ({cond.strip()}) "
        f"else ({_rewrite_ternaries(other.strip())}))"
    )


def _translate(source: str) -> str:
    """Java-ish → Python-ish surface translation."""
    s = source.strip().rstrip(";")
    s = s.replace("&&", " and ").replace("||", " or ")
    s = re.sub(r"!(?!=)", " not ", s)
    s = s.replace('"', "'")
    s = _rewrite_ternaries(s)
    s = re.sub(r"\btrue\b", "True", s)
    s = re.sub(r"\bfalse\b", "False", s)
    s = re.sub(r"\bnull\b", "None", s)
    return s


class CompiledScript:
    """A validated script; call with a SegmentContext-like resolver."""

    def __init__(self, source: str, lang: str = "painless",
                 extra_vars: tuple = ()):
        """``extra_vars``: additional bare names the script may reference
        (groovy binds params as bare variables), bound from params at
        run()."""
        self.source = source
        self.extra_vars = tuple(extra_vars)
        py = _translate(source)
        try:
            tree = ast.parse(py, mode="eval")
        except SyntaxError as e:
            raise ScriptException(f"cannot compile script [{source}]: {e}")
        self._validate(tree)
        # IfExp must become _where for vectorized evaluation
        tree = _Rewriter().visit(tree)
        ast.fix_missing_locations(tree)
        self._code = compile(tree, "<script>", "eval")

    def _validate(self, tree):
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES + (ast.keyword,)):
                raise ScriptException(
                    f"disallowed construct [{type(node).__name__}] in script [{self.source}]"
                )
            if isinstance(node, ast.Attribute) and node.attr.startswith("_"):
                raise ScriptException(
                    f"disallowed attribute [{node.attr}] in script [{self.source}]"
                )
            if isinstance(node, ast.Name) and node.id not in (
                "doc", "params", "Math", "_score", "_where", "True", "False", "None",
            ) and node.id not in self.extra_vars:
                raise ScriptException(f"unknown variable [{node.id}] in script")
            if isinstance(node, ast.Call):
                f = node.func
                ok = (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("Math", "params")
                ) or (isinstance(f, ast.Name) and f.id == "_where")
                if not ok:
                    raise ScriptException("only Math.* calls are allowed in scripts")

    def run(self, doc_resolver, score=None,
            params: Optional[Dict[str, Any]] = None, device=None):
        """Evaluate over the segment: ``doc_resolver(field)`` gives a
        _DocField; ``score`` is the query's score column (default an f32
        0.0); scalars the script makes live on ``device`` (the score's
        device when not given, else the CPU)."""
        if device is None:
            device = score.device if isinstance(score, torch.Tensor) \
                else torch.device("cpu")
        env = {
            "doc": _Doc(doc_resolver),
            "params": _Params(params or {}),
            "Math": _Math(device),
            "_score": score if score is not None else torch.zeros(
                (), dtype=torch.float32, device=device),
            "_where": _where_fn(device),
            **_HELPERS,
            "__builtins__": {},
        }
        for name in self.extra_vars:  # groovy-style bare param bindings
            env[name] = (params or {}).get(name)
        try:
            return eval(self._code, env)
        except ScriptException:
            raise
        except Exception as e:
            raise ScriptException(f"runtime error in script [{self.source}]: {e}")


def _bool_promoted(a, b):
    """+ - * operands. torch's forms with a Python scalar round as jnp's,
    so the scalar stays one; a bool tensor beside a number takes the
    number's type, as jnp promotes it (torch makes int64 of it, and
    refuses to subtract it)."""
    if (isinstance(a, torch.Tensor) and a.dtype == torch.bool) == \
            (isinstance(b, torch.Tensor) and b.dtype == torch.bool):
        return a, b
    a, b = _operands(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _add(a, b):
    a, b = _bool_promoted(a, b)
    return a + b


def _sub(a, b):
    a, b = _bool_promoted(a, b)
    return a - b


def _mul(a, b):
    a, b = _bool_promoted(a, b)
    return a * b


def _and(a, b):
    return a & b


def _or(a, b):
    return a | b


def _neg(a):
    return -a


def _pos(a):
    return +a


def _invert(a):
    return ~a


_COMPARE = {"Eq": lambda a, b: a == b, "NotEq": lambda a, b: a != b,
            "Lt": lambda a, b: a < b, "LtE": lambda a, b: a <= b,
            "Gt": lambda a, b: a > b, "GtE": lambda a, b: a >= b}


def _compare(ops, left, *rights):
    """A comparison, chained as Python chains one (the first false link
    ends it; a tensor's truth raises, as it does in the reference)."""
    a = left
    for op, b in zip(ops, rights):
        r = _COMPARE[op](a, b)
        if len(ops) > 1 and not r:
            return r
        a = b
    return r


#: operator → the function of this module that applies it. ``/ // %
#: **`` are jnp's forms (a scalar divided by a tensor is a reciprocal
#: times it in torch; floor division, remainder and integer powers round
#: elsewhere there)
_BINOPS = {ast.Add: "_add", ast.Sub: "_sub", ast.Mult: "_mul",
           ast.Div: "_div", ast.FloorDiv: "_floordiv", ast.Mod: "_mod",
           ast.Pow: "_pow"}
_UNARY = {ast.USub: "_neg", ast.UAdd: "_pos", ast.Not: "_invert"}
_HELPERS = {"_add": _add, "_sub": _sub, "_mul": _mul, "_div": _div,
            "_floordiv": _floordiv, "_mod": _mod, "_pow": _pow,
            "_and": _and, "_or": _or, "_neg": _neg, "_pos": _pos,
            "_invert": _invert, "_compare": _compare}


def _call(fn: str, args) -> ast.Call:
    return ast.Call(func=ast.Name(id=fn, ctx=ast.Load()), args=list(args),
                    keywords=[])


class _Rewriter(ast.NodeTransformer):
    """IfExp → _where(cond, then, else) so ternaries vectorize; BoolOp/Not →
    elementwise &, |, ~ (python `and`/`or` would force truthiness on arrays);
    every operator and comparison → a call of its function here."""

    def visit_BinOp(self, node):
        self.generic_visit(node)
        return _call(_BINOPS[type(node.op)], [node.left, node.right])

    def visit_Compare(self, node):
        self.generic_visit(node)
        ops = ast.Tuple(elts=[ast.Constant(type(o).__name__)
                              for o in node.ops], ctx=ast.Load())
        return _call("_compare", [ops, node.left] + node.comparators)

    def visit_IfExp(self, node):
        self.generic_visit(node)
        return _call("_where", [node.test, node.body, node.orelse])

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        fn = "_and" if isinstance(node.op, ast.And) else "_or"
        out = node.values[0]
        for v in node.values[1:]:
            out = _call(fn, [out, v])
        return out

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        return _call(_UNARY[type(node.op)], [node.operand])


_CACHE: Dict[tuple, CompiledScript] = {}


def compile_script(source: str, lang: str = "painless",
                   extra_vars: tuple = ()) -> CompiledScript:
    key = (lang, source, tuple(sorted(extra_vars)))
    cs = _CACHE.get(key)
    if cs is None:
        cs = _CACHE[key] = CompiledScript(source, lang,
                                          extra_vars=tuple(extra_vars))
    return cs


def as_column(vals, D: int, device, dtype=torch.float32):
    """A script's result as a [D] column of ``dtype`` (a Python scalar or
    a 0-d tensor broadcast, as the reference's ``jnp.full``)."""
    if not isinstance(vals, torch.Tensor):
        vals = bool(vals) if dtype == torch.bool else float(vals)
        vals = torch.full((), vals, dtype=dtype, device=device)
    vals = vals.to(device=device, dtype=dtype)
    return vals.expand(D) if vals.dim() == 0 else vals


# -- indexed (stored) scripts -------------------------------------------------
# Reference: ScriptService keeps indexed scripts in the cluster-global
# `.scripts` index (PUT /_scripts/{lang}/{id}); query-time specs reference
# them by id. Here a process-level registry.

_STORED: Dict[str, str] = {}
_STORED_VERSIONS: Dict[str, int] = {}


def store_script(lang: str, script_id: str, source: str,
                 version=None, version_type: str = "internal") -> int:
    """Store and version an indexed script (document versioning of the
    .scripts index). Returns the new version."""
    # compile eagerly: a bad script is rejected when it is stored
    compile_script(source, lang)
    from elasticsearch_tpu_torch.utils.errors import VersionConflictException

    key = f"{lang}/{script_id}"
    cur = _STORED_VERSIONS.get(key)
    if version_type not in ("internal", "external", "external_gt",
                            "external_gte", "force"):
        from elasticsearch_tpu_torch.utils.errors import \
            IllegalArgumentException

        raise IllegalArgumentException(
            f"version type [{version_type}] is not supported")
    if version is not None:
        version = int(version)
        if version_type in ("external", "external_gt"):
            if cur is not None and version <= cur:
                raise VersionConflictException(".scripts", script_id,
                                               cur, version)
            new = version
        elif version_type == "external_gte":
            if cur is not None and version < cur:
                raise VersionConflictException(".scripts", script_id,
                                               cur, version)
            new = version
        elif version_type == "force":
            new = version
        else:  # internal: must match the current version
            if (cur or 0) != version:
                raise VersionConflictException(".scripts", script_id,
                                               cur or 0, version)
            new = (cur or 0) + 1
    else:
        new = (cur or 0) + 1
    _STORED[key] = source
    _STORED_VERSIONS[key] = new
    return new


def get_stored_script(lang: str, script_id: str) -> Optional[str]:
    return _STORED.get(f"{lang}/{script_id}")


def stored_script_version(lang: str, script_id: str) -> Optional[int]:
    return _STORED_VERSIONS.get(f"{lang}/{script_id}")


def delete_stored_script(lang: str, script_id: str, version=None,
                         version_type: str = "internal") -> bool:
    """Document-delete versioning: internal requires an exact match;
    external forms conflict only when the provided version is behind the
    current one; force never conflicts."""
    from elasticsearch_tpu_torch.utils.errors import VersionConflictException

    key = f"{lang}/{script_id}"
    if key not in _STORED:
        return False
    if version is not None and version_type != "force":
        cur = _STORED_VERSIONS.get(key, 0)
        provided = int(version)
        conflict = (provided < cur
                    if version_type in ("external", "external_gt",
                                        "external_gte")
                    else provided != cur)
        if conflict:
            raise VersionConflictException(".scripts", script_id, cur,
                                           provided)
    _STORED.pop(key, None)
    _STORED_VERSIONS.pop(key, None)
    return True


def script_source(spec: Any) -> str:
    """Resolve a query-body script spec to source text: a bare string,
    {inline}/{source}, or an indexed-script reference {id}/{script_id}
    (+ optional lang, default painless)."""
    if isinstance(spec, str):
        return spec
    if not isinstance(spec, dict):
        raise ScriptException(f"invalid script spec [{spec!r}]")
    if "inline" in spec or "source" in spec:
        return spec.get("inline", spec.get("source", ""))
    sid = spec.get("id", spec.get("script_id"))
    if sid is not None:
        src = get_stored_script(spec.get("lang", "painless"), str(sid))
        if src is None:
            raise ScriptException(f"unable to find script [{sid}]")
        return src
    raise ScriptException("script spec needs [inline], [source] or [id]")


def script_params(spec: Any) -> dict:
    """A script spec's ``params`` ({} for a bare string)."""
    return (spec.get("params") or {}) if isinstance(spec, dict) else {}
