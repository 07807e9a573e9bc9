"""JSON-safe packing for cross-host payloads that carry numpy data.

Port of elasticsearch_tpu/utils/wire.py: the same tags and the same
output for the same objects. A ``torch.Tensor`` is refused with
``TensorOnWireError``: the query phase turns its results and agg partials
into host values once, at its end, and nothing is copied off the card in
silence on the way to a socket.

The TCP transport (cluster/transport.py) frames UTF-8 JSON; query-phase
results ride it carrying aggregation partials built from numpy arrays,
non-string dict keys (terms-agg buckets), tuples and sets. ``pack`` maps
those onto tagged JSON structures and ``unpack`` restores them exactly —
the counterpart of the reference's Streamable read/write pairs
(org/elasticsearch/common/io/stream/StreamInput.java) for our JSON wire.
"""
from __future__ import annotations

import base64
from typing import Any

import numpy as np
import torch

_TAGS = ("__nd__", "__map__", "__t__", "__set__", "__b__")


class TensorOnWireError(TypeError):
    """A torch tensor reached ``pack``: the caller must turn it into a
    host value (``.tolist()``, a numpy array) where it knows the cost."""


def pack(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    if isinstance(obj, (int, float)):
        return obj
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.ndarray):
        # ascontiguousarray promotes 0-d to 1-d on this numpy — record the
        # ORIGINAL shape so scalars round-trip as 0-d
        a = np.ascontiguousarray(obj)
        return {"__nd__": {"d": a.dtype.str, "s": list(obj.shape),
                           "b": base64.b64encode(a.tobytes()).decode()}}
    if isinstance(obj, bytes):
        return {"__b__": base64.b64encode(obj).decode()}
    if isinstance(obj, tuple):
        return {"__t__": [pack(v) for v in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"__set__": [pack(v) for v in sorted(obj, key=repr)]}
    if isinstance(obj, dict):
        # dicts ALWAYS go through __map__: JSON objects stringify keys, and
        # agg partials key buckets by ints/floats/tuples
        return {"__map__": [[pack(k), pack(v)] for k, v in obj.items()]}
    if isinstance(obj, list):
        return [pack(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        raise TensorOnWireError(
            f"a torch.Tensor {tuple(obj.shape)} on {obj.device} reached the "
            f"wire; turn it into a host value first")
    raise TypeError(f"cannot pack {type(obj).__name__} for the wire")


def unpack(obj: Any) -> Any:
    if isinstance(obj, list):
        return [unpack(v) for v in obj]
    if isinstance(obj, dict):
        if "__nd__" in obj:
            spec = obj["__nd__"]
            raw = base64.b64decode(spec["b"])
            return np.frombuffer(raw, dtype=np.dtype(spec["d"])).reshape(
                spec["s"]).copy()
        if "__map__" in obj:
            return {_key(unpack(k)): unpack(v) for k, v in obj["__map__"]}
        if "__t__" in obj:
            return tuple(unpack(v) for v in obj["__t__"])
        if "__set__" in obj:
            return set(unpack(v) for v in obj["__set__"])
        if "__b__" in obj:
            return base64.b64decode(obj["__b__"])
        return {k: unpack(v) for k, v in obj.items()}
    return obj


def _key(k: Any) -> Any:
    # dict keys must be hashable after the round trip
    return tuple(k) if isinstance(k, list) else k


# ---------------------------------------------------------------------------
# observability wire header (the frame-level "ctx" band)
# ---------------------------------------------------------------------------

#: frame key the transport reserves for the trace/task context — the
#: counterpart of the reference's ThreadContext request headers riding
#: every transport message (common/util/concurrent/ThreadContext).
CTX_KEY = "ctx"

#: per-band key→type whitelists: the header crosses trust boundaries on
#: every frame, so only known keys with the EXPECTED scalar type survive
#: (a peer can never smuggle structure — or a string task id that would
#: blow up the adopter's int() and fail an otherwise-valid frame — into
#: the coordinator's tracing state)
_CTX_BANDS = {"trace": {"trace_id": str, "span_id": str},
              "task": {"node": str, "id": int}}


def attach_ctx(frame: dict, ctx: Any) -> dict:
    """Attach a sanitized observability context to an outgoing frame
    (no-op on a falsy ctx). Mutates and returns ``frame``."""
    clean = sanitize_ctx(ctx)
    if clean:
        frame[CTX_KEY] = clean
    return frame


def extract_ctx(frame: Any) -> Any:
    """The sanitized observability context of an incoming frame, or
    None."""
    if not isinstance(frame, dict):
        return None
    return sanitize_ctx(frame.get(CTX_KEY))


def sanitize_ctx(ctx: Any) -> Any:
    """Keep only the whitelisted bands/keys whose values match the
    expected scalar type (bounded: ids longer than 128 chars are
    dropped, not truncated — a mangled id must not silently alias
    another trace; bool is never accepted even where int is)."""
    if not isinstance(ctx, dict):
        return None
    out = {}
    for band, keys in _CTX_BANDS.items():
        src = ctx.get(band)
        if not isinstance(src, dict):
            continue
        clean = {k: src[k] for k, want in keys.items()
                 if isinstance(src.get(k), want)
                 and not isinstance(src.get(k), bool)
                 and len(str(src[k])) <= 128}
        if clean:
            out[band] = clean
    return out or None
