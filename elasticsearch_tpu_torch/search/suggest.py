"""Suggesters: term, phrase, completion.

Port of elasticsearch_tpu/search/suggest.py (reference: ES's
SuggestPhase dispatching to the term suggester's edit-distance
candidates, the phrase suggester's n-gram language model over candidate
corrections, and the completion suggester's prefix lookup).

- Candidates come from ``batched_edit_distance``: one exact int32
  Levenshtein DP over the whole packed vocabulary at once, as torch ops
  on each segment's device, one query character a step, ``torch.cummin``
  carrying the insertion channel along each row.
- The phrase LM's bigram counts come from the positional CSR on the card
  (``ops/positional.py::positional_device``): the (doc, position, term
  id) triples sorted, neighbours one position apart paired, and the
  packed pairs counted by ``torch.unique``; kept per segment as sorted
  int64 keys and counts and looked up with ``torch.searchsorted``. The
  scoring (log-probabilities, the beam, the confidence test) stays f64
  on the host, as the reference computes it.
- Completion keeps each segment's inputs as a sorted Python list (its
  prefix range found by ``bisect``), the array form of the reference's
  FST, built once per frozen segment.
"""
from __future__ import annotations

from bisect import bisect_left
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from elasticsearch_tpu_torch.ops.positional import positional_device
from elasticsearch_tpu_torch.search.geo import parse_distance
from elasticsearch_tpu_torch.utils.errors import ElasticsearchTpuException


# -- batched edit distance ---------------------------------------------------

def pack_terms(terms: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """Unicode terms as a zero-padded int32 codepoint matrix [N, Lmax]
    and their lengths (an astral-plane character is one codepoint)."""
    n = len(terms)
    if n == 0:
        return np.zeros((0, 1), dtype=np.int32), np.zeros(0, dtype=np.int64)
    lens = np.array([len(t) for t in terms], dtype=np.int64)
    mat = np.zeros((n, max(1, int(lens.max()))), dtype=np.int32)
    for i, t in enumerate(terms):
        codes = np.frombuffer(t.encode("utf-32-le"), dtype=np.int32)
        mat[i, : codes.size] = codes
    return mat, lens


def _codepoints(text: str) -> List[int]:
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.int32).tolist()


def batched_edit_distance(query: str, mat: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """int32[N]: the Levenshtein distance from ``query`` to every packed
    term (``mat`` int32 [N, L], ``lens`` int64 [N], on one device), exact.
    Rows of L + 1 cells advance one query character a step; the
    insertion channel is a running minimum of ``curr[j] + (L - j)``."""
    n, L = mat.shape
    dev = mat.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    ramp = torch.arange(L, -1, -1, dtype=torch.int32, device=dev)
    prev = torch.arange(L + 1, dtype=torch.int32, device=dev).expand(
        n, L + 1).contiguous()
    for i, qc in enumerate(_codepoints(query), start=1):
        sub = prev[:, :-1] + (mat != qc).to(torch.int32)
        dele = prev[:, 1:] + 1
        curr = torch.empty_like(prev)
        curr[:, 0] = i
        curr[:, 1:] = torch.minimum(sub, dele)
        prev = torch.cummin(curr + ramp, dim=1).values - ramp
    return prev.gather(1, lens.view(-1, 1)).view(-1)


# -- vocabulary statistics over shards and segments --------------------------

class FieldVocab:
    """One field's (term -> df, cf) over every segment of the shards, on
    the host (each segment packs its own vocabulary on the device:
    ``segment_vocab``)."""

    def __init__(self, field: str):
        self.field = field
        self.df: Dict[str, int] = {}
        self.cf: Dict[str, int] = {}
        self.total_terms = 0
        self.num_docs = 0

    def add_segment(self, inv) -> None:
        df, cf = inv.df.tolist(), inv.cf.tolist()
        for term, tid in inv.vocab.items():
            self.df[term] = self.df.get(term, 0) + df[tid]
            self.cf[term] = self.cf.get(term, 0) + cf[tid]
        self.total_terms += inv.total_terms
        self.num_docs += inv.num_docs


_VOCAB_CACHE: "OrderedDict[Tuple, FieldVocab]" = OrderedDict()
_VOCAB_CAP = 16


def field_vocab(shards, field: str) -> FieldVocab:
    """The merged vocabulary, cached by (field, the exact segment ids):
    segments are immutable, so it holds until a refresh or a merge
    changes the set; an LRU of 16 bounds the memory."""
    segs = [seg for sh in shards for seg in sh.segments]
    key = (field, tuple(seg.seg_id for seg in segs))
    fv = _VOCAB_CACHE.get(key)
    if fv is not None:
        _VOCAB_CACHE.move_to_end(key)
        return fv
    fv = FieldVocab(field)
    for seg in segs:
        inv = seg.inverted.get(field)
        if inv is not None:
            fv.add_segment(inv)
    _VOCAB_CACHE[key] = fv
    while len(_VOCAB_CACHE) > _VOCAB_CAP:
        _VOCAB_CACHE.popitem(last=False)
    return fv


def segment_vocab(seg, field: str):
    """(terms, mat int32 [V, L], lens int64 [V]) of the segment's
    vocabulary of ``field``, packed on its device on first use and cached
    on it (charged to ``fielddata``; ``TpuSegment.fielddata_bytes``
    counts it). None without the field."""
    with seg._cache_lock:
        if field not in seg._vocab_packed:
            inv = seg.inverted.get(field)
            got = None
            if inv is not None and inv.terms:
                mat, lens = pack_terms(inv.terms)
                seg._pinned.append(seg.residency.track(
                    mat.nbytes + lens.nbytes, label=f"vocab:{field}",
                    reserve=True))
                put = seg.residency.device_put
                got = (inv.terms, put(mat), put(lens))
            seg._vocab_packed[field] = got
        return seg._vocab_packed[field]


# -- term suggester ------------------------------------------------------------

def _term_candidates(token: str, fv: FieldVocab, segs,
                     opts: dict) -> List[dict]:
    max_edits = int(opts.get("max_edits", 2))
    prefix_length = int(opts.get("prefix_length", opts.get("prefix_len", 1)))
    min_word_length = int(opts.get("min_word_length",
                                   opts.get("min_word_len", 4)))
    min_doc_freq = float(opts.get("min_doc_freq", 0.0))
    max_term_freq = float(opts.get("max_term_freq", 0.01))
    mode = opts.get("suggest_mode", "missing")
    size = int(opts.get("size", 5))
    sort = opts.get("sort", "score")

    token_df = fv.df.get(token, 0)
    if mode == "missing" and token_df > 0:
        return []
    # a token frequent in the index is taken as spelt right (a fraction is
    # a share of num_docs)
    if token_df:
        thresh = max_term_freq * fv.num_docs if max_term_freq < 1.0 \
            else max_term_freq
        if token_df > thresh and mode != "always":
            return []
    if len(token) < min_word_length:
        return []
    # each term's distance, from the segment vocabularies that hold it
    dists: Dict[str, int] = {}
    for seg in segs:
        got = segment_vocab(seg, fv.field)
        if got is None:
            continue
        terms, mat, lens = got
        dist = batched_edit_distance(token, mat, lens)
        hit = torch.nonzero((dist <= max_edits) & (dist > 0)).view(-1)
        cand = torch.stack([hit.to(torch.int64),
                            dist[hit].to(torch.int64)]).cpu().tolist()
        dists.update((terms[i], d) for i, d in zip(*cand))
    out = []
    min_df = min_doc_freq * fv.num_docs if 0 < min_doc_freq < 1.0 \
        else min_doc_freq
    for t, d in dists.items():
        if prefix_length and t[:prefix_length] != token[:prefix_length]:
            continue
        df = fv.df[t]
        if df < min_df:
            continue
        if mode == "popular" and df <= token_df:
            continue
        score = 1.0 - d / max(1, min(len(t), len(token)))
        out.append({"text": t, "score": round(score, 6), "freq": df})
    if sort == "frequency":
        out.sort(key=lambda o: (-o["freq"], -o["score"], o["text"]))
    else:
        out.sort(key=lambda o: (-o["score"], -o["freq"], o["text"]))
    return out[:size]


def _analyze_tokens(text: str, analyzer) -> List[Tuple[str, int, int]]:
    """(token, offset, length): offsets found by scanning the text left to
    right (the analysis chain carries no character offsets)."""
    out = []
    cursor = 0
    lower = text.lower()
    for t, _ in analyzer.analyze(text):
        at = lower.find(t.lower(), cursor)
        if at < 0:
            at = cursor
        else:
            cursor = at + len(t)
        out.append((t, at, len(t)))
    return out


def term_suggest(shards, text: str, opts: dict, analysis) -> List[dict]:
    field = opts.get("field")
    if not field:
        raise ElasticsearchTpuException("suggester [term] requires a [field]")
    analyzer = _suggest_analyzer(shards, opts, field, analysis)
    fv = field_vocab(shards, field)
    segs = [seg for sh in shards for seg in sh.segments]
    return [{"text": token, "offset": off, "length": ln,
             "options": _term_candidates(token, fv, segs, opts)}
            for token, off, ln in _analyze_tokens(text, analyzer)]


def _suggest_analyzer(shards, opts: dict, field: str, analysis):
    name = opts.get("analyzer")
    if name:
        return analysis.get(name)
    for sh in shards:
        fm = sh.searcher.mappings.get(field)
        if fm is not None and fm.search_analyzer:
            return analysis.get(fm.search_analyzer)
        if fm is not None and fm.analyzer:
            return analysis.get(fm.analyzer)
    return analysis.get("standard")


# -- phrase suggester ----------------------------------------------------------

#: packed (doc, position, term) keys must stay below this; a larger
#: product sorts key by key (``_lexsort_dev``)
_PACK_LIMIT = 1 << 62


def _lexsort_dev(keys: List[torch.Tensor]) -> torch.Tensor:
    """The order sorting by ``keys[0]``, then ``keys[1]``, ... (stable
    sorts from the last key)."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def segment_bigrams(seg, field: str):
    """(keys int64 [B] sorted, counts int64 [B], V) of the field's
    bigrams, ``t1 * V + t2`` over term ids, on the segment's device and
    cached on it (charged to ``fielddata``; ``TpuSegment.fielddata_bytes``
    counts them). A bigram is two neighbours one position apart in a
    doc's (position, term id) order, so of two tokens at one position (a
    synonym) only the one next in that order pairs; deleted docs count,
    as the reference reads every posting. None without positions."""
    with seg._cache_lock:
        if field not in seg._bigrams:
            seg._bigrams[field] = _build_bigrams(seg, field)
        return seg._bigrams[field]


def _build_bigrams(seg, field: str):
    """``segment_bigrams``' table, built and charged (under the segment's
    cache lock)."""
    inv = seg.inverted.get(field)
    if inv is None or inv.positions is None or not inv.nnz:
        return None
    pos, offs, dpp = positional_device(inv)
    n_pos = int(pos.shape[0])
    V = len(inv.terms)
    per_post = (offs[1: inv.nnz + 1] - offs[: inv.nnz]).to(torch.int64)
    tid = torch.repeat_interleave(inv.term_ids[: inv.nnz].to(torch.int64),
                                  per_post, output_size=n_pos)
    p64, d64 = pos.to(torch.int64), dpp.to(torch.int64)
    span_p = int(inv.positions.max()) + 1 if n_pos else 1
    if seg.max_docs * span_p * max(V, 1) < _PACK_LIMIT:
        key = (d64 * span_p + p64) * V + tid
        key, _ = torch.sort(key)
        t_s = key % V
        rest = key // V
        p_s, d_s = rest % span_p, rest // span_p
        del key, rest
    else:
        order = _lexsort_dev([d64, p64, tid])
        d_s, p_s, t_s = d64[order], p64[order], tid[order]
        del order
    del p64, d64, tid
    adj = (d_s[1:] == d_s[:-1]) & (p_s[1:] == p_s[:-1] + 1)
    pairs = t_s[:-1][adj] * V + t_s[1:][adj]
    del d_s, p_s, t_s, adj
    keys, counts = torch.unique(pairs, sorted=True, return_counts=True)
    keys, counts = keys.contiguous(), counts.to(torch.int64).contiguous()
    seg._pinned.append(seg.residency.track(
        keys.numel() * 8 + counts.numel() * 8, label=f"bigrams:{field}",
        reserve=True))
    return keys, counts, V


class PhraseLM:
    """Stupid-backoff bigram LM over a field (Brants et al. 2007), the
    reference's default smoothing. Bigram counts are read per (prev,
    word) pair from each segment's table, summed over shards and
    segments; ``prefetch`` reads a batch of pairs in one search a
    segment."""

    BACKOFF = 0.4

    def __init__(self, shards, field: str):
        self.fv = field_vocab(shards, field)
        self.field = field
        self.segs = [seg for sh in shards for seg in sh.segments]
        self._bi: Dict[Tuple[str, str], int] = {}

    def prefetch(self, pairs) -> None:
        todo = list(dict.fromkeys(p for p in pairs if p not in self._bi))
        if not todo:
            return
        got = [0] * len(todo)
        for seg in self.segs:
            table = segment_bigrams(seg, self.field)
            if table is None:
                continue
            keys, counts, V = table
            vocab = seg.inverted[self.field].vocab
            at, q = [], []
            for j, (a, b) in enumerate(todo):
                t1, t2 = vocab.get(a), vocab.get(b)
                if t1 is not None and t2 is not None:
                    at.append(j)
                    q.append(t1 * V + t2)
            if not q or not keys.numel():
                continue
            qt = torch.tensor(q, dtype=torch.int64, device=keys.device)
            idx = torch.searchsorted(keys, qt).clamp_(max=keys.numel() - 1)
            found = keys[idx] == qt
            vals = torch.where(found, counts[idx],
                               torch.zeros_like(qt)).cpu().tolist()
            for j, v in zip(at, vals):
                got[j] += v
        self._bi.update(zip(todo, got))

    def bigram(self, prev: str, word: str) -> int:
        if (prev, word) not in self._bi:
            self.prefetch([(prev, word)])
        return self._bi[(prev, word)]

    def logp(self, prev: Optional[str], word: str) -> float:
        total = max(1, self.fv.total_terms)
        uni = self.fv.cf.get(word, 0)
        if prev is not None:
            bi = self.bigram(prev, word)
            cprev = self.fv.cf.get(prev, 0)
            if bi > 0 and cprev > 0:
                return float(np.log(bi / cprev))
            return float(np.log(self.BACKOFF * max(uni, 0.5) / total))
        return float(np.log(max(uni, 0.5) / total))

    def score(self, tokens: List[str]) -> float:
        lp = 0.0
        prev = None
        for t in tokens:
            lp += self.logp(prev, t)
            prev = t
        return lp / max(1, len(tokens))


def phrase_suggest(shards, text: str, opts: dict, analysis) -> List[dict]:
    field = opts.get("field")
    if not field:
        raise ElasticsearchTpuException(
            "suggester [phrase] requires a [field]")
    size = int(opts.get("size", 5))
    max_errors = float(opts.get("max_errors", 1.0))
    confidence = float(opts.get("confidence", 1.0))
    rwel = float(opts.get("real_word_error_likelihood", 0.95))
    analyzer = _suggest_analyzer(shards, opts, field, analysis)
    gen_opts = dict(opts)
    for g in opts.get("direct_generator", [])[:1]:
        gen_opts.update(g)
    gen_opts.setdefault("suggest_mode", "always")
    gen_opts.setdefault("max_term_freq", 1e18)
    gen_opts.setdefault("min_word_length", 2)
    gen_opts.setdefault("size", 5)

    toks = [t for t, _, _ in _analyze_tokens(text, analyzer)]
    if not toks:
        return [{"text": text, "offset": 0, "length": len(text),
                 "options": []}]
    lm = PhraseLM(shards, field)
    fv = lm.fv

    # candidates a position: the token itself, then its corrections
    cand_sets: List[List[Tuple[str, float]]] = []
    for t in toks:
        cands = [(t, 0.0 if fv.df.get(t, 0) else -1.0)]
        for c in _term_candidates(t, fv, lm.segs, gen_opts):
            cands.append((c["text"], c["score"]))
        cand_sets.append(cands[: max(2, int(gen_opts["size"]))])
    # every bigram the beam can ask for, read in one batch
    lm.prefetch([(a, b) for prev, cur in zip(cand_sets, cand_sets[1:])
                 for a, _ in prev for b, _ in cur])

    max_changes = int(max_errors) if max_errors >= 1 else max(
        1, int(round(max_errors * len(toks))))

    # a beam over the positions with a channel penalty (the reference's
    # WordScorer): keeping a token costs log(rwel), changing it
    # log(1 - rwel), so a correction wins only on the LM's evidence
    log_keep = float(np.log(rwel))
    log_change = float(np.log(max(1e-9, 1.0 - rwel)))
    beams: List[Tuple[float, List[str], int]] = [(0.0, [], 0)]
    for pos, cands in enumerate(cand_sets):
        nxt: List[Tuple[float, List[str], int]] = []
        for lp, seq, nch in beams:
            prev = seq[-1] if seq else None
            for word, _cs in cands:
                changed = word != toks[pos]
                if changed and nch >= max_changes:
                    continue
                pen = log_change if changed else log_keep
                nxt.append((lp + lm.logp(prev, word) + pen, seq + [word],
                            nch + (1 if changed else 0)))
        nxt.sort(key=lambda b: -b[0])
        beams = nxt[:32]

    # the phrase as written scores base under the same channel model; a
    # candidate stays only when it beats confidence times that
    base = lm.score(toks) + log_keep
    seen = set()
    options = []
    pre = post = None
    hl = opts.get("highlight")
    if hl:
        pre, post = hl.get("pre_tag", "<em>"), hl.get("post_tag", "</em>")
    for lp, seq, _nch in beams:
        phrase = " ".join(seq)
        if phrase in seen:
            continue
        seen.add(phrase)
        score = lp / max(1, len(seq))
        if seq == toks:
            continue
        if confidence > 0 and np.exp(score) <= confidence * np.exp(base):
            continue
        opt = {"text": phrase, "score": round(float(np.exp(score)), 8)}
        if hl:
            opt["highlighted"] = " ".join(
                f"{pre}{w}{post}" if w != t else w for w, t in zip(seq, toks))
        options.append(opt)
        if len(options) >= size:
            break
    return [{"text": text, "offset": 0, "length": len(text),
             "options": options}]


# -- completion suggester ------------------------------------------------------

def _segment_completions(seg, field: str):
    """(sorted lowercased inputs, aligned (doc, weight, output, payload,
    context)) of one segment, cached on it. Python's codepoint order, so
    a prefix's range is a ``bisect`` and a walk while it holds."""
    with seg._cache_lock:
        if field not in seg._completions:
            seg._completions[field] = _build_completions(seg, field)
        return seg._completions[field]


def _build_completions(seg, field: str):
    inputs: List[str] = []
    meta: List[Tuple[int, float, str, Any, Any]] = []
    for doc in range(seg.num_docs):
        stored = seg.stored[doc] if doc < len(seg.stored) else None
        if not stored or field not in stored:
            continue
        for entry in stored[field]:
            if isinstance(entry, str):
                entry = {"input": [entry]}
            ins = entry.get("input", [])
            if isinstance(ins, str):
                ins = [ins]
            output = entry.get("output") or (ins[0] if ins else "")
            weight = float(entry.get("weight", 1))
            payload = entry.get("payload")
            ctx = entry.get("context")
            for s in ins:
                inputs.append(s.lower())
                meta.append((doc, weight, output, payload, ctx))
    order = sorted(range(len(inputs)), key=lambda i: inputs[i])
    return [inputs[i] for i in order], [meta[i] for i in order]


def _cut_packed(seg, field: str, inputs: List[str], plen: int):
    """The segment's inputs cut to ``plen`` characters, packed on its
    device once per length (fuzzy completion) and charged to
    ``fielddata``."""
    with seg._cache_lock:
        got = seg._completion_cuts.get((field, plen))
        if got is None:
            mat, lens = pack_terms([s[:plen] for s in inputs])
            seg._pinned.append(seg.residency.track(
                mat.nbytes + lens.nbytes, label=f"completion:{field}",
                reserve=True))
            put = seg.residency.device_put
            got = seg._completion_cuts[(field, plen)] = (put(mat), put(lens))
        return got


_GEOHASH32 = "0123456789bcdefghjkmnpqrstuvwxyz"


def _geohash(lat: float, lon: float, length: int) -> str:
    """Standard geohash (base-32 interleaved bisection), the cells of the
    reference's geo context."""
    lat_r, lon_r = [-90.0, 90.0], [-180.0, 180.0]
    bits, bit, even = 0, 0, True
    out = []
    while len(out) < length:
        if even:
            mid = (lon_r[0] + lon_r[1]) / 2
            if lon >= mid:
                bits = (bits << 1) | 1
                lon_r[0] = mid
            else:
                bits <<= 1
                lon_r[1] = mid
        else:
            mid = (lat_r[0] + lat_r[1]) / 2
            if lat >= mid:
                bits = (bits << 1) | 1
                lat_r[0] = mid
            else:
                bits <<= 1
                lat_r[1] = mid
        even = not even
        bit += 1
        if bit == 5:
            out.append(_GEOHASH32[bits])
            bits, bit = 0, 0
    return "".join(out)


# ES's precision table: the geohash length whose cell edge fits within a
# distance (GeoUtils.geoHashLevelsForPrecision, lengths 1-12)
_GEO_PRECISION_KM = [(5000, 1), (1250, 2), (156, 3), (39.1, 4), (4.9, 5),
                     (1.2, 6), (0.153, 7), (0.038, 8), (0.00477, 9),
                     (0.00119, 10), (0.000149, 11), (0.0000372, 12)]


def _geo_len(precision) -> int:
    if isinstance(precision, int):
        return max(1, min(int(precision), 12))
    km = parse_distance(precision) / 1000.0
    for edge, ln in _GEO_PRECISION_KM:
        if edge <= km:
            return ln
    return 12


def _ctx_point(v):
    if isinstance(v, dict):
        return float(v["lat"]), float(v.get("lon", v.get("lng")))
    if isinstance(v, (list, tuple)):
        return float(v[1]), float(v[0])  # GeoJSON order
    raise ElasticsearchTpuException(f"cannot parse geo context [{v}]")


def _context_match(cfgs: dict, entry_ctx, doc_src, query_ctx) -> bool:
    """One completion entry against the request's context values
    (ES's category and geolocation context mappings)."""
    for name, cfg in (cfgs or {}).items():
        want = (query_ctx or {}).get(name)
        if want is None:
            continue
        have = (entry_ctx or {}).get(name)
        if have is None and cfg.get("path"):
            have = (doc_src or {}).get(cfg["path"])
        if have is None:
            have = cfg.get("default")
        if cfg.get("type") == "geo":
            ln = _geo_len(cfg.get("precision", 6))
            if have is None:
                return False
            wlat, wlon = _ctx_point(want)
            hlat, hlon = _ctx_point(have)
            if _geohash(wlat, wlon, ln) != _geohash(hlat, hlon, ln):
                return False
        else:  # category
            haves = have if isinstance(have, list) else [have]
            wants = want if isinstance(want, list) else [want]
            if not set(map(str, wants)) & set(map(str, haves)):
                return False
    return True


def completion_suggest(shards, prefix: str, opts: dict,
                       mappings=None) -> List[dict]:
    field = opts.get("field")
    if not field:
        raise ElasticsearchTpuException(
            "suggester [completion] requires a [field]")
    size = int(opts.get("size", 5))
    query_ctx = opts.get("context")
    fm = mappings.get(field) if mappings is not None else None
    ctx_cfg = getattr(fm, "context", None) if fm is not None else None
    fuzzy = opts.get("fuzzy")
    # "fuzzy": {} and "fuzzy": true both take the defaults
    if fuzzy is True or fuzzy == {}:
        fuzzy = {"fuzziness": 1}
    p = prefix.lower()
    collected: Dict[str, dict] = {}
    for sh in shards:
        for seg in sh.segments:
            inputs, meta = _segment_completions(seg, field)
            if not inputs:
                continue
            if fuzzy:
                fz = int(fuzzy.get("fuzziness", 1)) \
                    if isinstance(fuzzy, dict) else 1
                mat, lens = _cut_packed(seg, field, inputs, len(p))
                dist = batched_edit_distance(p, mat, lens)
                idx = torch.nonzero(dist <= fz).view(-1).cpu().tolist()
            else:
                # the exact prefix range: bisect to its start, walk while
                # the prefix holds (astral inputs sort above U+FFFF, so no
                # sentinel upper bound)
                lo = bisect_left(inputs, p)
                hi = lo
                while hi < len(inputs) and inputs[hi].startswith(p):
                    hi += 1
                idx = range(lo, hi)
            live = seg.live_host
            for i in idx:
                doc, weight, output, payload, ectx = meta[i]
                if not live[doc]:
                    continue
                if query_ctx and ctx_cfg and not _context_match(
                        ctx_cfg, ectx,
                        seg.sources[doc] if doc < len(seg.sources) else None,
                        query_ctx):
                    continue
                cur = collected.get(output)
                if cur is None or weight > cur["score"]:
                    opt = {"text": output, "score": weight}
                    if payload is not None:
                        opt["payload"] = payload
                    collected[output] = opt
    options = sorted(collected.values(),
                     key=lambda o: (-o["score"], o["text"]))[:size]
    return [{"text": prefix, "offset": 0, "length": len(prefix),
             "options": options}]


# -- dispatch ------------------------------------------------------------------

SUGGEST_KINDS = ("term", "phrase", "completion")


def execute_suggest(shards, body: dict, analysis, mappings=None) -> dict:
    """Run a suggest body over the shards (each with ``.segments`` and
    ``.searcher``), one entry list per named suggester."""
    out: Dict[str, Any] = {}
    for name, spec in body.items():
        if name == "text":
            continue
        text, kind = validate_suggester(name, spec, body.get("text"))
        opts = spec[kind] or {}
        if kind == "term":
            out[name] = term_suggest(shards, text, opts, analysis)
        elif kind == "phrase":
            out[name] = phrase_suggest(shards, text, opts, analysis)
        else:
            out[name] = completion_suggest(shards, text, opts,
                                           mappings=mappings)
    return out


def validate_suggester(name: str, spec, global_text):
    """(text, kind) of one named suggester, or the typed error of a
    malformed one."""
    if not isinstance(spec, dict):
        raise ElasticsearchTpuException(f"suggester [{name}] malformed body")
    text = spec.get("text", spec.get("prefix", global_text))
    if text is None:
        raise ElasticsearchTpuException(f"suggester [{name}] requires [text]")
    kind = next((k for k in SUGGEST_KINDS if k in spec), None)
    if kind is None:
        raise ElasticsearchTpuException(
            f"suggester [{name}] requires one of {SUGGEST_KINDS}")
    return text, kind


def validate_suggest_body(body: dict) -> None:
    for name, spec in (body or {}).items():
        if name == "text":
            continue
        validate_suggester(name, spec, (body or {}).get("text"))


def merge_index_result(merged: Dict[str, List[dict]], res: dict) -> None:
    """Fold one index's suggest result into a cross-index accumulator:
    entries align by (text, offset), and an option text already present
    from another index wins (each index has its own vocabulary)."""
    for name, entries in res.items():
        if name == "_shards" or not isinstance(entries, list):
            continue
        if name not in merged:
            merged[name] = entries
            continue
        by_key = {(e["text"], e["offset"]): e for e in merged[name]}
        for e in entries:
            cur = by_key.get((e["text"], e["offset"]))
            if cur is None:
                merged[name].append(e)
                continue
            seen = {o["text"] for o in cur["options"]}
            cur["options"].extend(
                o for o in e["options"] if o["text"] not in seen)


def execute_suggest_multi(groups, body: dict, extra_results=()) -> dict:
    """Suggest over several indices, each with its own analysis registry:
    ``groups`` holds (shards, analysis[, mappings]) a index. Entries with
    the same (text, offset) merge and their options re-rank.
    ``extra_results`` are results computed elsewhere (a distributed
    index's merged fan over its members), merged the same way."""
    merged: Dict[str, List[dict]] = {}
    for group in groups:
        shards, analysis = group[0], group[1]
        mappings = group[2] if len(group) > 2 else None
        merge_index_result(merged, execute_suggest(shards, body, analysis,
                                                   mappings=mappings))
    for res in extra_results:
        merge_index_result(merged, res)
    _rerank_options(body, merged)
    return merged


def _rerank_options(body: dict, merged: Dict[str, List[dict]]) -> None:
    """Sort and cut each merged entry's options by its suggester's own
    size and sort."""
    for name, entries in merged.items():
        spec = body.get(name, {})
        kind = next((k for k in SUGGEST_KINDS if k in spec), None)
        opts = spec.get(kind) or {} if kind else {}
        size = int(opts.get("size", 5))
        if kind == "term" and opts.get("sort") == "frequency":
            keyf = lambda o: (-o.get("freq", 0), -o["score"], o["text"])
        else:
            keyf = lambda o: (-o["score"], o["text"])
        for e in entries:
            e["options"] = sorted(e["options"], key=keyf)[:size]


def merge_suggest(body: dict, payloads: List[dict]) -> dict:
    """Merge the suggest responses of disjoint shard sets of one index:
    entries align by position, an option seen twice sums its ``freq``
    and keeps the larger score; then each entry re-ranks."""
    merged: Dict[str, List[dict]] = {}
    for res in payloads:
        for name, entries in res.items():
            if name == "_shards" or not isinstance(entries, list):
                continue
            if name not in merged:
                merged[name] = [dict(e, options=[dict(o)
                                                 for o in e["options"]])
                                for e in entries]
                continue
            for cur, e in zip(merged[name], entries):
                by_text = {o["text"]: o for o in cur["options"]}
                for o in e["options"]:
                    have = by_text.get(o["text"])
                    if have is None:
                        cur["options"].append(dict(o))
                    else:
                        if "freq" in o or "freq" in have:
                            have["freq"] = (have.get("freq", 0)
                                            + o.get("freq", 0))
                        have["score"] = max(have.get("score", 0.0),
                                            o.get("score", 0.0))
    _rerank_options(body, merged)
    return merged
