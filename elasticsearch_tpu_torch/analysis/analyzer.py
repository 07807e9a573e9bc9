"""Analyzers: char filters + tokenizer + token filters.

Reference: org/elasticsearch/index/analysis/ — NamedAnalyzer, CustomAnalyzer,
StandardAnalyzerProvider, SimpleAnalyzerProvider, WhitespaceAnalyzerProvider,
KeywordAnalyzerProvider, StopAnalyzerProvider, EnglishAnalyzerProvider,
PatternAnalyzerProvider.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from elasticsearch_tpu_torch.analysis import filters as F
from elasticsearch_tpu_torch.analysis import tokenizers as T
from elasticsearch_tpu_torch.analysis import char_filters as C

Token = Tuple[str, int]


class Analyzer:
    def __init__(
        self,
        name: str,
        tokenizer: Callable[[str], List[Token]],
        token_filters: Sequence[Callable[[List[Token]], List[Token]]] = (),
        char_filters: Sequence[Callable[[str], str]] = (),
    ):
        self.name = name
        self.tokenizer = tokenizer
        self.token_filters = list(token_filters)
        self.char_filters = list(char_filters)

    def analyze(self, text: str) -> List[Token]:
        if text is None:
            return []
        for cf in self.char_filters:
            text = cf(text)
        tokens = self.tokenizer(text)
        for tf in self.token_filters:
            tokens = tf(tokens)
        return tokens

    def tokens(self, text: str) -> List[str]:
        return [t for t, _ in self.analyze(text)]


BUILTIN_ANALYZERS = {
    "standard": lambda: Analyzer("standard", T.standard_tokenizer, [F.lowercase_filter]),
    "simple": lambda: Analyzer("simple", T.lowercase_tokenizer),
    "whitespace": lambda: Analyzer("whitespace", T.whitespace_tokenizer),
    "keyword": lambda: Analyzer("keyword", T.keyword_tokenizer),
    "stop": lambda: Analyzer("stop", T.lowercase_tokenizer, [F.stop_filter]),
    "english": lambda: Analyzer(
        "english", T.standard_tokenizer, [F.lowercase_filter, F.stop_filter, F.porter_stem_filter]
    ),
    "pattern": lambda: Analyzer("pattern", T.pattern_tokenizer, [F.lowercase_filter]),
}


# per-language analyzers (reference: index/analysis/*AnalyzerProvider for
# GermanAnalyzer, FrenchAnalyzer, … and SnowballAnalyzerProvider.java):
# standard tokenizer → lowercase → language stop list → language stemmer.
# Stop lists are the high-frequency core of each snowball list
# (filters.LANGUAGE_STOP_WORDS); stemmers are the light UniNE family
# (documented deviations in both cases: subset list, light stemmer).
_LANGUAGE_ANALYZERS = ("french", "german", "spanish", "italian",
                       "portuguese", "dutch", "swedish", "norwegian",
                       "danish", "russian")


def _language_analyzer(lang: str) -> Analyzer:
    stem = lambda toks, _l=lang: F.stemmer_filter(toks, language=_l)
    sw = F.LANGUAGE_STOP_WORDS.get(lang, F.ENGLISH_STOP_WORDS)
    stop = lambda toks, _sw=sw: F.stop_filter(toks, stopwords=_sw)
    return Analyzer(lang, T.standard_tokenizer,
                    [F.lowercase_filter, stop, stem])


def get_analyzer(name: str, language: str | None = None) -> Analyzer:
    if name == "snowball":  # {"type": "snowball", "language": "German"}
        return _language_analyzer((language or "english").lower())
    if name in _LANGUAGE_ANALYZERS:
        return _language_analyzer(name)
    try:
        return BUILTIN_ANALYZERS[name]()
    except KeyError:
        raise ValueError(f"unknown analyzer [{name}]")


def build_custom_analyzer(name: str, config: dict, shared: dict | None = None) -> Analyzer:
    """Build from ES settings-style config:

    {"tokenizer": "standard", "filter": ["lowercase", "my_stop"],
     "char_filter": ["html_strip"]}

    `shared` holds custom tokenizer/filter/char_filter definitions from
    index settings (`analysis.filter.my_stop: {type: stop, stopwords: [...]}`)
    """
    shared = shared or {}

    def _resolve_tokenizer(tname):
        if tname in shared.get("tokenizer", {}):
            cfg = dict(shared["tokenizer"][tname])
            typ = cfg.pop("type")
            return T.get_tokenizer(typ, **cfg)
        return T.get_tokenizer(tname)

    def _resolve_filter(fname):
        if fname in shared.get("filter", {}):
            cfg = dict(shared["filter"][fname])
            typ = cfg.pop("type")
            return F.get_filter(typ, **cfg)
        return F.get_filter(fname)

    def _resolve_char_filter(cname):
        if cname in shared.get("char_filter", {}):
            cfg = dict(shared["char_filter"][cname])
            typ = cfg.pop("type")
            return C.get_char_filter(typ, **cfg)
        return C.get_char_filter(cname)

    tokenizer = _resolve_tokenizer(config.get("tokenizer", "standard"))
    tfs = [_resolve_filter(f) for f in config.get("filter", [])]
    cfs = [_resolve_char_filter(f) for f in config.get("char_filter", [])]
    return Analyzer(name, tokenizer, tfs, cfs)
