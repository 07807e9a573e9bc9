"""Tokenizers.

Reference: org/elasticsearch/index/analysis/*TokenizerFactory.java
(StandardTokenizerFactory, WhitespaceTokenizerFactory, KeywordTokenizerFactory,
LetterTokenizerFactory, LowerCaseTokenizerFactory, NGramTokenizerFactory,
EdgeNGramTokenizerFactory, PatternTokenizerFactory,
PathHierarchyTokenizerFactory).

Tokenizers are host-side (indexing is IO/string work — the TPU path starts
at the postings arrays). Each returns a list of (token, position) so the
positional index for phrase queries sees gaps exactly once per token.
"""
from __future__ import annotations

import re
from typing import Callable, List, Tuple

Token = Tuple[str, int]  # (text, position)

# Unicode-ish word tokenizer: runs of word chars incl. digits; splits on
# punctuation like Lucene's StandardTokenizer (UAX#29 simplified: keeps
# inner apostrophes/periods out, which matches ES behavior for plain text).
_STANDARD_RE = re.compile(r"\w+(?:[.']\w+)*", re.UNICODE)
_LETTER_RE = re.compile(r"[^\W\d_]+", re.UNICODE)


def _positions(tokens: List[str]) -> List[Token]:
    return [(t, i) for i, t in enumerate(tokens)]


def standard_tokenizer(text: str, max_token_length: int = 255) -> List[Token]:
    toks = [m.group(0) for m in _STANDARD_RE.finditer(text)]
    toks = [t[:max_token_length] for t in toks]
    return _positions(toks)


def whitespace_tokenizer(text: str) -> List[Token]:
    return _positions(text.split())


def keyword_tokenizer(text: str) -> List[Token]:
    return [(text, 0)] if text else []


def letter_tokenizer(text: str) -> List[Token]:
    return _positions([m.group(0) for m in _LETTER_RE.finditer(text)])


def lowercase_tokenizer(text: str) -> List[Token]:
    return _positions([m.group(0).lower() for m in _LETTER_RE.finditer(text)])


def ngram_tokenizer(text: str, min_gram: int = 1, max_gram: int = 2) -> List[Token]:
    out: List[Token] = []
    pos = 0
    for n in range(min_gram, max_gram + 1):
        for i in range(0, max(0, len(text) - n + 1)):
            out.append((text[i : i + n], pos))
            pos += 1
    return out


def edge_ngram_tokenizer(text: str, min_gram: int = 1, max_gram: int = 2) -> List[Token]:
    out: List[Token] = []
    for n in range(min_gram, min(max_gram, len(text)) + 1):
        out.append((text[:n], 0))
    return out


def pattern_tokenizer(text: str, pattern: str = r"\W+", group: int = -1) -> List[Token]:
    if group == -1:
        return _positions([t for t in re.split(pattern, text) if t])
    return _positions([m.group(group) for m in re.finditer(pattern, text)])


def path_hierarchy_tokenizer(text: str, delimiter: str = "/") -> List[Token]:
    parts = [p for p in text.split(delimiter) if p]
    out: List[Token] = []
    acc = ""
    for p in parts:
        acc = acc + delimiter + p if acc else (delimiter + p if text.startswith(delimiter) else p)
        out.append((acc, 0))
    return out


TOKENIZERS: dict = {
    "standard": standard_tokenizer,
    "whitespace": whitespace_tokenizer,
    "keyword": keyword_tokenizer,
    "letter": letter_tokenizer,
    "lowercase": lowercase_tokenizer,
    "ngram": ngram_tokenizer,
    "nGram": ngram_tokenizer,
    "edge_ngram": edge_ngram_tokenizer,
    "edgeNGram": edge_ngram_tokenizer,
    "pattern": pattern_tokenizer,
    "path_hierarchy": path_hierarchy_tokenizer,
}


def get_tokenizer(name: str, **params) -> Callable[[str], List[Token]]:
    try:
        fn = TOKENIZERS[name]
    except KeyError:
        raise ValueError(f"unknown tokenizer [{name}]")
    if params:
        import functools

        return functools.partial(fn, **params)
    return fn
