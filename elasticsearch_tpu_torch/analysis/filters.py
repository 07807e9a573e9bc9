"""Token filters.

Reference: org/elasticsearch/index/analysis/*TokenFilterFactory.java
(LowerCaseTokenFilterFactory, StopTokenFilterFactory, StemmerTokenFilterFactory,
ASCIIFoldingTokenFilterFactory, LengthTokenFilterFactory, TrimTokenFilterFactory,
TruncateTokenFilterFactory, UniqueTokenFilterFactory, ReverseTokenFilterFactory,
ShingleTokenFilterFactory, NGramTokenFilterFactory, EdgeNGramTokenFilterFactory,
SynonymTokenFilterFactory, SnowballTokenFilterFactory, KeywordMarkerTokenFilterFactory).

A filter maps List[(token, position)] -> List[(token, position)]. A dropped
stopword leaves a position gap (ES `enable_position_increments` semantics) so
phrase queries behave like Lucene's.
"""
from __future__ import annotations

import functools
import re
import unicodedata
from typing import Callable, List, Tuple

Token = Tuple[str, int]

# Lucene's EnglishAnalyzer default stopword set (ENGLISH_STOP_WORDS_SET).
ENGLISH_STOP_WORDS = frozenset(
    """a an and are as at be but by for if in into is it no not of on or such
    that the their then there these they this to was will with""".split()
)

# Per-language stopword sets: the high-frequency function-word core of the
# snowball lists Lucene bundles per LanguageAnalyzer (the full snowball
# files add rarer inflections; documented deviation: subset, not the full
# file). Used by the per-language / snowball analyzer providers.
LANGUAGE_STOP_WORDS = {
    "english": ENGLISH_STOP_WORDS,
    "french": frozenset(
        """au aux avec ce ces dans de des du elle en et eux il ils je la le
        les leur lui ma mais me mes moi mon ne nos notre nous on ou par pas
        pour qu que qui sa se ses son sur ta te tes toi ton tu un une vos
        votre vous y été étée étées étés étant suis es est sommes êtes sont
        serai sera serons serez seront serais serait serions seriez seraient
        étais était étions étiez étaient fus fut ai as avons avez ont aurai
        aura aurons aurez auront avais avait avions aviez avaient eut eu
        cette cet aussi même si ces leurs""".split()),
    "german": frozenset(
        """aber alle allem allen aller alles als also am an andere anderen
        auch auf aus bei bin bis bist da damit dann der den des dem die das
        dass daß du durch ein eine einem einen einer eines er es für hatte
        hatten hab habe haben hier hin hinter ich ihr ihre im in ist ja
        jede jedem jeden jeder jedes kann kein keine man mein mich mir mit
        muss nach nicht noch nun nur ob oder ohne sehr sein seine sich sie
        sind so über um und uns unser unter vom von vor war waren was wenn
        werde werden wie wieder will wir wird wo zu zum zur zwischen""".split()),
    "spanish": frozenset(
        """a al algo algunos ante antes como con contra cual cuando de del
        desde donde durante e el ella ellas ellos en entre era eran es esa
        esas ese eso esos esta estas este esto estos fue fueron ha han hasta
        hay la las le les lo los me mi mis mucho muy más ni no nos nosotros
        nuestra nuestro o os otra otros para pero poco por porque que quien
        se sea ser si sin sobre son soy su sus también tanto te tiene tienen
        todo todos tu tus un una uno unos vosotros y ya yo""".split()),
    "italian": frozenset(
        """a ad al alla alle ai agli all anche ancora aveva avevano c che
        chi ci come con contro cui da dal dalla dalle dai degli del della
        delle dei di dove e ed era erano essere fa fra gli ha hanno i il in
        io l la le lei li lo loro lui ma mi mia mio ne nei nel nella nelle
        no noi non nostra nostro o per perché più quella quelle quelli
        quello questa queste questi questo qui se sei si sia siamo sono sta
        su sua sue sui sul sulla suo te ti tra tu tua tuo un una uno vi voi
        è""".split()),
    "portuguese": frozenset(
        """a ao aos aquela aquele as até com como da das de dela dele deles
        depois do dos e ela elas ele eles em entre era essa esse esta este
        eu foi for foram há isso isto já lhe lhes mais mas me mesmo meu
        minha muito na nas nem no nos nossa nosso não o os ou para pela
        pelo por qual quando que quem se sem ser seu sua são só também te
        tem teu tu tua um uma você vocês""".split()),
    "dutch": frozenset(
        """aan al alles als altijd andere ben bij daar dan dat de der deze
        die dit doch doen door dus een en er ge geen geweest haar had heb
        hebben heeft hem het hier hij hoe hun iemand iets ik in is ja je
        kan kon kunnen maar me meer men met mij mijn moet na naar niet nog
        nu of om omdat ons ook op over reeds te tegen toch toen tot u uit
        uw van veel voor want waren was wat we wel werd wezen wie wij wil
        worden zal ze zei zelf zich zij zijn zo zonder zou""".split()),
    "swedish": frozenset(
        """alla allt att av blev bli blir blivit de dem den denna deras
        dess dessa det detta dig din dina ditt du där då efter ej eller en
        er era ert ett från för ha hade han hans har henne hennes hon
        honom hur här i icke ingen inom inte jag ju kan kunde man med mellan
        men mig min mina mitt mot mycket ni nu när någon något några och om
        oss på samma sedan sig sin sina sitta själv skulle som så sådan till
        under upp ut utan vad var vara varför varit varje vars vart vem vi
        vid vilka vilken vill åt än är över""".split()),
    "norwegian": frozenset(
        """alle at av bare begge ble blei bli blir da de deg dei deim deira
        den denne der dette di din disse du eg ein eit eitt eller elles en
        enn er et ett etter for fordi fra før ha hadde han hans har hennar
        henne hennes her hjå ho hoe honom hun hva hvem hver hvilke hvilken
        hvis hvor hvordan hvorfor i ikke ikkje ingen ja jeg kan kom korleis
        kva kvar kven man mange me med medan meg men mi min mine mitt mot
        mykje nå når og også om opp oss over på s seg selv si sia sidan sin
        sine sitt skal skulle so som store til um var vart varte ved vere
        verte vi vil ville vore vors vort være vært å""".split()),
    "danish": frozenset(
        """af alle alt anden at blev blive bliver da de dem den denne der
        deres det dette dig din disse dog du efter eller en end er et for
        fra ham han hans har havde have hende hendes her hos hun hvad hvis
        hvor i ikke ind jeg jer jo kunne man mange med meget men mig min
        mine mit mod ned noget nogle nu når og også om op os over på selv
        sig sin sine sit skal skulle som sådan thi til ud under var vi vil
        ville vor være været""".split()),
    "russian": frozenset(
        """а без более бы был была были было быть в вам вас весь во вот все
        всего всех вы где да даже для до его ее ей ею если есть еще же за
        здесь и из или им их к как ко когда кто ли либо мне может мы на
        надо наш не него нее нет ни них но ну о об однако он она они оно
        от очень по под при с со так также такой там те тем то того тоже
        той только том ты у уже хотя чего чей чем что чтобы чье чья эта
        эти это я""".split()),
}


def lowercase_filter(tokens: List[Token]) -> List[Token]:
    return [(t.lower(), p) for t, p in tokens]


def uppercase_filter(tokens: List[Token]) -> List[Token]:
    return [(t.upper(), p) for t, p in tokens]


def stop_filter(tokens: List[Token], stopwords=ENGLISH_STOP_WORDS) -> List[Token]:
    if stopwords == "_english_":
        stopwords = ENGLISH_STOP_WORDS
    elif stopwords == "_none_":
        return list(tokens)
    sw = {w.lower() for w in stopwords}
    return [(t, p) for t, p in tokens if t.lower() not in sw]


def asciifolding_filter(tokens: List[Token]) -> List[Token]:
    def fold(s: str) -> str:
        return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii") or s

    return [(fold(t), p) for t, p in tokens]


def length_filter(tokens: List[Token], min: int = 0, max: int = 2**31 - 1) -> List[Token]:
    return [(t, p) for t, p in tokens if min <= len(t) <= max]


def trim_filter(tokens: List[Token]) -> List[Token]:
    return [(t.strip(), p) for t, p in tokens]


def truncate_filter(tokens: List[Token], length: int = 10) -> List[Token]:
    return [(t[:length], p) for t, p in tokens]


def unique_filter(tokens: List[Token], only_on_same_position: bool = False) -> List[Token]:
    seen = set()
    out = []
    for t, p in tokens:
        key = (t, p) if only_on_same_position else t
        if key not in seen:
            seen.add(key)
            out.append((t, p))
    return out


def reverse_filter(tokens: List[Token]) -> List[Token]:
    return [(t[::-1], p) for t, p in tokens]


def shingle_filter(
    tokens: List[Token],
    min_shingle_size: int = 2,
    max_shingle_size: int = 2,
    output_unigrams: bool = True,
    token_separator: str = " ",
) -> List[Token]:
    out: List[Token] = []
    texts = [t for t, _ in tokens]
    for i, (t, p) in enumerate(tokens):
        if output_unigrams:
            out.append((t, p))
        for n in range(min_shingle_size, max_shingle_size + 1):
            if i + n <= len(texts):
                out.append((token_separator.join(texts[i : i + n]), p))
    return out


def ngram_filter(tokens: List[Token], min_gram: int = 1, max_gram: int = 2) -> List[Token]:
    out: List[Token] = []
    for t, p in tokens:
        for n in range(min_gram, max_gram + 1):
            for i in range(0, max(0, len(t) - n + 1)):
                out.append((t[i : i + n], p))
    return out


def edge_ngram_filter(tokens: List[Token], min_gram: int = 1, max_gram: int = 2) -> List[Token]:
    out: List[Token] = []
    for t, p in tokens:
        for n in range(min_gram, min(max_gram, len(t)) + 1):
            out.append((t[:n], p))
    return out


def synonym_filter(tokens: List[Token], synonyms: List[str] = ()) -> List[Token]:
    """Solr-format synonym rules: "a, b => c" (replace) or "a, b, c" (expand).

    Multi-word inputs ("united states => usa") match token *sequences* in the
    stream, like Lucene's SynonymFilter: rules are keyed by first token and
    matched greedily longest-first.
    """
    # first token -> list of (input_seq: tuple, outputs: list)
    rules: dict = {}

    def add_rule(seq_words: str, outputs: List[str]):
        seq = tuple(seq_words.split())
        if seq:
            rules.setdefault(seq[0], []).append((seq, outputs))

    for rule in synonyms:
        if "=>" in rule:
            lhs, rhs = rule.split("=>")
            targets = [w.strip() for w in rhs.split(",") if w.strip()]
            for w in (w.strip() for w in lhs.split(",")):
                if w:
                    add_rule(w, targets)
        else:
            group = [w.strip() for w in rule.split(",") if w.strip()]
            for w in group:
                add_rule(w, group)
    for cands in rules.values():
        cands.sort(key=lambda c: -len(c[0]))  # longest match first

    out: List[Token] = []
    i = 0
    n = len(tokens)
    while i < n:
        t, p = tokens[i]
        matched = False
        for seq, outputs in rules.get(t, ()):
            if i + len(seq) <= n and all(tokens[i + j][0] == seq[j] for j in range(len(seq))):
                # multi-word outputs emit one token per word at consecutive
                # positions (SynonymFilter graph flattened)
                for o in outputs:
                    for j, word in enumerate(o.split()):
                        out.append((word, p + j))
                i += len(seq)
                matched = True
                break
        if not matched:
            out.append((t, p))
            i += 1
    return out


# ---- Porter stemmer (classic algorithm; Lucene PorterStemFilter parity) ------

_V = "aeiou"


def _cons(w: str, i: int) -> bool:
    c = w[i]
    if c in _V:
        return False
    if c == "y":
        return i == 0 or not _cons(w, i - 1)
    return True


def _measure(stem: str) -> int:
    # count VC sequences
    m = 0
    i = 0
    n = len(stem)
    while i < n and _cons(stem, i):
        i += 1
    while i < n:
        while i < n and not _cons(stem, i):
            i += 1
        if i >= n:
            break
        m += 1
        while i < n and _cons(stem, i):
            i += 1
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(w: str) -> bool:
    return len(w) >= 2 and w[-1] == w[-2] and _cons(w, len(w) - 1)


def _cvc(w: str) -> bool:
    if len(w) < 3:
        return False
    return (
        _cons(w, len(w) - 3)
        and not _cons(w, len(w) - 2)
        and _cons(w, len(w) - 1)
        and w[-1] not in "wxy"
    )


def porter_stem(w: str) -> str:
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    flag = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
    elif w.endswith("ing"):
        if _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
    if flag:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and w[-1] not in "lsz":
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 3
    for suf, rep in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ):
        if w.endswith(suf):
            if _measure(w[: -len(suf)]) > 0:
                w = w[: -len(suf)] + rep
            break
    # step 4
    for suf in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 1:
                if suf == "ion" and not stem.endswith(("s", "t")):
                    break
                w = stem
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


def porter_stem_filter(tokens: List[Token]) -> List[Token]:
    return [(porter_stem(t), p) for t, p in tokens]


# ---- light language stemmers -------------------------------------------------
# UniNE-family light suffix-stripping stemmers — the algorithms behind
# Lucene's FrenchLightStemmer/GermanLightStemmer/etc., which the reference
# exposes via `stemmer`/`snowball` token filters (reference:
# index/analysis/StemmerTokenFilterFactory.java,
# SnowballAnalyzerProvider.java). Documented deviation: these are the
# LIGHT stemmers (strip the longest matching inflectional suffix with a
# minimum-stem guard), not full Snowball — the same trade Lucene's
# "light_*" variants make. english/porter runs the real Porter algorithm.

_UMLAUT_FOLD = str.maketrans({"ä": "a", "ö": "o", "ü": "u", "ß": "s",
                              "á": "a", "à": "a", "â": "a", "é": "e",
                              "è": "e", "ê": "e", "ë": "e", "î": "i",
                              "ï": "i", "í": "i", "ô": "o", "ó": "o",
                              "û": "u", "ù": "u", "ú": "u", "ç": "c",
                              "ã": "a", "õ": "o", "ñ": "n", "å": "a",
                              "ø": "o", "æ": "a"})

# ordered longest-first; a suffix strips only when >= 3 chars of stem remain
_LIGHT_SUFFIXES: dict = {
    "french": ("issements", "issement", "atrices", "ateurs", "ations",
               "atrice", "ateur", "ation", "ements", "ement", "euses",
               "ences", "ience", "antes", "ables", "istes", "iques", "ismes",
               "euse", "ence", "ante", "ants", "able", "iste", "ique",
               "isme", "eaux", "elles", "elle", "ines", "ine", "ives", "ive",
               "ifs", "aux", "ant", "ent", "ees", "és", "ée", "es", "er",
               "ez", "e", "s"),
    "german": ("ungen", "heiten", "keiten", "nisse", "ung", "heit", "keit",
               "nis", "ern", "em", "en", "er", "es", "e", "s", "n"),
    "spanish": ("amientos", "imientos", "amiento", "imiento", "aciones",
                "uciones", "adoras", "adores", "ancias", "acion", "ucion",
                "adora", "ador", "ancia", "mente", "ables", "ibles", "istas",
                "able", "ible", "ista", "osos", "osas", "oso", "osa", "idad",
                "ivas", "ivos", "iva", "ivo", "eza", "es", "os", "as", "o",
                "a", "e"),
    "italian": ("amenti", "imenti", "amento", "imento", "azioni", "azione",
                "atrici", "atori", "mente", "abili", "ibili", "isti", "iste",
                "abile", "ibile", "ista", "oso", "osa", "osi", "ose", "ità",
                "ivo", "iva", "ivi", "ive", "i", "e", "o", "a"),
    "portuguese": ("amentos", "imentos", "amento", "imento", "adoras",
                   "adores", "ações", "uções", "ância", "mente",
                   "idades", "idade", "ismos", "istas", "adora", "ación",
                   "ador", "aria", "osos", "osas", "oso", "osa", "ivas",
                   "ivos", "iva", "ivo", "es", "os", "as", "o", "a", "e"),
    "dutch": ("heden", "ingen", "eren", "ing", "en", "je", "es", "s", "e"),
    "swedish": ("heterna", "heten", "heter", "arna", "erna", "orna", "ande",
                "arne", "aste", "aren", "ades", "are", "ade", "ast", "arn",
                "et", "en", "ar", "er", "or", "at", "a", "e", "s"),
    "norwegian": ("hetene", "heten", "heter", "endes", "ande", "ende", "enes",
                  "ene", "ane", "ete", "ert", "et", "en", "ar", "er", "as",
                  "es", "a", "e", "s"),
    "danish": ("erendes", "erende", "hedens", "ethed", "erede", "heden",
               "heder", "endes", "ernes", "erens", "erets", "erne", "eren",
               "erer", "eres", "ered", "ende", "erne", "ets", "ere", "ens",
               "ers", "ets", "en", "er", "es", "et", "e", "s"),
    "russian": ("иями", "ями", "иях", "иям", "ами", "ого", "его", "ому",
                "ему", "ыми", "ими", "ешь", "ишь", "ете", "ите", "ала",
                "ыла", "ила", "ать", "ять", "ить", "еть", "ует", "ах", "ях",
                "ам", "ям", "ом", "ем", "ой", "ей", "ый", "ий", "ая", "яя",
                "ое", "ее", "ы", "и", "а", "я", "о", "е", "у", "ю", "ь"),
}

# suffixes must live in FOLDED form: light_stem folds the word before
# matching, so accented entries would be unreachable (and singular/plural
# pairs like nação/nações would stem apart). Fold the table once at import,
# order-preserving and deduped.
_LIGHT_SUFFIXES = {
    lang: tuple(dict.fromkeys(s.translate(_UMLAUT_FOLD) for s in sufs))
    for lang, sufs in _LIGHT_SUFFIXES.items()
}

_LIGHT_ALIASES = {
    "light_french": "french", "light_german": "german", "german2": "german",
    "light_spanish": "spanish", "light_italian": "italian",
    "light_portuguese": "portuguese", "portuguese_rslp": "portuguese",
    "light_swedish": "swedish", "light_norwegian": "norwegian",
    "kp": "dutch", "light_russian": "russian",
}


def light_stem(word: str, language: str) -> str:
    """Strip the longest matching inflectional suffix, keeping >= 3 chars
    of stem (applied once — light stemming, not full Snowball)."""
    w = word.lower()
    if language in ("german", "french", "spanish", "portuguese", "italian",
                    "swedish", "norwegian", "danish"):
        w = w.translate(_UMLAUT_FOLD)
    if language == "portuguese":
        # nasal plural normalization (ões/ãos/ães → ão, folded) — the rule
        # PortugueseLightStemmer applies before suffix stripping; without it
        # nação/nações stem apart
        for pl in ("oes", "aos", "aes"):
            if w.endswith(pl) and len(w) - len(pl) >= 2:
                w = w[: -len(pl)] + "ao"
                break
    for suf in _LIGHT_SUFFIXES[language]:
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def stemmer_filter(tokens: List[Token], language: str = "english") -> List[Token]:
    # ES documents capitalized snowball names ("German", "French")
    lang = str(language).lower()
    lang = _LIGHT_ALIASES.get(lang, lang)
    if lang in ("english", "porter", "porter2", "light_english", "minimal_english"):
        return porter_stem_filter(tokens)
    if lang in _LIGHT_SUFFIXES:
        return [(light_stem(t, lang), p) for t, p in tokens]
    # unknown languages degrade to identity (documented: only the table
    # above is supported)
    return list(tokens)


def keyword_marker_filter(tokens: List[Token], keywords=()) -> List[Token]:
    # marker semantics matter only in combination with stemming; our pipeline
    # applies it by pre-filtering stemming candidates in Analyzer.apply
    return list(tokens)


FILTERS: dict = {
    "lowercase": lowercase_filter,
    "uppercase": uppercase_filter,
    "stop": stop_filter,
    "asciifolding": asciifolding_filter,
    "length": length_filter,
    "trim": trim_filter,
    "truncate": truncate_filter,
    "unique": unique_filter,
    "reverse": reverse_filter,
    "shingle": shingle_filter,
    "ngram": ngram_filter,
    "nGram": ngram_filter,
    "edge_ngram": edge_ngram_filter,
    "edgeNGram": edge_ngram_filter,
    "synonym": synonym_filter,
    "porter_stem": porter_stem_filter,
    "stemmer": stemmer_filter,
    "snowball": stemmer_filter,
    "keyword_marker": keyword_marker_filter,
}


def get_filter(name: str, **params) -> Callable[[List[Token]], List[Token]]:
    try:
        fn = FILTERS[name]
    except KeyError:
        raise ValueError(f"unknown token filter [{name}]")
    if name == "stop" and "stopwords" in params:
        sw = params["stopwords"]
        return functools.partial(stop_filter, stopwords=sw)
    if params:
        # map ES param names onto python kwargs where they coincide
        sig_params = {k: v for k, v in params.items() if k not in ("type", "version")}
        if sig_params:
            return functools.partial(fn, **sig_params)
    return fn
