"""Lattice-based morphological analysis — the kuromoji architecture
(ref: deeplearning4j-nlp-japanese vendored analyzer,
com/atilika/kuromoji/** 55 files: TokenizerBase builds a ViterbiLattice
from dictionary + unknown-word candidates, ViterbiSearcher picks the
min-cost path using word costs + a connection-cost matrix).

This is the same three-stage design, self-contained:

1. **Dictionary lookup** (`MorphDictionary`): a character-trie over
   surface forms; every entry carries a part-of-speech class and a word
   cost.  A seed lexicon of common Japanese function words, auxiliaries
   and high-frequency morphemes ships in-module (no IPADIC in this
   image); domain words are added via ``add`` / ``user_entries`` with a
   low cost, mirroring kuromoji's user-dictionary override.

2. **Unknown-word candidates** (ref: kuromoji UnknownDictionary +
   CharacterDefinition): at positions where the dictionary has no (or
   only short) matches, same-script character groups are emitted as
   candidate tokens with script-class-dependent costs (kanji expensive
   per char, katakana runs cheap, latin/digit grouped whole).

3. **Viterbi search** (`viterbi_segment`): min-cost path through the
   lattice, cost = Σ word_cost + connection(left.pos, right.pos) — the
   connection matrix encodes Japanese ordering preferences (noun→particle
   cheap, particle→particle expensive, ...), the role of kuromoji's
   ConnectionCosts binary.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.text.cjk import _script
from deeplearning4j_tpu_torch.text.tokenization import (
    TokenPreProcess, Tokenizer, TokenizerFactory)

# Part-of-speech classes — the connection-cost context ids
# (ref: kuromoji ConnectionCosts left/right ids, collapsed to POS class).
BOS = "BOS"
EOS = "EOS"
NOUN = "noun"
PARTICLE = "particle"
VERB = "verb"
AUX = "aux"
ADJ = "adj"
ADV = "adv"
PREFIX = "prefix"
SUFFIX = "suffix"
SYMBOL = "symbol"
UNK = "unk"

_POS_IDS = {p: i for i, p in enumerate(
    [BOS, EOS, NOUN, PARTICLE, VERB, AUX, ADJ, ADV, PREFIX, SUFFIX,
     SYMBOL, UNK])}

# Connection-cost matrix [left.pos][right.pos] — small integers; the
# DEFAULT is 10, entries below override.  Encodes the ordering
# preferences kuromoji's ConnectionCosts matrix provides: particles
# attach after nouns/verbs, auxiliaries after verbs, two particles in a
# row are dispreferred, sentences end after verb/aux/noun.
_DEFAULT_CONN = 10
_CONN: Dict[Tuple[str, str], int] = {}


def _conn(pairs: Dict[Tuple[str, str], int]) -> None:
    _CONN.update(pairs)


_conn({
    (BOS, NOUN): 2, (BOS, VERB): 5, (BOS, ADV): 4, (BOS, PREFIX): 3,
    (BOS, ADJ): 4, (BOS, PARTICLE): 12, (BOS, AUX): 14, (BOS, UNK): 6,
    (NOUN, PARTICLE): 1, (NOUN, SUFFIX): 2, (NOUN, NOUN): 6,
    (NOUN, VERB): 5, (NOUN, AUX): 7, (NOUN, EOS): 4,
    (PARTICLE, NOUN): 2, (PARTICLE, VERB): 3, (PARTICLE, ADJ): 3,
    (PARTICLE, ADV): 4, (PARTICLE, PARTICLE): 9, (PARTICLE, UNK): 4,
    (PARTICLE, EOS): 8, (PARTICLE, PREFIX): 4,
    (VERB, AUX): 1, (VERB, PARTICLE): 3, (VERB, EOS): 2, (VERB, NOUN): 6,
    (AUX, EOS): 1, (AUX, PARTICLE): 4, (AUX, AUX): 3, (AUX, NOUN): 8,
    (ADJ, NOUN): 3, (ADJ, EOS): 3, (ADJ, PARTICLE): 4, (ADJ, AUX): 4,
    (ADV, VERB): 2, (ADV, ADJ): 3, (ADV, NOUN): 6,
    (PREFIX, NOUN): 1,
    (SUFFIX, PARTICLE): 2, (SUFFIX, EOS): 4, (SUFFIX, NOUN): 7,
    (UNK, PARTICLE): 3, (UNK, SUFFIX): 4, (UNK, EOS): 5, (UNK, NOUN): 7,
    (UNK, VERB): 6, (UNK, AUX): 7,
    (SYMBOL, NOUN): 5, (NOUN, SYMBOL): 5, (SYMBOL, EOS): 3,
})


def connection_cost(left_pos: str, right_pos: str) -> int:
    return _CONN.get((left_pos, right_pos), _DEFAULT_CONN)


@dataclasses.dataclass(frozen=True)
class MorphEntry:
    """One dictionary entry (ref: kuromoji TokenInfoDictionary record:
    surface, left/right id, word cost, POS features)."""

    surface: str
    pos: str = NOUN
    cost: int = 8
    base_form: Optional[str] = None  # dictionary form for inflections

    def __post_init__(self):
        if self.pos not in _POS_IDS:
            raise ValueError(f"unknown POS {self.pos!r}; "
                             f"known: {sorted(_POS_IDS)}")


# ---------------------------------------------------------------------------
# Seed lexicon — common particles, auxiliaries, demonstratives, frequent
# verbs (with common inflected forms), counters.  Costs: particles and
# auxiliaries very cheap (they are near-certain when they match),
# content words moderate.
# ---------------------------------------------------------------------------

def _entries() -> List[MorphEntry]:
    E = MorphEntry
    out: List[MorphEntry] = []
    # case particles / binding particles
    for s in ("は", "が", "を", "に", "へ", "と", "で", "も", "の", "や",
              "か", "ね", "よ", "ぞ", "わ", "さ"):
        out.append(E(s, PARTICLE, 2))
    for s in ("から", "まで", "より", "には", "では", "とは", "への",
              "だけ", "ほど", "くらい", "など", "ばかり", "しか", "こそ",
              "でも", "にも", "かも", "って"):
        out.append(E(s, PARTICLE, 4))
    # auxiliaries / copula and inflections
    for s, c in (("です", 2), ("でした", 3), ("ます", 2), ("ました", 3),
                 ("ません", 3), ("だ", 3), ("だった", 4), ("である", 4),
                 ("ない", 4), ("なかった", 5), ("たい", 4), ("られる", 4),
                 ("れる", 5), ("せる", 5), ("ている", 4), ("ていた", 4),
                 ("でいる", 5), ("ちゃう", 6), ("けど", 5)):
        out.append(E(s, AUX, c))
    # frequent verbs incl. inflected surfaces
    for s, base in (("する", None), ("した", "する"), ("して", "する"),
                    ("います", "いる"), ("いる", None), ("いた", "いる"),
                    ("ある", None), ("あった", "ある"), ("あります", "ある"),
                    ("なる", None), ("なった", "なる"), ("行く", None),
                    ("行った", "行く"), ("来る", None), ("来た", "来る"),
                    ("見る", None), ("見た", "見る"), ("言う", None),
                    ("言った", "言う"), ("思う", None), ("思った", "思う"),
                    ("食べる", None), ("食べた", "食べる"), ("ぬぐ", None),
                    ("書く", None), ("書いた", "書く"), ("読む", None),
                    ("読んだ", "読む"), ("使う", None), ("使った", "使う"),
                    ("できる", None), ("わかる", None), ("はく", None)):
        out.append(E(s, VERB, 6, base))
    # adjectives / adverbs / demonstratives
    for s in ("大きい", "小さい", "新しい", "古い", "良い", "よい", "いい",
              "高い", "安い", "早い", "遅い", "多い", "少ない", "長い", "短い"):
        out.append(E(s, ADJ, 6))
    for s in ("とても", "すこし", "少し", "もっと", "すぐ", "まだ", "もう",
              "いつも", "よく", "そして", "しかし", "また", "でも"):
        out.append(E(s, ADV, 5))
    for s in ("これ", "それ", "あれ", "どれ", "ここ", "そこ", "あそこ",
              "どこ", "この", "その", "あの", "どの", "こう", "そう", "ああ"):
        out.append(E(s, NOUN, 4))
    # common nouns (incl. the classic segmentation-ambiguity test words)
    for s in ("こと", "もの", "とき", "ところ", "ため", "ひと", "人", "日",
              "年", "月", "時間", "今日", "明日", "昨日", "日本", "東京",
              "東京都", "京都", "学校", "会社", "電車", "天気", "雨",
              "すもも", "もも", "うち", "にわ", "にわとり", "きもの",
              "はきもの", "仕事", "言葉", "問題", "結果", "世界", "自分"):
        out.append(E(s, NOUN, 6))
    for s in ("お", "ご", "新", "再"):
        out.append(E(s, PREFIX, 5))
    for s in ("さん", "ちゃん", "くん", "様", "たち", "的", "者", "化"):
        out.append(E(s, SUFFIX, 4))
    return out


class MorphDictionary:
    """Trie-backed surface dictionary with common-prefix lookup
    (ref: kuromoji TokenInfoDictionary + DoubleArrayTrie — a plain char
    trie here; lookups are per-sentence, not a serving hot path)."""

    def __init__(self, entries: Optional[Iterable[MorphEntry]] = None,
                 seed: bool = True):
        self._trie: dict = {}
        self.max_len = 1
        if seed:
            for e in _entries():
                self.add(e)
        for e in entries or ():
            self.add(e)

    def add(self, entry: MorphEntry) -> None:
        node = self._trie
        for ch in entry.surface:
            node = node.setdefault(ch, {})
        node.setdefault(None, []).append(entry)
        self.max_len = max(self.max_len, len(entry.surface))

    def add_word(self, surface: str, pos: str = NOUN, cost: int = 3) -> None:
        """User-dictionary entry — low default cost so it wins over the
        seed lexicon and unknown-word candidates (kuromoji user-dict
        semantics)."""
        self.add(MorphEntry(surface, pos, cost))

    def prefixes(self, text: str, start: int) -> List[MorphEntry]:
        """All dictionary entries whose surface == text[start:start+k]."""
        out: List[MorphEntry] = []
        node = self._trie
        i = start
        n = len(text)
        while i < n:
            node = node.get(text[i])
            if node is None:
                break
            i += 1
            out.extend(node.get(None, ()))
        return out


# ---------------------------------------------------------------------------
# Lattice + Viterbi
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LatticeNode:
    start: int
    end: int
    surface: str
    pos: str
    cost: int
    base_form: Optional[str] = None
    is_unknown: bool = False


# unknown-word generation per script class
# (ref: kuromoji CharacterDefinition invoke/group/length settings);
# punct groups whole so it carries pos=SYMBOL (and the symbol rows of
# the connection matrix apply)
_UNK_GROUP_WHOLE = {"latin", "digit", "katakana", "hangul", "punct"}
_UNK_CHAR_COST = {"kanji": 9, "hiragana": 8, "katakana": 4, "latin": 3,
                  "digit": 3, "hangul": 4, "punct": 4}
_UNK_MAX_LEN = {"kanji": 3, "hiragana": 4}


def _unknown_candidates(text: str, start: int) -> List[LatticeNode]:
    s = _script(text[start])
    n = len(text)
    end = start + 1
    while end < n and _script(text[end]) == s:
        end += 1
    run_len = end - start
    base = _UNK_CHAR_COST.get(s, 6)
    out: List[LatticeNode] = []
    if s in _UNK_GROUP_WHOLE:
        # whole same-script group as one token (kuromoji GROUP=true)
        out.append(LatticeNode(start, end, text[start:end],
                               SYMBOL if s == "punct" else UNK,
                               base + run_len, is_unknown=True))
    else:
        for L in range(1, min(_UNK_MAX_LEN.get(s, 2), run_len) + 1):
            out.append(LatticeNode(start, start + L, text[start:start + L],
                                   UNK, base * L + 2, is_unknown=True))
    return out


def build_lattice(text: str, dictionary: MorphDictionary
                  ) -> List[List[LatticeNode]]:
    """Nodes grouped by start position; every position is guaranteed at
    least one candidate (single-char unknown fallback) so the lattice is
    always connected."""
    n = len(text)
    by_start: List[List[LatticeNode]] = [[] for _ in range(n)]
    for i in range(n):
        if text[i].isspace():
            continue
        for e in dictionary.prefixes(text, i):
            by_start[i].append(LatticeNode(i, i + len(e.surface), e.surface,
                                           e.pos, e.cost, e.base_form))
        # unknown-word candidates: always invoked (short dictionary hits
        # must still compete with longer unknown spans and vice versa)
        by_start[i].extend(_unknown_candidates(text, i))
    return by_start


def viterbi_segment(text: str, dictionary: MorphDictionary
                    ) -> List[LatticeNode]:
    """Min-cost path (ref: kuromoji ViterbiSearcher.search) — dynamic
    program over positions; whitespace breaks the lattice into segments
    scored independently."""
    out: List[LatticeNode] = []
    start = 0
    n = len(text)
    while start < n:
        if text[start].isspace():
            start += 1
            continue
        end = start
        while end < n and not text[end].isspace():
            end += 1
        out.extend(_viterbi_span(text[start:end], dictionary, offset=start))
        start = end
    return out


def _viterbi_span(span: str, dictionary: MorphDictionary,
                  offset: int = 0) -> List[LatticeNode]:
    """True lattice Viterbi: the DP state is (position, POS class), not
    position alone — connection cost depends on the PREDECESSOR's POS,
    so a slightly more expensive prefix ending in a different class can
    still carry the global optimum (kuromoji's ViterbiSearcher relaxes
    per node the same way)."""
    n = len(span)
    if n == 0:
        return []
    by_start = build_lattice(span, dictionary)
    # best cost arriving at position i with a last-token POS class;
    # back[(i, pos)] = (node, prev_pos) for path reconstruction
    best: List[Dict[str, float]] = [dict() for _ in range(n + 1)]
    back: Dict[Tuple[int, str], Tuple[LatticeNode, str]] = {}
    best[0][BOS] = 0.0
    for i in range(n):
        if not best[i]:
            continue
        for node in by_start[i]:
            step = node.cost
            tgt = best[node.end]
            for left_pos, c0 in best[i].items():
                c = c0 + step + connection_cost(left_pos, node.pos)
                if c < tgt.get(node.pos, float("inf")):
                    tgt[node.pos] = c
                    back[(node.end, node.pos)] = (node, left_pos)
    # EOS connection picks the final class
    toks: List[LatticeNode] = []
    if best[n]:
        pos_cls = min(best[n],
                      key=lambda p: best[n][p] + connection_cost(p, EOS))
        pos = n
        while pos > 0:
            entry = back.get((pos, pos_cls))
            if entry is None:  # disconnected (shouldn't happen) — fall back
                toks.append(LatticeNode(pos - 1, pos, span[pos - 1], UNK, 0,
                                        is_unknown=True))
                pos -= 1
                pos_cls = UNK if (pos, UNK) in back else \
                    next((p for e, p in back if e == pos), BOS)
                continue
            node, prev_pos = entry
            toks.append(node)
            pos = node.start
            pos_cls = prev_pos
    toks.reverse()
    if offset:
        toks = [dataclasses.replace(t, start=t.start + offset,
                                    end=t.end + offset) for t in toks]
    return toks


# ---------------------------------------------------------------------------
# Tokenizer contract
# ---------------------------------------------------------------------------
# IPADIC/kuromoji CSV dictionary loading — a user who has a real
# kuromoji-format dictionary (IPADIC, NAIST-jdic, UniDic export, or a
# kuromoji user dictionary) can load it into MorphDictionary instead of
# the seed lexicon.
# ---------------------------------------------------------------------------

def parse_dictionary_line(line: str) -> List[str]:
    """Quote-aware CSV split with ``""`` unescape — kuromoji's
    DictionaryEntryLineParser.parseLine semantics (surfaces may contain
    commas inside quotes, e.g. ``"1,000",...``)."""
    fields: List[str] = []
    buf: List[str] = []
    inside = False
    quotes = 0
    for ch in line:
        if ch == '"':
            inside = not inside
            quotes += 1
        if ch == "," and not inside:
            fields.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if quotes % 2:
        raise ValueError(f"Unmatched quote in entry: {line!r}")
    fields.append("".join(buf))

    def unescape(v: str) -> str:
        if len(v) > 1 and v[0] == '"' and v[-1] == '"':
            v = v[1:-1]
        return v.replace('""', '"')

    return [unescape(f) for f in fields]


# IPADIC part-of-speech level-1 (and the 接尾 level-2 marker) → the
# connection-cost POS classes this lattice uses.  IPADIC names are
# standard across kuromoji-format dictionaries.
_IPADIC_POS = {
    "名詞": NOUN, "助詞": PARTICLE, "動詞": VERB, "助動詞": AUX,
    "形容詞": ADJ, "副詞": ADV, "接頭詞": PREFIX, "連体詞": ADJ,
    "接続詞": ADV, "感動詞": ADV, "記号": SYMBOL, "フィラー": ADV,
    "その他": UNK,
}

_IPADIC_POS_BY_LEN = sorted(_IPADIC_POS, key=len, reverse=True)


def ipadic_entry(fields: Sequence[str],
                 cost_divisor: int = 1500) -> MorphEntry:
    """One IPADIC CSV row → MorphEntry.  Layout (ref: kuromoji
    ipadic/compile/DictionaryEntry.java:24-66): surface, left_id,
    right_id, word_cost, pos1..pos4, conj_type, conj_form, base_form,
    reading, pronunciation.  Short rows (user dictionaries) need only
    surface[,left,right,cost[,pos1]].

    IPADIC word costs are shorts (≈ -20000..20000, frequent words most
    negative); this lattice's costs are small non-negative ints on the
    seed lexicon's scale, so raw costs are affinely squashed:
    ``clip(round(cost/divisor) + 8, 0, 24)`` — order-preserving, and a
    typical frequent word (≈ -6000) lands near the seed lexicon's cheap
    entries."""
    surface = fields[0]
    f3 = fields[3].strip() if len(fields) > 3 else ""
    try:
        raw_cost = int(f3) if f3 else 0
    except ValueError:
        # kuromoji USER-dictionary layout instead: surface, segmentation,
        # readings, pos-name (dict/UserDictionary.java) — field 3 is a
        # POS string like カスタム名詞.  Cheap cost so the user entry
        # wins, mirroring add_word / kuromoji user-dict semantics.
        return MorphEntry(surface, _ja_pos_name(f3), 3)
    pos1 = fields[4] if len(fields) > 4 else ""
    pos2 = fields[5] if len(fields) > 5 else ""
    pos = _IPADIC_POS.get(pos1, NOUN)
    if pos is NOUN and "接尾" in (pos1, pos2):
        pos = SUFFIX
    base = fields[10] if len(fields) > 10 else None
    if base in ("*", "", surface):
        base = None
    cost = int(min(24, max(0, round(raw_cost / cost_divisor) + 8)))
    return MorphEntry(surface, pos, cost, base)


def _ja_pos_name(name: str) -> str:
    """Best-effort POS class from a Japanese POS NAME (user dictionaries
    use free-form names like カスタム名詞): substring match against the
    IPADIC level-1 names, LONGEST first (助動詞 must hit aux, not the
    embedded 動詞), NOUN fallback."""
    for ja in _IPADIC_POS_BY_LEN:
        if ja in name:
            return _IPADIC_POS[ja]
    return NOUN


def load_ipadic_csv(source, dictionary: Optional[MorphDictionary] = None,
                    encoding: str = "utf-8-sig",
                    cost_divisor: int = 1500) -> MorphDictionary:
    """Load a kuromoji/IPADIC-format CSV dictionary (or a kuromoji USER
    dictionary — auto-detected per row) into a MorphDictionary (ref: the
    vendored analyzer's compile step,
    com/atilika/kuromoji/ipadic/compile/DictionaryEntry.java,
    dict/UserDictionary.java).

    ``source`` is a path (original IPADIC ships EUC-JP — pass
    ``encoding='euc-jp'``; the default also absorbs a UTF-8 BOM) or an
    iterable of already-decoded lines.  Kuromoji CSV has no comment
    syntax, so every non-empty line is an entry.  With no ``dictionary``
    argument a fresh one WITHOUT the seed lexicon is returned (a real
    dictionary replaces the seed, which remains the zero-download
    fallback); pass an existing dictionary to merge."""
    if dictionary is None:
        dictionary = MorphDictionary(seed=False)
    opened = None
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        import io as _io
        lines = opened = _io.open(source, "r", encoding=encoding)
    else:
        lines = source  # iterable of lines or an open file object
    try:
        for line in lines:
            line = line.strip("\r\n")
            if not line:
                continue
            dictionary.add(ipadic_entry(parse_dictionary_line(line),
                                        cost_divisor))
    finally:
        if opened is not None:
            opened.close()
    return dictionary


class JapaneseLatticeTokenizer(Tokenizer):
    """Viterbi segmentation with morpheme metadata
    (ref: kuromoji Token — surface/base-form/POS accessors)."""

    def __init__(self, sentence: str, dictionary: MorphDictionary,
                 preprocessor: Optional[TokenPreProcess] = None,
                 keep_punct: bool = False):
        import unicodedata
        self.morphemes = viterbi_segment(
            unicodedata.normalize("NFKC", sentence), dictionary)
        if not keep_punct:
            self.morphemes = [m for m in self.morphemes
                              if m.pos != SYMBOL
                              and _script(m.surface[0]) != "punct"]
        super().__init__([m.surface for m in self.morphemes], preprocessor)


class JapaneseLatticeTokenizerFactory(TokenizerFactory):
    """Drop-in TokenizerFactory for Word2Vec / the text pipeline — the
    dictionary-backed upgrade over cjk.JapaneseTokenizerFactory's
    longest-match heuristic."""

    def __init__(self, user_entries: Optional[Iterable] = None,
                 keep_punct: bool = False,
                 dictionary: Optional[MorphDictionary] = None):
        super().__init__()
        # a user-supplied dictionary (e.g. load_ipadic_csv) replaces the
        # seed lexicon, mirroring kuromoji's dictionary selection
        self.dictionary = dictionary if dictionary is not None \
            else MorphDictionary()
        for e in user_entries or ():
            if isinstance(e, MorphEntry):
                self.dictionary.add(e)
            else:
                self.dictionary.add_word(str(e))
        self.keep_punct = keep_punct

    def create(self, sentence: str) -> Tokenizer:
        return JapaneseLatticeTokenizer(sentence, self.dictionary,
                                        self._preprocessor,
                                        self.keep_punct)
