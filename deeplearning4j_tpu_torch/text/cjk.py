"""Japanese and Korean tokenizers
(ref: deeplearning4j-nlp-japanese — vendored kuromoji morphological
analyzer, com/atilika/kuromoji/** 55 files;
deeplearning4j-nlp-korean/.../KoreanTokenizer.java + twitter-text).

No dictionary ships in this image, so segmentation is script-class
driven with longest-match user/function-word dictionaries — the same
TokenizerFactory contract as the reference (plug into Word2Vec &
the text pipeline), with the dictionary as an extension point
(``user_dict``)."""

from __future__ import annotations

import re
import unicodedata
from typing import Iterable, List, Optional, Set

from deeplearning4j_tpu_torch.text.tokenization import (
    TokenPreProcess, Tokenizer, TokenizerFactory)

# -- script classification ---------------------------------------------------

_HIRAGANA = ("぀", "ゟ")
_KATAKANA = ("゠", "ヿ")
_KANJI = ("一", "鿿")
_HANGUL = ("가", "힣")
_HANGUL_JAMO = ("ᄀ", "ᇿ")


def _script(ch: str) -> str:
    if _HIRAGANA[0] <= ch <= _HIRAGANA[1]:
        return "hiragana"
    if _KATAKANA[0] <= ch <= _KATAKANA[1] or ch == "ー":  # chōonpu
        return "katakana"
    if _KANJI[0] <= ch <= _KANJI[1] or ch in "々〇":  # 々〇
        return "kanji"
    if (_HANGUL[0] <= ch <= _HANGUL[1]
            or _HANGUL_JAMO[0] <= ch <= _HANGUL_JAMO[1]):
        return "hangul"
    if ch.isalpha():
        return "latin"
    if ch.isdigit():
        return "digit"
    if ch.isspace():
        return "space"
    return "punct"


def _runs(text: str) -> List[str]:
    """Split into maximal same-script runs, dropping whitespace."""
    out: List[str] = []
    cur = ""
    cur_s = None
    for ch in text:
        s = _script(ch)
        if s == cur_s and s != "punct":
            cur += ch
        else:
            if cur and cur_s != "space":
                out.append(cur)
            cur = ch
            cur_s = s
    if cur and cur_s != "space":
        out.append(cur)
    return out


def _longest_match_split(run: str, dictionary: Set[str],
                         max_len: int) -> List[str]:
    """Greedy longest-match over a dictionary; unmatched prefixes emit
    single characters (kuromoji's unknown-word fallback for kanji)."""
    out: List[str] = []
    i = 0
    n = len(run)
    while i < n:
        matched = None
        for L in range(min(max_len, n - i), 0, -1):
            if run[i:i + L] in dictionary:
                matched = run[i:i + L]
                break
        if matched:
            out.append(matched)
            i += len(matched)
        else:
            out.append(run[i])
            i += 1
    return out


# -- Japanese ----------------------------------------------------------------

# Common particles/auxiliaries (hiragana function words) — the role of
# kuromoji's IPADIC entries for segmentation of hiragana runs.
_JA_FUNCTION = {
    "これ", "それ", "あれ", "ここ", "そこ", "の", "は", "が", "を", "に", "へ", "と",
    "で", "から", "まで", "より", "も", "か", "な", "ね", "よ", "です", "ます",
    "でした", "ました", "する", "した", "して", "いる", "ある", "ない", "だ",
    "という", "こと", "もの", "ため", "そして", "しかし", "また",
}


class JapaneseTokenizer(Tokenizer):
    """(ref: deeplearning4j-nlp-japanese JapaneseTokenizer over kuromoji)

    Segmentation: script-run boundaries are always token boundaries
    (kanji↔kana↔latin↔digit); hiragana runs are further split by
    longest-match over the function-word dictionary; kanji runs by
    longest-match over the user dictionary (else single chars —
    kuromoji's unknown-word heuristic)."""

    def __init__(self, sentence: str,
                 preprocessor: Optional[TokenPreProcess] = None,
                 user_dict: Optional[Set[str]] = None):
        user_dict = user_dict or set()
        max_u = max((len(w) for w in user_dict), default=1)
        toks: List[str] = []
        for run in _runs(unicodedata.normalize("NFKC", sentence)):
            s = _script(run[0])
            if s == "hiragana":
                toks.extend(_longest_match_split(
                    run, _JA_FUNCTION | user_dict,
                    max(max_u, 3)))
            elif s == "kanji":
                if user_dict:
                    toks.extend(_longest_match_split(run, user_dict, max_u))
                else:
                    toks.append(run)
            elif s == "punct":
                continue
            else:
                toks.append(run)
        super().__init__(toks, preprocessor)


class JapaneseTokenizerFactory(TokenizerFactory):
    """(ref: JapaneseTokenizerFactory.java)"""

    def __init__(self, user_dict: Optional[Iterable[str]] = None):
        super().__init__()
        self.user_dict = set(user_dict or [])

    def create(self, sentence: str) -> Tokenizer:
        return JapaneseTokenizer(sentence, self._preprocessor,
                                 self.user_dict)


# -- Korean ------------------------------------------------------------------

# Common postpositions (josa) stripped from the end of eojeol —
# the role of twitter-text's Korean stemmer in the reference.
_KO_JOSA = (
    "은", "는", "이", "가", "을", "를", "과", "와", "의", "에", "에서", "에게",
    "으로", "로", "도", "만", "까지", "부터", "보다", "처럼", "하고", "이나",
)


class KoreanTokenizer(Tokenizer):
    """(ref: deeplearning4j-nlp-korean/.../KoreanTokenizer.java)

    Eojeol (space-delimited) tokens; hangul↔latin↔digit boundaries
    split; trailing single-syllable josa separated (``strip_josa``)."""

    def __init__(self, sentence: str,
                 preprocessor: Optional[TokenPreProcess] = None,
                 strip_josa: bool = True):
        toks: List[str] = []
        for run in _runs(unicodedata.normalize("NFKC", sentence)):
            if _script(run[0]) == "punct":
                continue
            if strip_josa and _script(run[0]) == "hangul" and len(run) > 1:
                stripped = False
                for josa in sorted(_KO_JOSA, key=len, reverse=True):
                    if run.endswith(josa) and len(run) > len(josa):
                        toks.append(run[:-len(josa)])
                        toks.append(josa)
                        stripped = True
                        break
                if not stripped:
                    toks.append(run)
            else:
                toks.append(run)
        super().__init__(toks, preprocessor)


class KoreanTokenizerFactory(TokenizerFactory):
    """(ref: KoreanTokenizerFactory.java)"""

    def __init__(self, strip_josa: bool = True):
        super().__init__()
        self.strip_josa = strip_josa

    def create(self, sentence: str) -> Tokenizer:
        return KoreanTokenizer(sentence, self._preprocessor,
                               self.strip_josa)
