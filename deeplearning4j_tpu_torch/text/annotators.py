"""Annotation pipeline — the UIMA-analysis-engine role
(ref: deeplearning4j-nlp-uima/.../text/annotator/{SentenceAnnotator,
TokenizerAnnotator,PoStagger,StemmerAnnotator}.java — ClearTK/OpenNLP
engines behind a pipeline of annotators over a CAS).

The capability is the composable annotate() chain producing sentence,
token, POS, and stem annotations; the heavyweight UIMA CAS is replaced
by a plain Annotation list on an AnalysisContext."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional


@dataclasses.dataclass
class Annotation:
    kind: str      # sentence | token | pos | stem
    begin: int
    end: int
    value: str


class AnalysisContext:
    """The CAS analog: raw text + annotation layers."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: List[Annotation] = []

    def select(self, kind: str) -> List[Annotation]:
        return [a for a in self.annotations if a.kind == kind]

    def covered(self, kind: str, span: Annotation) -> List[Annotation]:
        return [a for a in self.annotations
                if a.kind == kind and a.begin >= span.begin
                and a.end <= span.end]


class Annotator:
    def process(self, ctx: AnalysisContext) -> None:
        raise NotImplementedError


class SentenceAnnotator(Annotator):
    """(ref: text/annotator/SentenceAnnotator.java)"""

    _BOUNDARY = re.compile(r"[.!?]+[\s\"')\]]*")

    def process(self, ctx: AnalysisContext) -> None:
        start = 0
        for m in self._BOUNDARY.finditer(ctx.text):
            end = m.end()
            seg = ctx.text[start:end].strip()
            if seg:
                b = ctx.text.index(seg, start)
                ctx.annotations.append(
                    Annotation("sentence", b, b + len(seg), seg))
            start = end
        tail = ctx.text[start:].strip()
        if tail:
            b = ctx.text.index(tail, start)
            ctx.annotations.append(
                Annotation("sentence", b, b + len(tail), tail))


class TokenizerAnnotator(Annotator):
    """(ref: text/annotator/TokenizerAnnotator.java)"""

    _TOKEN = re.compile(r"\w+(?:'\w+)?|[^\w\s]")

    def process(self, ctx: AnalysisContext) -> None:
        for sent in ctx.select("sentence"):
            for m in self._TOKEN.finditer(sent.value):
                ctx.annotations.append(Annotation(
                    "token", sent.begin + m.start(),
                    sent.begin + m.end(), m.group()))


class PoSTagger(Annotator):
    """Lightweight rule/lexicon POS tagger filling the PoStagger slot
    (ref: text/annotator/PoStagger.java — OpenNLP maxent model behind
    the same annotate-tokens-with-POS contract)."""

    _LEX: Dict[str, str] = {
        "the": "DT", "a": "DT", "an": "DT", "of": "IN", "in": "IN",
        "on": "IN", "at": "IN", "to": "TO", "and": "CC", "or": "CC",
        "is": "VBZ", "are": "VBP", "was": "VBD", "were": "VBD",
        "be": "VB", "been": "VBN", "he": "PRP", "she": "PRP", "it": "PRP",
        "they": "PRP", "i": "PRP", "you": "PRP", "we": "PRP",
        "not": "RB", "very": "RB", "quickly": "RB",
    }

    def _tag(self, word: str) -> str:
        lw = word.lower()
        if lw in self._LEX:
            return self._LEX[lw]
        if not word[0].isalnum():
            return "."
        if word[0].isdigit():
            return "CD"
        if word.endswith("ing"):
            return "VBG"
        if word.endswith("ed"):
            return "VBD"
        if word.endswith("ly"):
            return "RB"
        if word.endswith("s") and len(word) > 3:
            return "NNS"
        if word[0].isupper():
            return "NNP"
        return "NN"

    def process(self, ctx: AnalysisContext) -> None:
        for tok in ctx.select("token"):
            ctx.annotations.append(Annotation(
                "pos", tok.begin, tok.end, self._tag(tok.value)))


class StemmerAnnotator(Annotator):
    """Porter stemmer (ref: text/annotator/StemmerAnnotator.java —
    Snowball stemmer behind the stem-each-token contract)."""

    def process(self, ctx: AnalysisContext) -> None:
        for tok in ctx.select("token"):
            ctx.annotations.append(Annotation(
                "stem", tok.begin, tok.end, porter_stem(tok.value)))


class AnnotationPipeline:
    """Compose annotators (the AnalysisEngine chain)."""

    def __init__(self, *annotators: Annotator):
        self.annotators = list(annotators) or [
            SentenceAnnotator(), TokenizerAnnotator(), PoSTagger(),
            StemmerAnnotator()]

    def annotate(self, text: str) -> AnalysisContext:
        ctx = AnalysisContext(text)
        for a in self.annotators:
            a.process(ctx)
        return ctx


# ---------------------------------------------------------------------------
# Porter stemming algorithm (Porter 1980) — public-domain algorithm,
# implemented from the paper's rule tables.

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        cons = _is_cons(stem, i)
        if prev_vowel and cons:
            m += 1
        prev_vowel = not cons
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3)
            and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1)
            and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2 or not w.isalpha():
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif not w.endswith("ss") and w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        flag = False
        if w.endswith("ed") and _has_vowel(w[:-2]):
            w = w[:-2]
            flag = True
        elif w.endswith("ing") and _has_vowel(w[:-3]):
            w = w[:-3]
            flag = True
        if flag:
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
                     ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
                     ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
                     ("iviti", "ive"), ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible", "ant",
                "ement", "ment", "ent", "ou", "ism", "ate", "iti", "ous",
                "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 1:
                w = w[:-len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st":
            if _measure(w[:-3]) > 1:
                w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        if _measure(stem) > 1 or (_measure(stem) == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
