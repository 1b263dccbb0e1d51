"""Tokenizers and token preprocessors.

Mirrors the reference's tokenization SPI (ref: text/tokenization/
tokenizerfactory/DefaultTokenizerFactory.java, tokenizer/
DefaultTokenizer.java, preprocessor/CommonPreprocessor.java,
EndingPreProcessor.java, LowCasePreProcessor.java,
NGramTokenizerFactory.java).  Pure host-side string work.
"""

from __future__ import annotations

import re
from typing import Callable, Iterator, List, Optional


class TokenPreProcess:
    """Per-token normalization hook (ref: tokenization/tokenizer/TokenPreProcess.java)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits (ref: preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude English stemmer (ref: preprocessor/EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        if token.endswith("."):
            token = token[:-1]
        if token.endswith("ly"):
            token = token[:-2]
        if token.endswith("ing"):
            token = token[:-3]
        return token


class StemmingPreprocessor(CommonPreprocessor):
    """CommonPreprocessor + ending stemmer."""

    def pre_process(self, token: str) -> str:
        return EndingPreProcessor().pre_process(super().pre_process(token))


class Tokenizer:
    """Iterator of tokens over one sentence (ref: tokenization/tokenizer/Tokenizer.java)."""

    def __init__(self, tokens: List[str],
                 preprocessor: Optional[TokenPreProcess] = None):
        if preprocessor is not None:
            tokens = [preprocessor.pre_process(t) for t in tokens]
        self._tokens = [t for t in tokens if t]
        self._pos = 0

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        tok = self._tokens[self._pos]
        self._pos += 1
        return tok

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def __iter__(self) -> Iterator[str]:
        return iter(self._tokens)


class DefaultTokenizer(Tokenizer):
    """Whitespace tokenizer (ref: tokenizer/DefaultTokenizer.java wraps
    java.util.StringTokenizer — whitespace splitting)."""

    def __init__(self, sentence: str,
                 preprocessor: Optional[TokenPreProcess] = None):
        super().__init__(sentence.split(), preprocessor)


class TokenizerFactory:
    """Creates tokenizers; carries the shared preprocessor
    (ref: tokenizerfactory/TokenizerFactory.java)."""

    def __init__(self):
        self._preprocessor: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess) -> "TokenizerFactory":
        self._preprocessor = pre
        return self

    def get_token_pre_processor(self) -> Optional[TokenPreProcess]:
        return self._preprocessor

    def create(self, sentence: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    def create(self, sentence: str) -> Tokenizer:
        return DefaultTokenizer(sentence, self._preprocessor)


class RegexTokenizerFactory(TokenizerFactory):
    """Split on a regex (generalization of the reference's PosUima-free options)."""

    def __init__(self, pattern: str = r"\W+"):
        super().__init__()
        self._pattern = re.compile(pattern)

    def create(self, sentence: str) -> Tokenizer:
        return Tokenizer(self._pattern.split(sentence), self._preprocessor)


class NGramTokenizerFactory(TokenizerFactory):
    """Emit n-grams of an underlying tokenizer's tokens
    (ref: tokenizerfactory/NGramTokenizerFactory.java)."""

    def __init__(self, base: TokenizerFactory, min_n: int, max_n: int):
        super().__init__()
        self._base = base
        self._min_n = min_n
        self._max_n = max_n

    def create(self, sentence: str) -> Tokenizer:
        toks = self._base.create(sentence).get_tokens()
        out: List[str] = []
        for n in range(self._min_n, self._max_n + 1):
            for i in range(len(toks) - n + 1):
                out.append(" ".join(toks[i:i + n]))
        return Tokenizer(out, self._preprocessor)
