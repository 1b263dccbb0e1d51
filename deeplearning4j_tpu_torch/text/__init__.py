"""Text pipeline: tokenizers, sentence iterators, vocab construction.

The port's copy of the JAX package's ``text`` modules that the embedding
trainers read (ref: deeplearning4j-nlp-parent/deeplearning4j-nlp/.../text/
— sentence iterators, tokenization factories, stopwords — and
models/word2vec/wordstore/ — vocab cache + Huffman coding).  All of this
is host-side work feeding integer batches to the device steps in
``deeplearning4j_tpu_torch.embeddings``.
"""

from deeplearning4j_tpu_torch.text.sequence import Sequence, SequenceElement, VocabWord  # noqa: F401
from deeplearning4j_tpu_torch.text.tokenization import (  # noqa: F401
    CommonPreprocessor,
    DefaultTokenizer,
    DefaultTokenizerFactory,
    EndingPreProcessor,
    LowCasePreProcessor,
    NGramTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.text.sentence_iterators import (  # noqa: F401
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelAwareListSentenceIterator,
    LabelsSource,
    SentenceIterator,
)
from deeplearning4j_tpu_torch.text.stopwords import StopWords  # noqa: F401
from deeplearning4j_tpu_torch.text.vocab import AbstractCache, Huffman, VocabConstructor  # noqa: F401
