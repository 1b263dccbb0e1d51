"""Embedding models: SequenceVectors, Word2Vec, ParagraphVectors, GloVe.

The port of the JAX package's embedding stack (ref: models/
sequencevectors/SequenceVectors.java, models/word2vec/,
models/paragraphvectors/, models/glove/).  The reference's hot loop is a
fused native op per (center, context) pair batched 4096-at-a-time into
libnd4j (ref: models/embeddings/learning/impl/elements/SkipGram.java:271
``AggregateSkipGram``).  Here each flush of pairs is a loop of plain
torch ops on the device — gather rows, dot, sigmoid, scatter-add — over
chunks of 64 pairs, updating the tables in place (``kernels.py``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

from deeplearning4j_tpu_torch.embeddings.lookup import InMemoryLookupTable  # noqa: F401
from deeplearning4j_tpu_torch.embeddings.sequencevectors import (  # noqa: F401
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.embeddings.word2vec import Word2Vec  # noqa: F401
from deeplearning4j_tpu_torch.embeddings.paragraphvectors import ParagraphVectors  # noqa: F401
from deeplearning4j_tpu_torch.embeddings.glove import Glove  # noqa: F401
from deeplearning4j_tpu_torch.embeddings.serializer import WordVectorSerializer  # noqa: F401
