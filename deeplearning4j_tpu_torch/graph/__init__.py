"""Graph embeddings (ref: deeplearning4j-graph — graph/Graph.java,
data/GraphLoader.java, iterator random walkers, models/deepwalk/
DeepWalk.java + GraphHuffman.java).

Walks are generated on the host (pointer-chasing), then the embedding
training rides the same skip-gram/HS steps as Word2Vec through the
SequenceVectors engine on the device.
"""

from deeplearning4j_tpu_torch.graph.graph import Edge, Graph, Vertex  # noqa: F401
from deeplearning4j_tpu_torch.graph.loader import GraphLoader  # noqa: F401
from deeplearning4j_tpu_torch.graph.walkers import (  # noqa: F401
    Node2VecWalker, RandomWalkIterator, WeightedRandomWalkIterator)
from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk, GraphHuffman  # noqa: F401
from deeplearning4j_tpu_torch.graph.serializer import GraphVectorSerializer  # noqa: F401
