"""Graph vector persistence (ref: models/deepwalk/GraphVectorSerializer.java
— writeGraphVectors/loadTxtVectors: line per vertex "idx v0 v1 ...")."""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.graph.deepwalk import DeepWalk


class GraphVectorSerializer:
    @staticmethod
    def write_graph_vectors(model: DeepWalk, path: str) -> None:
        with open(path, "w") as f:
            for label in model.vocab.words():
                vec = model.word_vector(label)
                f.write(label + "\t" +
                        "\t".join(f"{v:.8g}" for v in vec) + "\n")

    @staticmethod
    def load_txt_vectors(path: str) -> dict:
        """→ {vertex_idx: np.ndarray} (ref: loadTxtVectors)."""
        out = {}
        with open(path) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                out[int(parts[0])] = np.array([float(v) for v in parts[1:]],
                                              np.float32)
        return out
