"""Word-vector persistence.

Mirrors the reference's ``WordVectorSerializer`` (ref: models/embeddings/
loader/WordVectorSerializer.java — original-C text & binary formats,
plus full-model zip with config json + vocab + syn0/syn1).  The files
are those of the JAX package, byte for byte for the same tables; a
reader puts the tables on ``device`` (CUDA unless the caller passes
``device="cpu"``).
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np

from deeplearning4j_tpu_torch.embeddings.lookup import (
    TABLES, InMemoryLookupTable)
from deeplearning4j_tpu_torch.embeddings.sequencevectors import (
    SequenceVectors, VectorsConfiguration)
from deeplearning4j_tpu_torch.ops.platform import DeviceLike
from deeplearning4j_tpu_torch.text.sequence import VocabWord
from deeplearning4j_tpu_torch.text.vocab import AbstractCache


class WordVectorSerializer:

    # -- original C text format -------------------------------------------
    @staticmethod
    def write_word_vectors(vectors, path: str) -> None:
        """``V D`` header then ``word f f f...`` per line (word2vec text)."""
        table = vectors.lookup_table
        vocab = vectors.vocab
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{vocab.num_words()} {table.vector_length}\n")
            syn0 = table.get_weights()
            for i in range(vocab.num_words()):
                word = vocab.word_at_index(i)
                vals = " ".join(f"{x:.6f}" for x in syn0[i])
                f.write(f"{word.label} {vals}\n")

    @staticmethod
    def read_word_vectors(path: str,
                          device: DeviceLike = None) -> SequenceVectors:
        vocab = AbstractCache()
        rows = []
        with open(path, "r", encoding="utf-8") as f:
            header = f.readline().split()
            _v, d = int(header[0]), int(header[1])
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < d + 1:
                    continue
                # Parse from the right: the last d fields are the vector,
                # everything before is the token (tokens may contain
                # spaces, e.g. n-grams or multi-word PV labels).
                word = VocabWord(" ".join(parts[:-d]))
                vocab.add_token(word)
                rows.append(np.array(parts[-d:], np.float32))
        # preserve file order as index order
        for i, label in enumerate(list(vocab._map)):
            vocab._map[label].index = i
        vocab._index = list(vocab._map.values())
        vocab.update_words_occurrences()
        sv = SequenceVectors(VectorsConfiguration(layer_size=d), vocab=vocab,
                             device=device)
        sv.lookup_table = InMemoryLookupTable.from_arrays(
            vocab, np.stack(rows), device=device)
        return sv

    # -- original C binary format -----------------------------------------
    @staticmethod
    def write_binary(vectors, path: str) -> None:
        table = vectors.lookup_table
        vocab = vectors.vocab
        syn0 = table.get_weights().astype(np.float32, copy=False)
        with open(path, "wb") as f:
            f.write(f"{vocab.num_words()} {table.vector_length}\n"
                    .encode("utf-8"))
            for i in range(vocab.num_words()):
                f.write(vocab.word_at_index(i).label.encode("utf-8") + b" ")
                f.write(syn0[i].tobytes())
                f.write(b"\n")

    @staticmethod
    def read_binary(path: str,
                    device: DeviceLike = None) -> SequenceVectors:
        with open(path, "rb") as f:
            header = f.readline().decode("utf-8").split()
            v, d = int(header[0]), int(header[1])
            vocab = AbstractCache()
            rows = []
            for _ in range(v):
                label = bytearray()
                while True:
                    ch = f.read(1)
                    if ch in (b" ", b""):
                        break
                    label += ch
                vec = np.frombuffer(f.read(4 * d), np.float32)
                f.read(1)  # trailing newline
                word = VocabWord(label.decode("utf-8"))
                vocab.add_token(word)
                rows.append(vec)
        for i, lab in enumerate(list(vocab._map)):
            vocab._map[lab].index = i
        vocab._index = list(vocab._map.values())
        sv = SequenceVectors(VectorsConfiguration(layer_size=d), vocab=vocab,
                             device=device)
        sv.lookup_table = InMemoryLookupTable.from_arrays(
            vocab, np.stack(rows), device=device)
        return sv

    # -- full model zip ----------------------------------------------------
    @staticmethod
    def write_word2vec_model(vectors, path: str) -> None:
        """Zip: config.json + vocab.json + syn0/syn1/syn1neg .npy
        (ref: writeWord2VecModel's zip of config/vocab/syn arrays)."""
        table = vectors.lookup_table
        vocab = vectors.vocab
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("config.json", json.dumps(vectors.conf.to_json()))
            vocab_entries = [
                {"label": w.label, "frequency": w.element_frequency,
                 "index": w.index, "codes": w.codes, "points": w.points,
                 "special": w.special, "isLabel": w.is_label}
                for w in vocab.vocab_words()]
            z.writestr("vocab.json", json.dumps(vocab_entries))
            for name in ("syn0", "syn1", "syn1neg"):
                arr = table.array(name)
                if arr is not None:
                    buf = io.BytesIO()
                    np.save(buf, arr)
                    z.writestr(f"{name}.npy", buf.getvalue())

    @staticmethod
    def read_word2vec_model(path: str, cls=None,
                            device: DeviceLike = None) -> SequenceVectors:
        cls = cls or SequenceVectors
        with zipfile.ZipFile(path, "r") as z:
            conf = VectorsConfiguration(**json.loads(z.read("config.json")))
            vocab = AbstractCache()
            entries = json.loads(z.read("vocab.json"))
            for e in entries:
                w = VocabWord(e["label"], e["frequency"])
                w.index = e["index"]
                w.codes = e["codes"]
                w.points = e["points"]
                w.special = e.get("special", False)
                w.is_label = e.get("isLabel", False)
                vocab._map[w.label] = w
            vocab._index = sorted(vocab._map.values(), key=lambda w: w.index)
            vocab.update_words_occurrences()
            sv = cls(conf, device=device)
            sv.vocab = vocab
            sv.lookup_table = InMemoryLookupTable(
                vocab, conf.layer_size, seed=conf.seed,
                use_hs=conf.use_hierarchic_softmax, negative=conf.negative,
                device=device)
            for name in TABLES:
                if f"{name}.npy" in z.namelist():
                    sv.lookup_table.set_array(
                        name, np.load(io.BytesIO(z.read(f"{name}.npy"))))
        return sv
