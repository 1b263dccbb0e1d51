#!/usr/bin/env python3
"""Time ``nn/serialization.write_model`` and ``load_model`` for one model,
on the host, with whichever ``deeplearning4j_tpu_torch`` is first on the
path: run it once per tree to compare two trees' zip formats.

    PYTHONPATH=TREE python3 tools/zip_save_cost.py --label NAME

The model is the featurized VGG16-224 head that ``chip_smoke.py``'s
``early_stop_and_resume`` checkpoints: fc1 25,088 -> 4,096 and fc2 4,096
-> 1,024 (both relu, dropout 0.5), dense 1,024 -> 256 relu, softmax
output 256 -> 5, Nesterovs (lr 5e-5), seeded weights, on the CPU; one
``fit`` step at batch 32 gives it its updater state, so a save writes
params and updater state as a checkpoint does (857,789,706 bytes of
float32 members).  ``--divisor D`` divides every width by D, for a quick
check on a small host.  The script saves ``--repeat`` times to one path
under ``--dir``, loads the last save once, and prints one JSON line:
the label, the seconds of each save and of the load, the zip's bytes,
its float32 members' bytes and compression, and the host's CPU count.
It uses no GPU.
"""

import argparse
import json
import os
import tempfile
import time
import zipfile

import numpy as np


def head(divisor: int):
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    w = [25_088 // divisor, 4_096 // divisor, 1_024 // divisor,
         256 // divisor]
    conf = (NeuralNetConfiguration.builder().seed(12345)
            .learning_rate(5e-5).updater("nesterovs").list()
            .layer(L.DenseLayer(n_in=w[0], n_out=w[1], activation="relu",
                                dropout=0.5))
            .layer(L.DenseLayer(n_in=w[1], n_out=w[2], activation="relu",
                                dropout=0.5))
            .layer(L.DenseLayer(n_in=w[2], n_out=w[3], activation="relu"))
            .layer(L.OutputLayer(n_in=w[3], n_out=5, activation="softmax",
                                 loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, w[0])).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 32)]
    net.fit(x, y)
    return net


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", required=True)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--divisor", type=int, default=1)
    ap.add_argument("--dir", default=None)
    args = ap.parse_args()
    from deeplearning4j_tpu_torch.nn.serialization import (
        load_model, write_model)

    net = head(args.divisor)
    with tempfile.TemporaryDirectory(dir=args.dir) as tmp:
        path = os.path.join(tmp, "model.zip")
        save_s = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            write_model(net, path)
            save_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        back = load_model(path, device="cpu")
        load_s = time.perf_counter() - t0
        assert bool((back.params() == net.params()).all())
        with zipfile.ZipFile(path) as zf:
            members = {i.filename: {"bytes": i.file_size,
                                    "stored_bytes": i.compress_size,
                                    "deflated": i.compress_type
                                    == zipfile.ZIP_DEFLATED}
                       for i in zf.infolist() if i.filename.endswith(".bin")}
        size = os.path.getsize(path)
    print(json.dumps({"label": args.label, "divisor": args.divisor,
                      "save_s": save_s, "load_s": load_s,
                      "zip_bytes": size, "members": members,
                      "cpu_count": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
