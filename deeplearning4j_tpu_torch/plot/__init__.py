from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne  # noqa: F401
