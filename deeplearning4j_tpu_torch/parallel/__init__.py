"""Attention cores — the port of ``deeplearning4j_tpu/parallel``, so far its
single-device part (``sequence``)."""
