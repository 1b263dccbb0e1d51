"""Network engine of the port: configurations, the MultiLayerNetwork and
the ComputationGraph, the flat parameter view, the zip format and the
bridge from JAX params; around the training step, listeners, transfer
learning, early stopping and checkpoints with resume."""
