"""Network engine of the port: configurations, the MultiLayerNetwork and
the ComputationGraph, the flat parameter view, the zip format and the
bridge from JAX params."""
