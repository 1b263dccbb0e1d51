"""Distributed data plumbing of the port: minibatches exported as ``.npz``
and streamed back by path (``scaleout/data.py``)."""
