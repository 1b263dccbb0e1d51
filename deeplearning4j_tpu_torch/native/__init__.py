"""Host-side helpers of the port's data path (the JAX package's
``native/``).  Only the numpy forms are here so far; the loader of the
prebuilt ``libdl4j_io.so`` comes beside them later."""
