"""Keras model import — the port of ``deeplearning4j_tpu/keras_import``
(ref: deeplearning4j-modelimport, KerasModelImport.java,
KerasSequentialModel.java, keras/layers/Keras*.java; HDF5 through h5py,
imported only where an ``.h5`` file is read)."""

from deeplearning4j_tpu_torch.keras_import.importer import (  # noqa: F401
    KerasModelImport)
