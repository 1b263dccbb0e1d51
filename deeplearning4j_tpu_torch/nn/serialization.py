"""The ModelSerializer zip — the port of ``deeplearning4j_tpu/nn/serialization.py``
for MultiLayerNetwork and ComputationGraph.

A zip holding ``configuration.json`` (the configuration dict tagged with
``"@model"``), ``coefficients.bin`` (the flat param vector of
``nn/params.py``, little-endian float32) and, once the network has
updater state, ``updaterState.bin`` (that state flattened in the JAX
package's ``tree_leaves`` order, little-endian float32).  The members
are the JAX package's byte for byte: a zip either package writes
restores in the other, and re-writing a restored model gives the same
``coefficients.bin`` and ``updaterState.bin`` (a graph's flattened in
its topological order).  The two float32 members are stored, not
deflated as the JAX package writes them: deflate barely shrinks float32
weights and costs host time in proportion to their size, which a
checkpoint pays at every save (``tools/zip_save_cost.py`` times a
tree's save); every zip reader takes either.  ``load_model`` tells the
two apart by the configuration (``is_graph_conf``).  A zip the original
Java DL4J wrote (its Jackson schema: ``confs`` for a network,
``networkInputs`` and ``vertices`` for a graph) is migrated by
``nn/dl4j_migration.py``, as the JAX package routes it.
"""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Union

import numpy as np

from deeplearning4j_tpu_torch.ops.platform import DeviceLike

CONFIG_NAME = "configuration.json"
COEFFICIENTS_NAME = "coefficients.bin"
UPDATER_NAME = "updaterState.bin"


def _f32_bytes(t) -> memoryview:
    """A float32 tensor's little-endian bytes, without a copy on the host
    beyond the one from the device."""
    return memoryview(np.ascontiguousarray(t.detach().cpu().numpy(),
                                           dtype="<f4")).cast("B")


def write_model(model, path: Union[str, Path],
                save_updater: bool = True) -> None:
    """(ref: ModelSerializer.writeModel); the updater state goes in when
    the model has one, unless ``save_updater`` is off."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    conf_dict = model.conf.to_dict()
    conf_dict["@model"] = type(model).__name__
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(CONFIG_NAME, json.dumps(conf_dict, indent=2))
        zf.writestr(COEFFICIENTS_NAME, _f32_bytes(model.params()),
                    zipfile.ZIP_STORED)
        if save_updater and model.opt_states is not None:
            zf.writestr(UPDATER_NAME, _f32_bytes(model.updater_state_flat()),
                        zipfile.ZIP_STORED)


def is_graph_conf(conf_dict: dict) -> bool:
    return (conf_dict.get("@model") == "ComputationGraph"
            or "vertices" in conf_dict)


def restore_multi_layer_network(path: Union[str, Path],
                                device: DeviceLike = None,
                                load_updater: bool = True):
    """(ref: ModelSerializer.restoreMultiLayerNetwork)"""
    from deeplearning4j_tpu_torch.nn.conf.network import (
        MultiLayerConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if "confs" in _read_conf(path):
        from deeplearning4j_tpu_torch.nn import dl4j_migration
        return dl4j_migration.restore_multi_layer_network(
            path, load_updater=load_updater, device=device)
    conf_dict, flat, upd = _read_zip(path, load_updater)
    return _restored(MultiLayerNetwork(
        MultiLayerConfiguration.from_dict(conf_dict), device=device),
        flat, upd)


def restore_computation_graph(path: Union[str, Path],
                              device: DeviceLike = None,
                              load_updater: bool = True):
    """(ref: ModelSerializer.restoreComputationGraph)"""
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
        ComputationGraphConfiguration)
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    conf_dict = _read_conf(path)
    if "networkInputs" in conf_dict and "vertices" in conf_dict:
        from deeplearning4j_tpu_torch.nn import dl4j_migration
        return dl4j_migration.restore_computation_graph(
            path, load_updater=load_updater, device=device)
    conf_dict, flat, upd = _read_zip(path, load_updater)
    return _restored(ComputationGraph(
        ComputationGraphConfiguration.from_dict(conf_dict), device=device),
        flat, upd)


def _read_conf(path) -> dict:
    with zipfile.ZipFile(path, "r") as zf:
        return json.loads(zf.read(CONFIG_NAME))


def _read_zip(path, load_updater: bool):
    """(configuration dict without its ``@model`` tag, flat params, flat
    updater state or None) of a zip."""
    with zipfile.ZipFile(path, "r") as zf:
        conf_dict = json.loads(zf.read(CONFIG_NAME))
        conf_dict.pop("@model", None)
        flat = np.frombuffer(zf.read(COEFFICIENTS_NAME), dtype="<f4")
        upd = (np.frombuffer(zf.read(UPDATER_NAME), dtype="<f4")
               if load_updater and UPDATER_NAME in zf.namelist() else None)
    return conf_dict, flat, upd


def _restored(net, flat, upd):
    net.init()
    net.set_params(flat.copy())
    if upd is not None:
        net.set_updater_state_flat(upd.copy())
    return net


def read_updater_state(path: Union[str, Path]):
    """The zip's flat updater state (``updaterState.bin``) as float32, or
    None when it holds none."""
    with zipfile.ZipFile(path, "r") as zf:
        if UPDATER_NAME not in zf.namelist():
            return None
        return np.frombuffer(zf.read(UPDATER_NAME), dtype="<f4").copy()


def load_model(path: Union[str, Path], device: DeviceLike = None,
               load_updater: bool = True):
    """Restore a model zip, a MultiLayerNetwork or a ComputationGraph by
    its configuration (ref: util/ModelGuesser.java)."""
    restore = (restore_computation_graph if is_graph_conf(_read_conf(path))
               else restore_multi_layer_network)
    return restore(path, device=device, load_updater=load_updater)
