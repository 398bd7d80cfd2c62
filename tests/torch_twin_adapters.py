"""The device adapters of the twins whose CPU test files import the JAX
package beside the port (``test_torch_serving.py``,
``test_torch_controllers.py``), kept here so that the card's twins
(``test_torch_twin_cuda_main.py``) load them on a host without jax. Like
every twin adapter, each is a function of the device: the CPU in those
files, the card in the card's twins.
"""

import types

import torch
from torch.utils import _pytree

from torch_twin import device_env


def _leaves(tree):
    """A pytree's leaves as ``jax.tree_util`` counts them: ``None`` is an
    empty subtree, not a leaf."""
    return [leaf for leaf in _pytree.tree_leaves(tree) if leaf is not None]


def serving_replace(device):
    """``test_serving_export.py`` against the port on ``device``: the port's
    device rule (``device=DEVICE`` at every export and load, in this
    process and in the fresh ones the tests start), its version key
    (``torch_version``), its platforms (``("cpu", "cuda")``), four shards
    of the device in place of XLA's virtual devices, and torch's pytree
    in place of ``jax.tree_util``; numpy reads a served tensor on the card
    after ``.cpu()``, as it reads JAX's device array."""
    dev = torch.device(device)
    return [
        ("import numpy as np\nimport pytest\n",
         "import numpy as np; np = _np\nimport pytest\nimport torch\n\n"
         f"DEVICE = torch.device({str(dev)!r})\n"
         "DEVICES = [DEVICE] * 4  # four shards in place of XLA's virtual devices\n"),
        ("\"import jax; jax.config.update('jax_platforms', 'cpu');\"",
         f"\"import torch; DEVICES = [torch.device({str(dev)!r})] * 4;\""),
        ("\nimport jax\nimport kompass_core_tpu_torch.serving as serving\n",
         "\nimport torch\nimport kompass_core_tpu_torch.serving as serving\n"),
        ("jax.devices()", "DEVICES"),
        ("import jax\n\n    assert header[\"jax_version\"] == jax.__version__",
         "assert header[\"torch_version\"] == torch.__version__"),
        ("    import jax\n", "    pass\n"),
        ("jax.tree_util.", "_tree_util."),
        ("get_packed_dwa_solver(SPEC)", "get_packed_dwa_solver(SPEC, DEVICE)"),
        ("export_packed_solver(SPEC, path)", "export_packed_solver(SPEC, path, device=DEVICE)"),
        ("export_packed_solver(spec, path)", "export_packed_solver(spec, path, device=DEVICE)"),
        ("export_packed_solver(SPEC, art_path)",
         "export_packed_solver(SPEC, art_path, device=DEVICE)"),
        ('platforms=("cpu", "tpu"))', 'platforms=("cpu", "cuda"), device=DEVICE)'),
        ('["cpu", "tpu"]', '["cpu", "cuda"]'),
        ('path, kind="misc")', 'path, kind="misc", device=DEVICE)'),
        ("load_packed_solver(path)", "load_packed_solver(path, device=DEVICE)"),
        ("path_capacity=512,\n", "path_capacity=512, device=DEVICE,\n"),
        ("path_capacity=256,\n", "path_capacity=256, device=DEVICE,\n"),
        ("export_fleet_tick(fleet, path)", "export_fleet_tick(fleet, path, device=DEVICE)"),
        ("export_fleet_tick(shard_fleet, art_path)",
         "export_fleet_tick(shard_fleet, art_path, device=DEVICE)"),
        ("export_fleet_tick(shard_fleet, p)",
         "export_fleet_tick(shard_fleet, p, device=DEVICE)"),
        ("export_fleet_ticks_on_device(fleet, k, path)",
         "export_fleet_ticks_on_device(fleet, k, path, device=DEVICE)"),
        ("make_fleet_ticks_on_device(\n        fleet.spec, k, chunk=fleet._chunk or None\n    )",
         "make_fleet_ticks_on_device(fleet.spec, k, DEVICE)"),
        ("load_artifact(path)", "load_artifact(path, device=DEVICE)"),
        ("load_artifact(p)", "load_artifact(p, device=DEVICE)"),
        ("load_artifact({art_path!r})",
         f"load_artifact({{art_path!r}}, device={str(dev)!r})"),
        # the fresh process reads the served output with numpy, as it reads
        # JAX's device array: a tensor on the card is copied to the host first
        ("out = np.asarray(art.call(np.load({buf_path!r})))",
         "out = np.asarray(art.call(np.load({buf_path!r})).cpu())"),
    ]


def serving_env(device):
    return {**device_env(device), "_tree_util": types.SimpleNamespace(
        tree_leaves=_leaves, tree_flatten=lambda tree: (_leaves(tree), None))}


def classic_replace(closed_loop):
    """``test_classic_controllers.py`` against the port: its helpers from
    ``closed_loop``, the registered twin of ``test_dwa_closed_loop.py``,
    and its ``DWA`` on the twin's device."""
    return [
        ("from test_dwa_closed_loop import", f"from {closed_loop} import"),
        ("DWA(robot=robot, ctrl_limits=limits, config=DWAConfig())",
         "DWA(robot=robot, ctrl_limits=limits, config=DWAConfig(), device=_device)"),
    ]
