"""Run the JAX package's own test modules against the port.

``port_twin`` loads a JAX package test module with its imports pointed at
the port, ``twin_tests`` puts its tests where pytest collects them, and
``to_port`` turns a JAX package host object into the port's own object
with the same state. This module imports neither jax nor
``kompass_core_tpu``, so the card's twins (``test_torch_twin_cuda.py``)
load through it on a host without jax; ``test_torch_host_modules.py``
re-exports all three.
"""

import functools
import io
import pickle
import re
import sys
import types
from pathlib import Path

import numpy as np
import torch

_JAX, _PORT = "kompass_core_tpu", "kompass_core_tpu_torch"


class _ToPort(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX or module.startswith(_JAX + "."):
            module = _PORT + module[len(_JAX):]
        return super().find_class(module, name)


def to_port(obj):
    """The port's object with ``obj``'s state: the same class path under
    ``kompass_core_tpu_torch`` (enums by value), every field copied."""
    return _ToPort(io.BytesIO(pickle.dumps(obj))).load()


_TESTS = Path(__file__).resolve().parent
_JAX_NAME = re.compile(r"\bkompass_core_tpu\b(?!_torch)")


def port_twin(name, replace=(), env=None, as_name=None):
    """The JAX package's test module ``tests/<name>.py`` run against the
    port: its source with every ``kompass_core_tpu`` name pointed at
    ``kompass_core_tpu_torch`` and each ``(old, new)`` of ``replace``
    applied (each must occur), executed as module ``torch_twin_<name>``
    (registered, so another twin can import it; ``as_name`` registers it
    under another suffix, for a second twin of one file). ``env`` seeds
    the module's namespace before it runs: the adapters that a
    replacement names. Loading a registered twin again with other
    replacements raises. Keep the replacements' line counts, so that the
    twin's line numbers are the original's."""
    mod_name = f"torch_twin_{as_name or name}"
    replace = tuple(tuple(pair) for pair in replace)
    if mod_name in sys.modules:
        mod = sys.modules[mod_name]
        assert mod.__twin_replace__ == replace, (
            f"{mod_name} is already loaded with other replacements")
        return mod
    path = _TESTS / f"{name}.py"
    src = _JAX_NAME.sub(_PORT, path.read_text())
    for old, new in replace:
        assert old in src, f"{name}: {old!r} not found"
        src = src.replace(old, new)
    mod = types.ModuleType(mod_name)
    mod.__file__ = str(path)
    mod.__twin_replace__ = replace
    mod.__dict__.update(env or {})
    sys.modules[mod_name] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    return mod


def twin_tests(namespace, mod, names=None, leave_out=(), wrap=None):
    """Put the twin's tests and fixtures (or those of ``names``), but those
    of ``leave_out``, into a test module's ``namespace``, where pytest
    collects them, each test through ``wrap`` when given; a name that is
    already there raises."""
    for key, value in vars(mod).items():
        is_test = key.startswith("test_") and callable(value)
        is_fixture = hasattr(value, "_fixture_function_marker") or type(
            value).__name__ == "FixtureFunctionDefinition"
        if key in leave_out:
            continue
        if (names is None and (is_test or is_fixture)) or (
                names is not None and key in names):
            assert key not in namespace, f"{key} is defined twice"
            namespace[key] = wrap(value) if wrap and is_test else value


def on_device(device):
    """``_on_device`` of a twin's ``env``: ``_on_device(f)`` is ``f`` with
    ``device=device``; a replacement wraps a port entry point in it where
    the JAX test calls the entry point without a device."""
    return lambda f: functools.partial(f, device=device)


class _JnpScalar:
    """``jnp.float32``: a scalar constructor that also names a dtype."""

    def __init__(self, dtype, device=None):
        self.dtype = np.dtype(dtype)
        self.device = device

    def __call__(self, v):
        return torch.as_tensor(np.asarray(v, self.dtype), device=self.device)


def _jnp_asarray(x, dtype=None, device=None):
    dtype = getattr(dtype, "dtype", dtype)
    if isinstance(x, torch.Tensor):
        x = x if device is None else x.to(device)
        return x if dtype is None else x.to(getattr(torch, np.dtype(dtype).name))
    a = np.asarray(x)
    if dtype is None:  # jax without x64: 64-bit values become 32-bit
        dtype = {np.float64: np.float32, np.int64: np.int32}.get(a.dtype.type, a.dtype)
    return torch.as_tensor(a.astype(dtype), device=device)


def tensor_args(f, device=None):
    """``f`` taking numpy arrays and scalars where the port's function
    takes tensors (made on ``device``, the CPU by default): the adapter
    of a port function that a JAX test calls with numpy inputs."""
    def conv(v):
        if hasattr(v, "_fields"):
            return type(v)(*map(conv, v))
        if isinstance(v, (tuple, list)):
            return type(v)(map(conv, v))
        if isinstance(v, (np.ndarray, np.generic)):
            return torch.as_tensor(v, device=device)
        return v

    @functools.wraps(f)
    def call(*args, **kwargs):
        return f(*map(conv, args), **{k: conv(v) for k, v in kwargs.items()})
    return call


def _np_dtype(dtype):
    """A numpy dtype from a numpy one or a ``jnp`` scalar constructor."""
    return dtype.dtype if isinstance(dtype, _JnpScalar) else dtype


def jnp_on(device):
    """``jax.numpy``'s array constructors as the twins use them, each
    making its tensor on ``device``: a twin replaces ``import jax.numpy as
    jnp`` by ``jnp = _jnp`` (``JNP``) and its ``env`` gives ``_jnp``. On a
    host without a card, where every card twin skips, a card's
    constructors make the module constants of a twin on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        device = torch.device("cpu")

    def on(a):
        return torch.as_tensor(a, device=device)

    return types.SimpleNamespace(
        asarray=functools.partial(_jnp_asarray, device=device),
        array=functools.partial(_jnp_asarray, device=device),
        float32=_JnpScalar(np.float32, device),
        int32=_JnpScalar(np.int32, device),
        arange=lambda *a, dtype=np.int32: on(np.arange(*a, dtype=_np_dtype(dtype))),
        full=lambda shape, v, dtype=np.float32: on(np.full(shape, v, _np_dtype(dtype))),
        ones=lambda shape, dtype=np.float32: on(np.ones(shape, _np_dtype(dtype))),
        zeros=lambda shape, dtype=np.float32: on(np.zeros(shape, _np_dtype(dtype))),
        stack=lambda arrays, axis=0: torch.stack(list(arrays), dim=axis),
    )


# the constructors on the CPU, for a twin that imports them by name
jnp = jnp_on("cpu")
JNP = ("import jax.numpy as jnp", "jnp = _jnp")
NP = ("import numpy as np\n", "import numpy as np; np = _np\n")


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu()
    if hasattr(v, "_fields"):
        return type(v)(*map(_host, v))
    if isinstance(v, (tuple, list)):
        return type(v)(map(_host, v))
    if isinstance(v, dict):
        return {k: _host(x) for k, x in v.items()}
    return v


class _OnHost:
    """numpy, or one of its submodules, whose functions take tensors on
    the card as numpy takes JAX's device arrays: each tensor argument is
    copied to the host first. A twin on the card replaces ``import numpy
    as np`` by ``np = _np`` (``NP``); the port's own modules keep numpy,
    so a port function that hands numpy a tensor on the card still
    fails."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        value = getattr(self._mod, name)
        if isinstance(value, types.ModuleType):
            return _OnHost(value)
        if not callable(value) or isinstance(value, type):
            return value  # dtypes, constants, classes

        @functools.wraps(value)
        def call(*args, **kwargs):
            return value(*map(_host, args), **{k: _host(v) for k, v in kwargs.items()})
        return call


def device_env(device):
    """The adapters every twin's ``env`` gives, on ``device``: ``_device``,
    ``_on_device`` (``on_device``), ``_jnp`` (``jnp_on``) and ``_np``
    (numpy itself on the CPU, ``_OnHost`` numpy on the card)."""
    device = torch.device(device)
    return {"_device": device, "_on_device": on_device(device),
            "_jnp": jnp_on(device),
            "_np": np if device.type == "cpu" else _OnHost(np)}
