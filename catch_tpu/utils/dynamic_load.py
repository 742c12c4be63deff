"""Dynamic loading of user-supplied Python modules/functions.

The plug-in mechanism for custom hybridization models (parity:
/root/reference/catch/utils/dynamic_load.py:10-55).  A custom cover
function runs on the host per candidate (probe, alignment) pair; the
cover engine calls back into it for candidates surviving the seed
prefilter (see catch_tpu/ops/cover.py).
"""

import importlib.util
import os


def load_module_from_path(path):
    """Load a Python module given a path to its .py file."""
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_function_from_path(path, fn_name):
    """Load a function named fn_name from the module at path."""
    module = load_module_from_path(path)
    fn = getattr(module, fn_name, None)
    if fn is None or not callable(fn):
        raise ValueError(
            f"Module at {path} has no callable function named {fn_name}")
    return fn
