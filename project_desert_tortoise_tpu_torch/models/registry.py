"""Mode registry: name -> ModeConfig (the framework's model families).

The port's own copy of the JAX package's ``models/registry.py``, over the
port's ``utils/config.py``.
"""
from project_desert_tortoise_tpu_torch.utils.config import MODES  # noqa: F401


def get_mode(name: str):
    try:
        return MODES[name]
    except KeyError:
        raise KeyError(f"unknown mode {name!r}; available: {sorted(MODES)}")
