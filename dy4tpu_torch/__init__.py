"""dy4tpu_torch: the dy4tpu FM broadcast receiver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``dy4tpu``'s layout module for module.  It imports
``torch`` and never ``jax``, and nothing of the ``dy4tpu`` package: it
carries its own copies of dy4tpu's JAX-free host layer (``config``,
``rds``, ``runtime/native`` with ``native/dy4_runtime.cpp``, and
``utils/io``).

``import dy4tpu_torch`` stays light: subpackages load on first use.
"""

__version__ = "0.1.0"

from dy4tpu_torch.config import MODES, ModeConfig, get_mode  # noqa: F401


def __getattr__(name):
    # lazy subpackage access, as in dy4tpu/__init__.py
    if name == "receiver":
        from dy4tpu_torch.pipeline import receiver
        return receiver
    raise AttributeError(f"module 'dy4tpu_torch' has no attribute {name!r}")
