"""dy4tpu_torch: the dy4tpu FM broadcast receiver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors ``dy4tpu``'s layout module for module.  It imports
``torch`` and never ``jax``; the JAX-free host layer of ``dy4tpu``
(``dy4tpu.config``, ``dy4tpu.rds.*``, ``dy4tpu.runtime.native`` and
``dy4tpu.utils.io``) is shared, not copied.

``import dy4tpu_torch`` stays light: subpackages load on first use.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy subpackage access, as in dy4tpu/__init__.py
    if name == "receiver":
        from dy4tpu_torch.pipeline import receiver
        return receiver
    raise AttributeError(f"module 'dy4tpu_torch' has no attribute {name!r}")
