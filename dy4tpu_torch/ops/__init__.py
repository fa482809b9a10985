"""DSP primitives of the port (counterparts of ``dy4tpu/ops``) and the
wrappers of the hand-written CUDA kernels.  Nothing is imported eagerly:
import the module you need, e.g. ``from dy4tpu_torch.ops import fir``."""
