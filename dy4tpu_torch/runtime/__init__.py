"""Runtime support of the port: ``kernels`` builds the CUDA sources in
``dy4tpu_torch/csrc`` with ``nvcc`` at first use and loads them."""
