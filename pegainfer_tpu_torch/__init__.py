"""pegainfer-tpu's PyTorch/CUDA port.

A second package beside the JAX reference ``pegainfer_tpu``: the same engine
contract, scheduler and paged KV, with PyTorch for tensor code and kernels
written by hand for NVIDIA Hopper in place of the Pallas TPU kernels. It
imports neither ``jax`` nor ``pegainfer_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
