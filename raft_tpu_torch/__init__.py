"""raft_tpu_torch — the PyTorch/CUDA port of raft_tpu for NVIDIA Hopper.

A package of its own beside the JAX package ``raft_tpu``, which stays the
reference: each module here keeps the path and public names of its JAX
counterpart, and every TPU (Pallas) kernel on a ported path is a
hand-written CUDA kernel under ``csrc/``, built at first use. Nothing
here imports JAX or the JAX package.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise.
"""

__version__ = "0.1.0"
