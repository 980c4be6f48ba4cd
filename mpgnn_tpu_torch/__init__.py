"""PyTorch/CUDA port of ``mpgnn_tpu`` for one NVIDIA H100.

Same module names as the JAX package; the sorted-CSR mean aggregation runs
on hand-written CUDA kernels (``ops/csr.py``, ``csrc/``). Importing the
package loads no submodule and builds nothing.
"""
