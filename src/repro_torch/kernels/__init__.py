"""Hand-written Hopper kernels for the serving hot spots.

Each kernel package ships:
  csrc/*.cu — the CUDA C++ kernel for sm_90a with a plain C interface
  ops.py    — the wrapper: launches the kernel for CUDA tensors, takes the
              plain version for CPU tensors, counts its launches
  ref.py    — the plain PyTorch version, the oracle the kernel is held to
"""
