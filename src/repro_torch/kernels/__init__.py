"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

``csrc/zo_direction.cu`` holds the four flat ZO-direction kernels; ``build``
compiles it with nvcc at first use, ``zo_direction`` binds it with ctypes,
``ref`` holds the plain versions and ``ops`` picks by tensor device.
"""
