"""Hand-written CUDA kernels: the nvcc builder and ctypes loader.

Nothing here imports or compiles at package import; ``build.library()``
compiles ``csrc/*.cu`` the first time a kernel is launched.
"""
