"""Hand-written Hopper kernels of the port, each beside its plain twin.

Importing this package builds nothing: a kernel's library is compiled the
first time a CUDA tensor reaches its wrapper.
"""
