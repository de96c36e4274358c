"""megalania_tpu: an LZMA compressor via simulated annealing on a GPU.

A from-scratch JAX framework (plus one CUDA kernel, kernels/) with the
capabilities of blackle/Megalania: anneal over LZMA packet parses to
minimize the exact compressed size, with many parallel chains per device
and block sharding across a device mesh.
"""
__version__ = "0.1.0"
