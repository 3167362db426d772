"""spcbpt_tpu — SPCBPT renderer in JAX, running on NVIDIA GPUs.

A from-scratch rebuild of the capabilities of the SPCBPT-OptiX7 reference
renderer (subspace-based probabilistic connections for bidirectional path
tracing): wavefront SoA pipelines under jit, a one-thread-per-ray CUDA BVH
traversal kernel, matmul-shaped subspace classification and on-device Gamma
training, and multi-device scaling via jax.sharding.
"""

__version__ = "0.1.0"
