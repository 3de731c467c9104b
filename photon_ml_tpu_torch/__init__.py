"""photon_ml_tpu_torch: the PyTorch/CUDA port of photon_ml_tpu for NVIDIA Hopper.

The JAX package ``photon_ml_tpu`` is the reference; this package mirrors its
module paths and never imports it (nor jax).
"""
