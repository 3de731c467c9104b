"""photon_ml_tpu_torch: the PyTorch/CUDA port of photon_ml_tpu for NVIDIA Hopper.

The JAX package ``photon_ml_tpu`` is the reference; this package mirrors its
module paths and never imports it (nor jax).

Two JAX modules have no file here:

  * ``photon_ml_tpu/io/native_build.py``: ``native_build.py`` builds the
    same ``native/`` sources (and the CUDA kernels) for the port;
  * ``photon_ml_tpu/compat.py``, whose shims paper over differences between
    jax versions. Each one's job is done here without a shim:

      - ``shard_map``: the process-group mesh, ``parallel/mesh.py``;
      - ``distributed_is_initialized``: ``torch.distributed.is_initialized``;
      - ``enable_x64``: the real dtype of ``types.real_dtype``;
      - ``enable_persistent_cache``: the build cache of the port's compiled
        code, ``native_build.use_persistent_cache`` (``--persistent-cache``);
      - ``pallas_tpu_compiler_params``: the nvcc flags of ``native_build``;
      - ``forced_cpu_device_count``, ``backends_initialized``,
        ``force_cpu_devices`` and ``ensure_cpu_collectives`` (several CPU
        devices in one process for collective tests): one gloo rank a
        process (``entry.dryrun_multihost``, ``tests/torch_rank_*.py``).

``entry.entry()`` is the port's entry point beside the JAX package's
``__graft_entry__.entry``.
"""
