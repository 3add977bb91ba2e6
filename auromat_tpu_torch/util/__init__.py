"""Host helpers copied from the jax-free ``auromat_tpu.util`` modules:
``osutil.touch`` and ``url.download_file``."""
