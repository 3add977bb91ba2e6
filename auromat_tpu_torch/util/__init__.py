"""Host helpers copied from the jax-free ``auromat_tpu.util`` modules
(``osutil``, ``url``, ``decorators``, ``coroutine``, ``movie``), the
multi-weight ``histogram`` on the device, the EXIF client and the lens
distortion correction."""
