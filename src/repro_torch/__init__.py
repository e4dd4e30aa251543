"""repro_torch — the PyTorch/CUDA port of :mod:`repro`.

Module for module it mirrors the JAX reference package
(``repro_torch/<sub>/<mod>.py`` for ``repro/<sub>/<mod>.py``).  The port
never imports ``jax`` or ``repro``: framework-neutral modules of the
reference are carried over as the port's own copies.

This ``__init__`` stays import-light on purpose — importing any submodule
must not pull in the model stack, the kernels or their build.
"""
