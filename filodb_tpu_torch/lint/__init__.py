"""The port's declaration decorators: copies of the runtime decorator
modules of ``filodb_tpu/lint/`` (``threads``, ``locks``, ``caches``,
``hotpath``, ``contracts``, ``capacity``), pure Python and importing
nothing of the JAX package.

The JAX package's static analyser lints the port with them::

    python -m filodb_tpu.lint filodb_tpu_torch

It matches a decorator by its leaf name (``single_writer``,
``cache_registry``, ...), so a declaration here reads as the reference's
does. ``tests/test_torch_lint.py`` runs that command and expects no
finding under ``filodb_tpu_torch/``.
"""
