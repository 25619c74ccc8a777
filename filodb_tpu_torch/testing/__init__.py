"""Test-support subsystems shipped with the package: chaos injection, and
the generated differential soak (``testing/soak.py``, imported on its own:
it loads the engine and torch)."""

from filodb_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosError, ChaosInjector, fire, install, installed, uninstall)
