"""Test-support subsystems shipped with the package (chaos injection)."""

from filodb_tpu_torch.testing.chaos import (  # noqa: F401
    ChaosError, ChaosInjector, fire, install, installed, uninstall)
