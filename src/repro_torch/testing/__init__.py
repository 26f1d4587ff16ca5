"""Test-support utilities shipped with the package (not only under
tests/) so benchmarks and examples can exercise the same machinery:

  * `faults` — the deterministic fault-injection harness used by the
    chaos suite and the robustness benchmark.
"""
from .faults import (Fault, FaultInjector, InjectedFault,
                     INJECTION_POINTS)

__all__ = ["Fault", "FaultInjector", "InjectedFault", "INJECTION_POINTS"]
