"""Physical-unit annotations and conversion constants used by the port.

The subset of the JAX package's ``repro.core.units`` that the port's
copies of the cluster, workload, profile and dynamics modules need: ``Annotated``
aliases that tag plain ``float`` / ``np.ndarray`` annotations with a
:class:`Unit` marker (erased at runtime), and the named bit/byte and
time scale constants.  The static checker reads its alias registry from the JAX
package's module; these aliases carry the same symbols.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Annotated

if TYPE_CHECKING:
    import numpy as np


class Unit:
    """Annotation marker naming a physical unit (``Unit("GB/s")``)."""

    __slots__ = ("symbol",)

    def __init__(self, symbol: str) -> None:
        self.symbol = symbol

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Unit({self.symbol!r})"


GB = Annotated[float, Unit("GB")]
GBArray = Annotated["np.ndarray", Unit("GB")]
GBps = Annotated[float, Unit("GB/s")]
GBpsArray = Annotated["np.ndarray", Unit("GB/s")]
Seconds = Annotated[float, Unit("s")]
SecondsArray = Annotated["np.ndarray", Unit("s")]
Ratio = Annotated[float, Unit("1")]

#: bit/byte scale factor (a bandwidth in GB/s times this is Gbit/s)
BITS_PER_BYTE = 8.0
#: GiB convention, as in the JAX package's units module
BYTES_PER_GB = float(2**30)
#: MiB, for reporting sampled bytes
BYTES_PER_MIB = float(2**20)
#: Chrome/Perfetto trace timestamps are microseconds
US_PER_SECOND = 1e6
