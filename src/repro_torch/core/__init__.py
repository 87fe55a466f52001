"""The simulation stack of the reconfigurable core (isa, traces, slots,
stack-distance engines, simulator, scheduler), ported to PyTorch."""
from repro_torch.core import (  # noqa: F401
    bitstream, isa, scheduler, simulator, slots, stackdist, stackdist_cold,
    stackdist_interleaved, traces,
)
