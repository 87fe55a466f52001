"""The simulation stack of the reconfigurable core (isa, traces, slots,
stack-distance engines, simulator, scheduler) and the slot-resident
expert tracker (`expert_slots`), ported to PyTorch."""
from repro_torch.core import (  # noqa: F401
    bitstream, expert_slots, isa, scheduler, simulator, slots, stackdist,
    stackdist_cold, stackdist_interleaved, traces,
)
