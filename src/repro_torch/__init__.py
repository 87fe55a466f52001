"""PyTorch/CUDA port of the FPGA-extended reconfigurable-core simulator.

A second package beside the JAX reference `repro`, mirroring its layout
module for module: `repro_torch.core` holds the simulator and its sweep
engines, `repro_torch.kernels` the hand-written Hopper kernels with their
plain PyTorch versions, and `repro_torch.bench` the paper-figure
benchmarks.  It imports torch and numpy, never jax or `repro`.
"""
