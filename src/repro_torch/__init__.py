"""PyTorch/CUDA port of the FPGA-extended reconfigurable-core simulator
and its model zoo.

A second package beside the JAX reference `repro`, mirroring its layout
module for module: `repro_torch.core` holds the simulator and its sweep
engines, `repro_torch.kernels` the hand-written Hopper kernels with their
plain PyTorch versions, `repro_torch.bench` the paper-figure benchmarks,
`repro_torch.configs`/`models`/`serve`/`launch` the attention-only and
MoE decoders, their continuous-batching server and the slot-aware
multi-tenant engine.  It imports torch and numpy, never jax or
`repro`.
"""
