"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it: `window_distance` (the simulator's window pass),
`flash_attention` (prefill) and `decode_attention` (one decode step);
`common` builds them with nvcc and holds the `use_kernel` knob."""
