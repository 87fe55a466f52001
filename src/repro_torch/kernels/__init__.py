"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it: `window_distance` (the simulator's window pass),
`flash_attention` (prefill), `decode_attention` (one decode step) and
`moe_gmm` (the MoE expert FFN: `moe_gmm`, `moe_gmm_skip`); `common`
builds them with nvcc and holds the `use_kernel` knob."""
