"""Hand-written Hopper kernels of the port, each with its plain PyTorch
version beside it: `window_distance` (the simulator's window pass),
`flash_attention` (prefill), `decode_attention` (one decode step),
`moe_gmm` (the MoE expert FFN: `moe_gmm`, `moe_gmm_skip`), `rglru_scan`
(RecurrentGemma's RG-LRU) and `rwkv6_scan` (RWKV6's WKV recurrence);
`common` builds them with nvcc and holds the `use_kernel` knob."""
