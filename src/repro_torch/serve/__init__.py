"""Serving: continuous batching over the port's models (`batching`,
`engine.model_batcher`), the slot-aware multi-tenant engine
(`engine.SlotServeEngine`) and the per-rank prefill and decode steps
under a sharding plan (`step`)."""
