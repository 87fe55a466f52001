"""Serving: continuous batching over the port's models (`batching`,
`engine.model_batcher`) and the slot-aware multi-tenant engine
(`engine.SlotServeEngine`)."""
