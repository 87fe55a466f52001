"""Serving: continuous batching over the port's models (`batching`,
`engine.model_batcher`)."""
