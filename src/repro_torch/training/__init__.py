"""Training (the port of ``repro.training``): the synthetic data, AdamW
with f32 master weights and the train step (remat forward, chunked
cross-entropy, grad accumulation, int8 gradient compression)."""
