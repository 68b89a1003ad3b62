"""Serving: paged KV pool, pooled sampler, engine and continuous-batching
scheduler (the port of ``repro.serve``)."""
