"""Serving engine of the port: scheduler, paged KV cache, engine."""
