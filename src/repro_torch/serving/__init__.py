"""Serving stack of the port: scheduler, paged KV cache, engine."""
