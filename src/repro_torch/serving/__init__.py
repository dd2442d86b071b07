"""Serving runtime: Execution Pool, prefill and decode instances, paged KV
cache and the Proxy that wires them."""
