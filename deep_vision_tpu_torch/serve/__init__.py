"""Serving tier: registry, int8 quantization, batching engine, HTTP."""
