"""Structured logging and per-request tracing."""
