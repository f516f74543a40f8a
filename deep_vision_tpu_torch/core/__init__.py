"""Configs, devices, weight restore and metrics."""
