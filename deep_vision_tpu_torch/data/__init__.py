"""Dataset normalization constants the serving wire needs."""
