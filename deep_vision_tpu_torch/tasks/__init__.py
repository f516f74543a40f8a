"""Training tasks: losses and eval metrics."""
