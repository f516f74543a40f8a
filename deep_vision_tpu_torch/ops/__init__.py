"""Tensor ops and the hand-written kernels' wrappers."""

#: every kernel wrapper that counts its launches (see :func:`counted`)
COUNTED: list = []


def counted(fn):
    """Register the kernel wrapper ``fn``, which adds one to
    ``fn.launches`` where it launches its kernel and nowhere else.  A
    captured CUDA graph reads this list to count its wrappers' launches
    once a replay (``core/step_graph.py``)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn
