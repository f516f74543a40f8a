"""PyTorch + CUDA port of ``deep_vision_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference each module is held
against; this package imports neither it nor JAX.  Slice 1 serves int8
ResNet classification over HTTP (``cli/serve.py``) with the uint8→int8
ingest in a hand-written CUDA kernel (``csrc/serve_ingest.cu``).  Slice 2
trains ResNet (``cli/train.py``) with each batch's color jitter and
normalize in a second one (``csrc/train_ingest.cu``).
"""
