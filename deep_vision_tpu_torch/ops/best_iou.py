"""``best_iou_max``: each prediction's best IoU over its image's unmasked
ground-truth boxes, the YOLOv3 loss's ignore mask.

The counterpart of the Pallas kernel ``deep_vision_tpu/ops/pallas_ops.py``
``best_iou_max`` (:402).  For ``(B, N, 4)`` float32 corner predictions,
``(B, M, 4)`` float32 corner ground truths and a ``(B, M)`` mask:

    out[b, i] = max_j where(mask[b, j] > 0, iou(pred[b, i], gt[b, j]), 0)

with the IoU of ``ops/boxes.broadcast_iou`` (denominator
``((area_p + area_g) − inter) + 1e-9``), and 0 when ``M == 0``.  NaN
propagates as ``amax`` propagates it: a prediction whose IoU with an
unmasked ground truth is NaN scores NaN; a masked one scores 0.

On a CUDA tensor, :func:`best_iou_max` launches the hand-written kernel
``csrc/best_iou_max.cu`` or raises; on a CPU tensor it computes
:func:`best_iou_max_plain`, the PyTorch version the tests and
``chip_smoke.py`` hold the kernel against.  The kernel computes every
pair's intersection and denominator with the plain version's IEEE
operations in the same order, keeps the pair with the largest exact
quotient and divides it once; round-to-nearest is monotone, so the two
agree bit for bit (tests/test_torch_best_iou.py models the reduction).
The loss calls it on detached inputs: the ignore mask is a hard
threshold and has no gradient, so there is no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deep_vision_tpu_torch.ops import counted
from deep_vision_tpu_torch.ops.boxes import broadcast_iou


def best_iou_max_plain(pred: torch.Tensor, gt: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """The PyTorch version of the kernel, on any device: it builds the
    ``(B, N, M)`` IoU matrix the kernel never stores."""
    b, n = pred.shape[0], pred.shape[1]
    if gt.shape[1] == 0:
        return torch.zeros((b, n), dtype=torch.float32, device=pred.device)
    iou = broadcast_iou(pred, gt)
    iou = torch.where(mask[:, None, :] > 0, iou,
                      torch.zeros((), dtype=iou.dtype, device=iou.device))
    return iou.amax(-1)


def _check(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor) -> None:
    for name, t in (("pred", pred), ("gt", gt), ("mask", mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"best_iou_max takes float32 {name}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"best_iou_max takes a contiguous {name}")
        if t.device != pred.device:
            raise ValueError(f"{name} on {t.device}, pred on {pred.device}")
    if pred.dim() != 3 or pred.shape[-1] != 4:
        raise ValueError(f"best_iou_max takes (B, N, 4) predictions, got "
                         f"{tuple(pred.shape)}")
    b = pred.shape[0]
    if gt.dim() != 3 or gt.shape[0] != b or gt.shape[-1] != 4:
        raise ValueError(f"best_iou_max takes (B, M, 4) ground truths for "
                         f"B={b}, got {tuple(gt.shape)}")
    if mask.shape != gt.shape[:2]:
        raise ValueError(f"best_iou_max takes a (B, M) mask "
                         f"{tuple(gt.shape[:2])}, got {tuple(mask.shape)}")
    if pred.device.type not in ("cuda", "cpu"):
        raise ValueError(f"best_iou_max runs on cuda or cpu, got "
                         f"{pred.device}")


@counted
def best_iou_max(pred: torch.Tensor, gt: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """``(B, N, 4)`` + ``(B, M, 4)`` + ``(B, M)`` float32 → ``(B, N)``.

    A CUDA tensor launches ``csrc/best_iou_max.cu`` on the current stream
    and counts the launch in ``best_iou_max.launches``; a CPU tensor
    takes :func:`best_iou_max_plain`."""
    _check(pred, gt, mask)
    if pred.device.type == "cpu":
        return best_iou_max_plain(pred, gt, mask)
    b, n, m = pred.shape[0], pred.shape[1], gt.shape[1]
    if b > 65535 or n >= 2 ** 31 or m >= 2 ** 31:
        raise ValueError(f"best_iou_max: shape (B={b}, N={n}, M={m}) is "
                         f"beyond the kernel's grid")
    out = torch.empty((b, n), dtype=torch.float32, device=pred.device)
    if b == 0 or n == 0:  # nothing to launch, so nothing to count
        return out
    # float4 loads need 16-byte alignment; a fresh allocation has it, an
    # offset view may not
    if pred.data_ptr() % 16:
        pred = pred.clone()
    if gt.data_ptr() % 16:
        gt = gt.clone()
    lib = _library()
    with torch.cuda.device(pred.device):  # launch on the stream's device
        err = lib.dvt_best_iou_max(
            pred.data_ptr(), gt.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, n, m, torch.cuda.current_stream(pred.device).cuda_stream)
    if err != 0:
        msg = lib.dvt_best_iou_max_error_string(err).decode()
        raise RuntimeError(f"best_iou_max kernel launch failed: {msg} "
                           f"(cudaError {err})")
    best_iou_max.launches += 1
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    from deep_vision_tpu_torch.ops import _build

    lib = _build.load("best_iou_max")
    fn = lib.dvt_best_iou_max
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dvt_best_iou_max_error_string.argtypes = [ctypes.c_int]
    lib.dvt_best_iou_max_error_string.restype = ctypes.c_char_p
    return lib
