"""MNIST idx-ubyte reading and preprocessing.

Port of ``deep_vision_tpu/data/mnist.py`` (the reference's
LeNet/pytorch/data_load.py, vectorized): 28×28 uint8 images → zero-pad to
32×32 → NHWC; ``preprocess`` normalizes on the host, ``pad_uint8`` keeps
the 1-byte wire for the card's normalize
(``ops/preprocess.make_mnist_preprocess``).  ``load_mnist`` finds the
files under their plain, ``.gz`` and ``.idx`` names.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

MEAN, STD = 0.1307, 0.3081  # MNIST pixel statistics on [0, 1] pixels


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def load_idx_images(path: str) -> np.ndarray:
    """idx3-ubyte file → uint8 (N, rows, cols)."""
    with _open(path) as f:
        b = f.read()
    magic = int.from_bytes(b[0:4], "big")
    if magic != 2051:
        raise ValueError(f"bad image idx magic {magic} in {path}")
    count = int.from_bytes(b[4:8], "big")
    rows = int.from_bytes(b[8:12], "big")
    cols = int.from_bytes(b[12:16], "big")
    images = np.frombuffer(b, np.uint8, count * rows * cols, offset=16)
    return images.reshape(count, rows, cols)


def load_idx_labels(path: str) -> np.ndarray:
    """idx1-ubyte file → int32 (N,)."""
    with _open(path) as f:
        b = f.read()
    magic = int.from_bytes(b[0:4], "big")
    if magic != 2049:
        raise ValueError(f"bad label idx magic {magic} in {path}")
    count = int.from_bytes(b[4:8], "big")
    return np.frombuffer(b, np.uint8, count, offset=8).astype(np.int32)


def pad_uint8(images: np.ndarray) -> np.ndarray:
    """uint8 (N, 28, 28) → uint8 NHWC (N, 32, 32, 1), zero borders."""
    return np.pad(images, ((0, 0), (2, 2), (2, 2)), "constant")[..., None]


def preprocess(images: np.ndarray, mean: float = MEAN,
               std: float = STD) -> np.ndarray:
    """uint8 (N, 28, 28) → normalized float32 NHWC (N, 32, 32, 1)."""
    x = np.pad(images, ((0, 0), (2, 2), (2, 2)), "constant")
    x = x.astype(np.float32) / 255.0
    x = (x - mean) / std
    return x[..., None]


def mnist_paths(root: str, split: str = "train") -> tuple[str, str]:
    """The (images, labels) files of ``split`` ("train" or "test") under
    ``root``, each as ``NAME``, ``NAME.gz`` or with ``-idx`` written
    ``.idx``."""
    prefix = "train" if split == "train" else "t10k"
    paths = []
    for name in (f"{prefix}-images-idx3-ubyte", f"{prefix}-labels-idx1-ubyte"):
        for cand in (name, name + ".gz", name.replace("-idx", ".idx")):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                paths.append(p)
                break
        else:
            raise FileNotFoundError(f"{name}[.gz] not under {root}")
    return paths[0], paths[1]


def load_mnist(root: str, split: str = "train",
               device_normalize: bool = False) -> dict[str, np.ndarray]:
    """``{"image", "label"}`` of ``split``.  ``device_normalize`` keeps
    the uint8 wire (raw bytes padded to 32×32; the card normalizes);
    otherwise the images are float32, normalized on the host."""
    images, labels = mnist_paths(root, split)
    raw = load_idx_images(images)
    image = pad_uint8(raw) if device_normalize else preprocess(raw)
    return {"image": image, "label": load_idx_labels(labels)}


def synthetic_mnist(n: int = 512, seed: int = 0, num_classes: int = 10
                    ) -> dict[str, np.ndarray]:
    """Learnable synthetic 32×32×1 digits for smoke runs."""
    from deep_vision_tpu_torch.data.synthetic import synthetic_classification

    return synthetic_classification(n, 32, 1, num_classes, seed)


def write_idx(root: str, split: str, images: np.ndarray,
              labels: np.ndarray, gz: bool = False) -> tuple[str, str]:
    """Write uint8 (N, 28, 28) ``images`` and ``labels`` as ``split``'s
    idx-ubyte files under ``root`` (``.gz`` if asked); returns the
    paths."""
    prefix = "train" if split == "train" else "t10k"
    n, rows, cols = images.shape
    img = (2051).to_bytes(4, "big") + n.to_bytes(4, "big") + \
        rows.to_bytes(4, "big") + cols.to_bytes(4, "big") + \
        np.ascontiguousarray(images, np.uint8).tobytes()
    lab = (2049).to_bytes(4, "big") + n.to_bytes(4, "big") + \
        np.asarray(labels, np.uint8).tobytes()
    out = []
    for name, data in ((f"{prefix}-images-idx3-ubyte", img),
                       (f"{prefix}-labels-idx1-ubyte", lab)):
        path = os.path.join(root, name + (".gz" if gz else ""))
        with (gzip.open(path, "wb") if gz else open(path, "wb")) as f:
            f.write(data)
        out.append(path)
    return out[0], out[1]
