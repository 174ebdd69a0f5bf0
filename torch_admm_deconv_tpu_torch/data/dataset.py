"""Paired image-folder dataset and batching loader.

Counterpart of torch_admm_deconv_tpu/data/dataset.py (:27-114): paired x/y
directories, float32 CHW images, a list of paired transforms. Files are
sorted by name (``compat_unsorted=True`` keeps the reference's unsorted
``glob`` pairing, which misaligns x/y when names differ); the loader yields
numpy batches that the trainer moves to the device once per step, and draws
every random choice from a seeded ``numpy`` Generator. PIL is imported only
when an image file is read, so the module imports without it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def read_image_chw(path: Path) -> np.ndarray:
    """Read an image file to float32 CHW (RGB or grayscale), range [0, 255]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB") if im.mode not in ("L", "RGB") else im)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = arr.transpose(2, 0, 1)
    return arr.astype(np.float32)


class ImageDataset:
    def __init__(
        self,
        x_source: Path,
        y_source: Path,
        transforms: Optional[Sequence] = None,
        device: Optional[str] = None,  # the reference's signature; unused
        compat_unsorted: bool = False,
    ):
        self.x_source = Path(x_source)
        self.y_source = Path(y_source)
        self.transforms = transforms
        self.device = device
        x_paths = list(self.x_source.glob("*"))
        y_paths = list(self.y_source.glob("*"))
        if not compat_unsorted:
            x_paths.sort()
            y_paths.sort()
        self.x_paths = np.array([str(p) for p in x_paths])
        self.y_paths = np.array([str(p) for p in y_paths])

    def __len__(self) -> int:
        return len(self.x_paths)

    def get(self, idx: int, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        x_im = read_image_chw(Path(self.x_paths[idx]))
        y_im = read_image_chw(Path(self.y_paths[idx]))
        if self.transforms is not None:
            for t in self.transforms:
                x_im, y_im = t(x_im, y_im, rng)
        return x_im, y_im

    def __getitem__(self, idx: int):
        return self.get(idx, np.random.default_rng())

    def shuffle(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        p = rng.permutation(len(self.x_paths))
        return self.x_paths[p], self.y_paths[p]


class DataLoader:
    """Minimal epoch iterator yielding stacked numpy (x, y) batches."""

    def __init__(
        self,
        dataset: ImageDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        batch_x: List[np.ndarray] = []
        batch_y: List[np.ndarray] = []
        for pos, idx in enumerate(order[:stop]):
            x, y = self.dataset.get(int(idx), self._rng)
            batch_x.append(x)
            batch_y.append(y)
            if len(batch_x) == self.batch_size or pos == stop - 1:
                yield np.stack(batch_x), np.stack(batch_y)
                batch_x, batch_y = [], []
