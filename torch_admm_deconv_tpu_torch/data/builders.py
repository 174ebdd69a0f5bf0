"""Synthetic blur/noise dataset builders.

Counterpart of torch_admm_deconv_tpu/data/builders.py, a copy of its NumPy
code (the port imports nothing of the JAX package): collect clean/degraded
pair lists for the GOPRO / HIDE / REALBLUR / SIDD / RENOIR / RNIND layouts,
optionally inject gaussian noise, and write
``<save>/awgn-{m}-{M}/{train,test}/{x,y}`` trees with uuid names. The
optional dependencies (cv2, rawpy, PIL) are imported lazily, inside the
function that needs them, and gated with an ImportError that names them.
"""

from __future__ import annotations

import enum
import uuid
from pathlib import Path
from typing import Callable, List, Optional, Tuple

import numpy as np


class Dset(enum.Enum):
    GOPRO = "gopro"
    HIDE = "hide"
    REALBLUR = "realblur"
    SIDD = "sidd"
    RENOIR = "renoir"
    RNIND = "rnind"


def _require_cv2():
    try:
        import cv2  # noqa: F401

        return cv2
    except ImportError as e:  # pragma: no cover
        raise ImportError("dataset building requires cv2 (opencv-python)") from e


def add_blur_gaussian(img: np.ndarray, k_shape=(17, 17), std: float = 2.4) -> np.ndarray:
    """Gaussian blur (utils/dset_utils.py:21-23)."""
    cv2 = _require_cv2()
    return cv2.GaussianBlur(img, k_shape, std)


def add_noise_gaussian(img: np.ndarray, mean: float = 0, stdv: float = 25) -> np.ndarray:
    """Additive gaussian noise, uint8-saturating (utils/dset_utils.py:26-30)."""
    rng = np.random.default_rng()
    noise = rng.normal(mean, stdv, img.shape)
    return np.clip(img.astype(np.float64) + noise, 0, 255).astype(img.dtype)


def get_rand_uuid() -> str:
    return str(uuid.uuid4())


def get_im_hash(img: np.ndarray) -> str:
    """Perceptual hash for dedup (utils/dset_utils.py:9-14)."""
    cv2 = _require_cv2()
    gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    h = cv2.img_hash.pHash(gray)
    return str(hex(int.from_bytes(h.tobytes(), byteorder="big", signed=False)))


def get_dset_im_paths(txt_file: Path) -> Tuple[List[Path], List[Path]]:
    """txt-driven pairing: each line '<y> <x>' relative to the txt dir
    (utils/dset_utils.py:33-38)."""
    lines = Path(txt_file).read_text().splitlines()
    y_paths = [Path(txt_file).parent / ln.split(" ")[0] for ln in lines if ln.strip()]
    x_paths = [Path(txt_file).parent / ln.split(" ")[1] for ln in lines if ln.strip()]
    return x_paths, y_paths


# ---------------------------------------------------------------------------
# per-layout pair collectors (make_blur_dset.py:40-220)
# ---------------------------------------------------------------------------


def gopro_pairs(root: Path, split: str) -> List[Tuple[Path, Path]]:
    """GOPRO layout: <root>/<split>/<scene>/{blur,sharp}/*.png."""
    pairs = []
    for scene in sorted((root / split).iterdir()):
        blur = sorted((scene / "blur").glob("*"))
        sharp = sorted((scene / "sharp").glob("*"))
        pairs += list(zip(blur, sharp))
    return pairs


def hide_pairs(root: Path, split: str) -> List[Tuple[Path, Path]]:
    """HIDE layout: GT/ plus blurred <split> dirs with matching names."""
    gt = {p.name: p for p in (root / "GT").rglob("*.png")}
    pairs = []
    for blurred in sorted((root / split).rglob("*.png")):
        if blurred.name in gt:
            pairs.append((blurred, gt[blurred.name]))
    return pairs


def realblur_pairs(root: Path, list_file: str) -> List[Tuple[Path, Path]]:
    """RealBlur ships txt pair lists (make_blur_dset.py REALBLUR path)."""
    x, y = get_dset_im_paths(root / list_file)
    return list(zip(x, y))


def sidd_pairs(root: Path) -> List[Tuple[Path, Path]]:
    """SIDD srgb layout: <scene>/{NOISY,GT}_SRGB_*.PNG."""
    pairs = []
    for scene in sorted(root.iterdir()):
        if not scene.is_dir():
            continue
        noisy = sorted(scene.glob("*NOISY_SRGB*"))
        gt = sorted(scene.glob("*GT_SRGB*"))
        pairs += list(zip(noisy, gt))
    return pairs


def rnind_gt_paths(root: Path) -> List[Path]:
    """RNIND ground-truth raw selection: files with ``_GT_`` in the name,
    first per scene id (reference make_blur_dset.py:200-209 — its dict
    keeps only the first GT raw seen for each ``<id>_GT_*`` stem)."""
    gts = {}
    for im in sorted(Path(root).glob("*")):
        if "_GT_" in im.name:
            gts.setdefault(im.stem.split("_GT_")[0], im)
    return list(gts.values())


def rnind_raw_postprocess(raws: List[Path], save_dir: Path) -> int:
    """Demosaic RNIND ``_GT_`` raws to 8-bit PNGs (make_blur_dset.py:211-216).

    Requires ``rawpy`` (undeclared in the reference's pyproject too); the
    import is gated so environments without it can still run every other
    builder. rawpy's postprocess returns RGB; the PNGs are written RGB
    (the reference's BGR2RGB + cv2.imwrite round-trip lands on the same
    channel order)."""
    try:
        import rawpy
    except ImportError as e:  # pragma: no cover
        raise ImportError("RNIND raw postprocessing requires rawpy") from e
    from PIL import Image

    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    count = 0
    for img in raws:
        with rawpy.imread(str(img)) as raw:
            arr = raw.postprocess()
        Image.fromarray(arr).save(save_dir / f"{Path(img).stem}.png")
        count += 1
    return count


def extract_patches(
    img: np.ndarray, patch: int = 256, overlap: float = 0.25
) -> List[np.ndarray]:
    """Overlapping patch tiling (RENOIR path, make_blur_dset.py:170-180)."""
    step = max(1, int(patch * (1.0 - overlap)))
    h, w = img.shape[:2]
    out = []
    for top in range(0, max(1, h - patch + 1), step):
        for left in range(0, max(1, w - patch + 1), step):
            p = img[top : top + patch, left : left + patch]
            if p.shape[0] == patch and p.shape[1] == patch:
                out.append(p)
    return out


# ---------------------------------------------------------------------------
# writer (make_blur_dset.py:26-37, 237-245)
# ---------------------------------------------------------------------------


def make_pair_dirs(save_root: Path, min_awgn: int, max_awgn: int) -> dict:
    base = Path(save_root) / f"awgn-{min_awgn}-{max_awgn}"
    dirs = {}
    for split in ("train", "test"):
        for side in ("x", "y"):
            d = base / split / side
            d.mkdir(parents=True, exist_ok=True)
            dirs[(split, side)] = d
    return dirs


def process_x_y_ims(
    pairs: List[Tuple[Path, Path]],
    x_dir: Path,
    y_dir: Path,
    min_awgn: int = 0,
    max_awgn: int = 0,
    patcher: Optional[Callable[[np.ndarray], List[np.ndarray]]] = None,
) -> int:
    """Read each (x, y) pair, optionally noise x, write both with a shared
    uuid name. Returns the number of written pairs."""
    cv2 = _require_cv2()
    rng = np.random.default_rng()
    count = 0
    for x_path, y_path in pairs:
        x_im = cv2.imread(str(x_path))
        y_im = cv2.imread(str(y_path))
        if x_im is None or y_im is None:
            continue
        x_patches = patcher(x_im) if patcher else [x_im]
        y_patches = patcher(y_im) if patcher else [y_im]
        for xp, yp in zip(x_patches, y_patches):
            if max_awgn > 0:
                std = float(rng.integers(min_awgn, max_awgn + 1))
                xp = add_noise_gaussian(xp, 0, std)
            name = get_rand_uuid() + ".png"
            cv2.imwrite(str(Path(x_dir) / name), xp)
            cv2.imwrite(str(Path(y_dir) / name), yp)
            count += 1
    return count


def build_synthetic_pairs(
    clean_dir: Path,
    save_root: Path,
    min_awgn: int = 0,
    max_awgn: int = 15,
    blur_kernel: Tuple[int, int] = (17, 17),
    blur_std: float = 2.4,
    test_fraction: float = 0.1,
    patch: Optional[int] = None,
) -> dict:
    """Beyond-reference convenience: blur+noise a folder of clean images
    into the awgn-{m}-{M} train/test tree directly."""
    cv2 = _require_cv2()
    dirs = make_pair_dirs(save_root, min_awgn, max_awgn)
    rng = np.random.default_rng(0)
    files = sorted(Path(clean_dir).glob("*"))
    n_test = max(1, int(len(files) * test_fraction)) if files else 0
    counts = {"train": 0, "test": 0}
    for i, f in enumerate(files):
        img = cv2.imread(str(f))
        if img is None:
            continue
        split = "test" if i < n_test else "train"
        patches = extract_patches(img, patch) if patch else [img]
        for p in patches:
            degraded = add_blur_gaussian(p, blur_kernel, blur_std)
            if max_awgn > 0:
                std = float(rng.integers(min_awgn, max_awgn + 1))
                degraded = add_noise_gaussian(degraded, 0, std)
            name = get_rand_uuid() + ".png"
            cv2.imwrite(str(dirs[(split, "x")] / name), degraded)
            cv2.imwrite(str(dirs[(split, "y")] / name), p)
            counts[split] += 1
    return counts
