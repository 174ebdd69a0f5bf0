"""The port's dataset builders (``data/builders.py``) and their CLI
(``scripts.make_blur_dset``) held against the JAX package's on the same
inputs, on the CPU. The builders draw noise from unseeded generators and
name files by ``uuid4``; to compare the packages, each run gets the same
seeded generators and the same name sequence, and written images are
compared by content."""

import contextlib
import importlib.util
import itertools
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_admm_deconv_tpu_torch.data import builders as t_b
from torch_admm_deconv_tpu_torch.scripts import make_blur_dset as t_cli

cv2 = pytest.importorskip("cv2")
j_b = pytest.importorskip("torch_admm_deconv_tpu.data.builders")

REPO = Path(__file__).resolve().parent.parent


@contextlib.contextmanager
def same_randomness(module):
    """Unseeded ``np.random.default_rng()`` calls draw from seeds 1000,
    1001, ...; ``module``'s file names are pair-0000, pair-0001, ..."""
    real = np.random.default_rng
    seeds, names = itertools.count(1000), itertools.count()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.random, "default_rng",
                   lambda seed=None: real(next(seeds) if seed is None else seed))
        mp.setattr(module, "get_rand_uuid", lambda: f"pair-{next(names):04d}")
        yield


def _write(path: Path, arr: np.ndarray) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), arr)
    return path


def _image(rng, h=40, w=48):
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def _tree(root: Path) -> dict:
    """Every written image under ``root`` by its relative path, decoded."""
    return {str(p.relative_to(root)): cv2.imread(str(p), cv2.IMREAD_UNCHANGED)
            for p in sorted(root.rglob("*.png"))}


def _same_tree(got: Path, want: Path):
    g, w = _tree(got), _tree(want)
    assert sorted(g) == sorted(w) and len(g) > 0
    for name in g:
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)


@pytest.mark.parametrize("patch,overlap,shape", [(4, 0.25, (10, 10, 3)), (16, 0.5, (40, 48, 3)),
                                                 (64, 0.25, (40, 48, 3))])
def test_extract_patches_matches_jax(patch, overlap, shape):
    img = np.arange(np.prod(shape)).reshape(shape).astype(np.uint8)
    got = t_b.extract_patches(img, patch, overlap)
    want = j_b.extract_patches(img, patch, overlap)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_make_pair_dirs_matches_jax(tmp_path):
    got = t_b.make_pair_dirs(tmp_path / "port", 0, 15)
    want = j_b.make_pair_dirs(tmp_path / "jax", 0, 15)
    assert {k: v.relative_to(tmp_path / "port") for k, v in got.items()} == {
        k: v.relative_to(tmp_path / "jax") for k, v in want.items()}
    assert all(v.is_dir() for v in got.values())


def test_blur_noise_and_hash_helpers_match_jax(rng):
    img = _image(rng)
    np.testing.assert_array_equal(t_b.add_blur_gaussian(img), j_b.add_blur_gaussian(img))
    np.testing.assert_array_equal(t_b.add_blur_gaussian(img, (5, 5), 1.0),
                                  j_b.add_blur_gaussian(img, (5, 5), 1.0))
    with same_randomness(t_b):
        got = t_b.add_noise_gaussian(img, 0, 10)
    with same_randomness(j_b):
        want = j_b.add_noise_gaussian(img, 0, 10)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and not np.array_equal(got, img)
    assert [d.value for d in t_b.Dset] == [d.value for d in j_b.Dset]


def test_pair_readers_match_jax(tmp_path):
    """Every pair-list reader on fake GoPro, HIDE, RealBlur, SIDD and RNIND
    layouts (the readers list files; they do not decode them)."""
    root = tmp_path / "data"
    files = [
        "gopro/train/s1/blur/000.png", "gopro/train/s1/blur/001.png",
        "gopro/train/s1/sharp/000.png", "gopro/train/s1/sharp/001.png",
        "gopro/train/s0/blur/a.png", "gopro/train/s0/sharp/a.png",
        "gopro/test/s2/blur/b.png", "gopro/test/s2/sharp/b.png",
        "hide/GT/x1.png", "hide/GT/x2.png", "hide/train/far/x1.png", "hide/train/near/x2.png",
        "hide/train/near/orphan.png", "hide/test/far/x2.png",
        "realblur/scene1/gt/a.png", "realblur/scene1/blur/a.png",
        "sidd/0001_001/0001_NOISY_SRGB_010.PNG", "sidd/0001_001/0001_GT_SRGB_010.PNG",
        "sidd/0002_001/0002_NOISY_SRGB_011.PNG", "sidd/0002_001/0002_GT_SRGB_011.PNG",
        "sidd/readme.txt",
        "rnind/sceneA_GT_0.arw", "rnind/sceneA_GT_1.arw", "rnind/sceneA_ISO6400_0.arw",
        "rnind/sceneB_GT_0.arw", "rnind/sceneC_ISO100_0.arw",
    ]
    for f in files:
        (root / f).parent.mkdir(parents=True, exist_ok=True)
        (root / f).write_bytes(b"x")
    (root / "realblur" / "RealBlur_J_train_list.txt").write_text(
        "scene1/gt/a.png scene1/blur/a.png\n\nscene1/gt/a.png scene1/blur/a.png\n")
    for split in ("train", "test"):
        assert t_b.gopro_pairs(root / "gopro", split) == j_b.gopro_pairs(root / "gopro", split)
        assert t_b.hide_pairs(root / "hide", split) == j_b.hide_pairs(root / "hide", split)
    assert len(t_b.gopro_pairs(root / "gopro", "train")) == 3
    assert len(t_b.hide_pairs(root / "hide", "train")) == 2
    listing = "RealBlur_J_train_list.txt"
    assert t_b.realblur_pairs(root / "realblur", listing) == j_b.realblur_pairs(
        root / "realblur", listing)
    assert t_b.get_dset_im_paths(root / "realblur" / listing) == j_b.get_dset_im_paths(
        root / "realblur" / listing)
    assert t_b.sidd_pairs(root / "sidd") == j_b.sidd_pairs(root / "sidd")
    assert len(t_b.sidd_pairs(root / "sidd")) == 2
    assert t_b.rnind_gt_paths(root / "rnind") == j_b.rnind_gt_paths(root / "rnind")
    assert [p.name for p in t_b.rnind_gt_paths(root / "rnind")] == ["sceneA_GT_0.arw",
                                                                   "sceneB_GT_0.arw"]


def test_process_x_y_ims_matches_jax(tmp_path, rng):
    """Pairs read by cv2, AWGN sigma in [5, 15] on x, tiled into 16-pixel
    patches: the same files with the same contents."""
    pairs = []
    for i in range(3):
        x = _write(tmp_path / "src" / f"x{i}.png", _image(rng))
        y = _write(tmp_path / "src" / f"y{i}.png", _image(rng))
        pairs.append((x, y))
    pairs.append((tmp_path / "src" / "missing.png", pairs[0][1]))  # unreadable: skipped
    counts = {}
    for name, mod in (("port", t_b), ("jax", j_b)):
        dirs = mod.make_pair_dirs(tmp_path / name, 5, 15)
        with same_randomness(mod):
            counts[name] = mod.process_x_y_ims(
                pairs, dirs[("train", "x")], dirs[("train", "y")], 5, 15,
                lambda im, m=mod: m.extract_patches(im, 16))
    assert counts["port"] == counts["jax"] == 3 * len(j_b.extract_patches(_image(rng), 16))
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_build_synthetic_pairs_matches_jax(tmp_path, rng):
    clean = tmp_path / "clean"
    for i in range(4):
        _write(clean / f"c{i}.png", _image(rng, 32, 32))
    counts = {}
    for name, mod in (("port", t_b), ("jax", j_b)):
        with same_randomness(mod):
            counts[name] = mod.build_synthetic_pairs(clean, tmp_path / name, 0, 10, (5, 5), 1.2,
                                                     test_fraction=0.25, patch=16)
    assert counts["port"] == counts["jax"] == {"train": 12, "test": 4}
    _same_tree(tmp_path / "port", tmp_path / "jax")


def _jax_cli():
    spec = importlib.util.spec_from_file_location("jax_make_blur_dset",
                                                  REPO / "scripts" / "make_blur_dset.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dset", ["synthetic", "gopro", "sidd"])
def test_make_blur_dset_cli_matches_jax(tmp_path, rng, monkeypatch, capsys, dset):
    """``-d DSET -i SRC -s OUT -m 0 -M 10`` on a few tiny PNGs: the same
    ``awgn-0-10/{train,test}/{x,y}`` tree, counts and printed lines as the
    JAX script."""
    src = tmp_path / "src"
    if dset == "synthetic":
        for i in range(3):
            _write(src / f"c{i}.png", _image(rng, 24, 32))
    elif dset == "gopro":
        for split, scenes in (("train", 2), ("test", 1)):
            for s in range(scenes):
                for i in range(2):
                    _write(src / split / f"s{s}" / "blur" / f"{i}.png", _image(rng, 24, 32))
                    _write(src / split / f"s{s}" / "sharp" / f"{i}.png", _image(rng, 24, 32))
    else:
        for s in range(3):
            _write(src / f"{s:04d}_001" / f"{s:04d}_NOISY_SRGB_010.png", _image(rng, 24, 32))
            _write(src / f"{s:04d}_001" / f"{s:04d}_GT_SRGB_010.png", _image(rng, 24, 32))
    jax_cli = _jax_cli()
    printed = {}
    for name, mod, run in (("port", t_b, t_cli.main), ("jax", j_b, jax_cli.main)):
        argv = ["-d", dset, "-i", str(src), "-s", str(tmp_path / name), "-m", "0", "-M", "10"]
        monkeypatch.setattr(sys, "argv", ["make_blur_dset.py", *argv])
        with same_randomness(mod):
            run(argv) if run is t_cli.main else run()
        printed[name] = capsys.readouterr().out
    assert printed["port"] == printed["jax"] and printed["port"]
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "awgn-0-10" / "train" / "x").is_dir()


def test_optional_dependencies_raise_as_in_jax(tmp_path, monkeypatch, rng):
    """cv2 and rawpy are imported where they are needed, with the JAX
    package's errors when they are missing."""
    img = _image(rng)
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mod in (t_b, j_b):
        with pytest.raises(ImportError, match="requires cv2"):
            mod.add_blur_gaussian(img)
        with pytest.raises(ImportError, match="requires cv2"):
            mod.process_x_y_ims([], tmp_path, tmp_path)
    monkeypatch.setitem(sys.modules, "rawpy", None)
    for mod in (t_b, j_b):
        with pytest.raises(ImportError, match="requires rawpy"):
            mod.rnind_raw_postprocess([], tmp_path)
