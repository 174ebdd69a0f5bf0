"""Build paired restoration datasets from a known layout.

    python -m torch_admm_deconv_tpu_torch.scripts.make_blur_dset -d gopro -i GOPRO/ \
        -s datasets -m 0 -M 15
    python -m torch_admm_deconv_tpu_torch.scripts.make_blur_dset -d synthetic -i clean/

Counterpart of the JAX package's ``scripts/make_blur_dset.py``, flag for
flag: collect clean/degraded pairs from a GOPRO / HIDE / REALBLUR / SIDD /
RENOIR / RNIND root, optionally inject AWGN, and write the
``<save>/awgn-{m}-{M}/{train,test}/{x,y}`` tree; ``--dset synthetic``
blurs and noises any folder of clean images. Host code (NumPy and cv2;
rawpy for RNIND): it touches no device and takes no ``--device``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from torch_admm_deconv_tpu_torch.data import builders
from torch_admm_deconv_tpu_torch.data.builders import Dset


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build paired restoration datasets")
    parser.add_argument("--dset", "-d", required=True,
                        choices=[d.value for d in Dset] + ["synthetic"])
    parser.add_argument("--source", "-i", required=True, help="dataset root dir")
    parser.add_argument("--save", "-s", default="datasets")
    parser.add_argument("--min_awgn", "-m", type=int, default=0)
    parser.add_argument("--max_awgn", "-M", type=int, default=0)
    parser.add_argument("--patch", type=int, default=0,
                        help="patch size for RENOIR-style tiling (0=off)")
    args = parser.parse_args(argv)

    root = Path(args.source)
    dirs = builders.make_pair_dirs(Path(args.save), args.min_awgn, args.max_awgn)
    patcher = (lambda im: builders.extract_patches(im, args.patch)) if args.patch else None

    if args.dset == "synthetic":
        counts = builders.build_synthetic_pairs(
            root, Path(args.save), args.min_awgn, args.max_awgn,
            patch=args.patch or None,
        )
        print(f"synthetic pairs written: {counts}")
        return

    d = Dset(args.dset)
    if d == Dset.GOPRO:
        split_pairs = {"train": builders.gopro_pairs(root, "train"),
                       "test": builders.gopro_pairs(root, "test")}
    elif d == Dset.HIDE:
        split_pairs = {"train": builders.hide_pairs(root, "train"),
                       "test": builders.hide_pairs(root, "test")}
    elif d == Dset.REALBLUR:
        split_pairs = {
            "train": builders.realblur_pairs(root, "RealBlur_J_train_list.txt"),
            "test": builders.realblur_pairs(root, "RealBlur_J_test_list.txt"),
        }
    elif d == Dset.SIDD:
        pairs = builders.sidd_pairs(root)
        n_test = max(1, len(pairs) // 10)
        split_pairs = {"train": pairs[n_test:], "test": pairs[:n_test]}
    elif d == Dset.RNIND:
        # RNIND: demosaic the _GT_ raws into clean train targets
        # (reference make_rnind_train_set, make_blur_dset.py:197-220 —
        # train-only, clean y; noise comes on the fly at train time)
        raws = builders.rnind_gt_paths(root)
        n = builders.rnind_raw_postprocess(raws, dirs[("train", "y")])
        print(f"train: {n} RNIND GT raws demosaiced")
        return
    elif d == Dset.RENOIR:
        # RENOIR: scene dirs with Noisy/Reference images;
        # pair the noisiest against the cleanest per scene, patch-tile.
        split_pairs = {"train": [], "test": []}
        scenes = sorted(p for p in root.iterdir() if p.is_dir())
        for si, scene in enumerate(scenes):
            ims = sorted(scene.glob("*"))
            if len(ims) < 2:
                continue
            pair = (ims[-1], ims[0])  # (noisy, clean) by name order
            split_pairs["test" if si % 10 == 0 else "train"].append(pair)
        if not patcher and d == Dset.RENOIR:
            patcher = lambda im: builders.extract_patches(im, 256)  # noqa: E731
    else:  # pragma: no cover
        raise ValueError(d)

    for split, pairs in split_pairs.items():
        n = builders.process_x_y_ims(
            pairs, dirs[(split, "x")], dirs[(split, "y")],
            args.min_awgn, args.max_awgn, patcher,
        )
        print(f"{split}: {n} pairs written")


if __name__ == "__main__":
    main()
