"""Path helpers, the counterpart of torch_admm_deconv_tpu/utils/paths.py
(the save-path and timestamp helpers live with the saver in
``train/saver.py``)."""

from __future__ import annotations

from pathlib import Path


def get_abs_path(relative_path: str) -> Path:
    """``relative_path`` appended to the port package's directory, as a
    string: pass it with its leading separator (JAX paths.py:9-12)."""
    root_path = Path(__file__).resolve().parent.parent
    return Path(str(root_path) + f"{relative_path}")


def get_x_y_paths(x_dir: str, y_dir: str):
    return get_abs_path(x_dir), get_abs_path(y_dir)
