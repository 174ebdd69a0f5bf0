"""One adapter a program entry: ``make_shared``, ``program``, ``control``
and ``check``, as ``run.py`` calls them."""

import torch


def set_precision(config: dict) -> None:
    """The precision the configuration states for cuDNN and cuBLAS: TF32
    only where it does not state float32."""
    tf32 = config["precision"] != "float32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
