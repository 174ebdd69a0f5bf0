"""Path helpers and the timing and tracing helpers (``utils.profiling``)."""

from torch_admm_deconv_tpu_torch.utils.paths import get_abs_path, get_x_y_paths  # noqa: F401
