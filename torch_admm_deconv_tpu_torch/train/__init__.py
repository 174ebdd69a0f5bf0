"""Training: the trainer, the LR schedule, the checkpoint saver, the logger."""

from torch_admm_deconv_tpu_torch.train.logger import MetricsLogger, psnr_compute  # noqa: F401
from torch_admm_deconv_tpu_torch.train.saver import (  # noqa: F401
    NNSaver,
    SaveMode,
    get_saving_model_path,
    get_time_formated,
    load_checkpoint,
)
from torch_admm_deconv_tpu_torch.train.schedules import cosine_annealing_warm_restarts  # noqa: F401
from torch_admm_deconv_tpu_torch.train.trainer import NNTrainer, make_optimizer  # noqa: F401
