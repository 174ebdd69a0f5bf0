"""PyTorch + CUDA port of the TV-ADMM deconvolution framework.

The JAX package ``torch_admm_deconv_tpu`` beside it is the reference. This
package imports neither JAX nor that package. Its entry points run on the
GPU unless the caller passes ``device="cpu"``; the solver's hand-written
Hopper kernels (``kernels/``, sources in ``csrc/``) build with ``nvcc`` on
first use.
"""

from torch_admm_deconv_tpu_torch.infer import (
    classical_restorer,
    model_restorer,
    restore_image,
    tiled_apply,
)
from torch_admm_deconv_tpu_torch.kernels.fused_admm import fused_elementwise_step
from torch_admm_deconv_tpu_torch.kernels.vmem_solver import (
    adaptive_vmem_available,
    admm_tv_adaptive_vmem,
    admm_tv_vmem,
    vmem_solve_available,
)
from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
from torch_admm_deconv_tpu_torch.models.denoiser import (
    DivergentRestorer,
    flagship_divergent_restorer,
)
from torch_admm_deconv_tpu_torch.ops.implicit import admm_tv_implicit
from torch_admm_deconv_tpu_torch.ops.solver import (
    AdaptiveResult,
    admm_tv,
    admm_tv_adaptive,
    tv_objective,
)

__all__ = [
    "ADMMDeconv",
    "AdaptiveResult",
    "DivergentRestorer",
    "adaptive_vmem_available",
    "admm_tv",
    "admm_tv_adaptive",
    "admm_tv_adaptive_vmem",
    "admm_tv_implicit",
    "admm_tv_vmem",
    "classical_restorer",
    "flagship_divergent_restorer",
    "fused_elementwise_step",
    "model_restorer",
    "restore_image",
    "tiled_apply",
    "tv_objective",
    "vmem_solve_available",
]
