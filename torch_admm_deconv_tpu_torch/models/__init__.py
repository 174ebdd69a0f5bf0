"""Restoration models: layers, attention, blocks, ADMMDeconv, DivergentRestorer,
NAFNet. The names of torch_admm_deconv_tpu/models/__init__.py that are
ported so far."""

from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv  # noqa: F401
from torch_admm_deconv_tpu_torch.models.attention import (  # noqa: F401
    CBAM,
    AttentionChannelPooling,
    BasicConv,
    ChannelCompression,
    ChannelGate,
    ChannelWiseAttention,
    SpatialGate,
    channel_pool,
    logsumexp_2d,
)
from torch_admm_deconv_tpu_torch.models.blocks import (  # noqa: F401
    DivergentAttention,
    DownBlock,
    MultiADMM,
    UpBlock,
    UpDownBlock,
)
from torch_admm_deconv_tpu_torch.models.denoiser import (  # noqa: F401
    DivergentRestorer,
    flagship_divergent_restorer,
)
from torch_admm_deconv_tpu_torch.models.layers_common import (  # noqa: F401
    Conv2d,
    ConvTranspose2d,
    InstanceNorm2d,
    LayerNorm2d,
    Linear,
    same_padding,
)
from torch_admm_deconv_tpu_torch.models.nafnet import (  # noqa: F401
    NAFBlock,
    NAFNet,
    NAFNetLocal,
    local_avg_pool2d,
    simple_gate,
)
from torch_admm_deconv_tpu_torch.models.regularizers import (  # noqa: F401
    admm_clipper,
    admm_weight_clipper,
    clip_grads_by_value,
    train_weight_clipper,
)
