"""Restoration models: every name of torch_admm_deconv_tpu/models/__init__.py.
The models' ``device`` argument: ``None`` means CUDA; the CPU only when
named."""

from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv  # noqa: F401
from torch_admm_deconv_tpu_torch.models.attention import (  # noqa: F401
    CBAM,
    AttentionChannelPooling,
    BasicConv,
    ChannelCompression,
    ChannelGate,
    ChannelPool,
    ChannelWiseAttention,
    SpatialGate,
    channel_pool,
    logsumexp_2d,
)
from torch_admm_deconv_tpu_torch.models.autoencoder import (  # noqa: F401
    Autoencoder,
    Decoder,
    Encoder,
)
from torch_admm_deconv_tpu_torch.models.blocks import (  # noqa: F401
    DepthwiseDownBlock,
    DivergentAttention,
    DownBlock,
    MultiADMM,
    MultiScaleConvPool,
    UpBlock,
    UpDownBlock,
    compute_depth_enc_in_out_channels,
    compute_enc_input_channels,
    compute_residual_dec_input_channels,
    conv2d_pooling_output_shape,
)
from torch_admm_deconv_tpu_torch.models.denoiser import (  # noqa: F401
    DECONV1,
    DECONV2,
    DivergentRestorer,
    flagship_divergent_restorer,
)
from torch_admm_deconv_tpu_torch.models.denoiser_v2 import (  # noqa: F401
    RestorerV2,
    RestorerV2Block,
)
from torch_admm_deconv_tpu_torch.models.fusion import ADMMFusion, Deconvs  # noqa: F401
from torch_admm_deconv_tpu_torch.models.learned_prox import (  # noqa: F401
    LearnedProxADMM,
    ProxNet,
)
from torch_admm_deconv_tpu_torch.models.layers_common import (  # noqa: F401
    Conv2d,
    ConvTranspose2d,
    InstanceNorm2d,
    LayerNorm2d,
    Linear,
    default_init_weights,
    same_padding,
)
from torch_admm_deconv_tpu_torch.models.local_patch import (  # noqa: F401
    LocalAttentionPatch,
    PatchProcessor,
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
from torch_admm_deconv_tpu_torch.models.restorer import Restorer, UpDownScale  # noqa: F401
from torch_admm_deconv_tpu_torch.models.sra import ParallelUpsampleReduce  # noqa: F401
from torch_admm_deconv_tpu_torch.models.varmap import (  # noqa: F401
    ChannelwiseVariance,
    channelwise_variance,
)
